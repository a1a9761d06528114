"""Closed-form and semi-analytic prices.

Counterpart of ``optpricer_tpu/models/analytic.py``:

* :func:`geometric_asian_price` — the discrete geometric Asian under GBM
  (the control-variate mean of the arithmetic Asian).
* :func:`merton_price` — Merton (1976) jump diffusion as a Poisson
  mixture of Black-Scholes prices.
* :func:`heston_price_cos` / :func:`bates_price_cos` — Fang and
  Oosterlee's COS expansion of the Heston (and Heston × lognormal-jump)
  characteristic function: a strike batch is one complex matvec over the
  cosine frequencies; :func:`fit_heston` calibrates it by
  Levenberg-Marquardt with exact forward-mode Jacobians, and
  :func:`heston_greeks_cos` differentiates it with ``torch.autograd``.
* :func:`sabr_implied_vol` / :func:`sabr_price_hagan` — Hagan et al.
  (2002); :func:`cev_price` — Schroder's noncentral chi-square form.
* :func:`barrier_price_bs`, :func:`double_barrier_price_bs`,
  :func:`lookback_price_bs` — continuously-monitored barriers and
  lookbacks under GBM; :func:`quanto_price`, :func:`chooser_price`,
  :func:`compound_price`.

None of these reaches a TPU kernel in the JAX package, so the port is
plain torch on ``device`` (default ``"cuda"``), float64 unless ``dtype=``
says otherwise. The operations follow the reference's in order, so a
price agrees with it to rounding; the COS strike sums run as one complex
matvec (``torch.matmul``) or, where each quote has its own expiry, as a
row sum.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import (_mask, _pdf, _prep, is_call_mask,
                                 price_core, vega_core)

__all__ = ["merton_price", "heston_price_cos", "bates_price_cos",
           "quanto_price", "quanto_adjusted_carry",
           "sabr_implied_vol", "sabr_price_hagan", "geometric_asian_price",
           "fit_heston", "heston_greeks_cos", "cev_price",
           "barrier_price_bs", "chooser_price", "compound_price",
           "lookback_price_bs", "double_barrier_price_bs"]

_ncdf = torch.special.ndtr


def _host_vector(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.ravel(np.asarray(values, np.float64))


# --------------------------------------------------------------------------
# Discrete geometric Asian — exact closed form (GBM)
# --------------------------------------------------------------------------

def geometric_asian_price_f64(S0, K, T, r, q=0.0, sigma=0.2, *,
                              kind="call", n_steps: int = 252) -> float:
    """Host-float64 scalar :func:`geometric_asian_price`: the control-variate
    mean must not inherit the kernels' f32 precision."""
    m = float(n_steps)
    c = r - q - 0.5 * sigma * sigma
    mu_g = math.log(S0) + c * T * (m + 1.0) / (2.0 * m)
    var_g = sigma * sigma * T * (m + 1.0) * (2.0 * m + 1.0) / (6.0 * m * m)
    sig_g = math.sqrt(var_g)
    df = math.exp(-r * T)
    F_g = math.exp(mu_g + 0.5 * var_g)
    d2 = (mu_g - math.log(K)) / sig_g
    d1 = d2 + sig_g
    Phi = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    if kind == "call":
        return df * (F_g * Phi(d1) - K * Phi(d2))
    return df * (K * Phi(-d2) - F_g * Phi(-d1))


def geometric_asian_price(S0, K, T, r, q=0.0, sigma=0.2, *, kind="call",
                          n_steps: int = 252, dtype=None, device=None):
    """Fixed-strike geometric-average Asian under GBM, exact closed form.

    The average runs over the n_steps grid points t_i = i·T/m, i = 1..m
    (t = 0 excluded), as in the Monte-Carlo engines; ln G is Gaussian with
    mu_G = ln S0 + c·T(m+1)/(2m), c = r − q − σ²/2, and
    sigma_G² = σ²·T·(m+1)(2m+1)/(6m²), so the price is a Black-Scholes
    formula on (mu_G, sigma_G). Inputs broadcast; float64 by default.
    """
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0, K, T, r, q, sigma = (torch.as_tensor(v, dtype=dt_, device=dev)
                             for v in (S0, K, T, r, q, sigma))
    is_call = torch.as_tensor(is_call_mask(kind), device=dev)
    m = float(n_steps)
    c = r - q - 0.5 * sigma * sigma
    mu_g = torch.log(S0) + c * T * (m + 1.0) / (2.0 * m)
    var_g = sigma * sigma * T * (m + 1.0) * (2.0 * m + 1.0) / (6.0 * m * m)
    sig_g = torch.sqrt(var_g)
    df = torch.exp(-r * T)
    F_g = torch.exp(mu_g + 0.5 * var_g)
    d2 = (mu_g - torch.log(K)) / sig_g
    d1 = d2 + sig_g
    Phi = torch.special.ndtr
    call = df * (F_g * Phi(d1) - K * Phi(d2))
    put = df * (K * Phi(-d2) - F_g * Phi(-d1))
    return torch.where(is_call, call, put)


# --------------------------------------------------------------------------
# Merton jump diffusion — exact series
# --------------------------------------------------------------------------

def merton_price(S0, K, T, r, q=0.0, sigma=0.2, *, lam=0.0, mJ=0.0,
                 sJ=0.0, kind="call", n_terms: int = 48, dtype=None,
                 device=None):
    """European price under Merton jump diffusion, exact to ``n_terms``.

    Conditional on ``k`` jumps the log-spot is Gaussian, so the price is
    a Poisson mixture of Black-Scholes prices with per-count inputs
    sigma_k² = sigma² + k·sJ²/T and r_k = r − lam·kappa + k·(mJ + sJ²/2)/T,
    kappa = e^{mJ+sJ²/2} − 1. Broadcasting over the scalar inputs; ``kind``
    may be a string or an array of strings.
    """
    S0, K, T, r, q, sigma, lam, mJ, sJ = _prep(
        dtype, device, S0, K, T, r, q, sigma, lam, mJ, sJ)
    is_call = _mask(kind, device)
    nd = torch.broadcast_shapes(S0.shape, K.shape, T.shape, r.shape,
                                q.shape, sigma.shape, lam.shape, mJ.shape,
                                sJ.shape, is_call.shape)
    kappa = torch.exp(mJ + 0.5 * sJ * sJ) - 1.0
    lam_p = lam * (1.0 + kappa)          # risk-neutral jump intensity ×(1+κ)
    k = torch.arange(n_terms, dtype=S0.dtype, device=S0.device).reshape(
        (n_terms,) + (1,) * len(nd))
    sig_k = torch.sqrt(sigma * sigma + k * sJ * sJ / T)
    r_k = r - lam * kappa + k * (mJ + 0.5 * sJ * sJ) / T
    # Poisson weight in log space for stability at large λ'T
    logw = -lam_p * T + k * torch.log(torch.clamp(lam_p * T, min=1e-300)) \
        - torch.lgamma(k + 1.0)
    w = torch.where(lam_p * T > 0.0, torch.exp(logw),
                    torch.where(k == 0.0, 1.0, 0.0).to(S0.dtype))
    return torch.sum(w * price_core(S0, K, T, r_k, q, sig_k, is_call), dim=0)


# --------------------------------------------------------------------------
# Heston — COS method
# --------------------------------------------------------------------------

def _log1p_c(z):
    """Complex log1p: series for small |z| (f32 log(1+z) loses the small-z
    information that the 1/ξ² prefactor in the Heston cf then amplifies).
    Both ``where``s keep the branch not taken away from a bad argument, so
    no NaN gradient leaks from it."""
    small = torch.abs(z) < 1e-3
    zs = torch.where(small, z, torch.zeros_like(z))
    series = zs * (1.0 - zs * (0.5 - zs / 3.0))
    return torch.where(small, series,
                       torch.log(torch.where(small, torch.ones_like(z),
                                             1.0 + z)))


def _heston_cf(u, T, r, q, v0, kappa, theta, xi, rho):
    """φ(u) = E[e^{iu·ln(S_T/S_0)}] — Heston characteristic function, the
    "little Heston trap" branch, with α−d formed as −ξ²(iu+u²)/(α+d) so
    that (α−d)/ξ² never divides a rounding residual by ξ²."""
    iu = 1j * u
    alpha = kappa - rho * xi * iu
    d = torch.sqrt(alpha * alpha + xi * xi * (iu + u * u))
    amd_over_xi2 = -(iu + u * u) / (alpha + d)       # (α−d)/ξ², exact
    g = amd_over_xi2 * xi * xi / (alpha + d)         # (α−d)/(α+d)
    edt = torch.exp(-d * T)
    # log((1−g·edt)/(1−g)) = log1p(−g·edt) − log1p(−g)
    log_ratio = _log1p_c(-g * edt) - _log1p_c(-g)
    C = (r - q) * iu * T + kappa * theta * (
        amd_over_xi2 * T - 2.0 * log_ratio / (xi * xi))
    D = amd_over_xi2 * (1.0 - edt) / (1.0 - g * edt)
    return torch.exp(C + D * v0)


def _kpi_fixed(k, frac):
    """k·frac mod 2 as a 24-bit integer in units of 2^-23: frac rounded
    to 23 bits in float32, the product in int64 masked to 24 bits."""
    nf = torch.round(frac.to(torch.float32) * (1 << 23)).to(torch.int64)
    return (k.to(torch.int64) * nf) & ((1 << 24) - 1)


def _trig_kpi(k, frac, dt_):
    """(cos, sin) of kπ·frac for integer k and frac ∈ [0, 1].

    In float32 the raw argument reaches N·π radians, where single-precision
    trig loses its digits, so k·frac is reduced mod 2 exactly: frac
    quantises to 23 bits and the product, formed in int64, is masked to 24
    bits (= mod 2 in fixed point) — the same integers as the reference's
    wrapping uint32 product, whose low 24 bits it keeps. float64 keeps the
    direct angle.
    """
    if dt_ == torch.float64:
        th = k.to(dt_) * math.pi * frac
        return torch.cos(th), torch.sin(th)
    m = _kpi_fixed(k, frac)
    th = m.to(torch.float32) * torch.tensor(math.pi / (1 << 23),
                                            dtype=torch.float32,
                                            device=m.device)
    return torch.cos(th), torch.sin(th)


def _cos_chi_psi(k, a, b, c, d, dt_):
    """∫_c^d e^y cos(kπ(y−a)/(b−a)) dy and ∫_c^d cos(·) dy (COS paper
    eq. 22-23); ``a``..``d`` broadcast against the frequency axis ``k``."""
    w = k * math.pi / (b - a)
    cos_d, sin_d = _trig_kpi(k, (d - a) / (b - a), dt_)
    cos_c, sin_c = _trig_kpi(k, (c - a) / (b - a), dt_)
    chi = (cos_d * torch.exp(d) - cos_c * torch.exp(c)
           + w * (sin_d * torch.exp(d) - sin_c * torch.exp(c))) / (1.0 + w * w)
    psi0 = d - c
    psik = (sin_d - sin_c) / torch.where(k == 0, 1.0, w)
    psi = torch.where(k == 0, psi0, psik)
    return chi, psi


def _jump_cf(u, T, lam, mJ, sJ):
    """Compound-Poisson lognormal-jump factor of the log-return cf
    (Bates 1996): exp(λT(e^{iu·mJ − u²sJ²/2} − 1) − iu·λT·κ̄) with
    κ̄ = e^{mJ + sJ²/2} − 1. λ = 0 returns exactly 1."""
    iu = 1j * u
    kbar = torch.exp(mJ + 0.5 * sJ * sJ) - 1.0
    return torch.exp(lam * T * (torch.exp(iu * mJ - 0.5 * u * u * sJ * sJ)
                                - 1.0) - iu * lam * T * kbar)


def _col(t):
    """A parameter against the frequency axis: 0-d stays a scalar, a
    per-quote vector (n,) becomes a column (n, 1)."""
    return t[..., None]


def _cos_put_call(S0, K, T, r, q, phi, a, b, is_call, N: int):
    """COS price from the cf values ``phi`` (shape P + (N,)) on [a, b]
    (shape P, with P = () for one set of parameters and (n_K,) for a
    per-quote set): put coefficients on [a, min(b, 0)], the k = 0 term
    halved, the phase matrix by binary doubling of one phasor per strike,
    the put floored at 0 and the call by parity."""
    dt_ = K.dtype
    cdt = phi.dtype
    ks = torch.arange(N, dtype=dt_, device=K.device)
    chi, psi = _cos_chi_psi(ks, _col(a), _col(b), _col(a),
                            _col(torch.clamp(b, max=0.0)), dt_)
    Uk = 2.0 / _col(b - a) * (psi - chi)  # put: K(1 − e^y)⁺ / K

    x = torch.log(S0 / K)                  # (n_K,)
    w = torch.ones(N, dtype=dt_, device=K.device)
    w[0] = 0.5
    coef = phi * (w * Uk).to(cdt)          # P + (N,)
    # phase matrix e^{iπk(x−a)/(b−a)} by binary doubling of the unit
    # base phasor: one trig per strike, error ≤ ~log2(N) ulps an entry
    theta1 = math.pi * (x - a) / (b - a)   # (n_K,)
    cur = torch.complex(torch.cos(theta1), torch.sin(theta1)).to(cdt)[:, None]
    pows = torch.ones((x.shape[0], 1), dtype=cdt, device=K.device)
    while pows.shape[1] < N:
        pows = torch.cat([pows, pows * cur], dim=1)
        cur = cur * cur
    phase = pows[:, :N]                    # (n_K, N)
    sums = phase @ coef if coef.dim() == 1 else torch.sum(phase * coef, -1)
    put = torch.exp(-r * T) * K * torch.real(sums)
    put = torch.clamp(put, min=0.0)
    call = put + S0 * torch.exp(-q * T) - K * torch.exp(-r * T)
    return torch.where(is_call, call, put)


def _heston_cos_core(S0, K, T, r, q, v0, kappa, theta, xi, rho, is_call,
                     L, *, N: int, lam=None, mJ=None, sJ=None):
    """COS body. ``K`` is (n_K,); every other input is 0-d or (n_K,) (one
    row of parameters per quote, as :func:`fit_heston` prices a surface).
    Optional (lam, mJ, sJ) multiply in the Bates jump factor and widen the
    cumulant truncation accordingly."""
    cdt = torch.complex128 if K.dtype == torch.float64 else torch.complex64

    # cumulant-based truncation (COS paper table 11)
    lam_ = xi  # vol-of-vol in the paper's notation
    c1 = (r - q) * T + (1.0 - torch.exp(-kappa * T)) \
        * (theta - v0) / (2.0 * kappa) - 0.5 * theta * T
    ekt = torch.exp(-kappa * T)
    c2 = 1.0 / (8.0 * kappa**3) * (
        lam_ * T * kappa * ekt * (v0 - theta) * (8.0 * kappa * rho - 4.0 * lam_)
        + kappa * rho * lam_ * (1.0 - ekt) * (16.0 * theta - 8.0 * v0)
        + 2.0 * theta * kappa * T * (-4.0 * kappa * rho * lam_ + lam_**2
                                     + 4.0 * kappa**2)
        + lam_**2 * ((theta - 2.0 * v0) * torch.exp(-2.0 * kappa * T)
                     + theta * (6.0 * ekt - 7.0) + 2.0 * v0)
        + 8.0 * kappa**2 * (v0 - theta) * (1.0 - ekt))
    if lam is not None:
        # Bates: jump cumulants shift the mean by λT(mJ − κ̄) and widen
        # the variance by λT(mJ² + sJ²)
        kbar = torch.exp(mJ + 0.5 * sJ * sJ) - 1.0
        c1 = c1 + lam * T * (mJ - kbar)
        c2 = c2 + lam * T * (mJ * mJ + sJ * sJ)
    spread = L * torch.sqrt(torch.clamp(torch.abs(c2), min=1e-12))
    a = c1 - spread
    b = c1 + spread

    ks = torch.arange(N, dtype=K.dtype, device=K.device)
    u = (ks * math.pi / _col(b - a)).to(cdt)
    col = [_col(t) for t in (T, r, q, v0, kappa, theta, xi, rho)]
    phi = _heston_cf(u, *col)
    if lam is not None:
        phi = phi * _jump_cf(u, col[0], _col(lam), _col(mJ), _col(sJ))
    return _cos_put_call(S0, K, T, r, q, phi, a, b, is_call, N)


def heston_price_cos(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi, rho,
                     kind="call", N: int = 256, L: float = 14.0,
                     dtype=None, device=None):
    """European option under Heston via the COS method (Fang-Oosterlee 2008).

    Truncation range [a, b] = c1 ± L·√c2 from the log-return cumulants;
    N cosine terms. A strike vector prices as one (n_K × N) · (N,) complex
    matvec. The put is computed directly (bounded payoff, stable
    coefficients) and the call recovered by put-call parity. A scalar
    strike and kind give a 0-d tensor.
    """
    S0, K_, T, r, q, v0, kappa, theta, xi, rho, L_ = _prep(
        dtype, device, S0, K, T, r, q, v0, kappa, theta, xi, rho, L)
    is_call = _mask(kind, device)
    scalar_k = K_.dim() == 0 and is_call.dim() == 0
    out = _heston_cos_core(S0, torch.atleast_1d(K_), T, r, q, v0, kappa,
                           theta, xi, rho, is_call, L_, N=int(N))
    return out[0] if scalar_k and out.shape == (1,) else out


def bates_price_cos(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi, rho,
                    lam, mJ, sJ, kind="call", N: int = 256,
                    L: float = 14.0, dtype=None, device=None):
    """European option under BATES (1996) — Heston diffusion + lognormal
    Merton jumps — via the COS method.

    φ_Bates = φ_Heston · φ_jumps, so the Heston COS machinery is reused
    with one extra complex factor per frequency; λ = 0 is
    :func:`heston_price_cos` bit for bit. Jump size ~ N(mJ, sJ²) in log
    space with intensity λ; the compensator κ̄ = e^{mJ+sJ²/2} − 1 keeps
    S·e^{−(r−q)t} a martingale.
    """
    if float(lam) < 0.0 or float(sJ) < 0.0:
        raise ValueError("lam and sJ must be non-negative")
    (S0, K_, T, r, q, v0, kappa, theta, xi, rho, lam_, mJ_, sJ_,
     L_) = _prep(dtype, device, S0, K, T, r, q, v0, kappa, theta, xi,
                    rho, lam, mJ, sJ, L)
    is_call = _mask(kind, device)
    scalar_k = K_.dim() == 0 and is_call.dim() == 0
    out = _heston_cos_core(S0, torch.atleast_1d(K_), T, r, q, v0, kappa,
                           theta, xi, rho, is_call, L_, N=int(N),
                           lam=lam_, mJ=mJ_, sJ=sJ_)
    return out[0] if scalar_k and out.shape == (1,) else out


# --------------------------------------------------------------------------
# SABR — Hagan asymptotic implied vol
# --------------------------------------------------------------------------

def sabr_implied_vol(F, K, T, alpha, beta, nu, rho, *, dtype=None,
                     device=None):
    """Hagan et al. (2002) lognormal implied vol σ_BS(F, K) under SABR.

    O((nu²+...)·T) asymptotic; broadcasting; the ATM limit is handled by a
    series in ln(F/K).
    """
    F, K, T, alpha, beta, nu, rho = _prep(dtype, device, F, K, T, alpha,
                                             beta, nu, rho)
    lnFK = torch.log(F / K)
    FKb = (F * K) ** (0.5 * (1.0 - beta))
    omb = 1.0 - beta
    # z/x(z) with a series for small z (removable singularity at ATM)
    z = (nu / alpha) * FKb * lnFK
    sqt = torch.sqrt(1.0 - 2.0 * rho * z + z * z)
    xz = torch.log((sqt + z - rho) / (1.0 - rho))
    small = torch.abs(z) < 1e-6
    zx = torch.where(small, 1.0 - 0.5 * rho * z,
                     z / torch.where(small, 1.0, xz))
    denom = FKb * (1.0 + omb**2 / 24.0 * lnFK**2
                   + omb**4 / 1920.0 * lnFK**4)
    corr = 1.0 + (omb**2 / 24.0 * alpha**2 / FKb**2
                  + 0.25 * rho * beta * nu * alpha / FKb
                  + (2.0 - 3.0 * rho**2) / 24.0 * nu**2) * T
    return alpha / denom * zx * corr


def sabr_price_hagan(S0, K, T, r, q=0.0, *, alpha, beta=1.0, nu, rho,
                     kind="call", dtype=None, device=None):
    """European price under SABR: Hagan implied vol plugged into BS.

    ``alpha`` is the spot-vol α₀ of ``processes.sabr_paths``; the Hagan
    formula quotes on the forward F = S0·e^{(r−q)T}.
    """
    S0, K, T, r, q, alpha, beta = _prep(dtype, device, S0, K, T, r, q,
                                           alpha, beta)
    F = S0 * torch.exp((r - q) * T)
    # α in Hagan's formula multiplies F^β; sabr_paths diffuses the SPOT
    # with σ_t·S^β, so translate the initial level to forward terms
    alpha_f = alpha * (F / S0) ** (beta - 1.0)
    iv = sabr_implied_vol(F, K, T, alpha_f, beta, nu, rho, dtype=S0.dtype,
                          device=S0.device)
    return price_core(S0, K, T, r, q, iv, _mask(kind, S0.device))


# --------------------------------------------------------------------------
# Heston calibration — LM on vega-weighted COS price residuals
# --------------------------------------------------------------------------

_HESTON_LOWER = (1e-4, 1e-2, 1e-4, 1e-2, -0.999)   # v0, kappa, theta, xi, rho
_HESTON_UPPER = (2.0, 20.0, 2.0, 3.0, 0.999)


def _quote_set(strikes, expiries, market_ivs, S0, r, q, dev):
    """Quote vectors, market call prices and vega weights, float64 on
    ``dev`` (the shared front of :func:`fit_heston` and ``levy.fit_vg``)."""
    f64 = torch.float64
    Kh, Th, ivh = (_host_vector(v) for v in (strikes, expiries, market_ivs))
    if not (Kh.shape == Th.shape == ivh.shape):
        raise ValueError("strikes, expiries and market_ivs must be "
                         "same-length vectors")
    Kv, Tv, iv = (torch.as_tensor(v, dtype=f64, device=dev)
                  for v in (Kh, Th, ivh))
    S0_, r_, q_ = _prep(f64, dev, S0, r, q)
    px_mkt = price_core(S0_, Kv, Tv, r_, q_, iv,
                        torch.tensor(True, device=dev))
    wv = 1.0 / torch.clamp(vega_core(S0_, Kv, Tv, r_, q_, iv), min=1e-4)
    return Kv, Tv, ivh, S0_, r_, q_, px_mkt, wv


def fit_heston(strikes, expiries, market_ivs, S0, r, q=0.0, *,
               x0=None, n_cos: int = 128, max_iter: int = 200, device=None):
    """Calibrate Heston ``(v0, kappa, theta, xi, rho)`` to a vanilla smile.

    ``strikes``/``expiries``/``market_ivs`` are same-length quote vectors.
    Quotes are converted to call prices and fitted with the shared
    bound-projected Levenberg-Marquardt loop (``calibration._lm_loop``,
    exact ``jacfwd`` Jacobians through the COS transform); each iteration
    prices the whole quote set at once, one row of COS terms per quote.
    Residuals are vega-weighted prices ≈ implied-vol residuals to first
    order. The fit runs in float64 on ``device``.

    Returns ``{"v0","kappa","theta","xi","rho","rmse"}`` with ``rmse`` the
    RMS vega-weighted price error (≈ RMS IV error).
    """
    from .calibration import _lm_loop

    dev = resolve_device(device)
    f64 = torch.float64
    Kv, Tv, ivh, S0_, r_, q_, px_mkt, wv = _quote_set(
        strikes, expiries, market_ivs, S0, r, q, dev)
    is_call = torch.tensor(True, device=dev)
    L_ = torch.tensor(14.0, dtype=f64, device=dev)

    def prices(x):
        return _heston_cos_core(S0_, Kv, Tv, r_, q_, x[0], x[1], x[2], x[3],
                                x[4], is_call, L_, N=int(n_cos))

    def residuals(x):
        return (prices(x) - px_mkt) * wv

    if x0 is None:
        iv_atm = float(np.median(ivh))
        x0 = (iv_atm**2, 2.0, iv_atm**2, 0.5, -0.5)
    t = lambda v: torch.as_tensor(v, dtype=f64, device=dev)
    x, _ = _lm_loop(residuals, t(x0)[None, :], t(_HESTON_LOWER),
                    t(_HESTON_UPPER), int(max_iter))
    x = x[0]
    rmse = float(torch.sqrt(torch.mean(residuals(x) ** 2)))
    v0, kappa, theta, xi, rho = (float(v) for v in x.cpu())
    return {"v0": v0, "kappa": kappa, "theta": theta, "xi": xi,
            "rho": rho, "rmse": rmse}


def heston_greeks_cos(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi, rho,
                      kind="call", N: int = 256, dtype=None, device=None):
    """Full AD Greek set through the COS transform — no bumping, no MC.

    ``torch.autograd`` differentiates the characteristic function, the
    cumulant truncation and the cosine coefficients exactly; gamma is the
    derivative of the delta graph (``create_graph=True``). Returns
    ``{"price", "delta", "gamma", "rho", "theta", "vega_v0",
    "vega_theta", "vega_xi", "vega_rho", "vega_kappa"}`` (theta is
    −∂V/∂T).
    """
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    args = [torch.tensor(float(v), dtype=dt_, device=dev, requires_grad=True)
            for v in (S0, T, r, v0, kappa, theta, xi, rho)]

    def price(s0, t_, r_, v0_, kap_, th_, xi_, rho_):
        return heston_price_cos(s0, K, t_, r_, q, v0=v0_, kappa=kap_,
                                theta=th_, xi=xi_, rho=rho_, kind=kind,
                                N=N, dtype=dt_, device=dev)

    px = price(*args)
    d = torch.autograd.grad(px, args, create_graph=True)
    gamma = torch.autograd.grad(d[0], args[0])[0]
    px, gamma, *d = (float(v.detach()) for v in (px, gamma, *d))
    return {"price": px, "delta": d[0], "gamma": gamma, "theta": -d[1],
            "rho": d[2], "vega_v0": d[3], "vega_kappa": d[4],
            "vega_theta": d[5], "vega_xi": d[6], "vega_rho": d[7]}


# --------------------------------------------------------------------------
# CEV — noncentral chi-square closed form
# --------------------------------------------------------------------------

def _gammainc(a, x, n_iter: int):
    """Regularised lower incomplete gamma P(a, x) for a > 0, x ≥ 0: the
    power series where x < a + 1 and Legendre's continued fraction for
    Q = 1 − P (modified Lentz) elsewhere, each run ``n_iter`` steps (both
    converge within ~9·√a steps at x ≈ a, their slowest point, and faster
    away from it). ``torch.special.gammainc`` switches to a truncated
    uniform asymptotic expansion for a > 20 and |x/a − 1| < 0.3, which
    misses P by up to 4e-10 there (against scipy); this form stays at
    the round-off of its log prefactor, as the JAX package's ``igamma``.
    """
    a, x = torch.broadcast_tensors(a, x)
    series = x < a + 1.0
    log_pref = a * torch.log(x) - x - torch.lgamma(a)
    # series: P = e^{log_pref} · Σ_n x^n / (a (a+1) … (a+n))
    term = 1.0 / a
    total = term
    ap = a
    for _ in range(n_iter):
        ap = ap + 1.0
        term = term * x / ap
        total = total + term
    p_series = torch.exp(log_pref) * total
    # continued fraction for Q on x ≥ a + 1 (a safe x elsewhere)
    tiny = 1e-300 if x.dtype == torch.float64 else 1e-30
    xc = torch.where(series, a + 1.0, x)
    b = xc + 1.0 - a
    c = torch.full_like(b, 1.0 / tiny)
    d = 1.0 / b
    h = d
    for i in range(1, n_iter + 1):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = torch.where(torch.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = torch.where(torch.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    q_cf = torch.exp(a * torch.log(xc) - xc - torch.lgamma(a)) * h
    return torch.where(series, p_series, 1.0 - q_cf)


def _ncx2_cdf(z, k, lam, n_terms: int):
    """Noncentral chi-square CDF by the Poisson mixture of central
    gammas: χ²(z; k, λ) = Σ_j Pois(j; λ/2)·P(k/2 + j, z/2), weights in
    log space. Adequate term count: n_terms ≳ λ/2 + 10·√(λ/2 + 1)."""
    j = torch.arange(n_terms, dtype=z.dtype, device=z.device)
    half = lam[..., None] * 0.5
    logw = (j * torch.log(torch.clamp(half, min=1e-300)) - half
            - torch.lgamma(j + 1.0))
    shape = k * 0.5 + j
    n_iter = 16 + int(9.0 * math.sqrt(float(torch.max(shape))))
    p = _gammainc(shape, z[..., None] * 0.5, n_iter)
    return torch.sum(torch.exp(logw) * p, dim=-1)


def cev_price(S0, K, T, r, q=0.0, *, sigma, beta, kind: str = "call",
              n_terms: int = 2048, dtype=None, device=None):
    """CEV closed form (absorbing boundary at zero), 0 < β < 1.

    dS = (r−q)S dt + σ S^β dW with zero absorbing, priced by the
    noncentral chi-square representation (Schroder 1989) with the time
    change τ = (e^{2(r−q)(1−β)T} − 1)/(2(r−q)(1−β)):

        a = K^{2(1−β)}/((1−β)²v),  c = F^{2(1−β)}/((1−β)²v),  b = 1/(1−β)
        C = e^{−rT}·( F·[1 − χ²(a; b+2, c)] − K·χ²(c; b, a) )

    with v = σ²τ and F = S0·e^{(r−q)T}. ``sigma`` is the CEV scale (units
    S^{1−β}). Broadcasts over strikes; ``n_terms`` bounds the Poisson
    mixture.
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    S0, K, T, r, q, sigma, beta = _prep(dtype, device, S0, K, T, r, q,
                                           sigma, beta)
    one_m = 1.0 - beta
    drift = 2.0 * (r - q) * one_m
    # τ → T as r→q (limit of the time change); branchless blend
    small = torch.abs(drift) < 1e-12
    tau = torch.where(small, T,
                      (torch.exp(torch.where(small, 0.0, drift) * T) - 1.0)
                      / torch.where(small, 1.0, drift))
    v = sigma * sigma * tau
    F = S0 * torch.exp((r - q) * T)
    a = K ** (2.0 * one_m) / (one_m * one_m * v)
    c = F ** (2.0 * one_m) / (one_m * one_m * v)
    b = 1.0 / one_m
    df = torch.exp(-r * T)
    call = df * (F * (1.0 - _ncx2_cdf(a, b + 2.0, c, n_terms))
                 - K * _ncx2_cdf(c, b, a, n_terms))
    if kind == "call":
        return call
    return call - df * (F - K)   # absorbed CEV is a true martingale


# --------------------------------------------------------------------------
# Single barriers — Merton / Reiner-Rubinstein reflection formulas
# --------------------------------------------------------------------------

def barrier_price_bs(S0, K, T, r, q=0.0, *, sigma, barrier,
                     barrier_type: str = "up-and-out", kind: str = "call",
                     rebate=0.0, dtype=None, device=None):
    """Closed-form CONTINUOUSLY-monitored barrier option under GBM
    (Merton 1973 / Reiner-Rubinstein 1991 reflection formulas).

    All eight {up,down} × {in,out} × {call,put} combinations,
    broadcasting. ``rebate`` is paid AT EXPIRY — knock-outs collect it when
    the barrier is hit, knock-ins when it is not. A spot already at/beyond
    the barrier is treated as hit.
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    parts = barrier_type.split("-")
    if (len(parts) != 3 or parts[0] not in ("up", "down")
            or parts[1] != "and" or parts[2] not in ("in", "out")):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    up = parts[0] == "up"
    knock_in = parts[2] == "in"
    S0, K, T, r, q, sigma, H, rebate = _prep(
        dtype, device, S0, K, T, r, q, sigma, barrier, rebate)

    st = sigma * torch.sqrt(T)
    mu = (r - q) / (sigma * sigma) - 0.5
    phi = 1.0 if kind == "call" else -1.0
    eta = -1.0 if up else 1.0
    dfq = torch.exp(-q * T)
    dfr = torch.exp(-r * T)
    hs = H / S0

    def block(x):
        return (phi * S0 * dfq * _ncdf(phi * x)
                - phi * K * dfr * _ncdf(phi * (x - st)))

    def rblock(y):
        return (phi * S0 * dfq * hs ** (2.0 * (mu + 1.0))
                * _ncdf(eta * y)
                - phi * K * dfr * hs ** (2.0 * mu)
                * _ncdf(eta * (y - st)))

    x1 = torch.log(S0 / K) / st + (1.0 + mu) * st
    x2 = torch.log(S0 / H) / st + (1.0 + mu) * st
    y1 = torch.log(H * H / (S0 * K)) / st + (1.0 + mu) * st
    y2 = torch.log(H / S0) / st + (1.0 + mu) * st
    A, B, C, D = block(x1), block(x2), rblock(y1), rblock(y2)

    k_beyond = K > H
    if not up and kind == "call":
        in0 = torch.where(k_beyond, C, A - B + D)
    elif up and kind == "call":
        in0 = torch.where(k_beyond, A, B - C + D)
    elif not up:  # down put
        in0 = torch.where(k_beyond, B - C + D, A)
    else:         # up put
        in0 = torch.where(k_beyond, A - B + D, C)

    # P(barrier hit before T), continuous monitoring of the GBM log-path
    nu = r - q - 0.5 * sigma * sigma
    b = torch.log(H / S0) if up else torch.log(S0 / H)   # > 0 pre-hit
    drift = nu if up else -nu
    p_hit = (_ncdf((drift * T - b) / st)
             + torch.exp(2.0 * drift * b / (sigma * sigma))
             * _ncdf((-b - drift * T) / st))
    p_hit = torch.clamp(p_hit, 0.0, 1.0)

    already = (S0 >= H) if up else (S0 <= H)
    if knock_in:
        live = in0 + rebate * dfr * (1.0 - p_hit)
        return torch.where(already, A, live)
    live = (A - in0) + rebate * dfr * p_hit
    return torch.where(already, rebate * dfr, live)


# --------------------------------------------------------------------------
# Quanto, chooser and compound options
# --------------------------------------------------------------------------

def quanto_adjusted_carry(q: float, sigma_S: float, sigma_fx: float,
                          rho_sfx: float) -> float:
    """The quanto drift correction q_eff = q + ρ_SFX · σ_S · σ_FX: feed it
    to any engine as the dividend yield and it prices the quanto version
    of its contract."""
    return float(q + rho_sfx * sigma_S * sigma_fx)


def quanto_price(S0, K, T, r_d: float, q: float = 0.0, *, sigma_S: float,
                 sigma_fx: float, rho_sfx: float, kind: str = "call",
                 dtype=None, device=None):
    """Quanto vanilla: foreign-asset option paid in domestic currency at
    a fixed conversion rate — Black-Scholes at the quanto-adjusted carry
    (:func:`quanto_adjusted_carry`), discounted at the domestic rate.
    Strike/kind broadcast like ``bs_price_vec``."""
    if sigma_fx < 0.0 or sigma_S < 0.0:
        raise ValueError("sigma_S and sigma_fx must be non-negative")
    if not -1.0 <= rho_sfx <= 1.0:
        raise ValueError(f"rho_sfx must be in [-1, 1], got {rho_sfx}")
    q_eff = quanto_adjusted_carry(q, sigma_S, sigma_fx, rho_sfx)
    from ..ops.black_scholes import bs_price_vec

    return bs_price_vec(S0, K, T, r_d, q_eff, sigma_S, kind, dtype=dtype,
                        device=device)


def chooser_price(S0, K, T, r, q=0.0, *, sigma, t_choose, dtype=None,
                  device=None):
    """Simple chooser: at ``t_choose`` the holder picks whichever of the
    strike-K, maturity-T call or put is worth more (Rubinstein 1991):

        V = C(S₀, K, T) + e^{−q(T−t₁)}·P(S₀, K·e^{−(r−q)(T−t₁)}, t₁)

    A float for scalar inputs, else a tensor."""
    if not 0.0 < t_choose <= T:
        raise ValueError("t_choose must lie in (0, T]")
    S0, K, T_, r_, q_, sig, t1 = _prep(dtype, device, S0, K, T, r, q,
                                          sigma, t_choose)
    true_ = torch.tensor(True, device=S0.device)
    call = price_core(S0, K, T_, r_, q_, sig, true_)
    K_adj = K * torch.exp(-(r_ - q_) * (T_ - t1))
    put = price_core(S0, K_adj, t1, r_, q_, sig, ~true_)
    out = call + torch.exp(-q_ * (T_ - t1)) * put
    return float(out) if out.dim() == 0 else out


def _compound_critical(K1, K2, tau, r, q, sigma, inner_call):
    """S* at which the UNDERLYING option's t₁ value equals K₁ — 100-step
    log-space bisection (the BS value is monotone in S)."""
    lo = torch.log(1e-6 * K2)
    hi = torch.log(1e6 * K2)
    is_c = torch.tensor(inner_call, device=K2.device)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        v = price_core(torch.exp(mid), K2, tau, r, q, sigma, is_c)
        # call value increases in S, put value decreases
        go_up = torch.where(is_c, v < K1, v > K1)
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    return torch.exp(0.5 * (lo + hi))


def compound_price(S0, K1, K2, t1, T2, r, q=0.0, *, sigma,
                   kind: str = "call", underlying: str = "call",
                   dtype=None, device=None):
    """Compound option (Geske 1979): a ``kind`` option expiring at t₁
    with strike K₁ on an ``underlying`` vanilla (strike K₂, maturity
    T₂ > t₁). Closed form in bivariate-normal rectangle probabilities
    (``ops.bvn.bvn_cdf``) with ρ = √(t₁/T₂), around the critical spot S*
    where the underlying's t₁ value crosses K₁. A float for scalar inputs,
    else a tensor."""
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if underlying not in ("call", "put"):
        raise ValueError("underlying must be 'call' or 'put'")
    if not 0.0 < t1 < T2:
        raise ValueError("need 0 < t1 < T2")
    from ..ops.bvn import bvn_cdf

    S, K1_, K2_, t1_, T2_, r_, q_, sig = _prep(
        dtype, device, S0, K1, K2, t1, T2, r, q, sigma)
    inner_call = underlying == "call"
    Sx = _compound_critical(K1_, K2_, T2_ - t1_, r_, q_, sig, inner_call)

    sq1 = sig * torch.sqrt(t1_)
    sq2 = sig * torch.sqrt(T2_)
    b = r_ - q_
    y1 = (torch.log(S / Sx) + (b + 0.5 * sig * sig) * t1_) / sq1
    y2 = y1 - sq1
    z1 = (torch.log(S / K2_) + (b + 0.5 * sig * sig) * T2_) / sq2
    z2 = z1 - sq2
    rho = torch.sqrt(t1_ / T2_)
    fwd = S * torch.exp((b - r_) * T2_)     # = S e^{−qT₂}
    dK2 = K2_ * torch.exp(-r_ * T2_)
    dK1 = K1_ * torch.exp(-r_ * t1_)

    if inner_call and kind == "call":
        out = (fwd * bvn_cdf(z1, y1, rho) - dK2 * bvn_cdf(z2, y2, rho)
               - dK1 * _ncdf(y2))
    elif inner_call:                      # put-on-call
        out = (dK2 * bvn_cdf(z2, -y2, -rho) - fwd * bvn_cdf(z1, -y1, -rho)
               + dK1 * _ncdf(-y2))
    elif kind == "call":                  # call-on-put
        out = (dK2 * bvn_cdf(-z2, -y2, rho) - fwd * bvn_cdf(-z1, -y1, rho)
               - dK1 * _ncdf(-y2))
    else:                                 # put-on-put
        out = (fwd * bvn_cdf(-z1, y1, -rho) - dK2 * bvn_cdf(-z2, y2, -rho)
               + dK1 * _ncdf(y2))
    return float(out) if out.dim() == 0 else out


# --------------------------------------------------------------------------
# Continuously-monitored lookbacks — Goldman-Sosin-Gatto / Conze-Viswanathan
# --------------------------------------------------------------------------

def _lb_bonus(lnX, e1, bb, sigma, T, eta):
    """The lookback "strike bonus" A common to the four GSG/CV formulas;
    ``eta=+1``: A = (σ²/2b)·[X^{−2b/σ²}·Φ(−e1 + 2b√T/σ) − e^{bT}·Φ(−e1)],
    ``eta=−1``: A = (σ²/2b)·[e^{bT}·Φ(e1) − X^{−2b/σ²}·Φ(e1 − 2b√T/σ)].
    Both vanish linearly at b = 0; the exact b→0 limit is blended in
    branchlessly so r = q prices stay finite."""
    sqT = torch.sqrt(T)
    small = torch.abs(bb) < 1e-7
    b_safe = torch.where(small, 1.0, bb)
    pref = sigma * sigma / (2.0 * b_safe)
    pow_term = torch.exp(-(2.0 * bb / (sigma * sigma)) * lnX)
    shift = (2.0 * bb / sigma) * sqT
    if eta > 0:
        gen = pref * (pow_term * _ncdf(-e1 + shift)
                      - torch.exp(bb * T) * _ncdf(-e1))
        lim = (-(lnX + 0.5 * sigma * sigma * T) * _ncdf(-e1)
               + sigma * sqT * _pdf(-e1))
    else:
        gen = pref * (torch.exp(bb * T) * _ncdf(e1)
                      - pow_term * _ncdf(e1 - shift))
        lim = ((lnX + 0.5 * sigma * sigma * T) * _ncdf(e1)
               + sigma * sqT * _pdf(e1))
    return torch.where(small, lim, gen)


def lookback_price_bs(S0, T, r, q=0.0, *, sigma, kind: str = "call",
                      strike_type: str = "floating", K=0.0,
                      running_extremum=None, dtype=None, device=None):
    """Closed-form CONTINUOUSLY-monitored lookback under GBM.

    Floating strike (Goldman-Sosin-Gatto 1979): call pays S_T − min S,
    put pays max S − S_T. Fixed strike (Conze-Viswanathan 1991): call
    pays (max S − K)⁺, put pays (K − min S)⁺. ``running_extremum`` is the
    already-observed extremum for seasoned contracts (running MIN for
    floating calls / fixed puts, running MAX for floating puts / fixed
    calls); it defaults to S0. r = q is the exact limit inside
    :func:`_lb_bonus`.
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if strike_type not in ("floating", "fixed"):
        raise ValueError("strike_type must be 'floating' or 'fixed'")
    S, T_, r_, q_, sig, K_ = _prep(dtype, device, S0, T, r, q, sigma, K)
    E = S if running_extremum is None else _prep(
        S.dtype, S.device, running_extremum)[0]

    bb = r_ - q_
    s = sig * torch.sqrt(T_)
    dfr = torch.exp(-r_ * T_)
    dfb = torch.exp((bb - r_) * T_)

    def d1_of(X):      # X = S/level
        return (torch.log(X) + (bb + 0.5 * sig * sig) * T_) / s

    if strike_type == "floating":
        X = S / E
        if kind == "call":        # pays S_T − m;  E = running min ≤ S
            a1 = d1_of(X)
            return (S * dfb * _ncdf(a1) - E * dfr * _ncdf(a1 - s)
                    + S * dfr * _lb_bonus(torch.log(X), a1, bb, sig, T_, +1))
        b1 = d1_of(X)             # pays M − S_T;  E = running max ≥ S
        return (E * dfr * _ncdf(-(b1 - s)) - S * dfb * _ncdf(-b1)
                + S * dfr * _lb_bonus(torch.log(X), b1, bb, sig, T_, -1))

    # fixed strike: blend the K-beyond-extremum and seasoned branches
    if kind == "call":            # pays (max − K)⁺;  E = running max
        def F(level):
            X = S / level
            d1 = d1_of(X)
            return (S * dfb * _ncdf(d1) - level * dfr * _ncdf(d1 - s)
                    + S * dfr * _lb_bonus(torch.log(X), d1, bb, sig, T_, -1))

        return torch.where(K_ > E, F(torch.maximum(K_, E)),
                           dfr * (E - K_) + F(torch.minimum(K_, E)))

    def F(level):                 # pays (K − min)⁺;  E = running min
        X = S / level
        d1 = d1_of(X)
        return (level * dfr * _ncdf(-(d1 - s))
                - S * dfb * _ncdf(-d1)
                + S * dfr * _lb_bonus(torch.log(X), d1, bb, sig, T_, +1))

    return torch.where(K_ < E, F(torch.minimum(K_, E)),
                       dfr * (K_ - E) + F(torch.maximum(K_, E)))


# --------------------------------------------------------------------------
# Double barriers — Ikeda-Kunitomo image series, integral form
# --------------------------------------------------------------------------

def _dbko_sums(S, A, B, L, U, T, r, q, sigma, n_images: int):
    """(∫_A^B x·p(x)dx·e^{−bT}/S, ∫_A^B p(x)dx) for the density p of S_T
    restricted to paths that stay inside (L, U) — the Ikeda-Kunitomo
    (1992) image expansion with flat barriers, stated as integrals so any
    strike placement reduces to clipped bounds; 2·n_images+1 image terms
    on a leading axis."""
    S, A, B, L, U, T, r, q, sigma = torch.broadcast_tensors(
        S, A, B, L, U, T, r, q, sigma)
    bb = r - q
    st = sigma * torch.sqrt(T)
    m1 = 2.0 * bb / (sigma * sigma) + 1.0
    n = torch.arange(-n_images, n_images + 1, dtype=S.dtype, device=S.device)
    n = n.reshape(n.shape + (1,) * S.dim())  # images × inputs
    lnU_L = torch.log(U / L)
    drift = (bb + 0.5 * sigma * sigma) * T

    def d(level):       # direct-image argument at integration bound
        return (torch.log(S / level) + 2.0 * n * lnU_L + drift) / st

    def dp(level):      # reflected-image argument
        return ((2.0 * (n + 1.0) * torch.log(L) - 2.0 * n * torch.log(U)
                 - torch.log(S * level)) + drift) / st

    def term(lg, hi, lo):
        # exp(lg)·(Φ(hi) − Φ(lo)) in log space: for wide corridors the
        # image weight overflows while the cdf difference underflows to 0,
        # and inf·0 would be NaN
        diff = _ncdf(hi) - _ncdf(lo)
        logdiff = torch.log(torch.where(diff > 0.0, diff, 1.0))
        return torch.where(diff > 0.0, torch.exp(lg + logdiff), 0.0)

    lgR1 = n * m1 * lnU_L
    lgR2 = m1 * ((n + 1.0) * torch.log(L) - n * torch.log(U) - torch.log(S))
    lgR1k = n * (m1 - 2.0) * lnU_L
    lgR2k = (m1 - 2.0) * ((n + 1.0) * torch.log(L) - n * torch.log(U)
                          - torch.log(S))
    dA, dB, dpA, dpB = d(A), d(B), dp(A), dp(B)
    xint = torch.sum(term(lgR1, dA, dB) - term(lgR2, dpA, dpB), dim=0)
    pint = torch.sum(term(lgR1k, dA - st, dB - st)
                     - term(lgR2k, dpA - st, dpB - st), dim=0)
    return xint, pint


def double_barrier_price_bs(S0, K, T, r, q=0.0, *, sigma, lower, upper,
                            kind: str = "call", knock: str = "out",
                            rebate=0.0, n_images: int = 5, dtype=None,
                            device=None):
    """Closed-form CONTINUOUSLY-monitored double-barrier option under GBM
    (Ikeda-Kunitomo 1992 image series, flat barriers L < U).

    ``knock="out"`` dies (collecting ``rebate`` AT EXPIRY) if either
    barrier is touched; ``knock="in"`` is alive only if one is (rebate at
    expiry when it never is). A spot at/beyond either barrier counts as
    already hit. Strikes outside (L, U) are handled by the integral form
    of the expansion.
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if knock not in ("in", "out"):
        raise ValueError("knock must be 'in' or 'out'")
    S, K_, T_, r_, q_, sig, L, U, reb = _prep(
        dtype, device, S0, K, T, r, q, sigma, lower, upper, rebate)
    dfr = torch.exp(-r_ * T_)
    dfb = torch.exp(-q_ * T_)                # e^{(b−r)T} = e^{−qT}
    if kind == "call":
        A = torch.clamp(K_, L, U)
        xint, pint = _dbko_sums(S, A, U, L, U, T_, r_, q_, sig,
                                int(n_images))
        ko = S * dfb * xint - K_ * dfr * pint
    else:
        B = torch.clamp(K_, L, U)
        xint, pint = _dbko_sums(S, L, B, L, U, T_, r_, q_, sig,
                                int(n_images))
        ko = K_ * dfr * pint - S * dfb * xint
    _, p_surv = _dbko_sums(S, L, U, L, U, T_, r_, q_, sig, int(n_images))
    p_surv = torch.clamp(p_surv, 0.0, 1.0)
    ko = torch.clamp(ko, min=0.0)
    already = (S <= L) | (S >= U)
    vanilla = price_core(S, K_, T_, r_, q_, sig,
                         torch.tensor(kind == "call", device=S.device))
    if knock == "out":
        live = ko + reb * dfr * (1.0 - p_surv)
        return torch.where(already, reb * dfr, live)
    live = (vanilla - ko) + reb * dfr * p_surv
    return torch.where(already, vanilla, live)

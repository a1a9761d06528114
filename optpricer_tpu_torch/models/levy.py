"""Infinite-activity Lévy models: Variance Gamma, NIG, CGMY.

Counterpart of ``optpricer_tpu/models/levy.py``. The three pure-jump
models are priced by the COS expansion of ``analytic`` (the put on the
cumulant-truncated range, the phase matrix by binary doubling, the call by
parity) with their closed-form characteristic functions, each with the
risk-neutral martingale correction ω so that E[S_T] = S0·e^{(r−q)T}.

``vg_paths`` / ``nig_paths`` simulate the exact subordinated transitions
and follow the paths protocol of ``processes`` — ``(n_steps+1,
n_paths_eff)`` with a t = 0 row, antithetic pairs sharing the subordinator
clock with the Gaussian part negated. As there, each is split into a draw
step on a ``torch.Generator`` seeded from ``seed`` (gamma increments by
Marsaglia-Tsang, inverse-Gaussian ones by Michael-Schucany-Haas from one
normal and one uniform) and a deterministic core (``_vg_core``,
``_ig_core``, ``_nig_core``) that maps the draws to paths with the
reference's operations in its order. The JAX package draws from
``jax.random`` keys, whose stream torch does not reproduce, so a seed gives
another sample than the reference's. CGMY is priced by COS only.

Plain torch on ``device`` (default ``"cuda"``), float64 unless ``dtype=``
says otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from ..ops import black_scholes as bs
from .analytic import _col, _cos_put_call, _log1p_c, _quote_set
from .processes import _generator

__all__ = [
    "vg_price_cos",
    "nig_price_cos",
    "cgmy_price_cos",
    "vg_paths",
    "nig_paths",
    "fit_vg",
]


# ---------------------------------------------------------------------------
# Generic Lévy COS core
# ---------------------------------------------------------------------------

def _levy_cos_put_call(S0, K, T, r, q, phi, c1, c2, c4, is_call, N: int):
    """COS price given the log-return cf φ(u) (drift + ω included) and its
    cumulants. Truncation [a, b] = c1 ∓ L√(c2 + √c4) with L = 10 — the
    Fang-Oosterlee recipe for Lévy models, where the 4th cumulant guards
    the heavy tails that c2 alone under-covers."""
    cdt = torch.complex128 if K.dtype == torch.float64 else torch.complex64
    L = torch.tensor(10.0, dtype=K.dtype, device=K.device)
    spread = L * torch.sqrt(torch.clamp(
        c2 + torch.sqrt(torch.clamp(c4, min=0.0)), min=1e-12))
    a = c1 - spread
    b = c1 + spread
    ks = torch.arange(N, dtype=K.dtype, device=K.device)
    u = ks * math.pi / _col(b - a)
    return _cos_put_call(S0, K, T, r, q, phi(u.to(cdt)), a, b, is_call, N)


def _prep(S0, K, T, r, q, kind, extra, dtype, device):
    vals = list(bs._prep(dtype, device, S0, K, T, r, q, *extra))
    is_call = bs._mask(kind, vals[0].device)
    scalar = vals[1].dim() == 0 and is_call.dim() == 0
    vals[1] = torch.atleast_1d(vals[1])
    return vals, is_call, scalar


def _expm1_c(z):
    """Complex expm1, elementarily: e^{x+iy} − 1 = (expm1(x)·cos y −
    2 sin²(y/2)) + i·e^x·sin y — every term well-conditioned near 0."""
    x, y = torch.real(z), torch.imag(z)
    re = torch.expm1(x) * torch.cos(y) - 2.0 * torch.sin(0.5 * y) ** 2
    return torch.complex(re, torch.exp(x) * torch.sin(y))


# ---------------------------------------------------------------------------
# Variance Gamma
# ---------------------------------------------------------------------------

def _vg_omega(theta, nu, sigma):
    """Martingale correction ω = ln(1 − θν − σ²ν/2)/ν, finite only when
    θν + σ²ν/2 < 1; ``log1p`` keeps the ν→0 limit exact."""
    return torch.log1p(-(theta * nu + 0.5 * sigma * sigma * nu)) / nu


def _vg_cos_core(S0, K, T, r, q, sig, th, nu_, is_call, N: int):
    """VG COS prices; ``K`` is (n_K,) and the other inputs 0-d or (n_K,)
    (one row per quote, as :func:`fit_vg` prices a surface)."""
    om = _vg_omega(th, nu_, sig)
    Tc, rc, qc, sc, thc, nc, omc = (_col(t) for t in (T, r, q, sig, th, nu_,
                                                      om))

    def phi(u):
        # (1 + z)^{−T/ν} with z = −iuθν + ½σ²νu², through complex log1p
        iu = 1j * u
        z = -iu * thc * nc + 0.5 * sc * sc * nc * u * u
        return torch.exp(iu * (rc - qc + omc) * Tc - (Tc / nc) * _log1p_c(z))

    c1 = (r - q + om + th) * T
    c2 = (sig * sig + nu_ * th * th) * T
    c4 = 3.0 * (sig**4 * nu_ + 2.0 * th**4 * nu_**3
                + 4.0 * sig * sig * th * th * nu_ * nu_) * T
    return _levy_cos_put_call(S0, K, T, r, q, phi, c1, c2, c4, is_call, N)


def vg_price_cos(S0, K, T, r, q=0.0, *, sigma, theta, nu,
                 kind: str = "call", N: int = 256, dtype=None, device=None):
    """European option under VARIANCE GAMMA via the COS method.

    VG is Brownian motion with drift θ and volatility σ on a gamma clock of
    unit mean rate and variance rate ν: φ_VG(u) = (1 − iuθν +
    ½σ²νu²)^{−T/ν}, times the drift factor e^{iu(r−q+ω)T}. ν→0 collapses
    to Black-Scholes; θ < 0 produces the equity skew. A scalar strike and
    kind give a 0-d tensor.
    """
    (S0, K, T, r, q, sig, th, nu_), is_call, scalar = _prep(
        S0, K, T, r, q, kind, (sigma, theta, nu), dtype, device)
    out = _vg_cos_core(S0, K, T, r, q, sig, th, nu_, is_call, int(N))
    return out[0] if scalar and out.shape == (1,) else out


def _standard_gamma(gen, a, shape, dtype, device) -> torch.Tensor:
    """Γ(a, 1) draws from ``gen``: Marsaglia-Tsang (2000) rejection for
    shape ≥ 1 (each round redraws the rejected entries), and for a < 1 a
    Γ(a + 1) draw times U^{1/a}. ``a`` is one shape (a float) or a tensor
    of ``shape``'s size, one shape per entry."""
    if isinstance(a, torch.Tensor):
        return _standard_gamma_per_entry(gen, a, shape, dtype, device)
    n = math.prod(shape)
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=gen, dtype=dtype, device=device)
        u = torch.rand(m, generator=gen, dtype=dtype, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * v
                          + d * torch.log(torch.clamp(v, min=1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        out = out * torch.rand(n, generator=gen, dtype=dtype,
                               device=device) ** (1.0 / a)
    return out.reshape(shape)


def _split_accepted(ok: torch.Tensor):
    """(positions of the accepted entries, of the rest), each in order,
    for one host sync (the count)."""
    order = torch.argsort((~ok).to(torch.int8), stable=True)
    n_ok = int(ok.sum())
    return order[:n_ok], order[n_ok:]


def _standard_gamma_per_entry(gen, a: torch.Tensor, shape, dtype,
                              device) -> torch.Tensor:
    """Γ(a_i, 1) draws, one shape per entry: the rejection rounds of
    :func:`_standard_gamma` with each entry's own (d, c), one host sync a
    round (the count left), and the U^{1/a} boost for the entries below 1
    from one uniform draw for all."""
    n = math.prod(shape)
    a = a.to(dtype=dtype, device=device).reshape(n)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=gen, dtype=dtype, device=device)
        u = torch.rand(m, generator=gen, dtype=dtype, device=device)
        dt, ct = d[todo], c[todo]
        v = (1.0 + ct * x) ** 3
        ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + dt - dt * v
                          + dt * torch.log(torch.clamp(v, min=1e-300)))
        take, rest = _split_accepted(ok)
        out[todo[take]] = (dt * v)[take]
        todo = todo[rest]
    u = torch.rand(n, generator=gen, dtype=dtype, device=device)
    out = torch.where(boost, out * u ** (1.0 / a), out)
    return out.reshape(shape)


def _gamma_sample_grad(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """∂x/∂a of a Γ(a, 1) sample x at fixed quantile (implicit
    reparameterisation, −∂_aP(a, x) / p(x; a)), as JAX's
    ``random_gamma_grad`` computes it: the series of P(a, x) for x ≤ 1 or
    x ≤ a, the continued fraction of Q(a, x) otherwise, each with its
    a-derivative carried along until it stops changing at float64
    precision (at most 2 000 terms of the fraction). Plain torch; the
    iterations are loops over the entries still moving."""
    eps = torch.finfo(x.dtype).eps
    a, x = torch.broadcast_tensors(a.to(x.dtype), x)
    out = torch.zeros_like(x)
    ok = (x > 0.0) & (a > 0.0)
    ax = a * torch.log(x) - x - torch.lgamma(a)
    ok &= ax >= -math.log(torch.finfo(x.dtype).max)
    use_cf = (x > 1.0) & (x > a)
    ser = ok & ~use_cf
    if bool(ser.any()):
        aa, xx = a[ser], x[ser]
        r, c, ans = aa.clone(), torch.ones_like(aa), torch.ones_like(aa)
        dc, dans = torch.zeros_like(aa), torch.zeros_like(aa)
        live = torch.ones_like(aa, dtype=torch.bool)
        while bool(live.any()):
            r1 = r + 1.0
            dc1 = dc * (xx / r1) - (c * xx) / (r1 * r1)
            dans1 = dans + dc1
            c1 = c * (xx / r1)
            ans1 = ans + c1
            r, dc, dans, c, ans = (torch.where(live, new, old) for new, old in
                                   ((r1, r), (dc1, dc), (dans1, dans),
                                    (c1, c), (ans1, ans)))
            live = live & (torch.abs(dc1 / dans1) > eps)
        dlog = torch.log(xx) - torch.special.digamma(aa + 1.0)
        out[ser] = -(dans + ans * dlog) * xx / aa
    cf = ok & use_cf
    if bool(cf.any()):
        aa, xx = a[cf], x[cf]
        y = 1.0 - aa
        z = xx + y + 1.0
        c = torch.zeros_like(xx)
        pkm2, qkm2 = torch.ones_like(xx), xx.clone()
        pkm1, qkm1 = xx + 1.0, z * xx
        ans = pkm1 / qkm1
        dpkm2, dqkm2 = torch.zeros_like(xx), torch.zeros_like(xx)
        dpkm1, dqkm1 = torch.zeros_like(xx), -xx
        dans = (dpkm1 - ans * dqkm1) / qkm1
        live = torch.ones_like(xx, dtype=torch.bool)
        for _ in range(2000):
            if not bool(live.any()):
                break
            c = c + 1.0
            y1, z1 = y + 1.0, z + 2.0
            yc = y1 * c
            pk = pkm1 * z1 - pkm2 * yc
            qk = qkm1 * z1 - qkm2 * yc
            nz = qk != 0.0
            ans1 = torch.where(nz, pk / qk, ans)
            dpk = dpkm1 * z1 - pkm1 - dpkm2 * yc + pkm2 * c
            dqk = dqkm1 * z1 - qkm1 - dqkm2 * yc + qkm2 * c
            dans1 = torch.where(nz, (dpk - ans1 * dqk) / qk, dans)
            moved = torch.where(nz, torch.abs(dans1 - dans),
                                torch.ones_like(dans))
            scale = torch.where(torch.abs(pk) > 1.0 / eps, eps, 1.0)
            new = (y1, z1, ans1, dans1, pkm1 * scale, qkm1 * scale,
                   pk * scale, qk * scale, dpkm1 * scale, dqkm1 * scale,
                   dpk * scale, dqk * scale)
            old = (y, z, ans, dans, pkm2, qkm2, pkm1, qkm1, dpkm2, dqkm2,
                   dpkm1, dqkm1)
            (y, z, ans, dans, pkm2, qkm2, pkm1, qkm1, dpkm2, dqkm2, dpkm1,
             dqkm1) = (torch.where(live, nv, ov) for nv, ov in zip(new, old))
            live = live & (moved > eps)
        dlog = torch.log(xx) - torch.special.digamma(aa)
        out[cf] = (dans + ans * dlog) * xx
    return torch.where((a > 0.0) & (x >= 0.0), out,
                       torch.full_like(out, float("nan")))


def _vg_core(g, Z, S0, T, r, q, sigma, theta, nu, *, antithetic: bool):
    """VG paths from the gamma clock increments ``g`` (Γ(Δt/ν, ν), shape
    (n_steps, n_paths)) and standard normals ``Z`` of the same shape."""
    n_steps = g.shape[0]
    dt = T / n_steps
    if antithetic:
        # pairs share the subordinator clock; the Gaussian part is negated
        g = torch.cat([g, g], dim=1)
        Z = torch.cat([Z, -Z], dim=1)
    om = _vg_omega(theta, nu, sigma)
    inc = (r - q + om) * dt + theta * g + sigma * torch.sqrt(g) * Z
    log_rel = torch.cumsum(inc, dim=0)
    top = torch.zeros((1, g.shape[1]), dtype=g.dtype, device=g.device)
    return S0 * torch.exp(torch.cat([top, log_rel], dim=0))


def vg_paths(S0: float, T: float, r: float, q: float = 0.0, *,
             sigma: float, theta: float, nu: float, n_steps: int = 252,
             n_paths: int = 10_000, antithetic: bool = True,
             seed: Optional[int] = None, dtype=None,
             device=None) -> torch.Tensor:
    """Exact Variance-Gamma paths (gamma-subordinated Brownian motion).

    Each increment draws the gamma clock g ~ Γ(Δt/ν, ν), then the
    conditional Gaussian θg + σ√g·Z — the exact VG transition, with no
    discretisation bias. Shape ``(n_steps+1, n_paths_eff)``, t = 0 row;
    antithetic doubles the columns. :func:`vg_price_cos` is the vanilla
    oracle.
    """
    if n_steps <= 0 or n_paths <= 0:
        raise ValueError("n_steps and n_paths must be positive.")
    if not 0.0 < 1.0 - theta * nu - 0.5 * sigma * sigma * nu:
        raise ValueError("VG moment condition violated: need "
                         "theta*nu + sigma^2*nu/2 < 1")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0_, T_, r_, q_, sig, th, nu_ = bs._prep(dt_, dev, S0, T, r, q, sigma,
                                             theta, nu)
    gen = _generator(seed, dev)
    shape = (int(n_steps), int(n_paths))
    g = _standard_gamma(gen, float(T) / int(n_steps) / float(nu), shape,
                        dt_, dev) * nu_
    Z = torch.randn(shape, generator=gen, dtype=dt_, device=dev)
    return _vg_core(g, Z, S0_, T_, r_, q_, sig, th, nu_,
                    antithetic=bool(antithetic))


# ---------------------------------------------------------------------------
# Normal Inverse Gaussian
# ---------------------------------------------------------------------------

def _nig_gamma(alpha, beta):
    return torch.sqrt(alpha * alpha - beta * beta)


def nig_price_cos(S0, K, T, r, q=0.0, *, alpha, beta, delta,
                  kind: str = "call", N: int = 256, dtype=None, device=None):
    """European option under NORMAL INVERSE GAUSSIAN via the COS method.

    NIG(α, β, δ): φ(u) = exp(Tδ(√(α²−β²) − √(α²−(β+iu)²))) times the
    drift factor with ω = δ(√(α²−(β+1)²) − √(α²−β²)) (finite iff
    α > |β+1|). α sets tail heaviness, β skew, δ scale.
    """
    (S0, K, T, r, q, al, be, de), is_call, scalar = _prep(
        S0, K, T, r, q, kind, (alpha, beta, delta), dtype, device)
    gam = _nig_gamma(al, be)
    om = de * (torch.sqrt(al * al - (be + 1.0) ** 2) - gam)
    Tc, rc, qc, alc, bec, dec, gc, omc = (_col(t) for t in (
        T, r, q, al, be, de, gam, om))

    def phi(u):
        iu = 1j * u
        v = bec + iu
        root = torch.sqrt(alc * alc - v * v)
        return torch.exp(Tc * dec * (gc - root) + iu * (rc - qc + omc) * Tc)

    c1 = (r - q + om) * T + de * be * T / gam
    c2 = de * al * al * T / gam**3
    c4 = 3.0 * de * al * al * (al * al + 4.0 * be * be) * T / gam**7
    out = _levy_cos_put_call(S0, K, T, r, q, phi, c1, c2, c4, is_call,
                             int(N))
    return out[0] if scalar and out.shape == (1,) else out


def _ig_core(Zc, U, mu, lam):
    """Inverse-Gaussian IG(μ, λ) from a standard normal ``Zc`` and a
    uniform ``U`` — Michael-Schucany-Haas (1976), branchless: y = μZc²;
    x = μ(1 + (y − √(4λy + y²))/(2λ)); x with probability μ/(μ+x), else
    μ²/x."""
    y = mu * Zc * Zc
    x = mu * (1.0 + (y - torch.sqrt(4.0 * lam * y + y * y)) / (2.0 * lam))
    x = torch.clamp(x, min=1e-30)
    take_x = U <= mu / (mu + x)
    return torch.where(take_x, x, mu * mu / x)


def _sample_ig(gen, mu, lam, shape, dtype, device):
    """IG(μ, λ) draws: one normal and one uniform per entry from ``gen``."""
    Zc = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    U = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return _ig_core(Zc, U, mu, lam)


def _nig_core(I, Z, S0, T, r, q, alpha, beta, delta, *, antithetic: bool):
    """NIG paths from the IG clock increments ``I`` and standard normals
    ``Z`` (both (n_steps, n_paths))."""
    n_steps = I.shape[0]
    dt = T / n_steps
    gam = _nig_gamma(alpha, beta)
    if antithetic:
        I = torch.cat([I, I], dim=1)
        Z = torch.cat([Z, -Z], dim=1)
    om = delta * (torch.sqrt(alpha * alpha - (beta + 1.0) ** 2) - gam)
    inc = (r - q + om) * dt + beta * I + torch.sqrt(I) * Z
    log_rel = torch.cumsum(inc, dim=0)
    top = torch.zeros((1, I.shape[1]), dtype=I.dtype, device=I.device)
    return S0 * torch.exp(torch.cat([top, log_rel], dim=0))


def _nig_clock(T, alpha, beta, delta, n_steps: int):
    """(μ, λ) of the IG subordinator increment of NIG(α, β, δΔt):
    IG(δΔt/γ, (δΔt)²)."""
    dt = T / n_steps
    return delta * dt / _nig_gamma(alpha, beta), (delta * dt) ** 2


def nig_paths(S0: float, T: float, r: float, q: float = 0.0, *,
              alpha: float, beta: float, delta: float, n_steps: int = 252,
              n_paths: int = 10_000, antithetic: bool = True,
              seed: Optional[int] = None, dtype=None,
              device=None) -> torch.Tensor:
    """Exact NIG paths (inverse-Gaussian-subordinated Brownian motion).

    Each increment draws the IG clock (one normal + one uniform) then the
    conditional Gaussian βI + √I·Z — the exact NIG transition. Same paths
    protocol and antithetic scheme as :func:`vg_paths`;
    :func:`nig_price_cos` is the vanilla oracle.
    """
    if n_steps <= 0 or n_paths <= 0:
        raise ValueError("n_steps and n_paths must be positive.")
    if not alpha > abs(beta + 1.0):
        raise ValueError("NIG moment condition violated: need "
                         "alpha > |beta + 1|")
    if not alpha > abs(beta):
        # not implied by the moment condition when beta < -0.5:
        # gamma = sqrt(alpha^2 - beta^2) must be real
        raise ValueError("NIG needs alpha > |beta|")
    if delta <= 0.0 or alpha <= 0.0:
        raise ValueError("need delta > 0 and alpha > 0")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0_, T_, r_, q_, al, be, de = bs._prep(dt_, dev, S0, T, r, q, alpha,
                                           beta, delta)
    gen = _generator(seed, dev)
    shape = (int(n_steps), int(n_paths))
    mu_ig, lam_ig = _nig_clock(T_, al, be, de, int(n_steps))
    I = _sample_ig(gen, mu_ig, lam_ig, shape, dt_, dev)
    Z = torch.randn(shape, generator=gen, dtype=dt_, device=dev)
    return _nig_core(I, Z, S0_, T_, r_, q_, al, be, de,
                     antithetic=bool(antithetic))


# ---------------------------------------------------------------------------
# CGMY
# ---------------------------------------------------------------------------

def cgmy_price_cos(S0, K, T, r, q=0.0, *, C, G, M, Y,
                   kind: str = "call", N: int = 256, dtype=None,
                   device=None):
    """European option under CGMY (tempered stable) via the COS method.

    ψ(u) = CΓ(−Y)[(M−iu)^Y − M^Y + (G+iu)^Y − G^Y] with Y ∈ (0, 2),
    Y ≠ 1; Γ(−Y) by the reflection formula −π / (sin(πY)·Γ(1+Y)), and
    ω = −ψ(−i) enforces the martingale condition (finite iff M > 1). Y→0
    recovers Variance Gamma with ν = 1/C, θν = 1/M − 1/G, σ²ν = 2/(MG).

    The parameters are checked on the host first: Y = 1 zeroes sin(πY)
    and M ≤ 1 makes ω complex, both of which would give a silent NaN.
    """
    if not 0.0 < float(Y) < 2.0 or float(Y) == 1.0:
        raise ValueError("CGMY needs Y in (0, 2) with Y != 1")
    if not float(M) > 1.0:
        raise ValueError("CGMY martingale condition needs M > 1")
    if float(G) <= 0.0 or float(C) <= 0.0:
        raise ValueError("CGMY needs C > 0 and G > 0")
    (S0, K, T, r, q, C_, G_, M_, Y_), is_call, scalar = _prep(
        S0, K, T, r, q, kind, (C, G, M, Y), dtype, device)
    gneg = -math.pi / (torch.sin(math.pi * Y_)
                       * torch.exp(torch.lgamma(1.0 + Y_)))      # Γ(−Y)
    MY, GY = M_ ** Y_, G_ ** Y_

    om = -C_ * gneg * (MY * torch.expm1(Y_ * torch.log1p(-1.0 / M_))
                       + GY * torch.expm1(Y_ * torch.log1p(1.0 / G_)))
    Tc, rc, qc, Cc, Gc, Mc, Yc, gc, MYc, GYc, omc = (_col(t) for t in (
        T, r, q, C_, G_, M_, Y_, gneg, MY, GY, om))

    def psi(u):
        # (M−iu)^Y − M^Y as M^Y·expm1(Y·log1p(−iu/M)): the direct
        # difference cancels for small Y, where Γ(−Y) ~ −1/Y amplifies it
        iu = 1j * u
        return Cc * gc * (MYc * _expm1_c(Yc * _log1p_c(-iu / Mc))
                          + GYc * _expm1_c(Yc * _log1p_c(iu / Gc)))

    def phi(u):
        return torch.exp(Tc * psi(u) + 1j * u * (rc - qc + omc) * Tc)

    g1 = torch.exp(torch.lgamma(1.0 - Y_))
    g2 = torch.exp(torch.lgamma(2.0 - Y_))
    g4 = torch.exp(torch.lgamma(4.0 - Y_))
    c1 = (r - q + om) * T + C_ * T * g1 * (M_ ** (Y_ - 1.0)
                                           - G_ ** (Y_ - 1.0))
    c2 = C_ * T * g2 * (M_ ** (Y_ - 2.0) + G_ ** (Y_ - 2.0))
    c4 = C_ * T * g4 * (M_ ** (Y_ - 4.0) + G_ ** (Y_ - 4.0))
    out = _levy_cos_put_call(S0, K, T, r, q, phi, c1, c2, c4, is_call,
                             int(N))
    return out[0] if scalar and out.shape == (1,) else out


# ---------------------------------------------------------------------------
# VG smile calibration
# ---------------------------------------------------------------------------

_VG_LOWER = (1e-3, -1.5, 1e-4)        # sigma, theta, nu
_VG_UPPER = (1.5, 1.5, 1.5)


def fit_vg(strikes, expiries, market_ivs, S0, r, q=0.0, *, x0=None,
           n_cos: int = 128, max_iter: int = 200, device=None):
    """Calibrate Variance Gamma ``(sigma, theta, nu)`` to a vanilla smile.

    Same design as ``analytic.fit_heston``: quotes → call prices,
    vega-weighted price residuals, the shared bound-projected
    Levenberg-Marquardt loop with exact ``jacfwd`` Jacobians through the
    COS transform, in float64 on ``device``. A soft penalty keeps the
    optimizer inside the VG moment condition θν + σ²ν/2 < 1.

    Returns ``{"sigma", "theta", "nu", "rmse"}``; ``rmse`` is the RMS
    vega-weighted price error (≈ RMS IV error).
    """
    from .calibration import _lm_loop

    dev = resolve_device(device)
    f64 = torch.float64
    Kv, Tv, ivh, S0_, r_, q_, px_mkt, wv = _quote_set(
        strikes, expiries, market_ivs, S0, r, q, dev)
    is_call = torch.tensor(True, device=dev)

    def price_res(x):
        return (_vg_cos_core(S0_, Kv, Tv, r_, q_, x[0], x[1], x[2], is_call,
                             int(n_cos)) - px_mkt) * wv

    def residuals(x):
        # soft wall on the moment condition θν + σ²ν/2 < 1 (the bound box
        # alone cannot express the joint constraint)
        viol = torch.clamp(x[1] * x[2] + 0.5 * x[0] * x[0] * x[2] - 0.95,
                           min=0.0)
        return price_res(x) + 1e3 * viol

    if x0 is None:
        x0 = (float(np.median(ivh)), -0.1, 0.2)
    t = lambda v: torch.as_tensor(v, dtype=f64, device=dev)
    x, _ = _lm_loop(residuals, t(x0)[None, :], t(_VG_LOWER), t(_VG_UPPER),
                    int(max_iter))
    x = x[0]
    rmse = float(torch.sqrt(torch.mean(price_res(x) ** 2)))
    sig, th, nu = (float(v) for v in x.cpu())
    return {"sigma": sig, "theta": th, "nu": nu, "rmse": rmse}

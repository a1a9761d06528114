"""SVI surface calibration and Dupire local volatility.

Counterpart of ``optpricer_tpu/models/calibration.py``, in float64:

* :class:`SVIParams` — a raw-SVI slice with analytic ``dw_dk`` /
  ``d2w_dk2``;
* :func:`fit_svi` — bound-projected Levenberg-Marquardt with exact
  Jacobians (``torch.func.jacfwd``), the reference's bounds, initial guess,
  accept/reject rule, λ schedule and convergence test;
  :func:`fit_svi_surface` fits every slice of a surface whose expiries
  quote the same number of strikes as ONE batch: the reference ``vmap``s
  its ``while_loop``, which steps until every slice has stopped while a
  stopped slice keeps its state; here the batch is written out with a
  per-slice "active" mask, so each iteration is one set of batched ops for
  the whole surface;
* :func:`fit_essvi` — the joint arbitrage-free eSSVI fit. Its softplus is
  ``logaddexp(x, 0)`` as ``jax.nn.softplus`` is (``torch.nn.functional.
  softplus`` turns linear above 20, inside the ±25 bounds);
* :class:`VolSurface` — linear total-variance interpolation in T with
  flat-vol extrapolation and a log-linear forward curve;
* :func:`dupire_local_vol` / :func:`dupire_local_vol_func` — Gatheral's
  formula with the reference's guards (w ≥ 1e-12, numerator ≥ 1e-12,
  denominator ≥ 1e-8, σ clipped to [0.01, 5]); the closure takes a tensor
  ``S`` on any device and a float or 0-d tensor ``t``, so it runs inside
  ``fd_price_local_vol`` and the path generators of ``processes.py``;
* the static no-arbitrage screens :func:`svi_butterfly_g`,
  :func:`svi_density`, :func:`check_butterfly`, :func:`check_calendar` and
  :func:`arbitrage_report`.

The fitters, the surface and the screens take ``device=`` (default
``"cuda"``); functions of a tensor argument follow that tensor's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..dtypes import resolve_device

__all__ = [
    "SVIParams", "VolSurface", "fit_svi", "fit_svi_surface",
    "fit_essvi",
    "dupire_local_vol", "dupire_local_vol_func",
    "svi_butterfly_g", "svi_density", "check_butterfly",
    "check_calendar", "arbitrage_report",
]

_F64 = torch.float64
_SVI_LOWER = (-0.5, 1e-6, -0.999, -2.0, 1e-4)
_SVI_UPPER = (2.0, 5.0, 0.999, 2.0, 5.0)


def _f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor: on its own device if it is a tensor, else
    on ``device`` (default ``"cuda"``)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F64)
    return torch.as_tensor(np.asarray(x, np.float64),
                           device=resolve_device(device))


# ---------------------------------------------------------------------------
# SVI raw parameterisation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SVIParams:
    """Raw SVI slice: w(k) = a + b(ρ(k−m) + √((k−m)² + σ²)), k = ln(K/F)."""

    a: float
    b: float
    rho: float
    m: float
    sigma: float
    expiry: float

    def total_var(self, k, device=None):
        """Total variance w(k)."""
        km = _f64(k, device) - self.m
        return self.a + self.b * (
            self.rho * km + torch.sqrt(km * km + self.sigma * self.sigma))

    def iv(self, k, device=None):
        """Implied vol from log-moneyness."""
        return torch.sqrt(torch.clamp(self.total_var(k, device), min=0.0)
                          / self.expiry)

    def dw_dk(self, k, device=None):
        """dw/dk = b(ρ + (k−m)/√((k−m)² + σ²))."""
        u = _f64(k, device) - self.m
        return self.b * (self.rho + u / torch.sqrt(u * u + self.sigma**2))

    def d2w_dk2(self, k, device=None):
        """d²w/dk² = bσ²/((k−m)² + σ²)^{3/2}."""
        u = _f64(k, device) - self.m
        return self.b * self.sigma**2 / (u * u + self.sigma**2) ** 1.5


# ---------------------------------------------------------------------------
# VolSurface
# ---------------------------------------------------------------------------
class VolSurface:
    """Interpolating vol surface built from SVI slices.

    Between calibrated expiries total variance is linear in T; beyond the
    ends the nearest slice's implied vol is kept (flat-vol extrapolation).
    The slice table and the forward curve live as float64 tensors on
    ``device``; evaluation on another device copies them there once.
    """

    def __init__(self, slices: dict, forward_curve: Optional[dict] = None,
                 *, device=None):
        if not slices:
            raise ValueError("At least one SVI slice is required.")
        self._slices = dict(sorted(slices.items()))
        self._expiries = np.array(sorted(slices.keys()), dtype=float)
        self._forward_curve = forward_curve or {}
        self.device = resolve_device(device)
        Ts = sorted(self._slices)
        self._T_np = np.asarray(Ts, dtype=float)
        self._P_np = np.array([[self._slices[T].a, self._slices[T].b,
                                self._slices[T].rho, self._slices[T].m,
                                self._slices[T].sigma] for T in Ts])
        if self._forward_curve:
            fts = sorted(self._forward_curve.keys())
            self._fwd_T_np = np.asarray(fts, dtype=float)
            self._fwd_F_np = np.asarray([self._forward_curve[t] for t in fts],
                                        dtype=float)
        else:
            self._fwd_T_np = self._fwd_F_np = None
        self._cache = {}
        self._T_arr, self._P_arr = self._arrays(self.device)[:2]

    def _arrays(self, device) -> tuple:
        """(T, P, fwd_T, fwd_F) as float64 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._cache:
            t = lambda a: None if a is None else torch.as_tensor(
                a, dtype=_F64, device=device)
            self._cache[device] = (t(self._T_np), t(self._P_np),
                                   t(self._fwd_T_np), t(self._fwd_F_np))
        return self._cache[device]

    @property
    def slices(self) -> dict:
        return dict(self._slices)

    @property
    def expiries(self) -> np.ndarray:
        return self._expiries.copy()

    @property
    def has_forward(self) -> bool:
        return self._fwd_T_np is not None

    def svi_table(self) -> np.ndarray:
        """The path kernel's f32 (6, n_slices) table: rows a, b, ρ, m, σ, T,
        one column per slice in increasing T."""
        return np.ascontiguousarray(
            np.vstack([self._P_np.T, self._T_np[None]]), np.float32)

    def _get_forward(self, T, device=None):
        """Forward at T: log-linear in T between the curve's points, with
        the end slopes beyond them."""
        if self._fwd_T_np is None:
            raise ValueError(
                f"Forward not available for T={T}. Provide forward_curve or "
                "pass log-moneyness directly to iv_from_logm().")
        dev = T.device if isinstance(T, torch.Tensor) else (
            self.device if device is None else torch.device(device))
        _, _, Ts, F = self._arrays(dev)
        T = _f64(T, dev)
        if Ts.shape[0] == 1:
            return F[0]
        logF = torch.log(F)
        i = torch.clamp(torch.searchsorted(Ts, T.reshape(-1)), 1,
                        Ts.shape[0] - 1).reshape(T.shape)
        slope = (logF[i] - logF[i - 1]) / (Ts[i] - Ts[i - 1])
        return torch.exp(logF[i - 1] + slope * (T - Ts[i - 1]))

    def total_var_from_logm(self, k, T):
        """Total variance at (k, T); linear in T between slices, flat vol
        beyond the ends."""
        k = _f64(k, self.device)
        Ts, P = self._arrays(k.device)[:2]
        T = _f64(T, k.device)
        w_all = _w_of_slices(P, k)                   # (n, *k)
        n = Ts.shape[0]
        if n == 1:
            return w_all[0] / Ts[0] * T
        idx = torch.clamp(torch.searchsorted(Ts, T.reshape(-1)), 1,
                          n - 1).reshape(T.shape)
        T_lo, T_hi = Ts[idx - 1], Ts[idx]
        w_lo, w_hi = w_all[idx - 1], w_all[idx]
        alpha = (T - T_lo) / (T_hi - T_lo)
        w_mid = (1.0 - alpha) * w_lo + alpha * w_hi
        w_short = w_all[0] / Ts[0] * T
        w_long = w_all[-1] / Ts[-1] * T
        return torch.where(T <= Ts[0], w_short,
                           torch.where(T >= Ts[-1], w_long, w_mid))

    def iv_from_logm(self, k, T):
        """Implied vol from log-moneyness k = ln(K/F) at expiry T."""
        w = self.total_var_from_logm(k, T)
        T = _f64(T, w.device)
        return torch.sqrt(torch.clamp(w, min=0.0)
                          / torch.clamp(T, min=1e-12))

    def iv(self, K, T):
        """Implied vol from absolute strike(s); needs the forward curve.
        A float for scalar input, else a tensor."""
        K = _f64(K, self.device)
        F = self._get_forward(T, K.device)
        result = self.iv_from_logm(torch.log(K / F), T)
        if result.ndim == 0:
            return float(result)
        return result


def _w_of_slices(params: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Total variance of every slice at k: (n_slices, *k.shape)."""
    shape = (-1,) + (1,) * k.ndim
    a, b, rho, m, sig = (params[:, i].reshape(shape) for i in range(5))
    km = k[None, ...] - m
    return a + b * (rho * km + torch.sqrt(km * km + sig * sig))


# ---------------------------------------------------------------------------
# Levenberg-Marquardt with exact Jacobians
# ---------------------------------------------------------------------------
def _svi_w(x, k):
    km = k - x[3]
    return x[0] + x[1] * (x[2] * km + torch.sqrt(km * km + x[4] * x[4]))


def _lm_loop(residuals, x0, lower, upper, max_iter: int, data=()):
    """Bound-projected Levenberg-Marquardt over a batch of problems.

    ``residuals(x, *data_i) -> (N,)`` is one problem's residual vector;
    ``x0`` is (B, d) and each tensor of ``data`` has the batch on its
    leading axis. A problem steps while it is active (under ``max_iter``
    iterations, not converged, λ < 1e10) and keeps its state once it has
    stopped; the loop ends when none is active. Returns (x (B, d),
    cost (B,)).
    """
    res = vmap(residuals)
    jac = vmap(jacfwd(residuals))

    def cost(x):
        r = res(x, *data)
        return 0.5 * torch.sum(r * r, dim=-1)

    x = x0.clone()
    B = x.shape[0]
    lam = torch.full((B,), 1e-3, dtype=x.dtype, device=x.device)
    c = cost(x)
    it = torch.zeros(B, dtype=torch.int64, device=x.device)
    converged = torch.zeros(B, dtype=torch.bool, device=x.device)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    while True:
        active = (it < max_iter) & ~converged & (lam < 1e10)
        if not bool(active.any()):
            break
        J = jac(x, *data)                                  # (B, N, d)
        r = res(x, *data)                                  # (B, N)
        Jt = J.transpose(1, 2)
        g = torch.matmul(Jt, r[..., None])[..., 0]         # gradient
        H = torch.matmul(Jt, J)                            # f64 matmul
        D = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-12)
        step = torch.linalg.solve(H + lam[:, None, None] * (D[:, None, :]
                                                            * eye),
                                  g[..., None])[..., 0]
        x_new = torch.clamp(x - step, lower, upper)
        c_new = cost(x_new)
        accept = c_new < c
        conv_new = accept & (torch.abs(c - c_new) < 1e-16 * (1.0 + c))
        lam_new = torch.where(accept, torch.clamp(lam * 0.3, min=1e-12),
                              lam * 3.0)
        x = torch.where((active & accept)[:, None], x_new, x)
        c = torch.where(active & accept, c_new, c)
        lam = torch.where(active, lam_new, lam)
        converged = torch.where(active, conv_new, converged)
        it = it + active.to(it.dtype)
    return x, c


def _svi_residuals(x, k, w_market):
    return _svi_w(x, k) - w_market


def _fit_svi_batch(k, w, x0, max_iter: int = 200):
    """LM on SVI total-variance residuals, one slice per row."""
    lower = torch.tensor(_SVI_LOWER, dtype=_F64, device=k.device)
    upper = torch.tensor(_SVI_UPPER, dtype=_F64, device=k.device)
    return _lm_loop(_svi_residuals, x0, lower, upper, max_iter,
                    data=(k, w))[0]


def fit_svi(strikes, forward: float, expiry: float, market_ivs, *,
            initial_guess: Optional[tuple] = None,
            bounds: Optional[tuple] = None, dtype=None,
            device=None) -> SVIParams:
    """Fit raw SVI to one smile slice (the reference's bounds and initial
    guess). ``dtype`` is accepted for API parity: the fit is float64."""
    del dtype
    dev = resolve_device(device)
    strikes = np.asarray(strikes, dtype=float)
    market_ivs = np.asarray(market_ivs, dtype=float)
    k = torch.as_tensor(np.log(strikes / forward), dtype=_F64, device=dev)
    w_market = torch.as_tensor(market_ivs**2 * expiry, dtype=_F64,
                               device=dev)
    if initial_guess is None:
        initial_guess = (float(np.mean(market_ivs**2 * expiry)), 0.1, 0.0,
                         0.0, 0.1)
    lower, upper = bounds if bounds is not None else (_SVI_LOWER, _SVI_UPPER)
    t = lambda v: torch.as_tensor(v, dtype=_F64, device=dev)
    x, _ = _lm_loop(_svi_residuals, t(initial_guess)[None, :], t(lower),
                    t(upper), 200, data=(k[None, :], w_market[None, :]))
    a, b, rho, m, sig = (float(v) for v in x[0].cpu())
    return SVIParams(a=a, b=b, rho=rho, m=m, sigma=sig, expiry=expiry)


def fit_svi_surface(strikes_by_expiry: dict, forwards: dict,
                    market_ivs_by_expiry: dict, *, dtype=None,
                    device=None) -> VolSurface:
    """Fit SVI slice by slice → :class:`VolSurface`.

    When every expiry quotes the same number of strikes, all slices fit as
    one batched Levenberg-Marquardt run; a ragged surface fits one slice
    at a time, as the reference does.
    """
    del dtype
    dev = resolve_device(device)
    Ts = sorted(strikes_by_expiry.keys())
    sizes = {len(np.asarray(strikes_by_expiry[T])) for T in Ts}
    if len(Ts) > 1 and len(sizes) == 1:
        ks, ws, x0s = [], [], []
        for T in Ts:
            strikes = np.asarray(strikes_by_expiry[T], dtype=float)
            ivs = np.asarray(market_ivs_by_expiry[T], dtype=float)
            w = ivs**2 * T
            ks.append(np.log(strikes / forwards[T]))
            ws.append(w)
            x0s.append((float(np.mean(w)), 0.1, 0.0, 0.0, 0.1))
        t = lambda v: torch.as_tensor(np.stack(v), dtype=_F64, device=dev)
        X = _fit_svi_batch(t(ks), t(ws), t(x0s)).cpu().numpy()
        slices = {T: SVIParams(a=float(X[i, 0]), b=float(X[i, 1]),
                               rho=float(X[i, 2]), m=float(X[i, 3]),
                               sigma=float(X[i, 4]), expiry=T)
                  for i, T in enumerate(Ts)}
        return VolSurface(slices, forward_curve=forwards, device=dev)

    slices = {T: fit_svi(strikes_by_expiry[T], forwards[T], T,
                         market_ivs_by_expiry[T], device=dev) for T in Ts}
    return VolSurface(slices, forward_curve=forwards, device=dev)


def _softplus(x):
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it, with no linear
    branch."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _essvi_unpack(x, n_exp: int):
    """Raw optimiser vector → (θ (n,), ρ, η, γ), constraints built in."""
    theta = torch.cumsum(_softplus(x[:n_exp]) + 1e-8, dim=0)
    rho = 0.99 * torch.tanh(x[n_exp])
    eta = _softplus(x[n_exp + 1]) + 1e-8
    gam = 0.5 * torch.sigmoid(x[n_exp + 2])
    return theta, rho, eta, gam


def _essvi_w(theta_i, rho, phi_i, k):
    return 0.5 * theta_i * (1.0 + rho * phi_i * k + torch.sqrt(
        (phi_i * k + rho) ** 2 + 1.0 - rho * rho))


def _essvi_residuals(n_exp: int):
    def residuals(x, k_pad, w_pad, wt_pad):
        theta, rho, eta, gam = _essvi_unpack(x, n_exp)
        phi = eta / theta**gam
        w = _essvi_w(theta[:, None], rho, phi[:, None], k_pad)
        fit_res = ((w - w_pad) * wt_pad).reshape(-1)
        cap = theta * phi * (1.0 + torch.abs(rho))
        zero = torch.zeros_like(cap)
        pen1 = 10.0 * torch.maximum(cap - 4.0, zero)
        pen2 = 10.0 * torch.maximum(cap * phi - 4.0, zero)
        return torch.cat([fit_res, pen1, pen2])

    return residuals


def fit_essvi(strikes_by_expiry: dict, forwards: dict,
              market_ivs_by_expiry: dict, *, dtype=None,
              max_iter: int = 400, device=None) -> tuple[VolSurface, dict]:
    """Global arbitrage-free eSSVI surface fit (power-law φ): one
    Levenberg-Marquardt solve over every quote of every expiry, calendar
    monotonicity built into θ and the Gatheral-Jacquier butterfly bounds
    as hinge penalties; each expiry is exported as exact raw SVI.

    Returns ``(surface, info)``; ``info`` carries the eSSVI parameters,
    per-expiry θ/φ, the butterfly margins and the fit RMSE in total
    variance.
    """
    del dtype
    dev = resolve_device(device)
    Ts = sorted(strikes_by_expiry.keys())
    n_exp = len(Ts)
    if n_exp < 1:
        raise ValueError("need at least one expiry")
    m_max = max(len(np.asarray(strikes_by_expiry[T])) for T in Ts)
    k_pad = np.zeros((n_exp, m_max))
    w_pad = np.zeros((n_exp, m_max))
    wt_pad = np.zeros((n_exp, m_max))
    atm_w = np.zeros(n_exp)
    for i, T in enumerate(Ts):
        strikes = np.asarray(strikes_by_expiry[T], dtype=float)
        ivs = np.asarray(market_ivs_by_expiry[T], dtype=float)
        if strikes.shape != ivs.shape:
            raise ValueError(f"expiry {T}: strikes/ivs shape mismatch")
        m = strikes.size
        k = np.log(strikes / forwards[T])
        w = ivs**2 * T
        k_pad[i, :m] = k
        w_pad[i, :m] = w
        wt_pad[i, :m] = 1.0
        atm_w[i] = w[np.argmin(np.abs(k))]

    # raw init: θ from the ATM quotes (inverse of the cumulative softplus),
    # ρ = 0, η = 1, γ = 0.3
    inc = np.maximum(np.diff(atm_w, prepend=0.0), 1e-4)
    inv_softplus = lambda y: np.log(np.expm1(np.maximum(y, 1e-8)))
    x0 = np.concatenate([inv_softplus(inc),
                         [0.0, inv_softplus(1.0), -0.35]])
    t = lambda v: torch.as_tensor(v, dtype=_F64, device=dev)
    dim = n_exp + 3
    x, cost = _lm_loop(_essvi_residuals(n_exp), t(x0)[None, :],
                       t(np.full(dim, -25.0)), t(np.full(dim, 25.0)),
                       int(max_iter),
                       data=(t(k_pad)[None], t(w_pad)[None], t(wt_pad)[None]))
    theta, rho, eta, gam = (v.cpu().numpy().astype(np.float64)
                            for v in _essvi_unpack(x[0], n_exp))
    rho, eta, gam = float(rho), float(eta), float(gam)
    phi = eta / theta**gam

    slices = {}
    for i, T in enumerate(Ts):
        th, ph = float(theta[i]), float(phi[i])
        slices[T] = SVIParams(
            a=0.5 * th * (1.0 - rho * rho), b=0.5 * th * ph,
            rho=rho, m=-rho / ph,
            sigma=np.sqrt(1.0 - rho * rho) / ph, expiry=T)
    surface = VolSurface(slices, forward_curve=dict(forwards), device=dev)
    n_quotes = int(wt_pad.sum())
    info = {
        "theta": theta, "rho": rho, "eta": eta, "gamma": gam,
        "phi": phi,
        "rmse_w": float(np.sqrt(2.0 * float(cost[0]) / max(n_quotes, 1))),
        "butterfly_margin": 4.0 - theta * phi * (1.0 + abs(rho)),
        "butterfly_margin2": 4.0 - theta * phi**2 * (1.0 + abs(rho)),
    }
    return surface, info


# ---------------------------------------------------------------------------
# Dupire local volatility
# ---------------------------------------------------------------------------
def dupire_local_vol(surface: VolSurface, S, t, r: float, q: float, *,
                     dT: float = 1e-4, device=None):
    """Dupire local vol σ_loc(S, t) in total-variance / log-moneyness
    coordinates (Gatheral), with the reference's guards. ``S`` is a tensor
    (its device is used) or array-like (on ``device``); ``t`` a float or a
    0-d tensor. A scalar ``S`` gives a 0-d tensor."""
    S_t = _f64(S, surface.device if device is None else device)
    scalar_in = S_t.ndim == 0
    S_arr = torch.atleast_1d(S_t)
    dev = S_arr.device
    t = torch.clamp(_f64(t, dev), min=1e-8)
    Ts, P = surface._arrays(dev)[:2]

    if surface.has_forward:
        F = surface._get_forward(t)
    else:
        F = torch.mean(S_arr)
    k = torch.log(S_arr / F)

    # spatial quantities from the t-interpolated surface: the analytic
    # slice derivatives blended with the weights of total_var_from_logm
    n_sl = Ts.shape[0]
    a, b, rho, m, sig = (P[:, i][:, None] for i in range(5))
    km = k[None, :] - m
    root = torch.sqrt(km * km + sig * sig)
    w_all = a + b * (rho * km + root)            # (n_slices, n_k)
    dw_all = b * (rho + km / root)
    d2w_all = b * sig**2 / root**3

    def _blend(q_all):
        if n_sl == 1:
            return q_all[0] * (t / Ts[0])
        i = torch.clamp(torch.searchsorted(Ts, t.reshape(1)), 1,
                        n_sl - 1)[0]
        alpha = (t - Ts[i - 1]) / (Ts[i] - Ts[i - 1])
        mid = (1.0 - alpha) * q_all[i - 1] + alpha * q_all[i]
        short = q_all[0] * (t / Ts[0])
        long = q_all[-1] * (t / Ts[-1])
        return torch.where(t <= Ts[0], short,
                           torch.where(t >= Ts[-1], long, mid))

    w = torch.clamp(_blend(w_all), min=1e-12)
    dw = _blend(dw_all)
    d2w = _blend(d2w_all)

    # ∂w/∂T by a centred difference on the interpolated surface
    t_up = t + dT
    t_dn = torch.clamp(t - dT, min=1e-8)
    w_up = surface.total_var_from_logm(k, t_up)
    w_dn = surface.total_var_from_logm(k, t_dn)
    dwdT = (w_up - w_dn) / (t_up - t_dn)

    numer = torch.clamp(dwdT, min=1e-12)
    y = k
    denom = (1.0 - (y / w) * dw
             + 0.25 * (-0.25 - 1.0 / w + (y / w) ** 2) * dw**2
             + 0.5 * d2w)
    denom = torch.clamp(denom, min=1e-8)
    sigma_loc = torch.clamp(torch.sqrt(torch.clamp(numer / denom, min=0.0)),
                            0.01, 5.0)
    if scalar_in:
        return sigma_loc[0]
    return sigma_loc


def dupire_local_vol_func(surface: VolSurface, r: float, q: float
                          ) -> Callable:
    """Closure ``sigma_loc(S, t) -> sigma`` for
    :func:`~optpricer_tpu_torch.models.pde.fd_price_local_vol`,
    :func:`~optpricer_tpu_torch.models.processes.local_vol_paths` and
    :func:`~optpricer_tpu_torch.models.processes.milstein_local_vol_paths`;
    it evaluates on ``S``'s device."""

    def _sigma_loc(S_arr, t):
        return dupire_local_vol(surface, S_arr, t, r, q)

    return _sigma_loc


# ---------------------------------------------------------------------------
# Static no-arbitrage diagnostics (Gatheral & Jacquier 2014)
# ---------------------------------------------------------------------------
def svi_butterfly_g(params: SVIParams, k, device=None):
    """Gatheral's butterfly factor g(k) of a raw-SVI slice; the slice is
    free of butterfly arbitrage iff g(k) ≥ 0 for all k."""
    k = _f64(k, device)
    w = torch.clamp(params.total_var(k), min=1e-12)
    wp = params.dw_dk(k)
    wpp = params.d2w_dk2(k)
    return ((1.0 - 0.5 * k * wp / w) ** 2
            - 0.25 * wp * wp * (1.0 / w + 0.25) + 0.5 * wpp)


def svi_density(params: SVIParams, k, device=None):
    """Risk-neutral density of log-moneyness implied by a raw-SVI slice:
    p(k) = g(k)/√(2πw(k))·exp(−d₋²/2), d₋ = −k/√w − √w/2."""
    k = _f64(k, device)
    w = torch.clamp(params.total_var(k), min=1e-12)
    sw = torch.sqrt(w)
    d_minus = -k / sw - 0.5 * sw
    g = svi_butterfly_g(params, k)
    return g / torch.sqrt(2.0 * math.pi * w) * torch.exp(-0.5 * d_minus**2)


def _grid(k_lo, k_hi, n, device):
    return torch.linspace(k_lo, k_hi, int(n), dtype=_F64,
                          device=resolve_device(device))


def check_butterfly(params: SVIParams, *, k_lo: float = -2.0,
                    k_hi: float = 2.0, n: int = 801, device=None) -> dict:
    """Scan one slice for butterfly arbitrage on a log-moneyness grid:
    ``{"ok", "min_g", "k_at_min"}``."""
    k = _grid(k_lo, k_hi, n, device)
    g = svi_butterfly_g(params, k)
    i = int(torch.argmin(g))
    return {"ok": bool(g[i] >= 0.0), "min_g": float(g[i]),
            "k_at_min": float(k[i])}


def check_calendar(surface: VolSurface, *, k_lo: float = -2.0,
                   k_hi: float = 2.0, n: int = 801, device=None) -> dict:
    """Scan a surface for calendar-spread arbitrage: total variance must
    not decrease in T at fixed log-moneyness. Returns ``{"ok", "min_gap",
    "pair", "k_at_min"}``."""
    Ts = [float(t) for t in surface.expiries]
    if len(Ts) < 2:
        return {"ok": True, "min_gap": float("inf"), "pair": None,
                "k_at_min": float("nan")}
    k = _grid(k_lo, k_hi, n, surface.device if device is None else device)
    worst = (float("inf"), None, float("nan"))
    for t0, t1 in zip(Ts, Ts[1:]):
        gap = (surface.slices[t1].total_var(k)
               - surface.slices[t0].total_var(k))
        i = int(torch.argmin(gap))
        if float(gap[i]) < worst[0]:
            worst = (float(gap[i]), (t0, t1), float(k[i]))
    return {"ok": worst[0] >= 0.0, "min_gap": worst[0],
            "pair": worst[1], "k_at_min": worst[2]}


def arbitrage_report(surface: VolSurface, *, k_lo: float = -2.0,
                     k_hi: float = 2.0, n: int = 801, device=None) -> dict:
    """Full static-arbitrage screen of a fitted surface:
    ``{"ok", "butterfly": {T: check_butterfly(...)}, "calendar":
    check_calendar(...)}``."""
    dev = surface.device if device is None else device
    kw = dict(k_lo=k_lo, k_hi=k_hi, n=n, device=dev)
    butterfly = {T: check_butterfly(p, **kw)
                 for T, p in surface.slices.items()}
    calendar = check_calendar(surface, **kw)
    ok = calendar["ok"] and all(b["ok"] for b in butterfly.values())
    return {"ok": ok, "butterfly": butterfly, "calendar": calendar}

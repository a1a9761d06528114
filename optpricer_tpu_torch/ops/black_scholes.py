"""Black-Scholes closed forms: price, Greeks, implied vol.

Counterpart of ``optpricer_tpu/ops/black_scholes.py``: one broadcasting
core of plain torch ops (there is no kernel here), with the scalar API as a
thin view of it. ``kind`` strings become a boolean mask on the host;
everything on the device is branch-free ``torch.where``.

Scalar implied vol is a bracketed bisection and the vectorised implied vol
a Newton iteration on vega, with the JAX package's stopping rules, so both
take the same branches on the same inputs.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Literal

import numpy as np
import torch

from ..core import CALL, PUT, OptionSpec
from ..dtypes import canonical, resolve_device

__all__ = [
    "price", "greeks", "implied_vol",
    "bs_price_vec", "bs_greeks_vec", "bs_implied_vol_vec",
    "bs_higher_greeks_vec",
]

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def is_call_mask(kind) -> np.ndarray:
    """Boolean mask: True where kind == 'call' (a string, booleans, or an
    array of either)."""
    if isinstance(kind, (bool, np.bool_)):
        return np.bool_(kind)
    if isinstance(kind, str):
        if kind not in (CALL, PUT):
            raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")
        return np.bool_(kind == CALL)
    if isinstance(kind, torch.Tensor):
        if kind.dtype != torch.bool:
            raise ValueError("tensor-valued kind must be boolean")
        return kind.cpu().numpy()
    arr = np.asarray(kind)
    if arr.dtype == bool:
        return arr
    bad = np.array([str(k) not in (CALL, PUT) for k in arr.flat], dtype=bool)
    if bad.any():
        raise ValueError("kind entries must be 'call' or 'put'")
    return np.array([str(k) == CALL for k in arr.flat],
                    dtype=bool).reshape(arr.shape)


def _cdf(x):
    return torch.special.ndtr(x)


def _pdf(x):
    return torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


# ---------------------------------------------------------------------------
# cores (pure tensor functions; broadcast)
# ---------------------------------------------------------------------------
def d1_d2(S, K, T, r, q, sigma):
    """d1, d2 of the Black-Scholes formula."""
    sig_sqrt_T = sigma * torch.sqrt(T)
    d1 = (torch.log(S / K) + (r - q + 0.5 * sigma * sigma) * T) / sig_sqrt_T
    return d1, d1 - sig_sqrt_T


def price_core(S, K, T, r, q, sigma, is_call):
    """Branch-free Black-Scholes price."""
    d1, d2 = d1_d2(S, K, T, r, q, sigma)
    disc_r = torch.exp(-r * T)
    disc_q = torch.exp(-q * T)
    call_px = disc_q * S * _cdf(d1) - disc_r * K * _cdf(d2)
    put_px = disc_r * K * _cdf(-d2) - disc_q * S * _cdf(-d1)
    return torch.where(is_call, call_px, put_px)


def greeks_core(S, K, T, r, q, sigma, is_call):
    """delta/gamma/vega/theta/rho; vega absolute (dPrice/dSigma), theta per
    year."""
    d1, d2 = d1_d2(S, K, T, r, q, sigma)
    disc_r = torch.exp(-r * T)
    disc_q = torch.exp(-q * T)
    sqrt_T = torch.sqrt(T)
    n_d1 = _pdf(d1)
    N_d1 = _cdf(d1)
    N_d2 = _cdf(d2)
    N_md1 = _cdf(-d1)
    N_md2 = _cdf(-d2)

    gamma = disc_q * n_d1 / (S * sigma * sqrt_T)
    vega = S * disc_q * n_d1 * sqrt_T

    delta = torch.where(is_call, disc_q * N_d1, disc_q * (N_d1 - 1.0))
    theta_common = -S * disc_q * n_d1 * sigma / (2.0 * sqrt_T)
    theta = torch.where(
        is_call,
        theta_common - r * K * disc_r * N_d2 + q * S * disc_q * N_d1,
        theta_common + r * K * disc_r * N_md2 - q * S * disc_q * N_md1,
    )
    rho = torch.where(is_call, K * T * disc_r * N_d2, -K * T * disc_r * N_md2)
    return {"delta": delta, "gamma": gamma, "vega": vega, "theta": theta,
            "rho": rho}


def higher_greeks_core(S, K, T, r, q, sigma, is_call):
    """vanna, volga, charm (−∂Δ/∂T, per year), speed and zomma."""
    d1, d2 = d1_d2(S, K, T, r, q, sigma)
    disc_q = torch.exp(-q * T)
    sqrt_T = torch.sqrt(T)
    n_d1 = _pdf(d1)
    vanna = -disc_q * n_d1 * d2 / sigma
    vega = S * disc_q * n_d1 * sqrt_T
    volga = vega * d1 * d2 / sigma
    gamma = disc_q * n_d1 / (S * sigma * sqrt_T)
    speed = -gamma / S * (d1 / (sigma * sqrt_T) + 1.0)
    zomma = gamma * (d1 * d2 - 1.0) / sigma
    common = disc_q * n_d1 * (
        2.0 * (r - q) * T - d2 * sigma * sqrt_T) / (2.0 * T * sigma * sqrt_T)
    charm = torch.where(is_call,
                        q * disc_q * _cdf(d1) - common,
                        -q * disc_q * _cdf(-d1) - common)
    return {"vanna": vanna, "volga": volga, "charm": charm,
            "speed": speed, "zomma": zomma}


def vega_core(S, K, T, r, q, sigma):
    d1, _ = d1_d2(S, K, T, r, q, sigma)
    return S * torch.exp(-q * T) * _pdf(d1) * torch.sqrt(T)


def _prep(dtype, device, *args):
    dt = canonical(dtype)
    dev = resolve_device(device)
    return tuple(torch.as_tensor(a if isinstance(a, torch.Tensor)
                                 else np.array(a, np.float64),
                                 dtype=dt, device=dev) for a in args)


def _mask(kind, device):
    return torch.as_tensor(is_call_mask(kind), device=resolve_device(device))


# ---------------------------------------------------------------------------
# Vectorised public API (scalars or arrays; broadcasts)
# ---------------------------------------------------------------------------
def bs_price_vec(S, K, T, r, q, sigma, kind, *, dtype=None,
                 device=None) -> torch.Tensor:
    """Vectorised Black-Scholes price."""
    S, K, T, r, q, sigma = _prep(dtype, device, S, K, T, r, q, sigma)
    return price_core(S, K, T, r, q, sigma, _mask(kind, device))


def bs_greeks_vec(S, K, T, r, q, sigma, kind, *, dtype=None,
                  device=None) -> Dict[str, torch.Tensor]:
    """Vectorised Greeks dict (delta/gamma/vega/theta/rho)."""
    S, K, T, r, q, sigma = _prep(dtype, device, S, K, T, r, q, sigma)
    return greeks_core(S, K, T, r, q, sigma, _mask(kind, device))


def bs_higher_greeks_vec(S, K, T, r, q, sigma, kind, *, dtype=None,
                         device=None) -> Dict[str, torch.Tensor]:
    """Vectorised vanna/volga/charm/speed/zomma."""
    S, K, T, r, q, sigma = _prep(dtype, device, S, K, T, r, q, sigma)
    return higher_greeks_core(S, K, T, r, q, sigma, _mask(kind, device))


# ---------------------------------------------------------------------------
# Scalar convenience API over OptionSpec
# ---------------------------------------------------------------------------
def price(opt: OptionSpec, kind: Literal["call", "put"] = CALL, *,
          device=None) -> float:
    """Scalar Black-Scholes price."""
    return float(bs_price_vec(opt.S0, opt.K, opt.T, opt.r, opt.q, opt.sigma,
                              kind, device=device))


def greeks(opt: OptionSpec, kind: Literal["call", "put"] = CALL, *,
           device=None) -> Dict[str, float]:
    """Scalar Greeks; vega is dPrice/dSigma in absolute units."""
    g = bs_greeks_vec(opt.S0, opt.K, opt.T, opt.r, opt.q, opt.sigma, kind,
                      device=device)
    return {k: float(v) for k, v in g.items()}


# ---------------------------------------------------------------------------
# Implied volatility
# ---------------------------------------------------------------------------
def _iv_bisect_core(S, K, T, r, q, target, is_call, lo, hi, tol,
                    maxiter=128):
    """Bracketed bisection for sigma, to ``tol`` in sigma."""
    for _ in range(maxiter):
        if not bool(torch.max(hi - lo) > tol):
            break
        mid = 0.5 * (lo + hi)
        f_mid = price_core(S, K, T, r, q, mid, is_call) - target
        f_lo = price_core(S, K, T, r, q, lo, is_call) - target
        same_side = torch.sign(f_mid) == torch.sign(f_lo)
        lo, hi = torch.where(same_side, mid, lo), torch.where(same_side, hi, mid)
    return 0.5 * (lo + hi)


def implied_vol(
    opt: OptionSpec,
    target_price: float,
    kind: Literal["call", "put"] = CALL,
    *,
    tol: float = 1e-8,
    maxiter: int = 100,
    bracket=(1e-6, 5.0),
    device=None,
) -> float:
    """Scalar implied vol via bracketed bisection. If f(a) and f(b) have the
    same sign the bracket is reset to ``(1e-6, max(5, 2*sigma))``."""
    del maxiter  # the bisection's own cap governs, as in the JAX package
    a, b = bracket
    f = lambda sig: price(replace(opt, sigma=float(sig)), kind,
                          device=device) - target_price
    if f(a) * f(b) > 0:
        a, b = 1e-6, max(5.0, 2.0 * opt.sigma if opt.sigma > 0 else 1.0)
        if f(a) * f(b) > 0:
            raise ValueError(
                f"implied_vol: target price {target_price} is not bracketed "
                f"by sigma in [{a}, {b}]")
    S, K, T, r, q, tgt, lo, hi, tol_t = _prep(
        None, device, opt.S0, opt.K, opt.T, opt.r, opt.q, target_price, a, b,
        tol)
    sig = _iv_bisect_core(S, K, T, r, q, tgt, _mask(kind, device), lo, hi,
                          tol_t)
    return float(sig)


def _iv_newton_core(S, K, T, r, q, target, is_call, sigma0, tol, maxiter=50):
    """Vectorised Newton-Raphson on vega: clamp sigma to [1e-6, 10], stop
    when every |step| < tol or at maxiter; entries whose final price misses
    the target by more than a dtype-aware band are NaN."""
    sigma = sigma0
    for _ in range(maxiter):
        px = price_core(S, K, T, r, q, sigma, is_call)
        vega = vega_core(S, K, T, r, q, sigma)
        vega_safe = torch.where(vega > 1e-15, vega,
                                torch.full_like(vega, float("nan")))
        step = (px - target) / vega_safe
        sigma = torch.clamp(sigma - step, 1e-6, 10.0)
        if bool(torch.all(torch.abs(step) < tol)):
            break
    px_final = price_core(S, K, T, r, q, sigma, is_call)
    eps = torch.finfo(sigma.dtype).eps
    band = torch.clamp(100.0 * eps * torch.clamp(torch.abs(target), min=1.0),
                       min=float(tol) * 100.0)
    bad = torch.abs(px_final - target) > band
    return torch.where(bad, torch.full_like(sigma, float("nan")), sigma)


def bs_implied_vol_vec(
    S, K, T, r, q, target_prices, kind,
    *, tol: float = 1e-8, maxiter: int = 50, init_vol: float = 0.3,
    dtype=None, device=None,
) -> torch.Tensor:
    """Vectorised implied vol via Newton-Raphson; non-converged entries NaN."""
    dt = canonical(dtype)
    S, K, T, r, q, target_prices = _prep(dtype, device, S, K, T, r, q,
                                         target_prices)
    shape = torch.broadcast_shapes(S.shape, K.shape, T.shape, r.shape,
                                   q.shape, target_prices.shape)
    sigma0 = torch.full(shape, init_vol, dtype=dt, device=S.device)
    return _iv_newton_core(S, K, T, r, q, target_prices, _mask(kind, device),
                           sigma0, float(tol), maxiter=maxiter)

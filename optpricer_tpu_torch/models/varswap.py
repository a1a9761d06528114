"""Variance swaps: log-contract replication, Heston closed form, MC.

Counterpart of ``optpricer_tpu/models/varswap.py``. Three routes to the
fair variance K_var = E[(1/T)∫σ²dt]:

* :func:`varswap_strike_replication` — the model-free log-contract
  replication K_var = (2e^{rT}/T)[∫₀^F P(K)/K² dK + ∫_F^∞ C(K)/K² dK] from
  any implied-vol surface: one vectorised Black-Scholes call on a
  log-strike grid and a trapezoid sum, on the device.
* :func:`varswap_strike_heston` — E[(1/T)∫v_t dt] = θ + (v0 − θ)(1 −
  e^{−κT})/(κT).
* :func:`varswap_strike_mc` — discrete monitoring, (1/T)E[Σ(ln
  S_{i+1}/S_i)²], on the port's path generators (GBM, Heston QE, Merton):
  the per-path sums reduce on the device, and one (n_paths,) vector
  comes to the host.

:func:`volswap_strike_mc` measures the vol-swap convexity gap. The path
generators draw from a ``torch.Generator``, so a seed gives another sample
than the reference's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from .monte_carlo import resolve_seed

__all__ = ["varswap_strike_replication", "varswap_strike_heston",
           "varswap_strike_mc", "volswap_strike_mc"]


def varswap_strike_replication(surface_iv, S0: float, r: float,
                               q: float, T: float, *,
                               n_strikes: int = 2048,
                               width: float = 10.0,
                               dtype=None, device=None) -> float:
    """Model-free fair variance by log-contract replication.

    ``surface_iv``: a constant vol (float: the result is σ² exactly), a
    callable ``(K, T) -> iv`` taking a tensor of strikes, or a surface
    object (its ``.iv`` is used). The OTM strip is integrated on
    ``n_strikes`` log-strike points over ``±width·σ_ATM·√T`` around the
    forward. Returns K_var in variance units (annualised).
    """
    if hasattr(surface_iv, "iv"):
        iv_fn = surface_iv.iv
    elif callable(surface_iv):
        iv_fn = surface_iv
    else:
        sig_const = float(surface_iv)
        iv_fn = lambda K, t: torch.full_like(K, sig_const)  # noqa: E731
    if T <= 0.0:
        raise ValueError(f"T must be positive, got {T}")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dt_, device=dev)
    host = lambda a: np.asarray(torch.as_tensor(a).cpu(), np.float64)
    F = S0 * np.exp((r - q) * T)
    sig_atm = float(np.mean(host(iv_fn(t(np.array([F])), T))))
    w = width * sig_atm * np.sqrt(T)
    y = np.linspace(np.log(F) - w, np.log(F) + w, n_strikes)
    K = t(np.exp(y))
    iv_np = host(iv_fn(K, T))
    # deep wings of a numerical surface may be NaN where the price
    # underflows vega: flat-extrapolate the last solvable vol
    good = np.isfinite(iv_np) & (iv_np > 0.0)
    if not good.any():
        raise ValueError("surface_iv returned no usable vols on the "
                         "replication grid")
    if not good.all():
        iv_np = np.interp(y, y[good], iv_np[good])
    iv = t(iv_np)

    from ..ops.black_scholes import price_core

    # OTM strip: puts below the forward, calls above
    is_call = K >= F
    prices = price_core(t(S0), K, t(T), t(r), t(q), iv, is_call)
    # trapezoid in y: dK = K dy, so ∫ O(K)/K² dK = ∫ O(K)/K dy
    integrand = prices / K
    dy = y[1] - y[0]
    integral = (torch.sum(integrand)
                - 0.5 * (integrand[0] + integrand[-1])) * dy
    return 2.0 * np.exp(r * T) / T * float(integral)


def varswap_strike_heston(v0: float, kappa: float, theta: float,
                          T: float) -> float:
    """Exact continuous-monitoring Heston fair variance:
    E[(1/T)∫₀ᵀ v_t dt] = θ + (v0 − θ)(1 − e^{−κT})/(κT)."""
    if T <= 0.0:
        raise ValueError(f"T must be positive, got {T}")
    if kappa <= 0.0:
        raise ValueError(f"kappa must be positive, got {kappa}")
    x = kappa * T
    return float(theta + (v0 - theta) * (1.0 - np.exp(-x)) / x)


def _logret_sq_sum(paths: torch.Tensor) -> torch.Tensor:
    """(n_paths,) per-path Σ(ln S_{i+1}/S_i)² of a path matrix, in f64."""
    lr = torch.diff(torch.log(paths.double()), dim=0)
    return torch.sum(lr * lr, dim=0)


def _mc_paths(S0, r, q, T, n_steps, n_paths, seed, dt_, *,
              sigma=None, heston=None, merton=None, antithetic=True,
              device=None):
    if sum(x is not None for x in (sigma, heston, merton)) != 1:
        raise ValueError("give exactly one of sigma=, heston= or merton=")
    kw = dict(antithetic=antithetic, seed=seed, dtype=dt_, device=device)
    if sigma is not None:
        from .processes import gbm_paths

        return gbm_paths(S0, r, q, sigma, T, n_steps, n_paths, **kw)
    if heston is not None:
        from .processes import heston_paths

        hp = {k: float(heston[k])
              for k in ("v0", "kappa", "theta", "xi", "rho")}
        return heston_paths(S0, r, q, hp["v0"], hp["kappa"], hp["theta"],
                            hp["xi"], hp["rho"], T, n_steps, n_paths,
                            scheme="qe", **kw)
    from .processes import merton_jump_paths

    mp = {k: float(merton[k]) for k in ("sigma", "lam", "mJ", "sJ")}
    return merton_jump_paths(S0, r, q, mp["sigma"], T, n_steps, n_paths,
                             lam=mp["lam"], mJ=mp["mJ"], sJ=mp["sJ"], **kw)


def _mean_se(x: np.ndarray):
    return float(x.mean()), float(x.std(ddof=1) / np.sqrt(x.size))


def _realised_variance(S0, r, q, T, n_steps, n_paths, seed, dtype, device,
                       **dyn) -> np.ndarray:
    """Host f64 (n_paths,) Σ(ln S_{i+1}/S_i)² / T of one path draw."""
    paths = _mc_paths(S0, r, q, T, int(n_steps), int(n_paths),
                      resolve_seed(seed), canonical(dtype), device=device,
                      **dyn)
    return _logret_sq_sum(paths).cpu().numpy() / T


def varswap_strike_mc(S0: float, r: float, q: float, T: float, *,
                      sigma: Optional[float] = None,
                      heston: Optional[dict] = None,
                      merton: Optional[dict] = None,
                      n_steps: int = 252, n_paths: int = 65_536,
                      antithetic: bool = True,
                      seed: Optional[int] = None,
                      dtype=None, device=None) -> tuple[float, float]:
    """Discretely monitored fair variance, (strike, stderr):
    K_d = (1/T) E[Σᵢ (ln S_{i+1}/S_i)²] over ``n_steps`` fixings, under
    GBM (``sigma=``), Heston QE (``heston=`` dict) or Merton jumps
    (``merton=`` dict: sigma, lam, mJ, sJ)."""
    return _mean_se(_realised_variance(
        S0, r, q, T, n_steps, n_paths, seed, dtype, device, sigma=sigma,
        heston=heston, merton=merton, antithetic=antithetic))


def volswap_strike_mc(S0: float, r: float, q: float, T: float, *,
                      sigma: Optional[float] = None,
                      heston: Optional[dict] = None,
                      merton: Optional[dict] = None,
                      n_steps: int = 252, n_paths: int = 65_536,
                      antithetic: bool = True,
                      seed: Optional[int] = None,
                      dtype=None, device=None) -> tuple[float, float]:
    """Discretely monitored fair volatility strike, (strike, stderr):
    E[√(RV/T)], below √K_var by Jensen's inequality."""
    return _mean_se(np.sqrt(_realised_variance(
        S0, r, q, T, n_steps, n_paths, seed, dtype, device, sigma=sigma,
        heston=heston, merton=merton, antithetic=antithetic)))

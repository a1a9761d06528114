"""Forward-start options and cliquets (ratchets).

Counterpart of ``optpricer_tpu/models/cliquet.py``:

* :func:`forward_start_price` — max(S_T − k·S_{T0}, 0) paid at T: the
  Rubinstein closed form S0·e^{−q·T0}·BS(1, k, T − T0) under GBM, or MC
  under any of the port's dynamics.
* :func:`cliquet_price_bs` — the capped/floored cliquet without a global
  floor under GBM, a sum of forward-start call spreads.
* :func:`cliquet_price_mc` — the general contract (global floor/cap, any
  dynamics), ``(price, stderr)``.

The MC routes share ``varswap._mc_paths``; each path's payoff reduces on
the device in f64 and one (n_paths,) vector comes to the host (the
reference copies the whole path matrix).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from .monte_carlo import resolve_seed
from .varswap import _mc_paths, _mean_se

__all__ = ["forward_start_price", "cliquet_price_bs", "cliquet_price_mc"]


def forward_start_price(S0: float, k: float, T0: float, T: float,
                        r: float, q: float = 0.0, *,
                        kind: str = "call",
                        sigma: Optional[float] = None,
                        heston: Optional[dict] = None,
                        merton: Optional[dict] = None,
                        method: str = "auto", n_steps: int = 64,
                        n_paths: int = 262_144,
                        antithetic: bool = True,
                        seed: Optional[int] = None, dtype=None,
                        device=None):
    """Forward-start option: max(±(S_T − k·S_{T0}), 0) paid at T.

    ``method="closed"`` (GBM only) returns the Rubinstein closed form
    S0·e^{−q·T0}·BS(1, k, T−T0); ``method="mc"`` simulates (T0 must land
    on the step grid); ``"auto"`` picks closed for GBM, MC otherwise. MC
    returns ``(price, stderr)``; the closed form a float.
    """
    if not 0.0 < T0 < T:
        raise ValueError(f"need 0 < T0 < T, got T0={T0}, T={T}")
    if k <= 0.0:
        raise ValueError(f"strike ratio k must be positive, got {k}")
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if method not in ("auto", "closed", "mc"):
        raise ValueError("method must be 'auto', 'closed' or 'mc'")
    if method == "auto":
        method = "closed" if sigma is not None and heston is None \
            and merton is None else "mc"
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    if method == "closed":
        if sigma is None:
            raise ValueError("method='closed' is the GBM Rubinstein "
                             "form; it needs sigma=")
        from ..ops.black_scholes import price_core

        t = lambda a: torch.as_tensor(a, dtype=dt_, device=dev)
        unit = price_core(t(1.0), t(k), t(T - T0), t(r), t(q), t(sigma),
                          torch.as_tensor(kind == "call", device=dev))
        # e^{−rT0}·E[S_{T0}]·BS_unit = S0·e^{−qT0}·BS(1, k, T−T0)
        return float(S0 * np.exp(-q * T0) * float(unit))
    # land T0 exactly on the step grid
    n_steps = int(n_steps)
    i0 = max(1, round(n_steps * T0 / T))
    if abs(i0 * T / n_steps - T0) > 1e-9 * T:
        raise ValueError(f"T0={T0} must land on the {n_steps}-step grid "
                         f"of T={T} (nearest node {i0 * T / n_steps})")
    S = _mc_paths(S0, r, q, T, n_steps, int(n_paths), resolve_seed(seed),
                  dt_, sigma=sigma, heston=heston, merton=merton,
                  antithetic=antithetic, device=dev)
    sign = 1.0 if kind == "call" else -1.0
    pay = torch.clamp(sign * (S[-1].double() - k * S[i0].double()),
                      min=0.0) * np.exp(-r * T)
    return _mean_se(pay.cpu().numpy())


def _period_spread_bs(sigma, dt_period, r, q, local_floor, local_cap):
    """E[min(max(R − 1, f), c)] for one lognormal period return R,
    undiscounted, via the call-spread decomposition f + C(1+f) − C(1+c)
    with C(k) the unit-spot forward Black-Scholes call on the return."""
    from math import erfc, exp, log, sqrt

    def unit_call(k):
        if k <= 0.0:
            # a call struck at or below zero on a positive return is the
            # forward itself minus the strike
            return exp((r - q) * dt_period) - k
        vol = sigma * sqrt(dt_period)
        d1 = (log(1.0 / k) + (r - q + 0.5 * sigma * sigma) * dt_period) \
            / vol
        d2 = d1 - vol
        Phi = lambda x: 0.5 * erfc(-x / sqrt(2.0))
        return exp((r - q) * dt_period) * Phi(d1) - k * Phi(d2)

    return local_floor + unit_call(1.0 + local_floor) \
        - unit_call(1.0 + local_cap)


def cliquet_price_bs(S0: float, T: float, r: float, q: float = 0.0, *,
                     sigma: float, n_periods: int = 12,
                     local_floor: float = 0.0,
                     local_cap: float = 0.08,
                     notional: float = 1.0) -> float:
    """Closed-form GBM cliquet without a global floor: the sum of capped/
    floored period returns decomposes into forward-start call spreads,
    discounted to t=0. Pays notional·Σᵢ min(max(S_{t_i}/S_{t_{i−1}} − 1,
    floor), cap) at T."""
    if local_cap < local_floor:
        raise ValueError("local_cap must be >= local_floor")
    if n_periods < 1 or T <= 0.0:
        raise ValueError("need n_periods >= 1 and T > 0")
    dt_p = T / n_periods
    per = _period_spread_bs(sigma, dt_p, r, q, local_floor, local_cap)
    return float(notional * n_periods * per * np.exp(-r * T))


def _cliquet_payoff(S, steps_per_period, local_floor, local_cap,
                    global_floor, global_cap):
    """(n_paths,) f64 sum of capped/floored period returns of a path
    matrix, with the optional global floor and cap."""
    fix = S[::int(steps_per_period)].double()   # (n_periods+1, n_paths)
    rets = fix[1:] / fix[:-1] - 1.0
    per = torch.clamp(rets, local_floor, local_cap).sum(dim=0)
    if global_floor is not None:
        per = torch.clamp(per, min=global_floor)
    if global_cap is not None:
        per = torch.clamp(per, max=global_cap)
    return per


def cliquet_price_mc(S0: float, T: float, r: float, q: float = 0.0, *,
                     sigma: Optional[float] = None,
                     heston: Optional[dict] = None,
                     merton: Optional[dict] = None,
                     n_periods: int = 12,
                     local_floor: float = 0.0, local_cap: float = 0.08,
                     global_floor: Optional[float] = None,
                     global_cap: Optional[float] = None,
                     notional: float = 1.0,
                     steps_per_period: int = 1,
                     n_paths: int = 262_144, antithetic: bool = True,
                     seed: Optional[int] = None,
                     dtype=None, device=None) -> tuple[float, float]:
    """General cliquet by MC, ``(price, stderr)``: capped/floored period
    returns, optional global floor/cap on the sum, any of the port's
    dynamics; ``steps_per_period`` > 1 refines the path between fixings."""
    if local_cap < local_floor:
        raise ValueError("local_cap must be >= local_floor")
    if n_periods < 1:
        raise ValueError("need n_periods >= 1")
    n_steps = int(n_periods) * int(steps_per_period)
    S = _mc_paths(S0, r, q, T, n_steps, int(n_paths), resolve_seed(seed),
                  canonical(dtype), sigma=sigma, heston=heston,
                  merton=merton, antithetic=antithetic,
                  device=resolve_device(device))
    per = _cliquet_payoff(S, steps_per_period, local_floor, local_cap,
                          global_floor, global_cap)
    return _mean_se((notional * per * np.exp(-r * T)).cpu().numpy())

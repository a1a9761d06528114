"""Model-validation framework (SR 11-7 style independent testing).

Counterpart of ``optpricer_tpu/validation.py``: :func:`cross_validate`,
:func:`convergence_analysis`, :func:`stress_test`,
:func:`backtest_delta_hedge`, every engine run on ``device`` (default
``"cuda"``).

The stress cube's Black-Scholes path is one broadcast over the shock grid;
the delta-hedge backtest marches all paths at once, one step of batched
tensor ops per rebalancing date (the reference's ``lax.scan``), with the
rebalancing decision taken on the host in the paths' dtype, so a date
without a trade launches nothing but the cash accrual.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .core import CALL, OptionSpec
from .dtypes import resolve_device
from .ops.black_scholes import greeks_core, is_call_mask, price_core

__all__ = [
    "cross_validate", "convergence_analysis", "stress_test",
    "backtest_delta_hedge",
]


def cross_validate(opt: OptionSpec, kind: str = CALL, *,
                   methods: Optional[list] = None, mc_paths: int = 100_000,
                   mc_seed: int = 42, tree_N: int = 500, fd_N_S: int = 200,
                   fd_N_t: int = 200, fem_N_S: int = 200,
                   fem_N_t: int = 200, device=None) -> dict:
    """Price with every engine and report the max discrepancy vs BS."""
    if methods is None:
        methods = ["bs", "mc", "tree", "fdm", "fem"]

    results: dict = {}
    if "bs" in methods:
        from .ops.black_scholes import price as bs_price
        results["bs"] = bs_price(opt, kind, device=device)
    if "mc" in methods:
        from .models.monte_carlo import euro_price_mc
        p, se = euro_price_mc(opt, kind, n_paths=mc_paths, seed=mc_seed,
                              return_stderr=True, device=device)
        results["mc"] = (p, se)
    if "tree" in methods:
        from .models.binomial import crr
        results["tree"] = crr(opt, kind, N=tree_N, device=device)
    if "fdm" in methods:
        from .models.pde import fd_price
        results["fdm"] = fd_price(opt, kind, N_S=fd_N_S, N_t=fd_N_t,
                                  device=device)
    if "fem" in methods:
        from .models.fem import fem_price
        results["fem"] = fem_price(opt, kind, N_S=fem_N_S, N_t=fem_N_t,
                                   device=device)

    ref = results.get("bs")
    if ref is not None:
        discs = [abs((v[0] if isinstance(v, tuple) else v) - ref)
                 for k, v in results.items() if k != "bs"]
        results["max_discrepancy"] = max(discs) if discs else 0.0
    else:
        results["max_discrepancy"] = float("nan")
    return results


def convergence_analysis(opt: OptionSpec, kind: str, method: str,
                         param_name: str, param_values, *,
                         reference: Optional[float] = None,
                         device=None) -> dict:
    """Error-vs-refinement sweep with a log-log order estimate."""
    param_values = list(param_values)
    if reference is None:
        from .ops.black_scholes import price as bs_price
        reference = bs_price(opt, kind, device=device)

    prices = []
    for val in param_values:
        val = int(val)
        if method == "mc":
            from .models.monte_carlo import euro_price_mc
            p = euro_price_mc(opt, kind, n_paths=val, seed=42,
                              return_stderr=False, device=device)
        elif method == "tree":
            from .models.binomial import crr
            p = crr(opt, kind, N=val, device=device)
        elif method == "fdm":
            from .models.pde import fd_price
            p = fd_price(opt, kind, N_S=val, N_t=val, device=device)
        elif method == "fem":
            from .models.fem import fem_price
            p = fem_price(opt, kind, N_S=val, N_t=val, device=device)
        else:
            raise ValueError(f"Unknown method: {method}")
        prices.append(float(p))

    errors = [abs(p - reference) for p in prices]
    order = float("nan")
    valid = [(v, e) for v, e in zip(param_values, errors) if e > 0]
    if len(valid) >= 2:
        log_v = np.log([v for v, _ in valid])
        log_e = np.log([e for _, e in valid])
        coeffs = np.polyfit(log_v, log_e, 1)
        order = -float(coeffs[0])

    return {"params": param_values, "prices": prices, "errors": errors,
            "order": order}


def stress_test(opt: OptionSpec, kind: str, spot_shocks, vol_shocks,
                rate_shocks, *, pricer: str = "bs",
                device=None) -> np.ndarray:
    """3-D shock cube: spot multiplicative × vol additive × rate additive.
    The BS pricer is one broadcast over the cube on ``device``; FDM/tree
    price point by point (grid-parameterised engines)."""
    spot_shocks = np.asarray(spot_shocks, dtype=float)
    vol_shocks = np.asarray(vol_shocks, dtype=float)
    rate_shocks = np.asarray(rate_shocks, dtype=float)
    shape = (len(spot_shocks), len(vol_shocks), len(rate_shocks))

    if pricer == "bs":
        dev = resolve_device(device)
        t = lambda v: torch.as_tensor(np.asarray(v, np.float64),
                                      device=dev)
        S = opt.S0 * spot_shocks[:, None, None]
        sig = np.maximum(opt.sigma + vol_shocks[None, :, None], 1e-6)
        r = opt.r + rate_shocks[None, None, :]
        out = price_core(t(S), t(opt.K), t(opt.T), t(r), t(opt.q), t(sig),
                         torch.as_tensor(is_call_mask(kind), device=dev))
        return torch.broadcast_to(out, shape).cpu().numpy()

    if pricer == "fdm":
        from .models.pde import fd_price as _price
    elif pricer == "tree":
        from .models.binomial import crr as _price
    else:
        raise ValueError(f"Unknown pricer: {pricer}")

    result = np.empty(shape)
    for i, ds in enumerate(spot_shocks):
        for j, dv in enumerate(vol_shocks):
            new_sig = max(opt.sigma + dv, 1e-6)
            for k_idx, dr in enumerate(rate_shocks):
                shocked = replace(opt, S0=opt.S0 * ds, sigma=new_sig,
                                  r=opt.r + dr)
                result[i, j, k_idx] = _price(shocked, kind, device=device)
    return result


def _hedge_scan(paths, K, T, r, q, sigma, is_call, V0, delta0, *,
                rebalance_freq: int):
    """P&L of a short option hedged with Δ shares along every path (the
    columns of ``paths``, (n_steps+1, n_paths)): cash accrues e^{r·dt},
    and on every ``rebalance_freq``-th date before expiry the position
    moves to the Black-Scholes delta at the remaining maturity. ``K`` …
    ``delta0`` are 0-d tensors of the paths' dtype on the host; the
    dates' maturities and rebalancing tests are computed there, in that
    dtype, as the reference's scan computes them."""
    dev = paths.device
    on_dev = lambda v: v.to(dev)
    n_steps = paths.shape[0] - 1
    dt = T / n_steps
    K_d, r_d, q_d, sig_d, call_d = (on_dev(v) for v in (K, r, q, sigma,
                                                        is_call))
    growth = on_dev(torch.exp(r * dt))
    cash = torch.full((paths.shape[1],), float(V0 - delta0 * paths[0, 0]
                                               .cpu()),
                      dtype=paths.dtype, device=dev)
    shares = torch.full_like(cash, float(delta0))
    for i in range(1, n_steps + 1):
        S_t = paths[i]
        tau = T - torch.tensor(float(i), dtype=paths.dtype) * dt
        cash = cash * growth
        if bool(tau > 1e-10) and i % rebalance_freq == 0:
            tau_safe = on_dev(torch.clamp(tau, min=1e-10))
            delta_new = greeks_core(S_t, K_d, tau_safe, r_d, q_d, sig_d,
                                    call_d)["delta"]
            cash = cash - (delta_new - shares) * S_t
            shares = delta_new
    S_T = paths[-1]
    payoff = torch.where(call_d, torch.clamp(S_T - K_d, min=0.0),
                         torch.clamp(K_d - S_T, min=0.0))
    return cash + shares * S_T - payoff


def backtest_delta_hedge(opt: OptionSpec, kind: str, paths,
                         rebalance_freq: int = 1, *, pricer: str = "bs",
                         device=None) -> dict:
    """Delta-hedge P&L simulation over pre-generated paths
    (``(n_steps+1, n_paths)``, e.g. ``gbm_paths``): short option, long Δ
    shares, cash accrues e^{r·dt}, rebalance every ``rebalance_freq``
    steps. Runs on ``device``, in the paths' floating dtype."""
    del pricer  # "bs" is the only supported delta model, as in the reference
    from .ops.black_scholes import greeks as bs_greeks
    from .ops.black_scholes import price as bs_price

    dev = resolve_device(device)
    paths = torch.as_tensor(paths, device=dev)
    V0 = bs_price(opt, kind, device=dev)
    delta0 = bs_greeks(opt, kind, device=dev)["delta"]
    host = lambda v: torch.tensor(v, dtype=paths.dtype)
    pnl = _hedge_scan(
        paths, host(opt.K), host(opt.T), host(opt.r), host(opt.q),
        host(opt.sigma), torch.as_tensor(is_call_mask(kind)), host(V0),
        host(delta0), rebalance_freq=int(rebalance_freq))
    pnl = pnl.cpu().numpy()
    return {
        "pnl": pnl,
        "mean_pnl": float(pnl.mean()),
        "std_pnl": float(pnl.std()),
        "max_drawdown": float(pnl.min()),
    }

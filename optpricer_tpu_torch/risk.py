"""Bump-and-reprice risk engine (model-agnostic), AD Greeks and exposure.

Counterpart of ``optpricer_tpu/risk.py``. :func:`numerical_greeks`,
:func:`scenario_grid`, :func:`portfolio_risk`, :func:`var_historical` and
:func:`cvar_historical` take an arbitrary
``pricer_func(S, K, T, r, q, sigma, kind) -> float`` callable, so Greeks
and VaR stay decoupled from the engine. :func:`ad_greeks` differentiates a
torch pricer with ``torch.func.grad``; it casts its inputs to float64
first, where the reference's ``jax.grad`` fails on integer arguments.
:func:`portfolio_risk_fast` and :func:`exposure_profile` run on
``device=`` (default ``"cuda"``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import grad

from .dtypes import canonical, resolve_device
from .ops.black_scholes import (bs_greeks_vec, bs_price_vec, is_call_mask,
                                price_core)

__all__ = [
    "numerical_greeks", "scenario_grid", "portfolio_risk",
    "portfolio_risk_fast", "var_historical", "cvar_historical", "ad_greeks",
    "exposure_profile",
]


def numerical_greeks(pricer_func: Callable[..., float], S, K, T, r, q, sigma,
                     kind: str, *, bump_pct: float = 0.01) -> dict:
    """Central-FD Greeks on an arbitrary pricer: spot bump ``bump_pct·S``
    for Δ/Γ, vol bump ``max(bump_pct·σ, 1e-4)``, forward 1-day theta,
    absolute ``bump_pct`` rate bump for rho."""
    P0 = pricer_func(S, K, T, r, q, sigma, kind)

    eps_S = bump_pct * S
    P_up = pricer_func(S + eps_S, K, T, r, q, sigma, kind)
    P_dn = pricer_func(S - eps_S, K, T, r, q, sigma, kind)
    delta = (P_up - P_dn) / (2.0 * eps_S)
    gamma = (P_up - 2.0 * P0 + P_dn) / (eps_S**2)

    eps_v = max(bump_pct * sigma, 1e-4)
    P_vup = pricer_func(S, K, T, r, q, sigma + eps_v, kind)
    P_vdn = pricer_func(S, K, T, r, q, max(sigma - eps_v, 1e-6), kind)
    vega = (P_vup - P_vdn) / (2.0 * eps_v)

    dt = 1.0 / 365.0
    if T > dt:
        P_t = pricer_func(S, K, T - dt, r, q, sigma, kind)
        theta_val = (P_t - P0) / dt
    else:
        theta_val = 0.0

    eps_r = bump_pct
    P_rup = pricer_func(S, K, T, r + eps_r, q, sigma, kind)
    P_rdn = pricer_func(S, K, T, r - eps_r, q, sigma, kind)
    rho = (P_rup - P_rdn) / (2.0 * eps_r)

    return {
        "delta": float(delta), "gamma": float(gamma), "vega": float(vega),
        "theta": float(theta_val), "rho": float(rho),
    }


def ad_greeks(pricer_core: Callable, S, K, T, r, q, sigma, kind: str, *,
              device=None) -> dict:
    """Exact Greeks by automatic differentiation through a torch pricer
    ``pricer_core(S, K, T, r, q, sigma, is_call) -> 0-d tensor``. Every
    market input is cast to a float64 tensor first, so integer spots and
    strikes differentiate. Theta is −dPrice/dT (calendar decay)."""
    dev = resolve_device(device)
    f64 = lambda v: torch.as_tensor(float(v), dtype=torch.float64,
                                    device=dev)
    S, K, T, r, q, sigma = (f64(v) for v in (S, K, T, r, q, sigma))
    is_call = torch.as_tensor(is_call_mask(kind), device=dev)

    def f(S, sigma, T, r):
        return pricer_core(S, K, T, r, q, sigma, is_call)

    delta = grad(f, argnums=0)(S, sigma, T, r)
    gamma = grad(grad(f, argnums=0), argnums=0)(S, sigma, T, r)
    vega = grad(f, argnums=1)(S, sigma, T, r)
    theta = -grad(f, argnums=2)(S, sigma, T, r)
    rho = grad(f, argnums=3)(S, sigma, T, r)
    return {k: float(v) for k, v in
            dict(delta=delta, gamma=gamma, vega=vega, theta=theta,
                 rho=rho).items()}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scenario_grid(pricer_func: Callable[..., float], S, K, T, r, q, sigma,
                  kind: str, spot_range, vol_range, *,
                  vectorized: bool = False) -> dict:
    """2-D spot×vol price grid. With ``vectorized=True`` the pricer must
    accept array S/sigma (the port's vectorised pricers do) and the grid
    is one broadcast call."""
    spot_range = np.asarray(spot_range, dtype=float)
    vol_range = np.asarray(vol_range, dtype=float)

    if vectorized:
        prices = np.asarray(_host(pricer_func(
            spot_range[:, None], K, T, r, q, vol_range[None, :], kind)),
            dtype=float)
    else:
        prices = np.empty((len(spot_range), len(vol_range)))
        for i, s in enumerate(spot_range):
            for j, v in enumerate(vol_range):
                prices[i, j] = float(pricer_func(float(s), K, T, r, q,
                                                 float(v), kind))
    return {
        "spot_values": spot_range.copy(),
        "vol_values": vol_range.copy(),
        "prices": prices,
    }


def portfolio_risk(instruments: list, pricer_func: Callable[..., float], *,
                   bump_pct: float = 0.01) -> dict:
    """Aggregate portfolio Greeks: per-instrument bump Greeks × signed
    position, summed."""
    totals = {"delta": 0.0, "gamma": 0.0, "vega": 0.0, "theta": 0.0,
              "rho": 0.0}
    total_value = 0.0
    inst_greeks = []

    for inst in instruments:
        pos = inst["position"]
        g = numerical_greeks(
            pricer_func, inst["S"], inst["K"], inst["T"], inst["r"],
            inst["q"], inst["sigma"], inst["kind"], bump_pct=bump_pct)
        price = pricer_func(inst["S"], inst["K"], inst["T"], inst["r"],
                            inst["q"], inst["sigma"], inst["kind"])
        scaled = {k: pos * v for k, v in g.items()}
        for k in totals:
            totals[k] += scaled[k]
        total_value += pos * float(price)
        inst_greeks.append({**scaled, "price": pos * float(price)})

    return {
        "total_delta": totals["delta"],
        "total_gamma": totals["gamma"],
        "total_vega": totals["vega"],
        "total_theta": totals["theta"],
        "total_rho": totals["rho"],
        "total_value": total_value,
        "instrument_greeks": inst_greeks,
    }


def portfolio_risk_fast(instruments: list, *, device=None) -> dict:
    """Whole-book closed-form Black-Scholes Greeks in one vectorised call;
    :func:`portfolio_risk`'s output schema."""
    cols = {c: np.array([float(i[c]) for i in instruments])
            for c in ("S", "K", "T", "r", "q", "sigma", "position")}
    kinds = np.array([i["kind"] for i in instruments])
    args = (cols["S"], cols["K"], cols["T"], cols["r"], cols["q"],
            cols["sigma"], kinds)
    g = bs_greeks_vec(*args, device=device)
    px = _host(bs_price_vec(*args, device=device))
    pos = cols["position"]
    scaled = {k: _host(v) * pos for k, v in g.items()}
    value = px * pos
    inst_greeks = [
        {**{k: float(scaled[k][i]) for k in scaled},
         "price": float(value[i])}
        for i in range(len(instruments))
    ]
    return {
        "total_delta": float(scaled["delta"].sum()),
        "total_gamma": float(scaled["gamma"].sum()),
        "total_vega": float(scaled["vega"].sum()),
        "total_theta": float(scaled["theta"].sum()),
        "total_rho": float(scaled["rho"].sum()),
        "total_value": float(value.sum()),
        "instrument_greeks": inst_greeks,
    }


def _returns(returns) -> torch.Tensor:
    if isinstance(returns, torch.Tensor):
        return returns.to(torch.float64)
    return torch.as_tensor(np.asarray(returns, dtype=np.float64))


def var_historical(returns, confidence: float = 0.99,
                   horizon: int = 1) -> float:
    """Historical VaR at the (1 − confidence) quantile (linear
    interpolation), √horizon-scaled, returned positive."""
    returns = _returns(returns)
    q = torch.quantile(returns, 1.0 - confidence)
    return float(-q * np.sqrt(horizon))


def cvar_historical(returns, confidence: float = 0.99,
                    horizon: int = 1) -> float:
    """Conditional VaR (expected shortfall): mean loss beyond the VaR
    threshold, √horizon-scaled, positive."""
    returns = _returns(returns)
    q = torch.quantile(returns, 1.0 - confidence)
    mask = returns <= q
    n_tail = torch.sum(mask)
    tail_mean = torch.where(
        n_tail > 0, torch.sum(torch.where(mask, returns, 0.0))
        / torch.clamp(n_tail, min=1), q)
    return float(-tail_mean * np.sqrt(horizon))


def _exposure_core(S_paths, t_grid, Ks, Ts, pos, is_call, r, q, sigma):
    """(n_times, n_paths) netted book value V_t along simulated spots: one
    broadcast Black-Scholes evaluation over (time × path × contract);
    expired contracts contribute nothing."""
    tau = torch.clamp(Ts[None, None, :] - t_grid[:, None, None], min=0.0)
    alive = tau > 0.0
    px = price_core(S_paths[:, :, None], Ks[None, None, :],
                    torch.clamp(tau, min=1e-8), r, q, sigma, is_call)
    vals = torch.where(alive, px, 0.0)
    return torch.sum(vals * pos[None, None, :], dim=-1)


def exposure_profile(instruments: list, *, n_paths: int = 65_536,
                     n_times: int = 25, horizon: float | None = None,
                     quantile: float = 0.975, antithetic: bool = True,
                     seed=None, dtype=None, device=None) -> dict:
    """Counterparty exposure profile of a netted vanilla book under GBM:
    simulate the underlying (:func:`~optpricer_tpu_torch.models.processes.
    gbm_paths`), mark the book with one broadcast Black-Scholes call over
    (time × path × contract), and reduce to EE(t) (with stderr), ENE(t),
    PFE(t) at ``quantile`` and EPE."""
    if not instruments:
        raise ValueError("instruments must be a non-empty list")
    if not 0.0 < quantile < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {quantile}")
    from .models.monte_carlo import resolve_seed
    from .models.processes import gbm_paths

    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0 = float(instruments[0]["S"])
    r = float(instruments[0]["r"])
    q = float(instruments[0].get("q", 0.0))
    sigma = float(instruments[0]["sigma"])
    for inst in instruments[1:]:
        for name, ref in (("S", S0), ("r", r), ("q", q), ("sigma", sigma)):
            if abs(float(inst.get(name, 0.0)) - ref) > 1e-12:
                raise ValueError(
                    "exposure_profile nets ONE underlying: all "
                    f"instruments must share {name}")
    Ts = np.asarray([float(i["T"]) for i in instruments])
    T_end = float(horizon) if horizon is not None else float(Ts.max())
    if T_end <= 0.0:
        raise ValueError("horizon must be positive")
    n_steps = int(n_times) - 1
    if n_steps < 1:
        raise ValueError("need n_times >= 2")

    paths = gbm_paths(S0, r, q, sigma, T_end, n_steps, int(n_paths),
                      antithetic=antithetic, seed=resolve_seed(seed),
                      dtype=dt_, device=dev)
    t = lambda v: torch.as_tensor(v, dtype=dt_, device=dev)
    t_grid = torch.linspace(0.0, T_end, n_steps + 1, dtype=torch.float64,
                            device=dev).to(dt_)
    V = _exposure_core(
        paths, t_grid, t([float(i["K"]) for i in instruments]), t(Ts),
        t([float(i["position"]) for i in instruments]),
        torch.as_tensor([i["kind"] == "call" for i in instruments],
                        device=dev),
        t(r), t(q), t(sigma))
    V = V.cpu().numpy().astype(np.float64)
    pos_part = np.maximum(V, 0.0)
    n = V.shape[1]
    ee = pos_part.mean(axis=1)
    t_np = t_grid.cpu().numpy().astype(np.float64)
    return {
        "t": t_np,
        "EE": ee,
        "EE_stderr": pos_part.std(axis=1, ddof=1) / np.sqrt(n),
        "ENE": np.minimum(V, 0.0).mean(axis=1),
        "PFE": np.quantile(pos_part, quantile, axis=1),
        # the trapezoid rule as numpy.trapezoid evaluates it
        "EPE": float((np.diff(t_np) * (ee[1:] + ee[:-1]) / 2.0).sum()
                     / (t_np[-1] - t_np[0])),
        "quantile": float(quantile),
    }

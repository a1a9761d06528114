"""Cox-Ross-Rubinstein binomial lattice.

Counterpart of ``optpricer_tpu/models/binomial.py``: backward induction on
a fixed-width (batch, N+1) value tensor on ``device`` (the valid prefix
shrinks by one node per step; stale tail entries are never read). The JAX
``lax.scan`` over time is a Python loop here, each step a handful of
batched tensor ops. ``crr_vec`` shares one tree across a strike/kind batch.

Node prices are computed in log space: S(k, j) = S0·exp(σ√dt·(2j−k)),
which avoids the u**j overflow of repeated powers and is exact for CRR
(u = 1/d).

``american_implied_vol`` inverts the American lattice (or the
Bjerksund-Stensland closed form) by 48 bisections over a whole chain at
once: one ``_crr_sigma_batch`` pass per bisection, the bracket updated with
``torch.where``, and no host synchronisation until the answer.
"""
from __future__ import annotations

from math import exp, sqrt
from typing import Literal

import numpy as np
import torch

from ..core import CALL, OptionSpec
from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import is_call_mask

__all__ = ["crr", "crr_vec", "american_implied_vol"]


def _tree_params(T: float, r: float, q: float, sigma: float, N: int):
    """Host-side tree parameters + validity check."""
    if N <= 0:
        raise ValueError("N must be positive.")
    dt = T / N
    u = exp(sigma * sqrt(dt))
    d = 1.0 / u
    disc = exp(-r * dt)
    p = (exp((r - q) * dt) - d) / (u - d)
    if not (0.0 < p < 1.0):
        raise ValueError(
            "Risk-neutral prob p out of (0,1); try larger N or different params.")
    return dt, u, d, disc, p


def _crr_core(S0, K, sig_sqrt_dt, disc, p, is_call, ex_levels=None, *,
              N: int, american: bool):
    """Backward induction over a (batch, N+1) value tensor.

    ``K`` and ``is_call`` are (batch,) tensors, the tree constants scalar
    tensors of the working dtype. ``ex_levels`` ((N,) bools, indexed by
    tree level k = N−1 … 0 in loop order) restricts the exercise
    projection to the marked levels — Bermudan induction.
    """
    j = torch.arange(N + 1, dtype=K.dtype, device=K.device)

    def payoff(S_nodes):
        call_pay = torch.clamp(S_nodes[None, :] - K[:, None], min=0.0)
        put_pay = torch.clamp(K[:, None] - S_nodes[None, :], min=0.0)
        return torch.where(is_call[:, None], call_pay, put_pay)

    V = payoff(S0 * torch.exp(sig_sqrt_dt * (2.0 * j - N)))
    zero_col = torch.zeros_like(V[:, :1])
    for i, k in enumerate(range(N - 1, -1, -1)):
        cont = disc * (p * V[:, 1:] + (1.0 - p) * V[:, :-1])
        V = torch.cat([cont, zero_col], dim=1)
        if american or (ex_levels is not None and ex_levels[i]):
            S_k = S0 * torch.exp(sig_sqrt_dt * (2.0 * j - float(k)))
            V = torch.maximum(V, payoff(S_k))
    return V[:, 0]


def _scalars(dtype, device, *values):
    return tuple(torch.tensor(v, dtype=dtype, device=device) for v in values)


def crr(opt: OptionSpec, kind: Literal["call", "put"] = CALL, N: int = 500,
        *, american: bool = False, exercise_dates=None, dtype=None,
        device=None) -> float:
    """Scalar CRR price, European or American.

    ``exercise_dates=[t_1, …]`` prices a BERMUDAN: exercise only at the
    listed dates (snapped to the nearest tree level; maturity is the
    terminal payoff). Mutually exclusive with ``american=True``.
    """
    if exercise_dates is not None and american:
        raise ValueError("exercise_dates (Bermudan) and american=True "
                         "are mutually exclusive")
    dt_, u, d, disc, p = _tree_params(opt.T, opt.r, opt.q, opt.sigma, N)
    dt = canonical(dtype)
    dev = resolve_device(device)
    sig_sqrt_dt = opt.sigma * sqrt(opt.T / N)
    ex_levels = None
    if exercise_dates is not None:
        lv = {int(round(float(t) / dt_)) for t in exercise_dates}
        lv = {m for m in lv if 1 <= m <= N - 1}
        ex_levels = [(N - 1 - i) in lv for i in range(N)]
    S0_t, ssd_t, disc_t, p_t = _scalars(dt, dev, opt.S0, sig_sqrt_dt, disc, p)
    out = _crr_core(
        S0_t, torch.tensor([opt.K], dtype=dt, device=dev), ssd_t, disc_t, p_t,
        torch.as_tensor(is_call_mask(kind), device=dev).reshape(1),
        ex_levels, N=int(N), american=bool(american))
    return float(out[0])


def crr_vec(S0: float, K, T: float, r: float, q: float, sigma: float,
            kind, N: int = 500, *, american: bool = False, dtype=None,
            device=None) -> torch.Tensor:
    """Batch CRR: one tree for (S0, T, r, q, sigma), every (K, kind) priced
    in a single backward pass. Returns prices with the shape of ``K``."""
    K_arr = np.atleast_1d(np.asarray(K, dtype=float))
    kind_mask = np.atleast_1d(is_call_mask(kind))
    if kind_mask.shape != K_arr.shape:
        kind_mask = np.broadcast_to(kind_mask, K_arr.shape)

    dt_, u, d, disc, p = _tree_params(T, r, q, sigma, N)
    dt = canonical(dtype)
    dev = resolve_device(device)
    sig_sqrt_dt = sigma * sqrt(T / N)
    S0_t, ssd_t, disc_t, p_t = _scalars(dt, dev, S0, sig_sqrt_dt, disc, p)
    out = _crr_core(
        S0_t, torch.as_tensor(K_arr.ravel(), dtype=dt, device=dev), ssd_t,
        disc_t, p_t,
        torch.as_tensor(np.ascontiguousarray(kind_mask).ravel(), device=dev),
        N=int(N), american=bool(american))
    return out.reshape(np.shape(K_arr))


def _crr_sigma_batch(S0, K, T, r, q, sigma, is_call, *, N: int,
                     american: bool):
    """CRR prices for a batch where EVERY entry carries its own σ (the
    inverse-pricing workhorse): per-entry tree constants broadcast against
    the node axis, the same backward induction as ``_crr_core``."""
    dt = T / N
    ssd = sigma * torch.sqrt(dt)                     # (batch,)
    u = torch.exp(ssd)
    d = 1.0 / u
    a = torch.exp((r - q) * dt)
    p = torch.clamp((a - d) / torch.clamp(u - d, min=1e-12), 0.0,
                    1.0)[:, None]
    disc = torch.exp(-r * dt)
    j = torch.arange(N + 1, dtype=sigma.dtype, device=sigma.device)

    def payoff(S_nodes):
        pay_c = torch.clamp(S_nodes - K[:, None], min=0.0)
        pay_p = torch.clamp(K[:, None] - S_nodes, min=0.0)
        return torch.where(is_call[:, None], pay_c, pay_p)

    V = payoff(S0 * torch.exp(ssd[:, None] * (2.0 * j - N)[None, :]))
    zero_col = torch.zeros_like(V[:, :1])
    for k in range(N - 1, -1, -1):
        cont = disc * (p * V[:, 1:] + (1.0 - p) * V[:, :-1])
        V = torch.cat([cont, zero_col], dim=1)
        if american:
            S_k = S0 * torch.exp(ssd[:, None] * (2.0 * j - float(k))[None, :])
            V = torch.maximum(V, payoff(S_k))
    return V[:, 0]


def _amer_iv_bisect(target, S0, K, T, r, q, is_call, lo, hi, *, N: int,
                    n_iter: int = 48):
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        px = _crr_sigma_batch(S0, K, T, r, q, mid, is_call, N=N,
                              american=True)
        too_low = px < target
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def _amer_iv_bisect_bs2002(target, S0, K, T, r, q, is_call, lo, hi, *,
                           n_iter: int = 48):
    """σ-bisection through the Bjerksund-Stensland 2002 closed form — the
    O(1) inverse (no lattice in the loop); the BS2002 price is monotone ↑
    in σ like the lattice price, so the same bracket logic applies."""
    from .american_analytic import _bs2002_price

    S0, K, T, r, q, is_call = torch.broadcast_tensors(S0, K, T, r, q,
                                                      is_call)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        px = _bs2002_price(S0, K, T, r, q, mid, is_call)
        too_low = px < target
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def american_implied_vol(price, S0: float, K, T: float, r: float,
                         q: float = 0.0, kind="put", *, N: int = 500,
                         sigma_lo: float = 1e-3, sigma_hi: float = 5.0,
                         engine: str = "crr", dtype=None, device=None):
    """DE-AMERICANISATION: implied vol from American option prices.

    Inverts the CRR lattice by 48 bisections, each pricing the WHOLE chain
    in one per-entry-σ batched tree (``_crr_sigma_batch``); on the card the
    bracket lives on the device and the host waits only for the answer.
    ``engine="bs2002"`` inverts the Bjerksund-Stensland closed form
    instead (no lattice in the loop).

    Entries whose price is at or below intrinsic (σ unidentifiable) or at
    or above the no-arbitrage cap come back NaN, as in
    ``bs_implied_vol_vec``. Scalar in → float out; else a float64 numpy
    array.
    """
    if engine not in ("crr", "bs2002"):
        raise ValueError("engine must be 'crr' or 'bs2002'")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    price_arr = np.atleast_1d(np.asarray(price, np.float64))
    K_arr = np.atleast_1d(np.asarray(K, np.float64))
    kind_mask = np.broadcast_to(np.atleast_1d(is_call_mask(kind)),
                                np.broadcast_shapes(price_arr.shape,
                                                    K_arr.shape))
    price_arr, K_arr = np.broadcast_arrays(
        price_arr, np.broadcast_to(K_arr, kind_mask.shape))
    intrinsic = np.where(kind_mask, np.maximum(S0 - K_arr, 0.0),
                         np.maximum(K_arr - S0, 0.0))
    cap = np.where(kind_mask, S0, K_arr)

    t = lambda v: torch.as_tensor(np.array(v, np.float64), dtype=dt_,
                                  device=dev)
    args = (t(price_arr), t(S0), t(K_arr), t(T), t(r), t(q),
            torch.as_tensor(np.array(kind_mask, bool), device=dev),
            t(np.full(price_arr.shape, sigma_lo)),
            t(np.full(price_arr.shape, sigma_hi)))
    if engine == "bs2002":
        iv = _amer_iv_bisect_bs2002(*args)
    else:
        iv = _amer_iv_bisect(*args, N=int(N))
    iv = iv.cpu().numpy().astype(np.float64)
    bad = (price_arr <= intrinsic + 1e-12) | (price_arr >= cap)
    iv = np.where(bad, np.nan, iv)
    return iv if np.ndim(price) or np.ndim(K) else float(iv[0])

"""Cox-Ross-Rubinstein binomial lattice.

Counterpart of ``optpricer_tpu/models/binomial.py``: backward induction on
a fixed-width (batch, N+1) value tensor on ``device`` (the valid prefix
shrinks by one node per step; stale tail entries are never read). The JAX
``lax.scan`` over time is a Python loop here, each step a handful of
batched tensor ops. ``crr_vec`` shares one tree across a strike/kind batch.

Node prices are computed in log space: S(k, j) = S0·exp(σ√dt·(2j−k)),
which avoids the u**j overflow of repeated powers and is exact for CRR
(u = 1/d).

``american_implied_vol`` waits for ``american_analytic`` (ROADMAP A.6).
"""
from __future__ import annotations

from math import exp, sqrt
from typing import Literal

import numpy as np
import torch

from ..core import CALL, OptionSpec
from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import is_call_mask

__all__ = ["crr", "crr_vec"]


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

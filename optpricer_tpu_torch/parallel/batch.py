"""Batch-axis data parallelism: shard option books across the mesh.

Counterpart of ``optpricer_tpu/parallel/batch.py``. The batch axis is laid
out across a :class:`~optpricer_tpu_torch.parallel.mesh.Mesh`: the book is
padded to a multiple of the mesh size (repeating its last row), each
device prices its contiguous shard with the same code, every shard is
launched before any is read back, and the shards are gathered in mesh
order and unpadded. There is no reduction. Every pricer returns a host
numpy array (a dict of them for the Greeks), as the reference's do.
"""
from __future__ import annotations

from math import sqrt

import numpy as np
import torch

from ..dtypes import canonical
from ..ops.black_scholes import greeks_core, is_call_mask, price_core
from .mesh import Mesh, shard_ranges

__all__ = ["bs_price_sharded", "bs_greeks_sharded", "crr_vec_sharded",
           "fd_batch_sharded"]


def _pad(arr: np.ndarray, n_dev: int):
    B = arr.shape[0]
    padded = -(-B // n_dev) * n_dev
    if padded != B:
        arr = np.concatenate([arr, np.repeat(arr[-1:], padded - B, axis=0)])
    return arr, B


def _shards(mesh: Mesh, n: int):
    """[(device, slice)] of a padded batch of ``n`` rows."""
    devices = mesh.device_list
    return [(dev, slice(lo, hi))
            for dev, (lo, hi) in zip(devices, shard_ranges(n, len(devices)))]


def _gather(parts) -> np.ndarray:
    return np.concatenate([p.detach().cpu().numpy() for p in parts])


def _prep_batch(mesh: Mesh, S, K, T, r, q, sigma, kind):
    mask = np.atleast_1d(is_call_mask(kind))
    cols = [np.atleast_1d(np.asarray(v, dtype=float))
            for v in (S, K, T, r, q, sigma)]
    B = max(max(c.shape[0] for c in cols), mask.shape[0])
    cols = [np.broadcast_to(c, (B,)).copy() for c in cols]
    mask = np.broadcast_to(mask, (B,)).copy()
    n_dev = mesh.devices.size
    cols = [_pad(c, n_dev)[0] for c in cols]
    mask = _pad(mask, n_dev)[0]
    return cols + [mask], B


def _bs_sharded(core, mesh, S, K, T, r, q, sigma, kind, dtype):
    dt = canonical(dtype)
    cols, B = _prep_batch(mesh, S, K, T, r, q, sigma, kind)
    args = [[torch.as_tensor(c[sl], dtype=dt, device=dev) for c in cols[:6]]
            + [torch.as_tensor(cols[6][sl], device=dev)]
            for dev, sl in _shards(mesh, cols[0].shape[0])]
    return [core(*a) for a in args], B


def bs_price_sharded(mesh: Mesh, S, K, T, r, q, sigma, kind, *, dtype=None):
    """Black-Scholes prices with the batch axis sharded over ``mesh``."""
    parts, B = _bs_sharded(price_core, mesh, S, K, T, r, q, sigma, kind,
                           dtype)
    return _gather(parts)[:B]


def bs_greeks_sharded(mesh: Mesh, S, K, T, r, q, sigma, kind, *, dtype=None):
    """Greeks dict with the batch axis sharded over ``mesh``."""
    parts, B = _bs_sharded(greeks_core, mesh, S, K, T, r, q, sigma, kind,
                           dtype)
    return {k: _gather([p[k] for p in parts])[:B] for k in parts[0]}


def _ladder(mesh: Mesh, K, kind):
    K_arr = np.atleast_1d(np.asarray(K, dtype=float))
    mask = np.broadcast_to(np.atleast_1d(is_call_mask(kind)),
                           K_arr.shape).copy()
    n_dev = mesh.devices.size
    K_pad, B = _pad(K_arr, n_dev)
    mask_pad, _ = _pad(mask, n_dev)
    return K_pad, mask_pad, B


def crr_vec_sharded(mesh: Mesh, S0, K, T, r, q, sigma, kind, N: int = 500,
                    *, american: bool = False, dtype=None):
    """CRR strike/kind batch sharded over the mesh: one tree per device
    shard, no communication."""
    from ..models.binomial import _crr_core, _tree_params

    dt = canonical(dtype)
    _, u, d, disc, p = _tree_params(T, r, q, sigma, N)
    K_pad, mask_pad, B = _ladder(mesh, K, kind)
    parts = []
    for dev, sl in _shards(mesh, K_pad.shape[0]):
        def s(v, dev=dev):
            return torch.tensor(v, dtype=dt, device=dev)

        parts.append(_crr_core(
            s(S0), torch.as_tensor(K_pad[sl], dtype=dt, device=dev),
            s(sigma * sqrt(T / N)), s(disc), s(p),
            torch.as_tensor(mask_pad[sl], device=dev), N=int(N),
            american=bool(american)))
    return _gather(parts)[:B]


def fd_batch_sharded(mesh: Mesh, S0, K, T, r, q, sigma, kind, *,
                     N_S: int = 200, N_t: int = 200, theta: float = 0.5,
                     S_max_mult: float = 4.0, american: bool = False,
                     dtype=None):
    """θ-scheme strike ladder with the batch axis sharded over the mesh.

    Every device marches the same grid and propagator (replicated, small)
    on its shard of strikes; each shard is read out at ln(S0) by linear
    interpolation on the host in float64 (``pde._readout``). On the card
    each per-step solve is the tridiagonal kernel K7."""
    from ..models.pde import _build_grid, _fd_solve, _readout

    dt_ = canonical(dtype)
    K_pad, mask_pad, B = _ladder(mesh, K, kind)
    x_np, dx, dt = _build_grid(S0, T, sigma, N_S, N_t, S_max_mult)
    marches = []
    for dev, sl in _shards(mesh, K_pad.shape[0]):
        def s(v, dev=dev):
            return torch.as_tensor(v, dtype=dt_, device=dev)

        V, _ = _fd_solve(
            x_grid=s(x_np), dt=s(dt), K=s(K_pad[sl]), r=s(r), q=s(q),
            sigma=s(sigma), is_call=torch.as_tensor(mask_pad[sl],
                                                     device=dev),
            theta=s(theta), barrier_mask=None, barrier_value=0.0,
            N_t=int(N_t), american=bool(american), two_layers=False)
        marches.append(V)
    return np.concatenate([_readout(x_np, V, S0) for V in marches])[:B]

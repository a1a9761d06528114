"""Sobol direction numbers and the Brownian-bridge map of the path-QMC kernel.

Counterpart of ``optpricer_tpu/ops/sobol.py`` (``direction_numbers``,
``brownian_bridge_order``) and of
``optpricer_tpu/ops/pallas_qmc_path.py:bridge_matrix``, the host halves of
the path-QMC kernel (``ops/qmc_path.py``). All three are host numpy, built
once per shape:

* ``direction_numbers`` reads scipy's 64-bit Joe-Kuo table truncated to 32
  bits, or, where scipy's private initialiser is missing, torch's 30-bit
  ``SobolEngine.sobolstate``, as the reference chooses; the two agree on
  their shared 30 bits;
* ``brownian_bridge_order`` is the breadth-first midpoint schedule;
* ``bridge_matrix`` unrolls that schedule into the (d, d) matrix A with
  ``W = z @ A``.

``sobol_uniforms`` and ``bridge_paths`` are the torch counterparts of the
reference's functions of those names, the stages of the float64 path-QMC
route (``models/mc_fused._qmc_replicate``): the digitally shifted point
set and the breadth-first bridge fill, on the points' device.
"""
from __future__ import annotations

import collections

import numpy as np

__all__ = ["direction_numbers", "brownian_bridge_order", "bridge_matrix",
           "sobol_uniforms", "bridge_paths"]

_DIR_CACHE: dict = {}
_MAXBIT = 32        # uint32 Gray-code word: 2^32 points per replicate
_TORCH_MAXBIT = 30  # precision of torch's SobolEngine table


def direction_numbers(d: int, m_bits: int = 21) -> np.ndarray:
    """(m_bits, d) uint32 Sobol direction numbers, scaled to 2^-32."""
    key = (int(d), int(m_bits))
    if key in _DIR_CACHE:
        return _DIR_CACHE[key]
    if m_bits > _MAXBIT:
        raise ValueError(f"m_bits={m_bits} exceeds the generators' uint32 "
                         f"precision ({_MAXBIT} bits => 2^{_MAXBIT} points)")
    out = _direction_numbers_scipy(d, m_bits)
    if out is None:
        out = _direction_numbers_torch(d, m_bits)
    _DIR_CACHE[key] = out
    return out


def _direction_numbers_scipy(d: int, m_bits: int):
    """The table from scipy's Joe-Kuo data, or None without its private
    initialiser."""
    try:
        from scipy.stats._sobol import _initialize_v
    except ImportError:
        return None
    v = np.zeros((d, _MAXBIT), dtype=np.uint64)
    _initialize_v(v, d, _MAXBIT)
    return v.T[:m_bits].astype(np.uint32)


def _direction_numbers_torch(d: int, m_bits: int) -> np.ndarray:
    """The 30-bit table from torch's initialised ``sobolstate``."""
    if m_bits > _TORCH_MAXBIT:
        raise ValueError(f"m_bits={m_bits} exceeds the Joe-Kuo table "
                         f"precision ({_TORCH_MAXBIT} bits) of torch's "
                         "SobolEngine")
    import torch

    eng = torch.quasirandom.SobolEngine(d, scramble=False)
    st = eng.sobolstate.numpy().astype(np.uint64)       # (d, 30)
    return (st.T[:m_bits] << np.uint64(32 - _TORCH_MAXBIT)).astype(np.uint32)


def brownian_bridge_order(d: int):
    """``(m, l, r, depth)`` int32 arrays of length d−1: dimension j+1 of the
    point set fills time index ``m[j]`` (1..d) from the already-built
    neighbours ``l[j]`` (0 is the origin) and ``r[j]``, breadth first;
    dimension 0 builds the terminal point d."""
    ms, ls, rs, ds = [], [], [], []
    todo = collections.deque([(0, d, 0)])
    while todo:
        lo, hi, lev = todo.popleft()
        if hi - lo < 2:
            continue
        mid = (lo + hi) // 2
        ms.append(mid)
        ls.append(lo)
        rs.append(hi)
        ds.append(lev)
        todo.append((lo, mid, lev + 1))
        todo.append((mid, hi, lev + 1))
    return (np.array(ms, np.int32), np.array(ls, np.int32),
            np.array(rs, np.int32), np.array(ds, np.int32))


def bridge_matrix(d: int, T: float) -> np.ndarray:
    """(d, d) f64 matrix A with ``W = z @ A``: row k holds the coefficient
    of z[:, k] in each W_t, column t−1 the time t·T/d."""
    ms, ls, rs, _ = brownian_bridge_order(d)
    dt = T / d
    C = np.zeros((d + 1, d))       # C[t] = coefficients of W_t over z
    C[d, 0] = np.sqrt(T)
    for j in range(len(ms)):
        m, l, r = int(ms[j]), int(ls[j]), int(rs[j])
        frac = (m - l) / (r - l)
        sd = np.sqrt((m - l) * (r - m) / (r - l) * dt)
        C[m] = C[l] + frac * (C[r] - C[l])
        C[m, 1 + j] += sd
    return C[1:].T


def sobol_uniforms(n: int, d: int, seed: int, index: int, *,
                   m_bits: int | None = None, dtype=None, device=None):
    """(n, d) digitally shifted Sobol uniforms in (0, 1): the reference's
    ``sobol_uniforms(n, d, fold_in(key(seed), index))``, the shift words
    ``jax_fold_in_bits(seed, index, d)``. ``m_bits`` defaults to the
    budget (≥ 2^11 so small point sets nest in the big ones). float64:
    (bits + ½)·2⁻³²; float32: the top 24 bits, cell-centred."""
    import torch

    from .swprng import jax_fold_in_bits

    dtype = torch.float64 if dtype is None else dtype
    if m_bits is None:
        m_bits = min(max(int(np.ceil(np.log2(max(n, 2)))), 11), _MAXBIT)
    if n > (1 << m_bits):
        raise ValueError(f"n={n} exceeds 2^m_bits={1 << m_bits} points")
    V = torch.as_tensor(direction_numbers(d, m_bits).astype(np.int64),
                        device=device)
    shift = torch.as_tensor(
        jax_fold_in_bits(seed, index, d).astype(np.int64), device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    gray = idx ^ (idx >> 1)
    x = torch.zeros((n, d), dtype=torch.int64, device=device)
    for k in range(m_bits):
        x = x ^ (((gray >> k) & 1)[:, None] * V[k][None, :])
    x = x ^ shift[None, :]
    if dtype == torch.float64:
        return (x.to(torch.float64) + 0.5) * (2.0 ** -32)
    return ((x >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def bridge_paths(z, T):
    """Brownian paths (n, d) at times (1..d)·T/d from quasi-normals z
    (n, d): z[:, 0] builds W_T, z[:, j] the j-th bridge midpoint, one
    breadth-first depth at a time (a gather, the conditional-Gaussian fill
    and a scatter), as the reference fills them."""
    import torch

    n, d = z.shape
    T = torch.as_tensor(T, dtype=z.dtype, device=z.device)
    dt = T / d
    ms, ls, rs, depth = brownian_bridge_order(d)
    W = torch.zeros((n, d + 1), dtype=z.dtype, device=z.device)
    W[:, d] = torch.sqrt(T) * z[:, 0]
    for lev in range(int(depth.max()) + 1 if len(depth) else 0):
        sel = np.nonzero(depth == lev)[0]
        m, l, r = ms[sel], ls[sel], rs[sel]
        wl, wr = W[:, l], W[:, r]
        frac = torch.as_tensor((m - l) / (r - l), dtype=z.dtype,
                               device=z.device)
        sd = torch.sqrt(torch.as_tensor((m - l) * (r - m) / (r - l),
                                        dtype=z.dtype, device=z.device) * dt)
        W[:, m] = wl + frac[None, :] * (wr - wl) \
            + sd[None, :] * z[:, 1 + sel]
    return W[:, 1:]

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
"""
from __future__ import annotations

import collections

import numpy as np

__all__ = ["direction_numbers", "brownian_bridge_order", "bridge_matrix"]

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

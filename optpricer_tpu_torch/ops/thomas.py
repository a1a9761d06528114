"""Batched Thomas solve, one system per thread (K7).

Counterpart of ``optpricer_tpu/ops/pallas_tridiag.py``. The PDE stack
solves a tridiagonal system per time step wherever the propagator does not
apply (local vol, PSOR's warm start, the per-step solvers) and builds its
propagator from M solves; on the card each of those is one launch of
``thomas_kernel`` (``csrc/thomas.cu``).

Names, JAX → port:

================================  ================================
``tridiag_solve_pallas``          ``tridiag_solve_kernel``
``tridiag_solve_pallas_lastdim``  ``tridiag_solve_kernel_lastdim``
``_thomas_kernel``                ``thomas_kernel`` (CUDA)
================================  ================================

Layout: the kernel works on ``(n, batch)`` — the system index leads, so a
warp's loads of one row are coalesced. ``a``, ``b`` and ``c`` are either
``(n, batch)`` or ``(n, 1)``: a column shared by every system is read with
a batch stride of 0, so the PDE stack's coefficients, one row vector per
step, are never expanded to the batch. There is no padding: the 8-row and
128-lane granularity is a TPU layout rule. ``a[0]`` and ``c[n−1]`` are
treated as 0 whatever they hold.

The arithmetic is the Pallas kernel's: forward elimination
c'_i = c_i / (b_i − a_i c'_{i−1}), d'_i = (d_i − a_i d'_{i−1}) /
(b_i − a_i c'_{i−1}) — two divisions per row — then x_i = d'_i − c'_i
x_{i+1}. ``_thomas_plain`` is the same loop in torch: the CPU path of the
wrappers and the kernel's reference on the card.

``tridiag_solve_kernel`` launches the kernel for tensors on a CUDA device
and counts the launch in ``tridiag_solve_kernel.launches``; for tensors on
the CPU it runs ``_thomas_plain``. Any other device raises.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .terminal_mc import _stream

__all__ = ["tridiag_solve_kernel", "tridiag_solve_kernel_lastdim"]

_DTYPES = {torch.float32: 0, torch.float64: 1}


def _thomas_plain(a, b, c, d):
    """Thomas solve along axis 0, broadcast over the trailing axes, in the
    kernel's arithmetic. Returns a new tensor of d's broadcast shape."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    n = d.shape[0]
    cp = torch.empty_like(d)
    x = torch.empty_like(d)              # holds d' until the back sweep
    cp[0] = c[0] / b[0]                  # a[0] unused
    x[0] = d[0] / b[0]
    for i in range(1, n):
        denom = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / denom
        x[i] = (d[i] - a[i] * x[i - 1]) / denom
    for i in range(n - 2, -1, -1):       # c[n−1] unused
        x[i] = x[i] - cp[i] * x[i + 1]
    return x


def _check(a, b, c, d):
    if d.dim() != 2:
        raise ValueError(f"d must be (n, batch), got shape {tuple(d.shape)}")
    n, batch = d.shape
    if d.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {d.dtype}")
    for name, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        if t.dtype != d.dtype or t.device != d.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, d is "
                             f"{d.dtype} on {d.device}")
        if t.dim() != 2 or t.shape[0] != n or t.shape[1] not in (1, batch):
            raise ValueError(f"{name} must be ({n}, {batch}) or ({n}, 1), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")


def tridiag_solve_kernel(a, b, c, d) -> torch.Tensor:
    """Solve T x = d for ``batch`` systems laid out as (n, batch).

    Kernel ``thomas_kernel`` in ``csrc/thomas.cu``; it replaces
    ``optpricer_tpu/ops/pallas_tridiag.py:_thomas_kernel`` (launched from
    ``tridiag_solve_pallas``). ``a``, ``b``, ``c`` are (n, batch) or (n, 1)
    (one column for every system); ``a[0]`` and ``c[n−1]`` are unused.
    """
    _check(a, b, c, d)
    if d.device.type == "cpu":
        return _thomas_plain(a, b, c, d)
    n, batch = d.shape
    x = torch.empty_like(d)
    cp = torch.empty_like(d)
    lib = _build.load()
    # element (i, j) of each operand at i·row + j·col
    strides = [(t.shape[1], 1) if t.shape[1] == batch and batch > 1
               else (1, 0) for t in (a, b, c)]
    with torch.cuda.device(d.device):
        err = lib.optpricer_thomas(
            a.data_ptr(), *strides[0], b.data_ptr(), *strides[1],
            c.data_ptr(), *strides[2], d.data_ptr(), x.data_ptr(),
            cp.data_ptr(), n, batch, _DTYPES[d.dtype], _stream(d.device))
    if err != 0:
        raise RuntimeError(f"thomas_kernel launch failed: CUDA error {err}")
    tridiag_solve_kernel.launches += 1
    return x


tridiag_solve_kernel.launches = 0


def _column(t, shape, n: int, batch: int) -> torch.Tensor:
    """(n, 1) if ``t`` is one vector shared by every system, else the
    (n, batch) transpose of its broadcast."""
    full = t.expand(shape)
    if all(s == 0 for s in full.stride()[:-1]):
        return full[(0,) * (len(shape) - 1)].reshape(n, 1).contiguous()
    return full.reshape(batch, n).t().contiguous()


def tridiag_solve_kernel_lastdim(a, b, c, d) -> torch.Tensor:
    """Solve along the LAST axis with any leading batch axes, the layout of
    the PDE stack's systems (``(..., n)``, as
    :func:`~optpricer_tpu_torch.ops.tridiag.tridiag_solve`). ``a``, ``b``,
    ``c`` broadcast against ``d``; a coefficient that is one row for every
    system stays one column. ``d`` is transposed once to (n, batch) and the
    solution back; nothing is padded."""
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape, d.shape)
    n = shape[-1]
    batch = math.prod(shape[:-1])
    A, B, C = (_column(t, shape, n, batch) for t in (a, b, c))
    D = d.expand(shape).reshape(batch, n).t().contiguous()
    x = tridiag_solve_kernel(A, B, C, D)
    return x.t().reshape(shape)

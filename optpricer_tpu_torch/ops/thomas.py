"""Batched tridiagonal solve by parallel cyclic reduction (K7).

Counterpart of ``optpricer_tpu/ops/pallas_tridiag.py``. The PDE stack
solves a tridiagonal system per time step wherever the propagator does not
apply (local vol, PSOR's warm start, the per-step solvers) and builds its
propagator from M solves; on the card each of those is one launch of K7
(``csrc/thomas.cu``).

Names, JAX → port:

================================  ====================================
``tridiag_solve_pallas``          ``tridiag_solve_kernel``
``tridiag_solve_pallas_lastdim``  ``tridiag_solve_kernel_lastdim``
``_thomas_kernel``                ``tridiag_pcr_kernel``,
                                  ``tridiag_partition_kernel`` (CUDA)
================================  ====================================

The kernel computes what the Pallas kernel computes, the solution of
T x = d with ``a[0]`` and ``c[n−1]`` never read, but gives each system a
block of threads instead of one lane: for n ≤ ``PCR_MAX_ROWS`` one thread
a row, each row normalised by its diagonal and then ⌈log₂ n⌉ levels of
cyclic reduction in shared memory; for larger n ``PART_THREADS`` threads
that each eliminate a chunk of rows down to its two end unknowns, a
cyclic reduction of those 2·``PART_THREADS`` unknowns, and a substitution
back into the chunks. What bounds it is the bytes (a, b, c, d read once,
x written once) for a batch of systems, and the levels' latency plus the
launch for a single system (the per-step solve of a local-vol march).

Layout: every operand is addressed by a row stride and a system stride,
so the PDE stack's ``(..., n)`` rows go in and come out as they are
(``tridiag_solve_kernel_lastdim``), ``(n, batch)`` columns as well
(``tridiag_solve_kernel``), and a coefficient shared by every system is
read with a system stride of 0. Nothing is transposed, padded or copied.

Plain versions: ``_thomas_plain`` is the Pallas kernel's Thomas
elimination in torch (two divisions per forward row), the CPU path of the
wrappers and the kernel's reference on the card. ``_pcr_plain`` repeats
the kernel's own arithmetic (the same normalisation, levels and chunks) so
that the CPU tests can hold the algorithm against the JAX kernel; no
entry point calls it.

``tridiag_solve_kernel`` and ``tridiag_solve_kernel_lastdim`` launch the
kernel for tensors on a CUDA device and count each launch in
``tridiag_solve_kernel.launches``, and by (n, batch) in
``tridiag_solve_kernel.launches_by_shape``; for tensors on the CPU they run
``_thomas_plain``. Any other device raises.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from .. import _build
from .terminal_mc import _stream

__all__ = ["tridiag_solve_kernel", "tridiag_solve_kernel_lastdim"]

_DTYPES = {torch.float32: 0, torch.float64: 1}
PCR_MAX_ROWS = 1024     # csrc/thomas.cu: one thread a row up to this n
PART_THREADS = 512      # csrc/thomas.cu: threads (chunks) a system above it


def _thomas_plain(a, b, c, d):
    """Thomas solve along axis 0, broadcast over the trailing axes, in the
    Pallas kernel's arithmetic. Returns a new tensor of d's broadcast
    shape."""
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


def _pcr_levels(a, c, d):
    """Cyclic reduction of unit-diagonal systems along axis 0: row i
    eliminates rows i ± s for s = 1, 2, 4, … (a row outside the system
    reads 0). Returns the solution."""
    n = d.shape[0]
    s = 1
    while s < n:
        zero = torch.zeros_like(d[:s])
        am, cm, dm = (torch.cat([zero, t[:-s]]) for t in (a, c, d))
        ap, cp, dp = (torch.cat([t[s:], zero]) for t in (a, c, d))
        r = 1.0 / (1.0 - a * cm - c * ap)
        d = r * (d - a * dm - c * dp)
        a, c = -r * a * am, -r * c * cp
        s *= 2
    return d


def _pcr_plain(a, b, c, d):
    """K7's algorithm in torch, along axis 0, broadcast over the trailing
    axes: diagonal-normalised PCR for n ≤ ``PCR_MAX_ROWS``, else the
    partitioned form (chunks of M = ⌈n / PART_THREADS⌉ rows, identity rows
    past n)."""
    a, b, c, d = (t.clone() for t in torch.broadcast_tensors(a, b, c, d))
    n = d.shape[0]
    a[0] = 0.0                           # a[0] and c[n−1] unused
    c[-1] = 0.0
    if n <= PCR_MAX_ROWS:
        rb = 1.0 / b
        return _pcr_levels(a * rb, c * rb, d * rb)

    P, M = PART_THREADS, -(-n // PART_THREADS)
    pad = P * M - n
    rest = d.shape[1:]
    fill = lambda t, v: torch.cat([t, torch.full((pad, *rest), v,
                                                 dtype=t.dtype,
                                                 device=t.device)])
    # chunk t holds rows t·M … t·M + M − 1: (P, M, ...)
    A, B, C, D = (fill(t, v).reshape(P, M, *rest)
                  for t, v in ((a, 0.0), (b, 1.0), (c, 0.0), (d, 0.0)))
    wa, wc, wd = [None] * M, [None] * M, [None] * M
    for l in range(M):                   # down: rid of x_{l−1}
        ai, bi, ci, di = A[:, l], B[:, l], C[:, l], D[:, l]
        if l < 2:
            rb = 1.0 / bi
            ap, cp, dp = ai * rb, ci * rb, di * rb
        else:
            r = 1.0 / (bi - ai * cp)
            dp = r * (di - ai * dp)
            ap = -r * ai * ap
            cp = r * ci
        wa[l], wc[l], wd[l] = ap, cp, dp
    last = (ap, cp, dp)                  # couples x_0 to the next chunk
    an, cn, dn = wa[M - 2], wc[M - 2], wd[M - 2]
    for l in range(M - 3, 0, -1):        # up: rid of x_{l+1}
        dn = wd[l] - wc[l] * dn
        an = wa[l] - wc[l] * an
        cn = -wc[l] * cn
        wa[l], wc[l], wd[l] = an, cn, dn
    r = 1.0 / (1.0 - wc[0] * an)         # row 0: rid of x_1
    first = (r * wa[0], -r * wc[0] * cn, r * (wd[0] - wc[0] * dn))
    red = [torch.stack([f, l_], dim=1).reshape(2 * P, *rest)
           for f, l_ in zip(first, last)]
    xr = _pcr_levels(*red).reshape(P, 2, *rest)
    x0, xl = xr[:, 0], xr[:, 1]
    x = torch.stack([x0] + [wd[l] - wa[l] * x0 - wc[l] * xl
                            for l in range(1, M - 1)] + [xl], dim=1)
    return x.reshape(P * M, *rest)[:n]


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
        shape = t.shape
        if len(shape) != 2 or shape[0] != n or shape[1] not in (1, batch):
            raise ValueError(f"{name} must be ({n}, {batch}) or ({n}, 1), "
                             f"got {tuple(shape)}")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")


def _strides(t, batch: int):
    """(row, system) strides of an (n, batch) or (n, 1) operand; a single
    column, or a system axis of stride 0, is one column for every system."""
    row, system = t.stride()
    return row, system if t.shape[1] == batch else 0


def _solve_into(a, b, c, d, x):
    """x ← the solution of the (n, batch) systems (a, b, c, d), checked by
    ``_check``, each operand a view of any strides. The kernel on a CUDA
    device, else ``_thomas_plain``."""
    if d.device.type == "cpu":
        x.copy_(_thomas_plain(a, b, c, d))
        return
    n, batch = d.shape
    work = None
    if n > PCR_MAX_ROWS:
        work = torch.empty(3 * batch * -(-n // PART_THREADS) * PART_THREADS,
                           dtype=d.dtype, device=d.device)
    lib = _build.load()
    with torch.cuda.device(d.device):
        err = lib.optpricer_thomas(
            a.data_ptr(), *_strides(a, batch), b.data_ptr(),
            *_strides(b, batch), c.data_ptr(), *_strides(c, batch),
            d.data_ptr(), *_strides(d, batch), x.data_ptr(),
            *_strides(x, batch), None if work is None else work.data_ptr(),
            n, batch, _DTYPES[d.dtype], _stream(d.device))
    if err != 0:
        raise RuntimeError(f"tridiagonal kernel launch failed: CUDA error "
                           f"{err}")
    tridiag_solve_kernel.launches += 1
    tridiag_solve_kernel.launches_by_shape[(n, batch)] += 1


def tridiag_solve_kernel(a, b, c, d) -> torch.Tensor:
    """Solve T x = d for ``batch`` systems laid out as (n, batch).

    Kernels ``tridiag_pcr_kernel`` / ``tridiag_partition_kernel`` in
    ``csrc/thomas.cu``; they replace
    ``optpricer_tpu/ops/pallas_tridiag.py:_thomas_kernel`` (launched from
    ``tridiag_solve_pallas``). ``a``, ``b``, ``c`` are (n, batch) or (n, 1)
    (one column for every system); ``a[0]`` and ``c[n−1]`` are unused.
    """
    _check(a, b, c, d)
    x = torch.empty(d.shape, dtype=d.dtype, device=d.device)
    _solve_into(a, b, c, d, x)
    return x


tridiag_solve_kernel.launches = 0
tridiag_solve_kernel.launches_by_shape = Counter()


def tridiag_solve_kernel_lastdim(a, b, c, d) -> torch.Tensor:
    """Solve along the LAST axis with any leading batch axes, the layout of
    the PDE stack's systems (``(..., n)``, as
    :func:`~optpricer_tpu_torch.ops.tridiag.tridiag_solve`). ``a``, ``b``,
    ``c`` broadcast against ``d``; a coefficient that is one row for every
    system is read with a system stride of 0. The kernel reads the rows
    where they lie and writes the ``(..., n)`` solution; nothing is
    transposed or padded."""
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape, d.shape)
    n = shape[-1]
    batch = math.prod(shape[:-1])
    # (n, batch) views: a view wherever the leading axes merge
    A, B, C, D = (t.expand(shape).reshape(batch, n).t() for t in (a, b, c, d))
    _check(A, B, C, D)
    x = torch.empty(shape, dtype=d.dtype, device=d.device)
    _solve_into(A, B, C, D, x.view(batch, n).t())
    return x

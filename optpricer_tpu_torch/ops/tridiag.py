"""Tridiagonal system solvers.

Counterpart of ``optpricer_tpu/ops/tridiag.py``. Every solver takes
``(a, b, c, d)`` along the last axis, batched over leading axes, with
``a[..., 0]`` and ``c[..., -1]`` unused:

* :func:`tridiag_solve` — the log-depth solve of the reference: a
  projective 2×2 scan for the LU pivots (each partial product rescaled by
  its max-abs entry), then two affine scans for the forward and backward
  substitutions. The reference runs them as ``lax.associative_scan``; torch
  has no public associative scan, so each is ⌈log₂ n⌉ doubling passes
  (Hillis-Steele) of the same combine functions, vectorised over the batch.
  The combine order differs from XLA's tree, so the two agree to round-off.
* :func:`tridiag_solve_thomas` — the reference's Thomas solve. On a CUDA
  tensor it launches K7 (``ops/thomas.py``: parallel cyclic reduction, a
  block of threads per system); on the CPU it runs K7's plain version, the
  Pallas kernel's Thomas elimination as a torch loop over rows (two
  divisions per forward row), which differs from the reference's
  ``lax.scan`` form (pivot then one division per row in the back
  substitution) by round-off.
* :func:`tridiag_inv` — the inverse of batched tridiagonal matrices, the
  Heston ADI's propagator build: one K7 launch (the plain Thomas solve on
  the CPU) against the identity's columns, then one Newton-Schulz step in
  full float32.
* :func:`tridiag_matvec` and :func:`tridiag_dense`.
"""
from __future__ import annotations

import torch

from ..dtypes import full_f32
from .thomas import tridiag_solve_kernel_lastdim

__all__ = ["tridiag_solve", "tridiag_solve_thomas", "tridiag_matvec",
           "tridiag_dense", "tridiag_inv"]


def tridiag_matvec(a, b, c, x):
    """y = T x for tridiagonal T=(a,b,c) along the last axis."""
    y = b * x
    y[..., 1:] += a[..., 1:] * x[..., :-1]
    y[..., :-1] += c[..., :-1] * x[..., 1:]
    return y


# ---------------------------------------------------------------------------
# Parallel (doubling-scan) solver
# ---------------------------------------------------------------------------
def _scan(combine, elems, reverse: bool = False):
    """Inclusive scan along the last axis by doubling: after the pass with
    offset k every position holds the combination of the 2k elements
    ending at it. ``combine(x, y)`` takes x earlier in the sequence; with
    ``reverse`` the sequence runs from the last index to the first."""
    n = elems[0].shape[-1]
    k = 1
    while k < n:
        if reverse:
            head = tuple(e[..., :n - k] for e in elems)
            earlier = tuple(e[..., k:] for e in elems)
            merged = combine(earlier, head)
            elems = tuple(torch.cat([m, e[..., n - k:]], dim=-1)
                          for m, e in zip(merged, elems))
        else:
            tail = tuple(e[..., k:] for e in elems)
            earlier = tuple(e[..., :n - k] for e in elems)
            merged = combine(earlier, tail)
            elems = tuple(torch.cat([e[..., :k], m], dim=-1)
                          for m, e in zip(merged, elems))
        k *= 2
    return elems


def _pivot_combine(x, y):
    # y ∘ x (x earlier in the sequence): Y @ X, rescaled by its max-abs entry
    x00, x01, x10, x11 = x
    y00, y01, y10, y11 = y
    r00 = y00 * x00 + y01 * x10
    r01 = y00 * x01 + y01 * x11
    r10 = y10 * x00 + y11 * x10
    r11 = y10 * x01 + y11 * x11
    scale = torch.maximum(torch.maximum(r00.abs(), r01.abs()),
                          torch.maximum(r10.abs(), r11.abs()))
    inv = torch.where(scale > 0,
                      1.0 / torch.where(scale > 0, scale, 1.0), 1.0)
    return r00 * inv, r01 * inv, r10 * inv, r11 * inv


def _pivots(a, b, c):
    """LU pivots b'_i of the Thomas elimination: b'_i = p_i / p_{i−1} with
    [p_i, p_{i−1}] = M_i···M_0 [1, 0]ᵀ, M_i = [[b_i, −a_i c_{i−1}], [1, 0]]."""
    off = torch.zeros_like(b)
    off[..., 1:] = -a[..., 1:] * c[..., :-1]
    c00, _, c10, _ = _scan(_pivot_combine,
                           (b, off, torch.ones_like(b), torch.zeros_like(b)))
    return c00 / c10


def _affine_combine(x, y):
    lx, dx = x
    ly, dy = y
    return lx * ly, ly * dx + dy


def _affine_scan(l, d, reverse: bool = False):
    """Solve y_i = l_i y_{i±1} + d_i by a scan of affine maps."""
    return _scan(_affine_combine, (l, d), reverse=reverse)[1]


def tridiag_solve(a, b, c, d):
    """Solve T x = d along the last axis; log-depth, batched over leading
    axes (``a[..., 0]`` and ``c[..., -1]`` unused)."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    bp = _pivots(a, b, c)
    # forward substitution: d'_i = d_i − (a_i / b'_{i−1}) d'_{i−1}
    l_fwd = torch.zeros_like(b)
    l_fwd[..., 1:] = -a[..., 1:] / bp[..., :-1]
    dp = _affine_scan(l_fwd, d)
    # back substitution: x_i = (d'_i − c_i x_{i+1}) / b'_i
    v = dp / bp
    u = torch.zeros_like(b)
    u[..., :-1] = -c[..., :-1] / bp[..., :-1]
    return _affine_scan(u, v, reverse=True)


def tridiag_dense(lo, mid, hi):
    """Dense (…, n, n) matrix from (…, n) bands (lo[..., 0] and hi[..., -1]
    unused)."""
    n = mid.shape[-1]
    eye = lambda k: torch.diag(torch.ones(n - abs(k), dtype=mid.dtype,
                                          device=mid.device), k)
    return (mid[..., :, None] * eye(0) + lo[..., :, None] * eye(-1)
            + hi[..., :, None] * eye(1))


# ---------------------------------------------------------------------------
# Thomas (K7 on the card)
# ---------------------------------------------------------------------------
def tridiag_solve_thomas(a, b, c, d):
    """Tridiagonal solve along the last axis, batched over leading axes:
    K7 for CUDA tensors, the plain Thomas loop on the CPU."""
    return tridiag_solve_kernel_lastdim(a, b, c, d)


def _band_product(lo, mid, hi, X):
    """M X for tridiagonal M = (lo, mid, hi) of (…, n) bands and X
    (…, n, m): three scaled row slices, no dense M."""
    out = mid[..., :, None] * X
    out[..., 1:, :] += lo[..., 1:, None] * X[..., :-1, :]
    out[..., :-1, :] += hi[..., :-1, None] * X[..., 1:, :]
    return out


def tridiag_inv(lo, mid, hi, newton: bool = True):
    """Inverse of batched tridiagonal matrices given as (…, n) bands
    (``lo[..., 0]`` and ``hi[..., -1]`` unused); returns (…, n, n).

    The reference solves against the n unit vectors with its log-depth scan
    and then applies one Newton-Schulz step X ← X(2I − MX), which squares
    the solver's O(cond·ε) error down to the working dtype's floor. Here
    the solve is ONE launch of K7 (``ops/thomas``) for every (matrix, unit
    vector) pair, the identity's rows the right-hand sides and the
    solutions written as the rows of the inverse's transpose. Each
    matrix's bands are read with a stride of 0 along the unit vectors, and
    the one identity with a stride of 0 along the matrices: the solve reads
    the bands and an (n, n) identity and writes the (…, n, n) result, and
    nothing is expanded or copied. On the CPU the solve is K7's plain
    Thomas version. The Newton step's MX is a band product and
    X(2I − MX) one ``torch.matmul`` in full float32 (TF32 off, the
    reference's ``Precision.HIGHEST``)."""
    n = mid.shape[-1]
    eye = torch.eye(n, dtype=mid.dtype, device=mid.device)
    # row k of the solution solves M x = e_k: column k of M⁻¹
    X = tridiag_solve_kernel_lastdim(lo[..., None, :], mid[..., None, :],
                                     hi[..., None, :], eye).transpose(-1, -2)
    if not newton:
        return X
    with full_f32():
        return torch.matmul(X, 2.0 * eye - _band_product(lo, mid, hi, X))

"""The Longstaff-Schwartz ladder's date loop as one CUDA pass a date.

Counterpart of no TPU kernel: the JAX package's ladder
(``optpricer_tpu/models/american_mc.py:_lsmc_backward_batch``) is plain
``jnp``. On the card, ``models.american_mc._lsmc_backward_batch`` hands its
date loop here for a float32 path matrix and the cubic basis; its own torch
code is the kernels' plain version, which the CPU runs and the card tests
hold them to.

The state carried from one date to the next is each (strike, path)'s
stopping date, one byte (``csrc/lsmc.cu``): ``lsmc_date`` launches, for a
date t, the pass that applies date t+1's exercise and sums date t's normal
equations over that state (at t = 0: the discounted cashflow's moments),
then the reduction that solves each strike's 4 x 4 system on the card (at
t = 0: writes the prices and standard errors). ``lsmc_backward`` runs the
dates from maturity down; nothing is read back, so the loop makes no host
sync. Each call of ``lsmc_date`` counts its two launches in
``lsmc_date.launches``; an empty ladder (no strike or no path) launches
nothing and counts nothing.

The stopping dates lie in a layout of the kernel's: for each tile of 32
strikes and each group of 16 paths, the 32 strikes' 16-byte words side by
side. The constants below size the buffers; the library's own are read
once a process and must be the same.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..utils.profiling import annotated
from .terminal_mc import _stream

__all__ = ["takes", "lsmc_backward", "lsmc_buffers", "lsmc_date",
           "MAX_STEPS"]

CHUNK = 128        # csrc/lsmc.cu: paths a block stages at a time
GROUP = 16         # paths in a strike's 16-byte word of stopping dates
TILE = 32          # strikes a warp
STRIKES_PER_BLOCK = 256   # csrc/lsmc.cu THREADS: a lane a strike
NSUM = 11          # a partial row: n_itm, Σx^1..6, Σy·x^0..3
MAX_STEPS = 255    # a stopping date is one byte
BASIS_DIM = 4


def takes(paths: torch.Tensor, basis_dim: int) -> bool:
    """Whether the kernels run this backward pass: a float32 path matrix
    on a CUDA device, the cubic basis, at most ``MAX_STEPS`` steps."""
    return (paths.is_cuda and paths.dtype == torch.float32
            and basis_dim == BASIS_DIM and 2 <= paths.shape[0] <= MAX_STEPS + 1)


def _chunks(n: int) -> int:
    return -(-n // CHUNK)


def _tiles(B: int) -> int:
    return -(-B // TILE)


@functools.cache
def _check_layout() -> None:
    """Raise unless the constants above are ``csrc/lsmc.cu``'s."""
    got = (ctypes.c_int * 6)()
    _build.load().optpricer_lsmc_layout(ctypes.addressof(got))
    want = (STRIKES_PER_BLOCK, CHUNK, GROUP, TILE, NSUM, MAX_STEPS)
    if tuple(got) != want:
        raise RuntimeError(f"ops/lsmc.py's layout {want} is not the "
                           f"library's {tuple(got)}")


@functools.cache
def _blocks_per_sm(n_steps: int) -> int:
    n = _build.load().optpricer_lsmc_occupancy(n_steps)
    if n <= 0:
        raise RuntimeError("lsmc_date_kernel occupancy query failed")
    return n


def _partial_rows(n: int, B: int, n_steps: int, device) -> int:
    """Blocks along the paths (a partial row each): one wave of the card's
    resident blocks over the strike blocks, each block a run of chunks."""
    slots = (torch.cuda.get_device_properties(device).multi_processor_count
             * _blocks_per_sm(n_steps))
    strike_blocks = max(1, -(-B // STRIKES_PER_BLOCK))
    per_block = -(-_chunks(n) * strike_blocks // slots)
    return -(-_chunks(n) // per_block)


def lsmc_buffers(paths: torch.Tensor, B: int) -> dict:
    """The date loop's device buffers for B strikes on ``paths``: ``tau``
    (the stopping dates, uninitialised), ``part`` (n_pb, 11, B) partial
    rows, ``betas`` (n_steps + 1, B, 4) with date t's coefficients in row
    t, ``out`` (2, B) the prices and standard errors."""
    n_steps, n = paths.shape[0] - 1, paths.shape[1]
    dev = paths.device
    _check_layout()
    n_pb = _partial_rows(n, B, n_steps, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(
        tau=torch.empty(_tiles(B) * TILE * _chunks(n) * CHUNK,
                        dtype=torch.uint8, device=dev),
        part=torch.empty((n_pb, NSUM, B), **f32),
        betas=torch.empty((n_steps + 1, B, BASIS_DIM), **f32),
        out=torch.empty((2, B), **f32))


@annotated("optpricer.launch.lsmc_date")
def lsmc_date(paths, K, sign, disc, t: int, tau, part, betas, out):
    """Date t of the backward pass on the card: exercise at date t+1 with
    ``betas[t+1]`` (none when t+1 is maturity, where ``tau`` starts at
    n_steps), date t's normal equations into ``part`` and ``betas[t]``; at
    t = 0 the prices and standard errors into ``out``. ``paths`` (n_steps +
    1, n), ``K`` and ``sign`` (B,), ``disc`` one element, all float32 and
    contiguous on one CUDA device; the buffers as ``lsmc_buffers`` makes
    them."""
    n_steps, n = paths.shape[0] - 1, paths.shape[1]
    B = K.shape[0]
    if not 0 <= t < n_steps:
        raise ValueError(f"date {t} outside [0, {n_steps})")
    for name, x in (("paths", paths), ("K", K), ("sign", sign),
                    ("disc", disc), ("part", part), ("betas", betas),
                    ("out", out)):
        if (x.dtype != torch.float32 or x.device != paths.device
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{paths.device}, got {x.dtype} on {x.device}")
    if (sign.shape != (B,) or disc.numel() != 1
            or betas.shape != (n_steps + 1, B, BASIS_DIM)
            or part.shape[1:] != (NSUM, B) or out.shape != (2, B)
            or tau.dtype != torch.uint8 or tau.device != paths.device
            or tau.numel() != _tiles(B) * TILE * _chunks(n) * CHUNK):
        raise ValueError("lsmc_date: buffers do not fit the ladder")
    if B == 0 or n == 0:
        return
    n_pb = part.shape[0]
    first = t == n_steps - 1
    err = _build.load().optpricer_lsmc_date(
        paths.data_ptr(), K.data_ptr(), sign.data_ptr(), disc.data_ptr(),
        None if first else betas[t + 1].data_ptr(), betas[t].data_ptr(),
        tau.data_ptr(), part.data_ptr(), out.data_ptr(), n, n_steps, B, t,
        int(first), -(-_chunks(n) // n_pb), n_pb, _stream(paths.device))
    if err != 0:
        raise RuntimeError(f"lsmc date kernel launch failed: CUDA error {err}")
    lsmc_date.launches += 2


lsmc_date.launches = 0


def lsmc_backward(paths, K, sign, disc):
    """(price, stderr) of each strike, float32 tensors (B,) on the card:
    the dates n_steps − 1 … 0 of :func:`lsmc_date` on fresh buffers."""
    buf = lsmc_buffers(paths, K.shape[0])
    for t in range(paths.shape[0] - 2, -1, -1):
        lsmc_date(paths, K, sign, disc, t, **buf)
    return buf["out"][0], buf["out"][1]

"""Terminal-GBM Monte-Carlo sufficient statistics: the two CUDA kernels.

Counterpart of ``optpricer_tpu/ops/pallas_mc.py``. Random bits come from
Threefry-2x32-20 keyed by (seed, global program id) with counter
(element, rep) — the JAX kernel's ``sw_prng`` stream — become normals by
Box-Muller (or Giles' inverse CDF under ``invcdf``), go through the exact
terminal GBM map and payoff, and are reduced to 13 sufficient statistics in
registers; no draw ever reaches device memory. The randomised-QMC variant
takes scrambled van der Corput points instead. Both give the JAX package's
draws for the same ``(seed, n_paths)``, so their statistics agree to f32
round-off.

Names, JAX → port:

==========================  ======================
``mc_sumstats_pallas``      ``mc_sumstats_kernel``
``mc_sumstats_pallas_sharded``  ``mc_sumstats_kernel_sharded``
``pallas_estimate``         ``terminal_estimate``
``pallas_greeks``           ``terminal_greeks``
``mc_sumstats_qmc``         ``mc_sumstats_qmc``
``qmc_estimate``            ``qmc_estimate``
``_plan_grid``              ``_plan_grid``
``_terminal_params``        ``_terminal_params``
``_run_kernel``             ``terminal_mc`` (kernel wrapper)
``_run_qmc_kernel``         ``terminal_qmc`` (kernel wrapper)
==========================  ======================

Each wrapper launches its CUDA kernel (``csrc/terminal_mc.cu``) for tensors
on a CUDA device and counts the launch in its ``launches`` attribute; for
tensors on the CPU it runs its plain torch version (``_mc_sumstats_plain``,
``_mc_qmc_plain``), which computes the same layout tile by tile. Any other
device raises. ``terminal_qmc`` also takes host tensors with an explicit
CUDA ``device``: its kernel reads seed and params by value.
"""
from __future__ import annotations

import functools
from math import erf, exp, log, sqrt

import numpy as np
import torch

from .. import _build
from ..dtypes import MC_DTYPE, resolve_device
from . import stats as stats_ops
from .fastmath import bitrev32, exp32, log32, norminv32
from .swprng import threefry2x32

__all__ = ["mc_sumstats_kernel", "mc_sumstats_kernel_sharded",
           "mc_sumstats_qmc", "terminal_mc",
           "terminal_qmc", "terminal_estimate", "terminal_greeks",
           "qmc_estimate", "TILE", "NSTAT"]

BLOCK_R = 256           # rows of a rep tile
LANES = 128
TILE = BLOCK_R * LANES  # draws per bit tile; 2 tiles of normals per rep
NSTAT = stats_ops.STATSG_DIM

_ROW = 16               # kernel stats rows are padded to 16 floats
_THREADS = 256          # csrc/terminal_mc.cu THREADS
_BLOCKS_PER_PROGRAM = TILE // _THREADS
_TINY = 2.0 ** -24
_TWO_PI = float(np.float32(6.283185307179586))
_MASK32 = 0xFFFFFFFF
# f32 tail compares of the TPU kernels are exact while the tile index fits
# in the f32 mantissa; the kernels' integer compare equals them there
_MAX_TILE_INDEX = 1 << 24
# csrc/terminal_mc.cu's K2 launch: a cluster of _QMC_CLUSTER blocks a
# program, _QMC_ROWS block rows a block, a group of _QMC_GROUP threads a
# row, each thread _QMC_ELEMS elements of a row's 32-element warp row
_QMC_CLUSTER = 8
_QMC_ROWS = _BLOCKS_PER_PROGRAM // _QMC_CLUSTER
_QMC_ELEMS = 4
_QMC_SEG = 32 // _QMC_ELEMS
_QMC_GROUP = _THREADS // _QMC_ELEMS
# the block sizes the wrapper chooses from: groups that split a block's rows
# evenly, up to a row a group
_QMC_BLOCK_SIZES = tuple(_QMC_GROUP * g for g in (16, 8, 4, 2, 1))


# ---------------------------------------------------------------------------
# host planning (shared by the plain versions and the kernels)
# ---------------------------------------------------------------------------
def _plan_grid(n_paths: int, per_rep: int, n_dev: int = 1,
               target_per_dev: int = 64):
    """(reps, n_programs): grid sizing with n_programs a device multiple.

    Padded programs fall entirely beyond ``n_paths`` and contribute zero
    weight, so padding to a device multiple never changes the estimate.
    """
    target = target_per_dev * n_dev
    reps = max(1, -(-int(n_paths) // (per_rep * target)))
    n_programs = -(-int(n_paths) // (per_rep * reps))
    n_programs = -(-n_programs // n_dev) * n_dev
    return int(reps), int(n_programs)


def _full_programs(n_paths: int, n_programs: int, reps: int,
                   offset: int = 0) -> int:
    """How many of the grid's programs are full: the first ones, whose
    every draw ((offset + pid)·reps + j)·2·TILE + elem (+ TILE) lies below
    n_paths, so that each weight is 1 and ``terminal_mc_kernel`` runs its
    block-uniform body with no draw index, compare or weight. Below 2^24
    tiles only the last program can hold a draw past n_paths."""
    full = int(n_paths) // (reps * 2 * TILE) - int(offset)
    return max(0, min(int(n_programs), full))


def _terminal_params(n_paths, S0, K, T, r, q, sigma, is_call) -> torch.Tensor:
    """Host f32[7] (S0, K, μT, σ√T, df, n_paths, sign)."""
    mu = (r - q - 0.5 * sigma * sigma) * T
    sig = sigma * np.sqrt(T)
    df = np.exp(-r * T)
    sign = 1.0 if is_call else -1.0
    return torch.tensor([S0, K, mu, sig, df, float(n_paths), sign],
                        dtype=MC_DTYPE)


def _plan_qmc(n_paths: int, n_replicates: int):
    """(n_rep, reps, progs_per_rep): points per replicate, rounded up so
    every replicate holds the same count, and the grid that covers them."""
    R = int(n_replicates)
    n_rep = -(-int(n_paths) // R)
    target_progs = max(1, 64 // R)
    reps = max(1, -(-n_rep // (TILE * target_progs)))
    progs_per_rep = -(-n_rep // (TILE * reps))
    return n_rep, int(reps), int(progs_per_rep)


def _qmc_full_tiles(n_rep: int, reps: int, progs_per_rep: int) -> int:
    """How many of a replicate's programs are full: the first ones, whose
    every point (tile_idx·reps + j)·TILE + elem lies below n_rep as the
    kernel reads it (the f32 count of ``_terminal_params``), so that
    ``terminal_qmc_kernel`` runs its body with no weight."""
    n = int(np.float32(n_rep))
    return max(0, min(int(progs_per_rep), n // (int(reps) * TILE)))


def _qmc_args(seed: torch.Tensor, params: torch.Tensor) -> np.ndarray:
    """int32[9], the words of csrc/terminal_mc.cu's ``QmcArgs``: the seed
    pair and the bits of the f32 params, from host copies."""
    return np.concatenate([seed.cpu().numpy(),
                           params.cpu().numpy().view(np.int32)])


@functools.cache
def _qmc_clusters(device_index: int, threads: int, reps: int) -> int:
    """Clusters of ``terminal_qmc_kernel`` (its instantiation for reps)
    that the card holds at once with blocks of ``threads``
    (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.load().optpricer_terminal_qmc_clusters(
            threads, reps, ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"terminal_qmc_kernel occupancy query failed: "
                           f"CUDA error {err}")
    return n.value


@functools.cache
def _qmc_threads(device_index: int, n_programs: int, reps: int) -> int:
    """A block's threads for ``terminal_qmc_kernel``'s n_programs clusters:
    of ``_QMC_BLOCK_SIZES``, the one at which the card holds the most of
    the launch's threads at once (its clusters resident,
    ``_qmc_clusters``, or all n_programs), the smaller on a tie (more
    clusters resident, fewer rows a thread)."""
    held = {t: min(n_programs, _qmc_clusters(device_index, t, reps)) * t
            for t in _QMC_BLOCK_SIZES}
    return min(held, key=lambda t: (-held[t], t))


def _seed_pair(seed: int, device, offset: int = 0) -> torch.Tensor:
    """int32 (seed mod 2^31 − 1, program offset): the kernels' stream key
    and the global id of the grid's first program."""
    return torch.tensor([seed % (2**31 - 1), offset], dtype=torch.int32,
                        device=device)


def _shard_plan(mesh, n_paths: int, per_rep: int):
    """(reps, programs a device, [(device, program offset)]) of one global
    grid split over ``mesh``'s devices in mesh order, as the JAX package's
    sharded entries split it: ``_plan_grid`` aims at 64 programs a device,
    so reps, and with them the draws, follow the device count."""
    devices = mesh.device_list
    reps, n_programs = _plan_grid(int(n_paths), per_rep, len(devices))
    per = n_programs // len(devices)
    return reps, per, [(dev, d * per) for d, dev in enumerate(devices)]


def _check_inputs(seed: torch.Tensor, params: torch.Tensor, n_programs: int,
                  reps: int):
    if n_programs < 1 or reps < 1:
        raise ValueError(f"empty grid: n_programs={n_programs}, reps={reps} "
                         "(n_paths must be positive)")
    if seed.dtype != torch.int32 or seed.shape != (2,):
        raise ValueError("seed must be an int32 tensor of shape (2,)")
    if params.dtype != MC_DTYPE or params.shape != (7,):
        raise ValueError("params must be a float32 tensor of shape (7,)")
    if not (seed.is_contiguous() and params.is_contiguous()):
        raise ValueError("seed and params must be contiguous")
    if seed.device != params.device:
        raise ValueError(f"seed on {seed.device}, params on {params.device}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path and the kernels' on-card reference)
# ---------------------------------------------------------------------------
def _observe(z, S0, K, mu, sig, df, sign):
    """Per-draw observables: payoff, CVs and z-weighted Greek moments."""
    ST = S0 * exp32(mu + sig * z)
    d = sign * (ST - K)
    X = df * torch.clamp(d, min=0.0)
    Y1 = df * ST
    Y2 = df * (d > 0.0).to(MC_DTYPE)
    return X, Y1, Y2, X * z, X * z * z, Y2 * z


def _moments(X, Y1, Y2, Xz, Xz2, Y2z, w):
    """The 13 sums over the last (tile) axis."""
    WX = X * w
    WY1 = Y1 * w
    WY2 = Y2 * w
    terms = (w, WX, WX * X, WY1, WY1 * Y1, WX * Y1, WY2, WY2 * Y2, WX * Y2,
             WY1 * Y2, Xz * w, Xz2 * w, Y2z * w)
    return torch.stack([t.sum(dim=-1) for t in terms], dim=-1)


def _mc_sumstats_plain(seed, params, *, n_programs: int, reps: int,
                       antithetic: bool, invcdf: bool = False
                       ) -> torch.Tensor:
    """Plain version of ``terminal_mc``: all programs of one rep at a time,
    a (n_programs, TILE) tile per normal, Kahan over reps, then the
    programs combined in order."""
    dev = params.device
    key0, offset = (int(v) for v in seed.tolist())
    S0, K, mu, sig, df, n_paths, sign = params.tolist()
    pid = (offset + torch.arange(n_programs, dtype=torch.int64,
                                 device=dev))[:, None]
    elem = torch.arange(TILE, dtype=torch.int64, device=dev)[None, :]
    base_elem = elem.to(MC_DTYPE)
    pid_f = pid.to(MC_DTYPE)
    obs = lambda z: _observe(z, S0, K, mu, sig, df, sign)

    acc = torch.zeros((n_programs, NSTAT), dtype=MC_DTYPE, device=dev)
    comp = torch.zeros_like(acc)
    for j in range(reps):
        bits_a, bits_b = threefry2x32(key0, pid, elem, j)
        u1 = ((bits_a >> 8).to(MC_DTYPE) + 0.5) * _TINY
        if invcdf:
            u2 = ((bits_b >> 8).to(MC_DTYPE) + 0.5) * _TINY
            z1 = norminv32(u1)
            z2 = norminv32(u2)
        else:
            u2 = (bits_b >> 8).to(MC_DTYPE) * _TINY
            rad = torch.sqrt(-2.0 * log32(u1))
            theta = _TWO_PI * u2
            z1 = rad * torch.cos(theta)
            z2 = rad * torch.sin(theta)
        # tail mask by the per-tile remainder, in f32 as on the TPU
        rem1 = n_paths - (pid_f * reps + j) * (2.0 * TILE)
        rem2 = rem1 - TILE
        w1 = (base_elem < rem1).to(MC_DTYPE)
        w2 = (base_elem < rem2).to(MC_DTYPE)
        if antithetic:
            def pair(z, w):
                return _moments(*(0.5 * (a + b)
                                  for a, b in zip(obs(z), obs(-z))), w)
            s = pair(z1, w1) + pair(z2, w2)
        else:
            s = _moments(*obs(z1), w1) + _moments(*obs(z2), w2)
        acc, comp = stats_ops.kahan_add(acc, comp, s)
    return stats_ops.combine_scan(acc)


def _mul32(a, c: int):
    """(a · c) mod 2**32 for uint32 values in int64, without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mc_qmc_plain(seed, params, *, n_programs: int, reps: int,
                  progs_per_rep: int) -> torch.Tensor:
    """Plain version of ``terminal_qmc``: (n_programs, 13) f32 rows."""
    dev = params.device
    key0, offset = (int(v) for v in seed.tolist())
    S0, K, mu, sig, df, n_rep, sign = params.tolist()
    pid = (offset + torch.arange(n_programs, dtype=torch.int64,
                                 device=dev))[:, None]
    rep_id = pid // progs_per_rep
    tile_idx = pid % progs_per_rep

    # murmur3 finalizer of (seed, replicate) → digital-shift word
    h = (key0 & _MASK32) ^ _mul32(rep_id, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)

    elem = torch.arange(TILE, dtype=torch.int64, device=dev)[None, :]
    base_elem = elem.to(MC_DTYPE)
    acc = torch.zeros((n_programs, NSTAT), dtype=MC_DTYPE, device=dev)
    comp = torch.zeros_like(acc)
    for j in range(reps):
        local0 = (tile_idx * reps + j) * TILE
        u_bits = bitrev32(local0 + elem) ^ h
        u = ((u_bits >> 8).to(MC_DTYPE) + 0.5) * _TINY
        z = norminv32(u)
        w = (base_elem < n_rep - local0.to(MC_DTYPE)).to(MC_DTYPE)
        # w is 0 or 1, so (X·z)·w here equals the TPU kernel's (X·w)·z
        s = _moments(*_observe(z, S0, K, mu, sig, df, sign), w)
        acc, comp = stats_ops.kahan_add(acc, comp, s)
    return acc


# ---------------------------------------------------------------------------
# plain mirrors of terminal_qmc_kernel's launch (for the tests)
# ---------------------------------------------------------------------------
def _qmc_points(n_programs: int, reps: int, progs_per_rep: int,
                threads: int) -> np.ndarray:
    """(n_programs, TILE·reps) int64: for each program the in-replicate
    index of every point its cluster's threads form, in the kernel's index
    arithmetic (block, thread, row a group takes, element of the thread,
    rep), so each program's row holds each of its points once."""
    groups = threads // _QMC_GROUP
    pid = np.arange(n_programs).reshape(-1, 1, 1, 1, 1, 1)
    rank = np.arange(_QMC_CLUSTER).reshape(1, -1, 1, 1, 1, 1)
    t = np.arange(threads).reshape(1, 1, -1, 1, 1, 1)
    it = np.arange(_QMC_ROWS // groups).reshape(1, 1, 1, -1, 1, 1)
    i = np.arange(_QMC_ELEMS).reshape(1, 1, 1, 1, -1, 1)
    j = np.arange(reps).reshape(1, 1, 1, 1, 1, -1)
    q = t % _QMC_GROUP
    row = rank * _QMC_ROWS + t // _QMC_GROUP + groups * it
    local = ((pid % progs_per_rep) * reps * TILE + row * _THREADS
             + (q // _QMC_SEG) * 32 + q % _QMC_SEG + _QMC_SEG * i + j * TILE)
    return np.broadcast_to(local, (n_programs, _QMC_CLUSTER, threads,
                                   _QMC_ROWS // groups, _QMC_ELEMS, reps)
                           ).reshape(n_programs, -1)


def _block_row_plain(v: torch.Tensor) -> torch.Tensor:
    """``block_row``'s sum (csrc/reduce.cuh) of v (..., 256, k): in each
    warp of 32, lane l adds lane l + off for off = 16, 8, 4, 2, 1; then
    0 + warp 0 + ... + warp 7."""
    w = v.reshape(v.shape[:-2] + (_THREADS // 32, 32, v.shape[-1]))
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off, :] + w[..., off:2 * off, :]
    return _warp_rows(w[..., 0, :])


def _qmc_row_plain(v: torch.Tensor) -> torch.Tensor:
    """``terminal_qmc_kernel``'s sum of a block row v (..., 256, k): a
    thread's elements l + _QMC_SEG·i of a warp row folded in registers
    (``qmc_fold``: the even-indexed ones' sum plus the odd-indexed ones'),
    the shuffle levels below _QMC_SEG, then 0 + warp row 0 + ... + 7."""
    w = v.reshape(v.shape[:-2] + (_THREADS // 32, _QMC_ELEMS, _QMC_SEG,
                                  v.shape[-1]))

    def fold(idx):
        if len(idx) == 1:
            return w[..., idx[0], :, :]
        return fold(idx[0::2]) + fold(idx[1::2])

    t = fold(list(range(_QMC_ELEMS)))
    off = _QMC_SEG // 2
    while off:
        t = t[..., :off, :] + t[..., off:2 * off, :]
        off //= 2
    return _warp_rows(t[..., 0, :])


def _warp_rows(w: torch.Tensor) -> torch.Tensor:
    """0 + w[..., 0, :] + w[..., 1, :] + ..., in that order."""
    t = torch.zeros_like(w[..., 0, :])
    for r in range(w.shape[-2]):
        t = t + w[..., r, :]
    return t


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def terminal_mc(seed: torch.Tensor, params: torch.Tensor, *, n_programs: int,
                reps: int, antithetic: bool, invcdf: bool = False
                ) -> torch.Tensor:
    """f32[13] terminal-GBM sums over the (n_programs, reps) grid.

    Kernel ``terminal_mc_kernel`` in ``csrc/terminal_mc.cu``; it replaces
    ``optpricer_tpu/ops/pallas_mc.py:_mc_kernel`` (launched from
    ``_run_kernel``). It is bound by the issue of its rep loop (a
    Threefry block, a log/sqrt/sincospi and 2-4 exp32 polynomials per base
    draw) and writes only 16 floats per block of 256 draws-per-rep; one
    thread per (program, element) keeps the Kahan sums over reps in
    registers, and a fixed-order block tree plus a second combine pass
    replace atomics, so a seed's stats are bitwise-reproducible. The full
    programs (``_full_programs``: all but the last of a ragged count) run
    a body with no draw index or weight; antithetic, the loop sums f(z) +
    f(−z) and the last combine pass halves each stat by its degree.
    """
    _check_inputs(seed, params, n_programs, reps)
    if n_programs * reps >= _MAX_TILE_INDEX:
        raise ValueError("n_paths must stay below 2**24 tiles of 2*TILE draws")
    if params.device.type == "cpu":
        return _mc_sumstats_plain(seed, params, n_programs=n_programs,
                                  reps=reps, antithetic=antithetic,
                                  invcdf=invcdf)
    dev = params.device
    block_rows = torch.empty((n_programs * _BLOCKS_PER_PROGRAM, _ROW),
                             dtype=MC_DTYPE, device=dev)
    prog_rows = torch.empty((n_programs, _ROW), dtype=MC_DTYPE, device=dev)
    out = torch.empty((_ROW,), dtype=MC_DTYPE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_terminal_mc(
            seed.data_ptr(), params.data_ptr(), block_rows.data_ptr(),
            prog_rows.data_ptr(), out.data_ptr(), n_programs, reps,
            int(bool(antithetic)), int(bool(invcdf)), _stream(dev))
    if err != 0:
        raise RuntimeError(f"terminal_mc_kernel launch failed: CUDA error {err}")
    terminal_mc.launches += 1
    return out[:NSTAT]


terminal_mc.launches = 0


def blocks_per_sm(antithetic: bool, invcdf: bool = False) -> int:
    """Resident blocks per SM of ``terminal_mc_kernel`` on the current card
    (the CUDA runtime's occupancy for its registers)."""
    n = _build.load().optpricer_terminal_mc_occupancy(int(bool(antithetic)),
                                                      int(bool(invcdf)))
    if n < 0:
        raise RuntimeError("terminal_mc occupancy query failed")
    return n


def terminal_qmc(seed: torch.Tensor, params: torch.Tensor, *,
                 n_programs: int, reps: int, progs_per_rep: int,
                 device=None) -> torch.Tensor:
    """f32[n_programs, 13] randomised-QMC sums, one row per program.

    Kernel ``terminal_qmc_kernel`` in ``csrc/terminal_mc.cu``; it replaces
    ``optpricer_tpu/ops/pallas_mc.py:_mc_qmc_kernel`` (launched from
    ``_run_qmc_kernel``). Bound by the issue of its per-point body (one
    inverse CDF and one exp32 a point; the scramble is a bit reversal and
    an XOR). A program is one cluster of 8 blocks: a thread Kahan-sums 4
    elements of a block row over their reps in registers and folds them as
    the block tree pairs them, the rows go into the leader block's shared
    memory, and the leader Kahan-sums them in order, in one launch with no
    scratch. A block's threads are those at which the card holds the most
    of the launch's threads at once (``_qmc_threads``, from the cluster
    occupancy query).

    ``device``: where to run, by default ``params``' device; a CPU device
    runs the plain version ``_mc_qmc_plain``. On a CUDA device the kernel
    takes seed and params by value (``_qmc_args``): from host tensors as
    they are, which lets the entry point ``mc_sumstats_qmc`` copy nothing
    to the card, or from the card's tensors through a copy to the host.
    """
    _check_inputs(seed, params, n_programs, reps)
    if n_programs * reps >= _MAX_TILE_INDEX:
        raise ValueError("the grid must stay below 2**24 tiles")
    dev = params.device if device is None else torch.device(device)
    if params.device.type == "cuda" and dev != params.device:
        raise ValueError(f"params on {params.device}, device={dev}")
    if dev.type == "cpu":
        return _mc_qmc_plain(seed, params, n_programs=n_programs, reps=reps,
                             progs_per_rep=progs_per_rep)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    args = _qmc_args(seed, params)
    out = torch.empty((n_programs, NSTAT), dtype=MC_DTYPE, device=dev)
    threads = _qmc_threads(dev.index, n_programs, reps)
    with torch.cuda.device(dev):
        err = _build.load().optpricer_terminal_qmc(
            args.ctypes.data, out.data_ptr(), n_programs, reps,
            progs_per_rep, threads, _stream(dev))
    if err != 0:
        raise RuntimeError(f"terminal_qmc_kernel launch failed: CUDA error {err}")
    terminal_qmc.launches += 1
    return out


terminal_qmc.launches = 0


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def mc_sumstats_kernel(seed: int, n_paths: int, S0, K, T, r, q, sigma,
                       is_call: bool, *, antithetic: bool, dtype=None,
                       invcdf: bool = False, device=None) -> torch.Tensor:
    """(13,) f32 sufficient statistics of n_paths terminal GBM draws.

    Each program produces ``2·TILE·reps`` base draws (two normals per bit
    pair); the grid just covers ``n_paths`` and the tail is masked.
    ``dtype`` is accepted for API parity: the kernel is float32.
    """
    del dtype
    dev = resolve_device(device)
    reps, n_programs = _plan_grid(int(n_paths), 2 * TILE)
    params = _terminal_params(n_paths, S0, K, T, r, q, sigma, is_call).to(dev)
    return terminal_mc(_seed_pair(seed, dev), params, n_programs=n_programs,
                       reps=reps, antithetic=bool(antithetic),
                       invcdf=bool(invcdf))


def mc_sumstats_kernel_sharded(mesh, seed: int, n_paths: int, S0, K, T, r,
                               q, sigma, is_call: bool, *, antithetic: bool,
                               dtype=None, invcdf: bool = False
                               ) -> torch.Tensor:
    """(13,) f32 stats of one global grid split over ``mesh``: each device
    runs ``terminal_mc`` over its contiguous slice of the programs (the
    offset is the second seed word, so every draw keeps its global program
    id), every shard is launched before any is waited for, and the stats
    are summed in mesh order on the first device (``parallel.mesh.
    mesh_sum``, the ``psum``). Counterpart of ``mc_sumstats_pallas_sharded``;
    on a CPU mesh each shard runs the plain version."""
    from ..parallel.mesh import mesh_sum

    del dtype
    reps, per, shards = _shard_plan(mesh, n_paths, 2 * TILE)
    host = _terminal_params(n_paths, S0, K, T, r, q, sigma, is_call)
    inputs = [(_seed_pair(seed, dev, off), host.to(dev))
              for dev, off in shards]
    return mesh_sum([terminal_mc(sd, params, n_programs=per, reps=reps,
                                 antithetic=bool(antithetic),
                                 invcdf=bool(invcdf))
                     for sd, params in inputs])


def mc_sumstats_qmc(seed: int, n_paths: int, S0, K, T, r, q, sigma,
                    is_call: bool, *, n_replicates: int = 16,
                    device=None) -> np.ndarray:
    """Per-replicate (R, 13) float64 sufficient statistics for RQMC
    terminal GBM. ``n_paths`` is rounded up so every replicate holds the
    same tile-aligned point count; the actual count is ``stats[:, 0].sum()``.
    """
    dev = resolve_device(device)
    R = int(n_replicates)
    n_rep, reps, progs_per_rep = _plan_qmc(n_paths, R)
    if n_rep >= 2**31:  # the reference's in-replicate index is int32
        raise ValueError("points per replicate must stay below 2**31")
    # built on the host and passed by value: nothing is copied to the card
    params = _terminal_params(n_rep, S0, K, T, r, q, sigma, is_call)
    rows = terminal_qmc(_seed_pair(seed, "cpu"), params,
                        n_programs=R * progs_per_rep, reps=reps,
                        progs_per_rep=progs_per_rep, device=dev)
    # host-side f64 per-replicate reduction (few rows, precision cheap)
    rows = rows.cpu().numpy().astype(np.float64)
    return rows.reshape(R, progs_per_rep, NSTAT).sum(axis=1)


def _host(stats) -> np.ndarray:
    if isinstance(stats, torch.Tensor):
        stats = stats.detach().cpu().numpy()
    return np.asarray(stats, np.float64)


def terminal_estimate(stats_vec, S0, K, T, r, q, sigma, is_call: bool,
                      control_variate: bool):
    """(price, stderr) from the stats vector; dual CV when enabled."""
    s = _host(stats_vec)
    if s[0] == 0:
        return float("nan"), float("nan")
    if not control_variate:
        n, sx, sx2 = s[0], s[1], s[2]
        m = sx / n
        v = max(0.0, sx2 / n - m * m)
        return float(m), float(sqrt(v / n))
    EY1 = S0 * exp(-q * T)  # E[e^{−rT}·S_T] under Q
    d2 = (log(S0 / K) + (r - q - 0.5 * sigma * sigma) * T) / (sigma * sqrt(T))
    Phi = lambda x: 0.5 * (1.0 + erf(x / sqrt(2.0)))
    p_itm = Phi(d2) if is_call else Phi(-d2)
    EY2 = exp(-r * T) * p_itm
    mean, se = stats_ops.cv2_mean_se(s, EY1, EY2)
    # f32 moment-roundoff floor
    return mean, max(se, 2e-6 * (1.0 + abs(mean)))


def terminal_greeks(stats_vec, S0, K, T, r, q, sigma, is_call: bool) -> dict:
    """The full MC Greek set from the 13-stat vector.

    With A ≡ e^{−rT}·sign·1{ITM}·S_T = X + sign·K·Y2:
    delta = E[A]/S0, vega = E[A·(√T·z − σT)], rho = sign·K·T·E[Y2],
    theta = r·E[X] − (r−q−σ²/2)·E[A] − σ/(2√T)·E[A·z],
    gamma (likelihood ratio) = (E[X·z²] − E[X])/(S0²σ²T) − E[X·z]/(S0²σ√T),
    digital = E[Y2]. The dual-CV price feeds E[X]; all host float64.
    """
    s = _host(stats_vec)
    n = s[0]
    price, _ = terminal_estimate(s, S0, K, T, r, q, sigma, is_call,
                                 control_variate=True)
    sign = 1.0 if is_call else -1.0
    mX = price
    mY2 = s[6] / n
    mXz = s[10] / n
    mXz2 = s[11] / n
    mY2z = s[12] / n
    sqT = sqrt(T)

    mA = mX + sign * K * mY2
    mAz = mXz + sign * K * mY2z

    delta = mA / S0
    vega = sqT * mAz - sigma * T * mA
    rho = sign * K * T * mY2
    theta = r * mX - (r - q - 0.5 * sigma * sigma) * mA \
        - sigma / (2.0 * sqT) * mAz
    gamma = (mXz2 - s[1] / n) / (S0 * S0 * sigma * sigma * T) \
        - mXz / (S0 * S0 * sigma * sqT)
    return {"price": price, "delta": float(delta), "gamma": float(gamma),
            "vega": float(vega), "theta": float(theta), "rho": float(rho),
            "digital": float(mY2)}


def qmc_estimate(rep_stats, S0, K, T, r, q, sigma, is_call: bool,
                 control_variate: bool = True):
    """(price, stderr) from per-replicate stats: mean of the R replicate
    (CV-corrected) means, stderr from their spread, floored at the f32
    pipeline's systematic error level."""
    s = _host(rep_stats)
    means = []
    for row in s:
        if control_variate:
            m, _ = terminal_estimate(row, S0, K, T, r, q, sigma, is_call, True)
        else:
            m = row[1] / row[0]
        means.append(m)
    means = np.asarray(means)
    R = means.size
    se = float(means.std(ddof=1) / np.sqrt(R)) if R > 1 else float("nan")
    mean = float(means.mean())
    return mean, max(se, 2e-7 * (1.0 + abs(mean)))

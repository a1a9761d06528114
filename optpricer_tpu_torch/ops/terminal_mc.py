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
device raises.
"""
from __future__ import annotations

from math import erf, exp, log, sqrt

import numpy as np
import torch

from .. import _build
from ..dtypes import MC_DTYPE, resolve_device
from . import stats as stats_ops
from .fastmath import bitrev32, exp32, log32, norminv32
from .swprng import threefry2x32

__all__ = ["mc_sumstats_kernel", "mc_sumstats_qmc", "terminal_mc",
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


def _seed_pair(seed: int, device) -> torch.Tensor:
    return torch.tensor([seed % (2**31 - 1), 0], dtype=torch.int32,
                        device=device)


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
# kernel wrappers
# ---------------------------------------------------------------------------
def terminal_mc(seed: torch.Tensor, params: torch.Tensor, *, n_programs: int,
                reps: int, antithetic: bool, invcdf: bool = False
                ) -> torch.Tensor:
    """f32[13] terminal-GBM sums over the (n_programs, reps) grid.

    Kernel ``terminal_mc_kernel`` in ``csrc/terminal_mc.cu``; it replaces
    ``optpricer_tpu/ops/pallas_mc.py:_mc_kernel`` (launched from
    ``_run_kernel``). It is bound by integer and SFU throughput (a Threefry
    block, a log/sqrt/sincospi and 2-4 exp32 polynomials per base draw)
    and writes only 16 floats per block of 256 draws-per-rep; one thread
    per (program, element) keeps the Kahan sums over reps in registers, and
    a fixed-order block tree plus a second combine pass replace atomics, so
    a seed's stats are bitwise-reproducible.
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


def terminal_qmc(seed: torch.Tensor, params: torch.Tensor, *,
                 n_programs: int, reps: int, progs_per_rep: int
                 ) -> torch.Tensor:
    """f32[n_programs, 13] randomised-QMC sums, one row per program.

    Kernel ``terminal_qmc_kernel`` in ``csrc/terminal_mc.cu``; it replaces
    ``optpricer_tpu/ops/pallas_mc.py:_mc_qmc_kernel`` (launched from
    ``_run_qmc_kernel``). Bound by SFU and FMA throughput (one inverse CDF
    and one exp32 per point, the scramble is a bit reversal and an XOR);
    the same register-resident per-thread Kahan loop and fixed-order block
    and program combine as ``terminal_mc``.
    """
    _check_inputs(seed, params, n_programs, reps)
    if n_programs * reps >= _MAX_TILE_INDEX:
        raise ValueError("the grid must stay below 2**24 tiles")
    if params.device.type == "cpu":
        return _mc_qmc_plain(seed, params, n_programs=n_programs, reps=reps,
                             progs_per_rep=progs_per_rep)
    dev = params.device
    block_rows = torch.empty((n_programs * _BLOCKS_PER_PROGRAM, _ROW),
                             dtype=MC_DTYPE, device=dev)
    out = torch.empty((n_programs, _ROW), dtype=MC_DTYPE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_terminal_qmc(
            seed.data_ptr(), params.data_ptr(), block_rows.data_ptr(),
            out.data_ptr(), n_programs, reps, progs_per_rep, _stream(dev))
    if err != 0:
        raise RuntimeError(f"terminal_qmc_kernel launch failed: CUDA error {err}")
    terminal_qmc.launches += 1
    return out[:, :NSTAT]


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
    params = _terminal_params(n_rep, S0, K, T, r, q, sigma, is_call).to(dev)
    rows = terminal_qmc(_seed_pair(seed, dev), params,
                        n_programs=R * progs_per_rep, reps=reps,
                        progs_per_rep=progs_per_rep)
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

"""Terminal-GBM Monte Carlo for a heterogeneous European book: the book
kernel.

Counterpart of ``optpricer_tpu/ops/pallas_mc_batch.py``. Every contract of
the book rides one lane of a 128-lane contract tile (ktile) with its own
strike, call/put sign, spot, (r−q−σ²/2)T, σ√T and discount factor
(``kparams``, (n_ktiles, 8, 128) f32), so the whole book is one launch.
Draws come from Threefry-2x32-20 keyed by (seed mod (2³¹−1),
ktile·n_programs + program) with counter (row·128 + lane, rep) — the JAX
kernel's ``sw_prng`` stream — and become two Box-Muller normals per
element and rep; each lane reduces its own 10 sufficient statistics (the
dual-CV layout of ``ops/stats.py``), so a seed gives the reference's
per-contract statistics to f32 round-off.

``mc_batch`` launches the CUDA kernel (``csrc/mc_batch.cu``) for tensors on
a CUDA device and counts the launch in ``mc_batch.launches``; for tensors on
the CPU it runs its plain torch version (``_mc_batch_plain``). The
estimator (the 2×2 control-variate solve per contract, the f32 round-off
floor) is host float64 numpy, as in the reference.
"""
from __future__ import annotations

from math import erf, sqrt

import numpy as np
import torch

from .. import _build
from ..dtypes import MC_DTYPE, resolve_device
from ..utils.profiling import annotate, annotated
from . import stats as stats_ops
from .black_scholes import is_call_mask
from .fastmath import exp32, log32
from .swprng import threefry2x32
from .terminal_mc import _MAX_TILE_INDEX, _stream

__all__ = ["mc_batch", "euro_price_mc_batch", "batch_kparams",
           "BLOCK_R", "LANES", "NSTAT"]

BLOCK_R = 256                   # rows of a rep tile
LANES = 128                     # contracts per ktile
NSTAT = stats_ops.STATS2_DIM    # 10 sums per contract
KROWS = 8                       # kparams rows per ktile

_ROW = 16                       # csrc/mc_batch.cu ROW
_TINY = 2.0 ** -24
_TWO_PI = float(np.float32(6.283185307179586))
_TARGET_PROGRAMS = 16           # the reference's grid target


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------
def batch_kparams(S0, K, T, r, q, sigma, kind):
    """(kparams f32 (n_ktiles, 8, 128), book columns): the contract tiles
    of a book whose fields broadcast against each other. Rows are K, sign,
    S0, (r−q−σ²/2)T, σ√T, e^{−rT}, 0, 0; the last tile is padded with the
    book's last contract."""
    mask0 = np.atleast_1d(is_call_mask(kind))
    cols = [np.atleast_1d(np.asarray(v, dtype=float))
            for v in (S0, K, T, r, q, sigma)]
    B = int(np.broadcast_shapes(*(c.shape for c in cols), mask0.shape)[0])
    S0a, Ka, Ta, ra, qa, siga = (np.broadcast_to(c, (B,)).astype(float)
                                 for c in cols)
    mask = np.broadcast_to(mask0, (B,)).astype(float)
    n_ktiles = -(-B // LANES)
    pad = n_ktiles * LANES - B

    def padded(v):
        return np.concatenate([v, np.full(pad, v[-1])]).reshape(n_ktiles,
                                                                LANES)

    mu = (ra - qa - 0.5 * siga**2) * Ta
    sg = siga * np.sqrt(Ta)
    df = np.exp(-ra * Ta)
    kparams = np.zeros((n_ktiles, KROWS, LANES), np.float32)
    for row, v in enumerate((Ka, 2 * mask - 1.0, S0a, mu, sg, df)):
        kparams[:, row, :] = padded(v)
    book = dict(B=B, S0=S0a, K=Ka, T=Ta, r=ra, q=qa, sigma=siga, mask=mask,
                df=df)
    return kparams, book


def _plan(n_paths: int):
    """(reps, n_programs): the reference's grid, about 16 programs."""
    per_rep = 2 * BLOCK_R  # base draws per lane per rep
    reps = max(1, -(-int(n_paths) // (per_rep * _TARGET_PROGRAMS)))
    n_programs = -(-int(n_paths) // (per_rep * reps))
    return int(reps), int(n_programs)


def _full_programs(n_paths: int, n_programs: int, reps: int) -> int:
    """How many of the grid's programs are full: the first ones, whose
    every draw (pid·reps + j)·2·256 + row (+ 256) lies below n_paths, so
    that each weight is 1 and the kernel's block-uniform full body forms no
    draw index or weight. Below 2^24 tiles only the last program can hold
    a draw past n_paths."""
    return min(n_programs, int(n_paths) // (reps * 2 * BLOCK_R))


def _check_inputs(seed, params, kparams, n_programs, reps):
    if n_programs < 1 or reps < 1:
        raise ValueError(f"empty grid: n_programs={n_programs}, reps={reps} "
                         "(n_paths must be positive)")
    if n_programs * reps >= _MAX_TILE_INDEX:
        raise ValueError("n_paths must stay below 2**24 tiles of 2*256 draws")
    if seed.dtype != torch.int32 or seed.shape != (1,):
        raise ValueError("seed must be an int32 tensor of shape (1,)")
    if params.dtype != MC_DTYPE or params.shape != (1,):
        raise ValueError("params must be a float32 tensor of shape (1,)")
    if kparams.dtype != MC_DTYPE or kparams.ndim != 3 \
            or kparams.shape[1:] != (KROWS, LANES) or kparams.shape[0] < 1:
        raise ValueError(f"kparams must be float32 (n_ktiles, {KROWS}, "
                         f"{LANES}), got {tuple(kparams.shape)} "
                         f"{kparams.dtype}")
    if not (seed.is_contiguous() and params.is_contiguous()
            and kparams.is_contiguous()):
        raise ValueError("seed, params and kparams must be contiguous")
    if not seed.device == params.device == kparams.device:
        raise ValueError("seed, params and kparams must share a device")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")


# ---------------------------------------------------------------------------
# plain torch version (the CPU path and the kernel's on-card reference)
# ---------------------------------------------------------------------------
def _mc_batch_plain(seed, params, kparams, *, n_programs: int, reps: int,
                    antithetic: bool) -> torch.Tensor:
    """Plain version of ``mc_batch``: every (program, ktile) tile of one
    rep at once as a (n_programs, n_ktiles, 256, 128) tensor, the rows
    summed per lane, Kahan over reps, then the programs combined in order
    per ktile — the TPU kernel's order."""
    dev = params.device
    key0 = int(seed[0])
    n_paths = float(params[0])
    n_ktiles = kparams.shape[0]
    pid = torch.arange(n_programs, dtype=torch.int64,
                       device=dev).view(-1, 1, 1, 1)
    ktile = torch.arange(n_ktiles, dtype=torch.int64,
                         device=dev).view(1, -1, 1, 1)
    rows = torch.arange(BLOCK_R, dtype=torch.int64, device=dev).view(-1, 1)
    lanes = torch.arange(LANES, dtype=torch.int64, device=dev).view(1, -1)
    elem = rows * LANES + lanes
    key1 = ktile * n_programs + pid
    row_f = rows.to(MC_DTYPE)
    K, sign, S0, mu, sig, df = (kparams[:, i, :].view(1, n_ktiles, 1, LANES)
                                for i in range(6))

    def xy(z):
        ST = S0 * exp32(mu + sig * z)
        X = df * torch.clamp(sign * (ST - K), min=0.0)
        return X, df * ST, df * (sign * (ST - K) > 0.0).to(MC_DTYPE)

    def moments(X, Y1, Y2, w):
        WX, WY1, WY2 = X * w, Y1 * w, Y2 * w
        terms = (w.expand_as(X), WX, WX * X, WY1, WY1 * Y1, WX * Y1, WY2,
                 WY2 * Y2, WX * Y2, WY1 * Y2)
        return torch.stack([t.sum(dim=-2) for t in terms], dim=-2)

    def branch(z, w):
        if antithetic:
            return moments(*(0.5 * (a + b) for a, b in zip(xy(z), xy(-z))),
                           w)
        return moments(*xy(z), w)

    acc = torch.zeros((n_programs, n_ktiles, NSTAT, LANES), dtype=MC_DTYPE,
                      device=dev)
    comp = torch.zeros_like(acc)
    pid_f = pid.to(MC_DTYPE)
    for j in range(reps):
        bits_a, bits_b = threefry2x32(key0, key1, elem, j)
        u1 = ((bits_a >> 8).to(MC_DTYPE) + 0.5) * _TINY
        u2 = (bits_b >> 8).to(MC_DTYPE) * _TINY
        rad = torch.sqrt(-2.0 * log32(u1))
        theta = _TWO_PI * u2
        # per-lane draw budget, in f32 as on the TPU
        rem1 = n_paths - (pid_f * reps + j) * (2.0 * BLOCK_R)
        w1 = (row_f < rem1).to(MC_DTYPE)
        w2 = (row_f < rem1 - BLOCK_R).to(MC_DTYPE)
        s = branch(rad * torch.cos(theta), w1) \
            + branch(rad * torch.sin(theta), w2)
        acc, comp = stats_ops.kahan_add(acc, comp, s)
    return stats_ops.combine_scan(acc.reshape(n_programs, -1)).reshape(
        n_ktiles, NSTAT, LANES)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
@annotated("optpricer.launch.mc_batch")
def mc_batch(seed: torch.Tensor, params: torch.Tensor, kparams: torch.Tensor,
             *, n_programs: int, reps: int, antithetic: bool
             ) -> torch.Tensor:
    """f32 (n_ktiles, 10, 128): each contract lane's sums over the
    (n_programs, reps) grid; ``params`` is f32[1] (n_paths per contract).

    Kernel ``mc_batch_kernel`` in ``csrc/mc_batch.cu``; it replaces
    ``optpricer_tpu/ops/pallas_mc_batch.py:_mc_batch_kernel`` (launched from
    ``_run_batch_kernel``). Bound by instruction issue (a Threefry
    block, a log32, a sqrt, one sincosf and two or four exp32 per
    base-draw pair), like ``terminal_mc``: a block of 256 threads (one per
    row) owns one (program, ktile, lane), Kahan-sums over reps in
    registers and reduces its rows in a fixed tree; a second pass combines
    the programs of each lane in order, with no atomics. A full program
    (``_full_programs``) runs a body with no draw index or weight.
    """
    _check_inputs(seed, params, kparams, n_programs, reps)
    if params.device.type == "cpu":
        return _mc_batch_plain(seed, params, kparams, n_programs=n_programs,
                               reps=reps, antithetic=antithetic)
    dev = params.device
    n_ktiles = int(kparams.shape[0])
    block_rows = torch.empty((n_ktiles * LANES * n_programs, _ROW),
                             dtype=MC_DTYPE, device=dev)
    out = torch.empty((n_ktiles * LANES, _ROW), dtype=MC_DTYPE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_mc_batch(
            seed.data_ptr(), params.data_ptr(), kparams.data_ptr(),
            block_rows.data_ptr(), out.data_ptr(), n_programs, n_ktiles, reps,
            int(bool(antithetic)), _stream(dev))
    if err != 0:
        raise RuntimeError(f"mc_batch_kernel launch failed: CUDA error {err}")
    mc_batch.launches += 1
    return out[:, :NSTAT].reshape(n_ktiles, LANES, NSTAT).transpose(1, 2)


mc_batch.launches = 0


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------
@annotated("optpricer.call")
def euro_price_mc_batch(S0, K, T, r, q, sigma, kind, *,
                        n_paths: int = 1_000_000, seed: int = 0,
                        antithetic: bool = True,
                        control_variate: bool = True, device=None):
    """Price a fully heterogeneous European book by fused Monte Carlo.

    Every argument broadcasts over the book (per-position S0/K/T/r/q/σ/kind
    all allowed). Each option receives ``n_paths`` base draws, independent
    across the book. Returns ``(prices, stderrs)`` as float64 numpy arrays
    of the book's length: with ``control_variate`` the dual control
    variate (terminal spot, digital) solved per contract, its standard
    error floored at 2e-6·(1 + |price|) (f32 moment round-off).
    """
    with annotate("optpricer.prepare"):
        dev = resolve_device(device)
        kparams, book = batch_kparams(S0, K, T, r, q, sigma, kind)
        B = book["B"]
        reps, n_programs = _plan(n_paths)
    with annotate("optpricer.copy"):
        seed_t = torch.tensor([seed % (2**31 - 1)], dtype=torch.int32,
                              device=dev)
    with annotate("optpricer.copy"):
        paths_t = torch.tensor([float(n_paths)], dtype=MC_DTYPE, device=dev)
    with annotate("optpricer.copy"):
        kparams_t = torch.as_tensor(kparams).to(dev)
    stats = mc_batch(seed_t, paths_t, kparams_t, n_programs=n_programs,
                     reps=reps, antithetic=bool(antithetic))
    with annotate("optpricer.read"):
        s = stats.cpu().numpy()
    with annotate("optpricer.estimate"):
        s = s.astype(np.float64)
        s = s.transpose(1, 0, 2).reshape(NSTAT, -1)[:, :B]      # (10, B)
        return _book_estimate(s, book, control_variate)


def _book_estimate(s, book, control_variate: bool):
    """(prices, stderrs) from the (10, B) per-contract sums, host f64."""
    n = s[0]
    mX = s[1] / n
    vX = np.maximum(0.0, s[2] / n - mX**2)
    if not control_variate:
        return mX, np.sqrt(vX / n)

    m1, m2 = s[3] / n, s[6] / n
    v11 = np.maximum(0.0, s[4] / n - m1**2)
    v22 = np.maximum(0.0, s[7] / n - m2**2)
    c1X = s[5] / n - m1 * mX
    c2X = s[8] / n - m2 * mX
    c12 = s[9] / n - m1 * m2
    det = v11 * v22 - c12**2
    det = np.where(det > 1e-30, det, np.inf)
    b1 = (v22 * c1X - c12 * c2X) / det
    b2 = (v11 * c2X - c12 * c1X) / det

    S0a, Ka, Ta, ra, qa, siga = (book[k] for k in ("S0", "K", "T", "r", "q",
                                                   "sigma"))
    EY1 = S0a * np.exp(-qa * Ta)
    srt = siga * np.sqrt(Ta)
    d2 = (np.log(S0a / Ka) + (ra - qa) * Ta - 0.5 * srt**2) / srt
    Phi = np.vectorize(lambda x: 0.5 * (1.0 + erf(x / sqrt(2.0))))
    EY2 = book["df"] * Phi((2 * book["mask"] - 1.0) * d2)

    explained = b1 * c1X + b2 * c2X
    mean = mX - b1 * (m1 - EY1) - b2 * (m2 - EY2)
    var = np.maximum(0.0, vX - explained)
    se = np.sqrt(var / n)
    # f32 round-off floor: when the CVs explain (numerically) all of the
    # variance the statistical se underestimates the true uncertainty
    se = np.maximum(se, 2e-6 * (1.0 + np.abs(mean)))
    return mean, se

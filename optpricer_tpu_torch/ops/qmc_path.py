"""Fused path QMC: Sobol → Φ⁻¹ → Brownian bridge → payoff (K5).

Counterpart of ``optpricer_tpu/ops/pallas_qmc_path.py``. Per point: a
Gray-code Sobol word per time step (an XOR ladder over the direction
numbers, XORed with the replicate's digital shift), cell-centred f32
uniforms, ``norminv32``, the whole GBM log-path as one linear map
``logS = drift + z @ (σA)`` with A the Brownian-bridge matrix, ``exp32``,
and the payoff's masked reductions over the steps (terminal spot, running
sum / log-sum / max / min, barrier crossing) into 6 statistics
[n, ΣX, ΣX², ΣY, ΣY², ΣXY] with X = e^{−rT}·payoff and Y = e^{−rT}·S_T.
Nothing of shape (points, steps) reaches device memory.

The R replicate shifts are ``jax.random.bits(fold_in(key(seed), i))`` in
the reference; ``ops/swprng.jax_fold_in_bits`` rebuilds them from the
port's Threefry, so a seed randomises the same point set the same way.

Names, JAX → port:

=============================  ============================
``path_qmc_sumstats_pallas``   ``path_qmc_sumstats_kernel``
``qmc_path_estimate``          ``qmc_path_estimate``
``_run_qmc_path``              ``qmc_path`` (kernel wrapper)
``_replicate_shifts``          ``_replicate_shifts``
=============================  ============================

``qmc_path`` launches ``qmc_path_kernel`` (``csrc/qmc_path.cu``) for
tensors on a CUDA device and counts the launch in ``qmc_path.launches``;
for tensors on the CPU it runs the plain torch version ``_qmc_path_plain``.
Any other device raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..dtypes import MC_DTYPE, resolve_device
from . import stats as stats_ops
from .fastmath import exp32, norminv32
from .sobol import bridge_matrix, direction_numbers
from .swprng import jax_fold_in_bits
from .terminal_mc import _stream

__all__ = ["path_qmc_sumstats_kernel", "qmc_path_estimate", "qmc_path",
           "NSTAT", "PAYOFF_IDS"]

LANES = 128
P_TILE = 256          # points per rep tile
MAX_M_BITS = 31       # ≤ 2^31 points per replicate (int32 point index)
NSTAT = 6
PAYOFF_IDS = {"vanilla": 0, "barrier": 1, "asian": 2, "digital": 3,
              "lookback": 4}

_ROW = 8              # kernel stats rows are padded to 8 floats
_THREADS = 64         # csrc/qmc_path.cu THREADS: points per block
_BLOCKS_PER_TILE = P_TILE // _THREADS
_MAX_SMEM = 232448    # bytes of shared memory a block can have on Hopper
_TINY = 2.0 ** -24
# the plain version's working set: elements of one (points, steps) chunk
_PLAIN_CHUNK = 1 << 26
# flag bits of the kernel's runtime payoff switches (csrc/qmc_path.cu Flag)
_FLAG_BITS = {"barrier_up": 1, "knock_in": 2, "is_call": 4,
              "arithmetic": 8, "fixed_strike": 16}


# ---------------------------------------------------------------------------
# host planning: the kernel's inputs
# ---------------------------------------------------------------------------
def _plan(n_points: int, n_steps: int, n_replicates: int):
    """(m_bits, d_pad, reps, progs_per_rep) as the reference plans them."""
    m_bits = max(int(np.ceil(np.log2(max(n_points, 2)))), 11)
    if m_bits > MAX_M_BITS:
        raise ValueError(f"n_points={n_points} exceeds 2^{MAX_M_BITS} "
                         "points per replicate")
    d_pad = -(-int(n_steps) // LANES) * LANES
    tiles_per_rep = -(-int(n_points) // P_TILE)
    progs_per_rep = int(min(8, tiles_per_rep))
    reps = -(-tiles_per_rep // progs_per_rep)
    return int(m_bits), int(d_pad), int(reps), progs_per_rep


def _replicate_shifts(seed: int, *, R: int, d: int, d_pad: int) -> np.ndarray:
    """(R, d_pad) int32 digital-shift words, zero beyond column d."""
    out = np.zeros((R, d_pad), np.uint32)
    for i in range(R):
        out[i, :d] = jax_fold_in_bits(seed, i, d)
    return out.view(np.int32)


def _kernel_inputs(seed, n_points, n_steps, S0, K, T, r, q, sigma, *,
                   n_replicates, barrier, rebate, payout):
    """The host arrays of the reference: seed pair (seed, n_last), f32[6]
    params, V, shifts, B = σA and the drift row, as numpy."""
    d = int(n_steps)
    m_bits, d_pad, _, _ = _plan(n_points, d, n_replicates)
    V = np.zeros((m_bits, d_pad), np.uint32)
    V[:, :d] = direction_numbers(d, m_bits)
    shifts = _replicate_shifts(int(seed), R=int(n_replicates), d=d,
                               d_pad=d_pad)
    A = bridge_matrix(d, float(T))
    c = float(r) - float(q) - 0.5 * float(sigma) ** 2
    t = np.arange(1, d + 1, dtype=np.float64) * (float(T) / d)
    B = np.zeros((d_pad, d_pad), np.float32)
    B[:d, :d] = (float(sigma) * A).astype(np.float32)
    drift = np.zeros((1, d_pad), np.float32)
    drift[0, :d] = (np.log(float(S0)) + c * t).astype(np.float32)
    params = np.asarray([S0, K, np.exp(-float(r) * float(T)), barrier,
                         rebate, payout], np.float32)
    seed_pair = np.asarray([int(seed) & 0xFFFFFFFF, int(n_points) - 1],
                           np.uint32).view(np.int32)
    return seed_pair, params, V.view(np.int32), shifts, B, drift


def _check_inputs(seed, params, V, shifts, B, drift, *, n_programs, reps,
                  progs_per_rep, n_steps, d_pad, m_bits):
    if n_programs < 1 or reps < 1 or progs_per_rep < 1:
        raise ValueError("empty grid (n_points must be positive)")
    if n_programs % progs_per_rep:
        raise ValueError("n_programs must be a multiple of progs_per_rep")
    if not 1 <= n_steps <= d_pad or d_pad % LANES:
        raise ValueError(f"need 1 <= n_steps <= d_pad, d_pad a multiple of "
                         f"{LANES}; got {n_steps}, {d_pad}")
    if n_steps * (_THREADS + 8) * 4 > _MAX_SMEM:
        raise ValueError(f"n_steps={n_steps} needs more shared memory than "
                         "a block has")
    R = n_programs // progs_per_rep
    want = {"seed": (seed, torch.int32, (2,)),
            "params": (params, MC_DTYPE, (6,)),
            "V": (V, torch.int32, (m_bits, d_pad)),
            "shifts": (shifts, torch.int32, (R, d_pad)),
            "B": (B, MC_DTYPE, (d_pad, d_pad)),
            "drift": (drift, MC_DTYPE, (1, d_pad))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != params.device:
            raise ValueError(f"{name} on {t.device}, params on "
                             f"{params.device}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")


# ---------------------------------------------------------------------------
# plain torch version (the CPU path and the kernel's on-card reference)
# ---------------------------------------------------------------------------
def _qmc_path_plain(seed, params, V, shifts, B, drift, *, n_programs: int,
                    reps: int, progs_per_rep: int, n_steps: int, d_pad: int,
                    m_bits: int, payoff_id: int, barrier_up: bool,
                    knock_in: bool, is_call: bool, arithmetic: bool,
                    fixed_strike: bool) -> torch.Tensor:
    """Plain version of ``qmc_path``: (n_programs, 6) f32 rows, a chunk of
    reps at a time. The product z @ B runs as one multiply and one add per
    step index, in the kernel's order, so logS rounds as in the kernel."""
    del d_pad
    dev = params.device
    d = n_steps
    n_last = int(seed[1])
    S0, K, df, barrier, rebate, payout = (params[i] for i in range(6))
    sign = 1.0 if is_call else -1.0
    pid = torch.arange(n_programs, dtype=torch.int64, device=dev)
    rep_id = pid // progs_per_rep
    tile_idx = (pid % progs_per_rep).view(-1, 1, 1)
    shift = (shifts[rep_id, :d].to(torch.int64) & 0xFFFFFFFF).view(
        n_programs, 1, 1, d)
    Vd = V[:, :d].to(torch.int64) & 0xFFFFFFFF
    Bd = B[:d, :d]
    row = torch.arange(P_TILE, dtype=torch.int64, device=dev).view(1, 1, -1)

    def vanilla(x):
        return torch.clamp(sign * (x - K), min=0.0)

    chunk = max(1, _PLAIN_CHUNK // (n_programs * P_TILE * d))
    acc = torch.zeros((n_programs, NSTAT), dtype=MC_DTYPE, device=dev)
    comp = torch.zeros_like(acc)
    for j0 in range(0, reps, chunk):
        js = torch.arange(j0, min(reps, j0 + chunk), dtype=torch.int64,
                          device=dev).view(1, -1, 1)
        idx = (tile_idx * reps + js) * P_TILE + row     # (progs, reps, 256)
        gray = (idx ^ (idx >> 1)).unsqueeze(-1)
        x = shift.expand(-1, idx.shape[1], P_TILE, -1)
        for k in range(m_bits):
            x = x ^ (((gray >> k) & 1) * Vd[k])
        u = ((x >> 8).to(MC_DTYPE) + 0.5) * _TINY
        z = norminv32(u)
        dot = torch.zeros_like(z)
        for k in range(d):
            dot = dot + z[..., k:k + 1] * Bd[k]
        logS = drift[0, :d] + dot
        S = exp32(logS)
        ST = S[..., d - 1]
        if payoff_id == 2:
            avg = S.sum(-1) / d if arithmetic else exp32(logS.sum(-1) / d)
            pay = vanilla(avg) if fixed_strike \
                else torch.clamp(sign * (ST - avg), min=0.0)
        elif payoff_id == 4:
            rmax = torch.maximum(S.amax(-1), S0)
            rmin = torch.minimum(S.amin(-1), S0)
            if fixed_strike:
                pay = torch.clamp(rmax - K, min=0.0) if is_call \
                    else torch.clamp(K - rmin, min=0.0)
            else:
                pay = (ST - rmin) if is_call else (rmax - ST)
        elif payoff_id == 1:
            hit = (S >= barrier) if barrier_up else (S <= barrier)
            hit0 = bool(S0 >= barrier) if barrier_up else bool(S0 <= barrier)
            crossed = hit.any(-1) | hit0
            live = vanilla(ST)
            pay = torch.where(crossed, live if knock_in else rebate,
                              rebate if knock_in else live)
        elif payoff_id == 3:
            pay = torch.where(sign * (ST - K) > 0.0, payout, 0.0)
        else:
            pay = vanilla(ST)
        w = (idx <= n_last).to(MC_DTYPE)
        X = df * pay * w
        Y = df * ST * w
        s = torch.stack([w.sum(-1), X.sum(-1), (X * pay * df).sum(-1),
                         Y.sum(-1), (Y * ST * df).sum(-1),
                         (X * ST * df).sum(-1)], dim=-1)  # (progs, reps, 6)
        for c in range(s.shape[1]):
            acc, comp = stats_ops.kahan_add(acc, comp, s[:, c])
    return acc


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def qmc_path(seed, params, V, shifts, B, drift, *, n_programs: int,
             reps: int, progs_per_rep: int, n_steps: int, d_pad: int,
             m_bits: int, payoff_id: int, barrier_up: bool, knock_in: bool,
             is_call: bool, arithmetic: bool, fixed_strike: bool
             ) -> torch.Tensor:
    """f32[n_programs, 6] path-QMC sums, one row per program.

    Kernel ``qmc_path_kernel`` in ``csrc/qmc_path.cu``; it replaces
    ``optpricer_tpu/ops/pallas_qmc_path.py:_qmc_path_kernel`` (launched
    from ``_run_qmc_path``). One thread owns one point: its Sobol words
    and normals go to shared memory, then it forms each time step's
    log-spot as a dot product with a column of B, eight columns at a time
    from a slab the block stages in shared memory (the whole B, 256 KB at
    252 steps, does not fit). Bound by the n_steps² multiply-adds of that
    product.
    """
    kw = dict(n_programs=n_programs, reps=reps, progs_per_rep=progs_per_rep,
              n_steps=n_steps, d_pad=d_pad, m_bits=m_bits)
    _check_inputs(seed, params, V, shifts, B, drift, **kw)
    flags = dict(barrier_up=barrier_up, knock_in=knock_in, is_call=is_call,
                 arithmetic=arithmetic, fixed_strike=fixed_strike)
    if params.device.type == "cpu":
        return _qmc_path_plain(seed, params, V, shifts, B, drift,
                               payoff_id=payoff_id, **kw, **flags)
    dev = params.device
    bits = sum(_FLAG_BITS[name] for name, on in flags.items() if on)
    block_rows = torch.empty((n_programs * reps * _BLOCKS_PER_TILE, _ROW),
                             dtype=MC_DTYPE, device=dev)
    out = torch.empty((n_programs, _ROW), dtype=MC_DTYPE, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_qmc_path(
            seed.data_ptr(), params.data_ptr(), V.data_ptr(),
            shifts.data_ptr(), B.data_ptr(), drift.data_ptr(),
            block_rows.data_ptr(), out.data_ptr(), n_programs, reps,
            progs_per_rep, n_steps, d_pad, m_bits, int(payoff_id), bits,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"qmc_path_kernel launch failed: CUDA error {err}")
    qmc_path.launches += 1
    return out[:, :NSTAT]


qmc_path.launches = 0


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def path_qmc_sumstats_kernel(seed: int, n_points: int, n_steps: int,
                             S0, K, T, r, q, sigma, is_call: bool, *,
                             payoff: str = "vanilla", n_replicates: int = 8,
                             barrier: float = 0.0,
                             barrier_type: str = "up-and-out",
                             rebate: float = 0.0,
                             average_type: str = "arithmetic",
                             strike_type: str = "fixed", payout: float = 1.0,
                             device=None) -> np.ndarray:
    """(R, 6) float64 per-replicate sufficient statistics
    [n, ΣX, ΣX², ΣY, ΣY², ΣXY] with X = e^{−rT}·payoff, Y = e^{−rT}·S_T.

    ``n_points`` is the budget per replicate (≤ 2^31). The programs of a
    replicate are summed on the host in float64.
    """
    if payoff not in PAYOFF_IDS:
        raise ValueError(f"unknown payoff {payoff!r}")
    dev = resolve_device(device)
    R = int(n_replicates)
    m_bits, d_pad, reps, ppr = _plan(int(n_points), int(n_steps), R)
    arrays = _kernel_inputs(seed, int(n_points), int(n_steps), S0, K, T, r,
                            q, sigma, n_replicates=R, barrier=barrier,
                            rebate=rebate, payout=payout)
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    rows = qmc_path(*tensors, n_programs=R * ppr, reps=reps,
                    progs_per_rep=ppr, n_steps=int(n_steps), d_pad=d_pad,
                    m_bits=m_bits, payoff_id=PAYOFF_IDS[payoff],
                    barrier_up=barrier_type.startswith("up"),
                    knock_in=barrier_type.endswith("in"),
                    is_call=bool(is_call),
                    arithmetic=average_type == "arithmetic",
                    fixed_strike=strike_type == "fixed")
    rows = rows.cpu().numpy().astype(np.float64)
    return rows.reshape(R, ppr, NSTAT).sum(axis=1)


def qmc_path_estimate(rep_stats, S0, q, T, *, control_variate: bool = True):
    """(price, stderr) from (R, 6) replicate stats: the mean of the R
    replicate estimates (spot-CV adjusted when asked; E[e^{−rT}S_T] =
    S0·e^{−qT}) and the spread of those estimates as the error bar."""
    s = rep_stats
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    s = np.asarray(s, np.float64)
    R = s.shape[0]
    if control_variate:
        EY = float(S0) * np.exp(-float(q) * float(T))
        est = np.array([stats_ops.cv_mean_se_np(s[i], EY)[0]
                        for i in range(R)])
    else:
        est = s[:, 1] / s[:, 0]
    return float(est.mean()), float(est.std(ddof=1) / np.sqrt(R))

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
port's Threefry, all R in two broadcast passes, so a seed randomises the
same point set the same way.

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
Any other device raises. The kernel reads the bridge by its nonzeros from
a plan that ``_bridge_plan`` builds on the host, beside B, in
``_kernel_inputs``; its sparse bridge and block-common Sobol words have
plain mirrors, ``_bridge_sparse_plain`` and ``_sobol_words_split``.
"""
from __future__ import annotations

import functools
import math

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
_LOW_BITS = 6         # csrc/qmc_path.cu LOW_BITS: Gray-code bits a thread owns
_JB = 8               # csrc/qmc_path.cu JB: bridge columns per group
_SLOTS = 32           # csrc/qmc_path.cu SLOTS: normals a thread holds at once
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


def _plan_width(n_steps: int) -> int:
    """Entries a column of the kernel's bridge table: ceil(log2 d) + 1, the
    most nonzeros a column of the Brownian-bridge matrix holds (time j's
    ancestors in the bisection schedule and the terminal dimension)."""
    return (int(n_steps) - 1).bit_length() + 1


def _shared_bytes(n_steps: int) -> int:
    """csrc/qmc_path.cu shared_bytes: a block's slots of normals and its
    common words."""
    return (_SLOTS * _THREADS + int(n_steps)) * 4


def _replicate_shifts(seed: int, *, R: int, d: int, d_pad: int) -> np.ndarray:
    """(R, d_pad) int32 digital-shift words, zero beyond column d: row i is
    ``bits(fold_in(key(seed), i), (d,))``, all R rows in two broadcast
    Threefry passes (``jax_fold_in_bits``). Cached per (seed, R, d,
    d_pad); callers get copies."""
    return _shift_words(int(seed), int(R), int(d), int(d_pad)).copy()


@functools.lru_cache(maxsize=16)
def _shift_words(seed: int, R: int, d: int, d_pad: int) -> np.ndarray:
    out = np.zeros((R, d_pad), np.uint32)
    out[:, :d] = jax_fold_in_bits(seed, np.arange(R), d)
    return out.view(np.int32)


def _kernel_inputs(seed, n_points, n_steps, S0, K, T, r, q, sigma, *,
                   n_replicates, barrier, rebate, payout):
    """The host arrays of the reference: seed pair (seed, n_last), f32[6]
    params, V, shifts, B = σA and the drift row, as numpy, then the
    kernel's plan of B (``_bridge_plan``)."""
    d = int(n_steps)
    m_bits, d_pad, _, _ = _plan(n_points, d, n_replicates)
    V, B, plan = _bridge_tables(d, m_bits, float(T), float(sigma))
    shifts = _replicate_shifts(seed, R=n_replicates, d=d, d_pad=d_pad)
    c = float(r) - float(q) - 0.5 * float(sigma) ** 2
    t = np.arange(1, d + 1, dtype=np.float64) * (float(T) / d)
    drift = np.zeros((1, d_pad), np.float32)
    drift[0, :d] = (np.log(float(S0)) + c * t).astype(np.float32)
    params = np.asarray([S0, K, np.exp(-float(r) * float(T)), barrier,
                         rebate, payout], np.float32)
    seed_pair = np.asarray([int(seed) & 0xFFFFFFFF, int(n_points) - 1],
                           np.uint32).view(np.int32)
    return (seed_pair, params, V.copy(), shifts, B.copy(), drift,
            plan.copy())


@functools.lru_cache(maxsize=16)
def _bridge_tables(d: int, m_bits: int, T: float, sigma: float):
    """(V, B, plan) of a shape, σ and T: the direction numbers as int32
    (m_bits, d_pad), B = σA as f32 (d_pad, d_pad) and its plan. Cached, as
    none depends on the seed or the market but σ and T; callers get
    copies."""
    d_pad = -(-d // LANES) * LANES
    V = np.zeros((m_bits, d_pad), np.uint32)
    V[:, :d] = direction_numbers(d, m_bits)
    V = V.view(np.int32)
    B = np.zeros((d_pad, d_pad), np.float32)
    B[:d, :d] = (sigma * bridge_matrix(d, T)).astype(np.float32)
    return V, B, _bridge_plan(B, V, d)


def _check_inputs(seed, params, V, shifts, B, drift, plan=None, *,
                  n_programs, reps, progs_per_rep, n_steps, d_pad, m_bits):
    if n_programs < 1 or reps < 1 or progs_per_rep < 1:
        raise ValueError("empty grid (n_points must be positive)")
    if n_programs % progs_per_rep:
        raise ValueError("n_programs must be a multiple of progs_per_rep")
    if not 1 <= n_steps <= d_pad or d_pad % LANES:
        raise ValueError(f"need 1 <= n_steps <= d_pad, d_pad a multiple of "
                         f"{LANES}; got {n_steps}, {d_pad}")
    if _shared_bytes(n_steps) > _MAX_SMEM:
        raise ValueError(f"n_steps={n_steps} needs more shared memory than "
                         f"a block has ({_MAX_SMEM} bytes)")
    if not _LOW_BITS <= m_bits <= MAX_M_BITS:
        raise ValueError(f"m_bits={m_bits} outside [{_LOW_BITS}, "
                         f"{MAX_M_BITS}]")
    R = n_programs // progs_per_rep
    want = {"seed": (seed, torch.int32, (2,)),
            "params": (params, MC_DTYPE, (6,)),
            "V": (V, torch.int32, (m_bits, d_pad)),
            "shifts": (shifts, torch.int32, (R, d_pad)),
            "B": (B, MC_DTYPE, (d_pad, d_pad)),
            "drift": (drift, MC_DTYPE, (1, d_pad))}
    if plan is not None:
        want["plan"] = (plan, torch.int32,
                        (_plan_layout(n_steps, _plan_width(n_steps))[1],))
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
def _qmc_path_plain(seed, params, V, shifts, B, drift, plan=None, *,
                    n_programs: int, reps: int, progs_per_rep: int,
                    n_steps: int, d_pad: int, m_bits: int, payoff_id: int,
                    barrier_up: bool, knock_in: bool, is_call: bool,
                    arithmetic: bool, fixed_strike: bool,
                    step_order: bool = False) -> torch.Tensor:
    """Plain version of ``qmc_path``: (n_programs, 6) f32 rows, a chunk of
    reps at a time. The product z @ B runs densely, as one multiply and one
    add per step index in ascending k, which the kernel's sum over the
    nonzeros alone keeps bit for bit; the plan is not read.

    ``step_order``: the Asian's running sums of S and log S are formed one
    step at a time from +0, in step order, and divided by the step count,
    as the kernel forms them, not by ``torch.sum``, whose other order
    parts from the kernel's by more than the f32 round-off of one sum at
    thousands of steps. A mirror for the tests and ``chip_smoke.py``; the
    CPU path does not take it."""
    del d_pad, plan
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
            x = S if arithmetic else logS
            if step_order:
                total = torch.zeros_like(x[..., 0])
                for k in range(d):
                    total = total + x[..., k]
                avg = total / torch.tensor(float(d), dtype=MC_DTYPE,
                                           device=dev)
            else:
                avg = x.sum(-1) / d
            if not arithmetic:
                avg = exp32(avg)
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
# the kernel's plan of B, and plain mirrors of its sparse bridge and split
# Sobol words
# ---------------------------------------------------------------------------
def _plan_layout(n_steps: int, width: int):
    """((shape, first int) of entries, groups, gen and vlow, ints in all):
    the plan's int32 array as csrc/qmc_path.cu carve reads it, each part
    16-byte aligned."""
    n_groups = -(-int(n_steps) // _JB)
    layout, at = [], 0
    for shape in ((n_groups, width, 2 * _JB), (n_groups, 2), (n_steps, 2),
                  (n_steps, 8)):
        layout.append((shape, at))
        at += -(-math.prod(shape) // 4) * 4
    return tuple(layout), at


def _plan_parts(plan, n_steps: int):
    """(entries, groups, gen, vlow) views of a plan (numpy or torch)."""
    layout, _ = _plan_layout(n_steps, _plan_width(n_steps))
    return tuple(plan[at:at + math.prod(shape)].reshape(shape)
                 for shape, at in layout)


def _bridge_plan(B: np.ndarray, V: np.ndarray, n_steps: int) -> np.ndarray:
    """The plan ``qmc_path_kernel`` reads B by: int32, ``_plan_layout``.

    Dimension k lives from the group (of 8 columns) of its first nonzero
    column to that of its last; the dimensions, in order of first group
    (ascending k within one), each take the lowest of ``_SLOTS`` slots
    free in that group. entries (n_groups, width, 16): entry i of group g
    holds in column c < 8 the slot offset s·64 of column 8g + c's i-th
    nonzero (ascending k) and in column 8 + c the bits of B[k, 8g + c];
    past a column's last nonzero, 0 and +0. groups (n_groups, 2): the
    group's first gen row and its count. gen (n_steps, 2): (k, slot
    offset) by first group; rows past the used dimensions are 0. vlow
    (n_steps, 8): the direction numbers of Gray-code bits 0..5 at each
    dimension and two zeros. Built from the f32 B, so that an entry that
    underflows to 0 is skipped. Raises where B is not a bridge the plan
    can hold: a column with more than ``_plan_width`` nonzeros, or more
    than ``_SLOTS`` dimensions live in one group."""
    d = int(n_steps)
    width = _plan_width(d)
    n_groups = -(-d // _JB)
    nz = B[:d, :d] != 0.0
    counts = nz.sum(axis=0)
    if int(counts.max()) > width:
        raise ValueError(f"B has a column of {int(counts.max())} nonzeros, "
                         f"more than a Brownian bridge's {width} at {d} "
                         "steps")
    used = nz.any(axis=1)
    first = np.where(used, nz.argmax(axis=1) // _JB, -1)
    last = np.where(used, (d - 1 - nz[:, ::-1].argmax(axis=1)) // _JB, -1)
    order = np.flatnonzero(used)
    order = order[np.argsort(first[order], kind="stable")]
    slot = np.zeros(d, np.int64)
    until = [-1] * _SLOTS            # the last group of each slot's tenant
    for k in order.tolist():
        s = next((s for s in range(_SLOTS) if until[s] < first[k]), None)
        if s is None:
            raise ValueError(f"B has more than {_SLOTS} dimensions live in "
                             f"the group of column {_JB * int(first[k])}")
        until[s], slot[k] = int(last[k]), s
    plan = np.zeros(_plan_layout(d, width)[1], np.int32)
    entries, groups, gen, vlow = _plan_parts(plan, d)
    jj, kk = np.nonzero(nz.T)        # by column, ascending k within one
    pos = np.arange(jj.size) - (np.cumsum(counts) - counts)[jj]
    entries[jj // _JB, pos, jj % _JB] = slot[kk] * _THREADS
    entries[jj // _JB, pos, _JB + jj % _JB] = B[kk, jj].view(np.int32)
    bucket = np.searchsorted(first[order], np.arange(n_groups + 1))
    groups[:, 0], groups[:, 1] = bucket[:-1], np.diff(bucket)
    gen[:order.size, 0], gen[:order.size, 1] = order, slot[order] * _THREADS
    vlow[:, :_LOW_BITS] = V[:_LOW_BITS, :d].T
    return plan


def _bridge_sparse_plain(z, plan, *, n_steps: int) -> torch.Tensor:
    """The kernel's bridge, (..., n_steps) from normals z (..., n_steps),
    through its slots: per group of 8 columns, the normals first used there
    stored into their slots (which start at +0), then each column summed
    over its table entries, a = a + slot·b from +0 in entry order."""
    entries, groups, gen, _ = (torch.as_tensor(t) for t in
                               _plan_parts(plan, n_steps))
    z = z[..., :n_steps]
    slots = torch.zeros(z.shape[:-1] + (_SLOTS,), dtype=z.dtype,
                        device=z.device)
    cols = []
    for g in range(len(groups)):
        first, count = (int(v) for v in groups[g])
        for k, off in gen[first:first + count].tolist():
            slots[..., off // _THREADS] = z[..., k]
        a = torch.zeros(z.shape[:-1] + (_JB,), dtype=z.dtype, device=z.device)
        for i in range(entries.shape[1]):
            s = entries[g, i, :_JB].long() // _THREADS
            b = entries[g, i, _JB:].contiguous().view(torch.float32)
            a = a + slots[..., s] * b
        cols.append(a)
    return torch.cat(cols, dim=-1)[..., :n_steps]


def _sobol_words_split(idx, V, shift, *, m_bits: int) -> torch.Tensor:
    """The kernel's Sobol words (..., d) for point indices idx (...): the
    block-common word (the shift and the direction numbers of Gray-code
    bits 6 .. m_bits−1 of the block's first point) XOR the direction
    numbers of the point's own 6 low bits. uint32 values in int64."""
    idx = idx.to(torch.int64)
    gray = idx ^ (idx >> 1)
    first = idx - (idx % _THREADS)
    gray_hi = first ^ (first >> 1)
    Vd = V.to(torch.int64) & 0xFFFFFFFF
    x = (shift.to(torch.int64) & 0xFFFFFFFF).expand(idx.shape + shift.shape)
    for b in range(_LOW_BITS, m_bits):
        x = x ^ (((gray_hi >> b) & 1).unsqueeze(-1) * Vd[b])
    for b in range(_LOW_BITS):
        x = x ^ (((gray >> b) & 1).unsqueeze(-1) * Vd[b])
    return x


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def blocks_per_sm(payoff_id: int, n_steps: int) -> int:
    """Resident blocks per SM of ``qmc_path_kernel`` for the payoff at
    ``n_steps`` on the current card (the CUDA runtime's occupancy with the
    block's dynamic shared memory)."""
    n = _build.load().optpricer_qmc_path_occupancy(int(payoff_id),
                                                   int(n_steps))
    if n < 0:
        raise RuntimeError("qmc_path occupancy query failed")
    return n


def qmc_path(seed, params, V, shifts, B, drift, plan=None, *,
             n_programs: int, reps: int, progs_per_rep: int, n_steps: int,
             d_pad: int, m_bits: int, payoff_id: int, barrier_up: bool,
             knock_in: bool, is_call: bool, arithmetic: bool,
             fixed_strike: bool) -> torch.Tensor:
    """f32[n_programs, 6] path-QMC sums, one row per program.

    Kernel ``qmc_path_kernel`` in ``csrc/qmc_path.cu``; it replaces
    ``optpricer_tpu/ops/pallas_qmc_path.py:_qmc_path_kernel`` (launched
    from ``_run_qmc_path``). B must be a Brownian bridge σA, and on a CUDA
    device ``plan`` its plan, ``_bridge_plan(B, V, n_steps)``, which
    ``_kernel_inputs`` builds beside it: each column's nonzeros in
    ascending k (a bridge holds at most ⌈log2 d⌉ + 1 a column,
    ``_plan_width``), and for each dimension a slot of ``_SLOTS`` from the
    group of 8 columns of its first use to that of its last. The kernel
    reads B only through the plan; the plain version on the CPU forms the
    dense product and does not read the plan.

    One thread owns one point of a block of 64: the block XORs the
    Gray-code bits its points share into one word a step, each thread its
    own 6 low bits; a thread draws each normal into its slot when its
    dimension is first used, then forms each step's log-spot from the
    column's nonzeros alone, eight columns' chains interleaved, in the
    dense product's k order, so logS keeps the dense product's bits. A
    block holds 8 KB of slots and n_steps common words: registers (64 a
    thread, 16 blocks an SM) bound its residency up to about 1 000 steps,
    shared memory above that (13 blocks an SM at 2 048 steps). Bound by
    the issue of its instructions: per point and step one norminv32,
    ~log2(d) + 1 multiply-adds with their shared loads and, for the Asian,
    one exp32.
    """
    kw = dict(n_programs=n_programs, reps=reps, progs_per_rep=progs_per_rep,
              n_steps=n_steps, d_pad=d_pad, m_bits=m_bits)
    _check_inputs(seed, params, V, shifts, B, drift, plan, **kw)
    flags = dict(barrier_up=barrier_up, knock_in=knock_in, is_call=is_call,
                 arithmetic=arithmetic, fixed_strike=fixed_strike)
    if params.device.type == "cpu":
        return _qmc_path_plain(seed, params, V, shifts, B, drift,
                               payoff_id=payoff_id, **kw, **flags)
    if plan is None:
        raise ValueError("qmc_path_kernel reads B through its plan: pass "
                         "plan=_bridge_plan(B, V, n_steps)")
    dev = params.device
    bits = sum(_FLAG_BITS[name] for name, on in flags.items() if on)
    rows = n_programs * reps * _BLOCKS_PER_TILE
    # the block rows, then the program rows, in one allocation
    sums = torch.empty((rows + n_programs, _ROW), dtype=MC_DTYPE, device=dev)
    out = sums[rows:]
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_qmc_path(
            seed.data_ptr(), params.data_ptr(), V.data_ptr(),
            shifts.data_ptr(), drift.data_ptr(), plan.data_ptr(),
            sums.data_ptr(), out.data_ptr(), n_programs, reps, progs_per_rep,
            n_steps, d_pad, m_bits, _plan_width(n_steps), int(payoff_id),
            bits, _stream(dev))
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

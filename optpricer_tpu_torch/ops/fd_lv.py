"""Fused local-vol θ-scheme march of a strike ladder in one kernel (K8).

Counterpart of ``optpricer_tpu/ops/pallas_fd_lv.py``: the whole march of
``models.pde.fd_price_local_vol_batch(solver="fused" | "fused_pcr" |
"fused_thomas")`` — σ from a precomputed table, the operator diagonals,
the rhs with the Dirichlet transfer, a PCR or Thomas solve and the
optional American projection — for every time step inside one launch of
``fd_lv_pcr_kernel`` / ``fd_lv_thomas_kernel`` (``csrc/fd_lv.cu``).

Names, JAX → port:

=========================  ==========================
``fd_lv_ladder_pallas``    ``fd_lv_ladder_kernel``
``_run_fd_lv``             ``fd_lv`` (kernel wrapper)
``_fd_lv_kernel``          ``fd_lv_pcr_kernel``, ``fd_lv_thomas_kernel``
=========================  ==========================

The σ table is built as the reference builds it: S on the full grid is
``exp`` of the f32 grid, ``t_n = arange(N_t)·dt`` in f32, ``sigma_func``
is evaluated on the device for every t_n at once (``torch.vmap``, the
counterpart of ``jax.vmap``) and the interior rows are kept. The port
stores it as (N_t, m_pad), so a step's column is contiguous; the reference
stores (m_pad, n_t_pad) and picks a column by a one-hot lane reduction.
``convert.fd_lv_sigma_table`` carries a reference table across.

Everything is float32, as on the TPU. Rows m..m_pad−1 (m_pad = m rounded
up to 8, the reference's grid padding) are identity equations that solve
to 0. The strikes are not padded: there is no lane tile on the card, and
``b_tile`` and ``interpret`` are accepted for the reference's signature and
ignored.

``fd_lv`` launches ``fd_lv_plan_kernel`` and then the march for tensors
on a CUDA device, and counts the launch in ``fd_lv.launches`` and by method
in ``fd_lv.launches_by_method``; for tensors on the CPU it runs the plain
torch version ``_fd_lv_plain``, which repeats the kernel's f32 arithmetic
operation by operation (with ``ops/fastmath.exp32``). Any other device
raises. There is no fallback: a failed build or launch raises.

The pre-kernel writes the march's strike-independent terms once per
launch (``csrc/fd_lv.cu``, "plan"); ``_fd_lv_plan_plain`` is its plain
version and ``_fd_lv_march_plain`` the march of every strike from that
plan, which gives ``_fd_lv_plain``'s layer bit for bit. ``_launch_plan``
is the kernels' grid and the plan's size, as ``optpricer_fd_lv`` computes
them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..dtypes import resolve_device
from ..utils.profiling import annotated
from .black_scholes import is_call_mask
from .fastmath import exp32
from .grid import build_grid
from .terminal_mc import _stream

__all__ = ["fd_lv_ladder_kernel", "fd_lv", "fd_lv_plan", "METHODS"]

GROUP = 8                      # the reference's grid-row padding
METHODS = {"pcr": 0, "thomas": 1}
_MAX_PCR_ROWS = 1024           # one thread per row in one block
_F32 = torch.float32
# csrc/fd_lv.cu's constants
PCR_STRIKES = 8                # strikes a PCR block
THOMAS_STRIKES = 8             # strikes a Thomas block
THOMAS_THREADS = 128           # threads (four warps) a Thomas block
PLAN_WORDS = 8                 # plan floats per (step, row)
MAX_SMEM = 232_448             # dynamic shared memory a block may use
# a Thomas block's shared words per row: two steps' plan (2 x 2 float4),
# the strikes' layer and d' columns, S
THOMAS_ROW_WORDS = 16 + 2 * THOMAS_STRIKES + 1
THOMAS_SMEM_ROWS = MAX_SMEM // (THOMAS_ROW_WORDS * 4)


# ---------------------------------------------------------------------------
# plain torch version (the CPU path and the kernel's on-card reference)
# ---------------------------------------------------------------------------
def _shift_down(x, k):
    """Row i gets x[i − k]; rows < k get 0."""
    return torch.cat([torch.zeros_like(x[:k]), x[:-k]])


def _shift_up(x, k):
    """Row i gets x[i + k]; the last k rows get 0."""
    return torch.cat([x[k:], torch.zeros_like(x[:k])])


def _fd_lv_plain(params, K, sign, sig_tab, *, n_t: int, m: int, m_pad: int,
                 theta: float, american: bool, method: str) -> torch.Tensor:
    """Plain version of ``fd_lv``: the (m_pad, B) interior layer at t = 0.

    Every array is laid out as the reference's (m_pad, lanes) tiles, one
    column per strike; the σ-derived coefficients are the same in every
    column, so they are kept as one (m_pad, 1) column."""
    dev = params.device
    x_min, dx, dt, r, q = (params[i] for i in range(5))
    e = float(np.float32(1.0 - theta)) * dt
    td = float(np.float32(theta)) * dt
    rows = torch.arange(m_pad, device=dev).view(-1, 1)
    interior = (rows < m).to(_F32)
    row0 = (rows == 0).to(_F32)
    rowL = (rows == m - 1).to(_F32)

    S = exp32(x_min + (rows.to(_F32) + 1.0) * dx)
    S_min = torch.exp(x_min)
    S_max = torch.exp(x_min + float(m + 1) * dx)
    Kr = K.view(1, -1)
    sg = sign.view(1, -1)
    is_call = sg > 0.0
    zero = torch.zeros((), dtype=_F32, device=dev)
    intrinsic = torch.maximum(sg * (S - Kr), zero) * interior

    def bc_pair(tau):
        disc_K = Kr * exp32(-r * tau + 0.0 * Kr)
        left = torch.where(is_call, zero, torch.maximum(disc_K - S_min, zero))
        right = torch.where(is_call, torch.maximum(S_max - disc_K, zero),
                            zero)
        return left, right

    V = intrinsic
    bc_l_old, bc_r_old = bc_pair(zero)
    for i in range(n_t):
        n_i = (n_t - 1) - i
        tau = float(n_t - ((n_t - 1) - i)) * dt
        sig = sig_tab[n_i].view(-1, 1)
        alpha = 0.5 * sig * sig / (dx * dx)
        beta = (r - q - 0.5 * sig * sig) / (2.0 * dx)
        AL = (alpha - beta) * interior
        CL = (alpha + beta) * interior
        bc_l_new, bc_r_new = bc_pair(tau)

        Vm1 = torch.cat([bc_l_old, V[:-1]])
        Vp1 = _shift_up(V, 1)
        Vp1[m - 1] = bc_r_old[0]
        bL = -(AL + CL) - r * interior
        DP = ((1.0 + e * bL) * V + e * AL * Vm1 + e * CL * Vp1
              + td * AL * row0 * bc_l_new + td * CL * rowL * bc_r_new)

        if method == "pcr":
            not0 = (rows != 0).to(_F32)
            notL = (rows != m - 1).to(_F32)
            rb0 = 1.0 / (1.0 + td * (AL + CL + r * interior))
            D = DP * rb0
            A = -td * AL * not0 * rb0
            C = -td * CL * notL * rb0
            for k in range((m_pad - 1).bit_length()):
                sft = 1 << k
                am, cm, dm = (_shift_down(x, sft) for x in (A, C, D))
                ap, cpv, dpv = (_shift_up(x, sft) for x in (A, C, D))
                rcp = 1.0 / (1.0 - A * cm - C * ap)
                A, C, D = (-rcp * A * am, -rcp * C * cpv,
                           rcp * (D - A * dm - C * dpv))
            V = D
        else:
            CP = torch.empty_like(DP)
            cp_prev = torch.zeros_like(DP[0])
            dp_prev = torch.zeros_like(DP[0])
            for j in range(m_pad):
                mask_int = 1.0 if j < m else 0.0
                a_lhs = zero if j == 0 else -td * AL[j]
                b_lhs = 1.0 + td * (AL[j] + CL[j] + r * mask_int)
                c_lhs = -td * CL[j]
                rcp = 1.0 / (b_lhs - a_lhs * cp_prev)
                cp_prev = c_lhs * rcp
                dp_prev = (DP[j] - a_lhs * dp_prev) * rcp
                CP[j] = cp_prev
                DP[j] = dp_prev
            V = torch.empty_like(DP)
            x_next = torch.zeros_like(DP[0])
            for j in range(m_pad - 1, -1, -1):
                cj = zero if j == m_pad - 1 else CP[j]
                x_next = DP[j] - cj * x_next
                V[j] = x_next
        if american:
            V = torch.maximum(V, intrinsic)
        bc_l_old, bc_r_old = bc_l_new, bc_r_new
    return V


def _plan_offsets(n_t: int, m_pad: int):
    """(start of exp32(−r·τ), start of S) in a plan of ``_launch_plan``'s
    ``plan_floats`` words: the (n_t, m_pad, PLAN_WORDS) terms first."""
    disc = n_t * m_pad * PLAN_WORDS
    return disc, disc + n_t + 1


def _fd_lv_plan_plain(params, sig_tab, *, n_t: int, m: int, m_pad: int,
                      theta: float, method: str) -> torch.Tensor:
    """Plain version of ``fd_lv_plan_kernel``: f32[plan_floats], the
    strike-independent terms of every (march step, row) in the kernel's
    layout (``csrc/fd_lv.cu``), by ``_fd_lv_plain``'s operations."""
    dev = params.device
    x_min, dx, dt, r, q = (params[i] for i in range(5))
    e = float(np.float32(1.0 - theta)) * dt
    td = float(np.float32(theta)) * dt
    rows = torch.arange(m_pad, device=dev)
    interior = (rows < m).to(_F32)
    row0 = (rows == 0).to(_F32)
    rowL = (rows == m - 1).to(_F32)
    zero = torch.zeros((), dtype=_F32, device=dev)

    sig = sig_tab.flip(0)                      # march order: step i, n_t-1-i
    alpha = 0.5 * sig * sig / (dx * dx)
    beta = (r - q - 0.5 * sig * sig) / (2.0 * dx)
    AL = (alpha - beta) * interior
    CL = (alpha + beta) * interior
    bL = -(AL + CL) - r * interior
    b_lhs = 1.0 + td * (AL + CL + r * interior)
    words = [1.0 + e * bL, e * AL, e * CL, td * AL * row0, td * CL * rowL]
    if method == "pcr":
        rb0 = 1.0 / b_lhs
        words += [rb0, -td * AL * (rows != 0).to(_F32) * rb0,
                  -td * CL * (rows != m - 1).to(_F32) * rb0]
    else:
        a_lhs = torch.where(rows == 0, zero, -td * AL)
        c_lhs = -td * CL
        rcp = torch.empty_like(b_lhs)
        cback = torch.empty_like(b_lhs)
        cp_prev = torch.zeros_like(b_lhs[:, 0])
        for j in range(m_pad):
            rcp[:, j] = 1.0 / (b_lhs[:, j] - a_lhs[:, j] * cp_prev)
            cp_prev = c_lhs[:, j] * rcp[:, j]
            cback[:, j] = zero if j == m_pad - 1 else cp_prev
        words += [cback, a_lhs, rcp]
    tau = torch.arange(1, n_t + 1, dtype=_F32, device=dev) * dt
    disc = exp32(torch.cat([(-r * zero).view(1), -r * tau]))
    S = exp32(x_min + (rows.to(_F32) + 1.0) * dx)
    return torch.cat([torch.stack(words, dim=-1).reshape(-1), disc, S])


def _fd_lv_march_plain(plan, params, K, sign, *, n_t: int, m: int,
                       m_pad: int, american: bool,
                       method: str) -> torch.Tensor:
    """The (m_pad, B) layer at t = 0 from a plan (``_fd_lv_plan_plain``'s
    or the kernel's): the march's per-strike substitution, as the kernels
    run it. Equal to ``_fd_lv_plain`` bit for bit."""
    dev = params.device
    x_min, dx = params[0], params[1]
    o_disc, o_S = _plan_offsets(n_t, m_pad)
    words = plan[:o_disc].view(n_t, m_pad, PLAN_WORDS)
    disc = plan[o_disc:o_S]
    S = plan[o_S:].view(-1, 1)
    interior = (torch.arange(m_pad, device=dev) < m).to(_F32).view(-1, 1)
    S_min = torch.exp(x_min)
    S_max = torch.exp(x_min + float(m + 1) * dx)
    Kr = K.view(1, -1)
    sg = sign.view(1, -1)
    is_call = sg > 0.0
    zero = torch.zeros((), dtype=_F32, device=dev)
    intrinsic = torch.maximum(sg * (S - Kr), zero) * interior

    def bc_pair(dsc):
        disc_K = Kr * dsc
        left = torch.where(is_call, zero, torch.maximum(disc_K - S_min, zero))
        right = torch.where(is_call, torch.maximum(S_max - disc_K, zero),
                            zero)
        return left, right

    V = intrinsic
    bc_l_old, bc_r_old = bc_pair(disc[0])
    for i in range(n_t):
        f1, eA, eC, tA0, tCL, w5, w6, w7 = (words[i, :, k].view(-1, 1)
                                            for k in range(PLAN_WORDS))
        bc_l_new, bc_r_new = bc_pair(disc[i + 1])
        Vm1 = torch.cat([bc_l_old, V[:-1]])
        Vp1 = _shift_up(V, 1)
        Vp1[m - 1] = bc_r_old[0]
        D = f1 * V + eA * Vm1 + eC * Vp1 + tA0 * bc_l_new + tCL * bc_r_new
        if method == "pcr":
            D, A, C = D * w5, w6, w7
            for k in range((m_pad - 1).bit_length()):
                sft = 1 << k
                am, cm, dm = (_shift_down(x, sft) for x in (A, C, D))
                ap, cpv, dpv = (_shift_up(x, sft) for x in (A, C, D))
                rcp = 1.0 / (1.0 - A * cm - C * ap)
                A, C, D = (-rcp * A * am, -rcp * C * cpv,
                           rcp * (D - A * dm - C * dpv))
            V = D
        else:
            dp = torch.zeros_like(D[0])
            for j in range(m_pad):
                dp = (D[j] - w6[j] * dp) * w7[j]
                D[j] = dp
            V = torch.empty_like(D)
            x = torch.zeros_like(D[0])
            for j in range(m_pad - 1, -1, -1):
                x = D[j] - w5[j] * x
                V[j] = x
        if american:
            V = torch.maximum(V, intrinsic)
        bc_l_old, bc_r_old = bc_l_new, bc_r_new
    return V


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def _check(params, K, sign, sig_tab, n_t, m, m_pad, method):
    if method not in METHODS:
        raise ValueError(f"method must be one of {sorted(METHODS)}, got "
                         f"{method!r}")
    if not 1 <= m <= m_pad or (method == "pcr" and m_pad > _MAX_PCR_ROWS):
        raise ValueError(f"need 1 <= m <= m_pad (<= {_MAX_PCR_ROWS} for "
                         f"pcr), got m={m}, m_pad={m_pad}")
    B = K.shape[0] if K.dim() == 1 else -1
    want = {"params": (params, (6,)), "K": (K, (B,)), "sign": (sign, (B,)),
            "sig_tab": (sig_tab, (n_t, m_pad))}
    for name, (t, shape) in want.items():
        if t.dtype != _F32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != params.device:
            raise ValueError(f"{name} on {t.device}, params on "
                             f"{params.device}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")


class LaunchPlan(NamedTuple):
    """``optpricer_fd_lv``'s launch of the march: strikes a block, blocks,
    threads a block, dynamic shared-memory bytes, the plan's f32 words
    (the pre-kernel runs one block of 256 threads per step) and the f32
    words of the Thomas scratch (0 where the columns fit in shared
    memory)."""
    strikes_per_block: int
    blocks: int
    threads: int
    smem_bytes: int
    plan_floats: int
    scratch_floats: int


def _launch_plan(method: str, n_strikes: int, m_pad: int,
                 n_t: int) -> LaunchPlan:
    """The grid of ``fd_lv_pcr_kernel`` / ``fd_lv_thomas_kernel`` for
    ``n_strikes`` strikes on ``m_pad`` rows, as ``csrc/fd_lv.cu`` computes
    it. PCR: ``PCR_STRIKES`` strikes a block, one thread per row, the
    layers, a, c and the strikes' d in shared memory. Thomas:
    ``THOMAS_STRIKES`` strikes a block of ``THOMAS_THREADS``, which form
    the rhs together, one lane a strike running its substitutions; up to
    ``THOMAS_SMEM_ROWS``
    rows, shared memory holds two steps' plan, the strikes' layer and d'
    columns and S; above them the plan is read from device memory and the
    columns are the output and an (m_pad, B) scratch."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {sorted(METHODS)}, got "
                         f"{method!r}")
    if method == "pcr" and m_pad > _MAX_PCR_ROWS:
        raise ValueError(f"pcr takes m_pad <= {_MAX_PCR_ROWS}, got {m_pad}")
    plan_floats = _plan_offsets(n_t, m_pad)[1] + m_pad
    if method == "pcr":
        g = PCR_STRIKES
        return LaunchPlan(g, -(-n_strikes // g), m_pad,
                          (3 * g + 4) * m_pad * 4, plan_floats, 0)
    g = THOMAS_STRIKES
    in_smem = m_pad <= THOMAS_SMEM_ROWS
    return LaunchPlan(g, -(-n_strikes // g), THOMAS_THREADS,
                      THOMAS_ROW_WORDS * m_pad * 4 if in_smem else 0,
                      plan_floats, 0 if in_smem else m_pad * n_strikes)


@annotated("optpricer.launch.fd_lv")
def fd_lv(params, K, sign, sig_tab, *, n_t: int, m: int, m_pad: int,
          theta: float, american: bool, method: str = "pcr") -> torch.Tensor:
    """f32[m_pad, B]: the interior layer at t = 0 of every strike's march.

    ``params`` f32[6] (x_min, dx, dt, r, q, T); ``K`` and ``sign`` (+1 call,
    −1 put) f32[B]; ``sig_tab`` f32[n_t, m_pad], row n the σ column of step
    n. Kernels ``fd_lv_plan_kernel``, then ``fd_lv_pcr_kernel`` /
    ``fd_lv_thomas_kernel`` in ``csrc/fd_lv.cu``; they replace
    ``optpricer_tpu/ops/pallas_fd_lv.py:_fd_lv_kernel`` (launched from
    ``_run_fd_lv``). The pre-kernel computes the strike-independent terms
    (for Thomas the factorisation too) once per step; PCR runs
    ``PCR_STRIKES`` strikes a block, Thomas ``THOMAS_STRIKES`` a block, one
    lane a strike's substitutions, the plan staged in shared memory
    (``_launch_plan``).
    """
    _check(params, K, sign, sig_tab, n_t, m, m_pad, method)
    kw = dict(n_t=n_t, m=m, m_pad=m_pad, theta=theta, american=american,
              method=method)
    if params.device.type == "cpu":
        return _fd_lv_plain(params, K, sign, sig_tab, **kw)
    dev = params.device
    B = K.shape[0]
    plan = _launch_plan(method, B, m_pad, n_t)
    out = torch.empty((m_pad, B), dtype=_F32, device=dev)
    table = torch.empty(plan.plan_floats, dtype=_F32, device=dev)
    scratch = torch.empty(max(plan.scratch_floats, 1), dtype=_F32,
                          device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_fd_lv(
            params.data_ptr(), K.data_ptr(), sign.data_ptr(),
            sig_tab.data_ptr(), out.data_ptr(), table.data_ptr(),
            scratch.data_ptr(), n_t, m, m_pad, B,
            float(np.float32(1.0 - theta)), float(np.float32(theta)),
            int(bool(american)), METHODS[method], _stream(dev))
    if err != 0:
        raise RuntimeError(f"fd_lv kernel launch failed: CUDA error {err}")
    fd_lv.launches += 1
    fd_lv.launches_by_method[method] += 1
    return out


fd_lv.launches = 0
fd_lv.launches_by_method = {method: 0 for method in METHODS}


def fd_lv_plan(params, sig_tab, *, n_t: int, m: int, m_pad: int,
               theta: float, method: str = "pcr") -> torch.Tensor:
    """f32[plan_floats]: the plan ``fd_lv`` computes before its march, by
    ``fd_lv_plan_kernel`` alone on a CUDA device and by
    ``_fd_lv_plan_plain`` on the CPU (same layout, ``csrc/fd_lv.cu``)."""
    K = torch.ones(1, dtype=_F32, device=params.device)
    _check(params, K, K, sig_tab, n_t, m, m_pad, method)
    if params.device.type == "cpu":
        return _fd_lv_plan_plain(params, sig_tab, n_t=n_t, m=m, m_pad=m_pad,
                                 theta=theta, method=method)
    dev = params.device
    table = torch.empty(_launch_plan(method, 1, m_pad, n_t).plan_floats,
                        dtype=_F32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_fd_lv_plan(
            params.data_ptr(), sig_tab.data_ptr(), table.data_ptr(), n_t, m,
            m_pad, float(np.float32(1.0 - theta)), float(np.float32(theta)),
            METHODS[method], _stream(dev))
    if err != 0:
        raise RuntimeError(f"fd_lv plan launch failed: CUDA error {err}")
    return table


# ---------------------------------------------------------------------------
# host planning and the public entry point
# ---------------------------------------------------------------------------
def _sigma_table(sigma_func, x_np, dt, N_S: int, N_t: int, m_pad: int,
                 device) -> torch.Tensor:
    """f32[N_t, m_pad]: σ(S_j, t_n) on the interior nodes, zero beyond m."""
    m = N_S - 1
    S_grid32 = torch.exp(torch.as_tensor(x_np, dtype=_F32, device=device))
    t_vals = (torch.arange(N_t, dtype=_F32, device=device)
              * torch.tensor(dt, dtype=_F32, device=device))

    def column(t):
        sig = torch.as_tensor(sigma_func(S_grid32, t), dtype=_F32,
                              device=device)
        return sig.expand(S_grid32.shape)[1:N_S]

    table = torch.zeros((N_t, m_pad), dtype=_F32, device=device)
    table[:, :m] = torch.vmap(column)(t_vals)
    return table


def _kernel_inputs(S0, K, T, r, q, kind, *, N_S, N_t, S_max_mult, ref_vol):
    """Host arrays: (x grid f64, dt, strikes f64, call mask, params f32[6],
    K f32[B], sign f32[B], m, m_pad)."""
    K_arr = np.atleast_1d(np.asarray(K, dtype=float)).reshape(-1)
    mask = np.broadcast_to(np.atleast_1d(is_call_mask(kind)),
                           K_arr.shape).copy()
    x_np, dx, dt = build_grid(S0, T, ref_vol, N_S, N_t, S_max_mult)
    m = int(N_S) - 1
    m_pad = -(-m // GROUP) * GROUP
    params = np.asarray([x_np[0], dx, dt, r, q, T], np.float32)
    sign = np.where(mask, 1.0, -1.0).astype(np.float32)
    return (x_np, dt, K_arr, mask, params, K_arr.astype(np.float32), sign,
            m, m_pad)


def fd_lv_ladder_kernel(S0, K, T, r, q, sigma_func, kind, *,
                        N_S: int = 512, N_t: int = 512, theta: float = 0.5,
                        S_max_mult: float = 4.0, ref_vol: float = 0.3,
                        american: bool = False, b_tile: int = 512,
                        interpret=None, method: str = "pcr",
                        device=None) -> np.ndarray:
    """Local-vol strike/kind ladder priced by the fused march: (B,) float64
    prices interpolated at ln S0 on the host.

    Same grid and θ-scheme as ``models.pde.fd_price_local_vol_batch``;
    ``sigma_func(S, t)`` is a torch callable of a grid tensor and a 0-d
    time. ``method``: ``"pcr"`` (parallel cyclic reduction, N_S ≤ 1025) or
    ``"thomas"``. ``b_tile`` and ``interpret`` are the reference's TPU
    options and are ignored.
    """
    del b_tile, interpret
    dev = resolve_device(device)
    (x_np, dt, K_arr, mask, params, K32, sign, m, m_pad) = _kernel_inputs(
        S0, K, T, r, q, kind, N_S=N_S, N_t=N_t, S_max_mult=S_max_mult,
        ref_vol=ref_vol)
    sig_tab = _sigma_table(sigma_func, x_np, dt, int(N_S), int(N_t), m_pad,
                           dev)
    as_dev = lambda a: torch.from_numpy(a).to(dev)
    V_int = fd_lv(as_dev(params), as_dev(K32), as_dev(sign), sig_tab,
                  n_t=int(N_t), m=m, m_pad=m_pad, theta=float(theta),
                  american=bool(american), method=str(method))

    return _ladder_prices(V_int, x_np, K_arr, mask, S0, r, T)


def _ladder_prices(V_int, x_np, K_arr, mask, S0, r, T) -> np.ndarray:
    """(B,) f64 prices at ln S0 from the kernel's (m_pad, B') layer: the
    analytic Dirichlet rows at tau = T around the m interior rows, then a
    linear interpolation per strike, on the host."""
    B = K_arr.size
    m = len(x_np) - 2
    V_int = V_int.cpu().numpy()[:m, :B]
    disc_K = K_arr * np.exp(-r * T)
    S_min, S_max = np.exp(x_np[0]), np.exp(x_np[-1])
    left = np.where(mask, 0.0, np.maximum(disc_K - S_min, 0.0))
    right = np.where(mask, np.maximum(S_max - disc_K, 0.0), 0.0)
    V_full = np.concatenate([left[None, :], V_int, right[None, :]], axis=0)
    x0 = np.log(S0)
    prices = np.empty(B)
    for b in range(B):
        prices[b] = np.interp(x0, x_np, V_full[:, b])
    return prices

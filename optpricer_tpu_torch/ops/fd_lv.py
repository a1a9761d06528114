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

``fd_lv`` launches the kernel for tensors on a CUDA device and counts the
launch in ``fd_lv.launches``; for tensors on the CPU it runs the plain
torch version ``_fd_lv_plain``, which repeats the kernel's f32 arithmetic
operation by operation (with ``ops/fastmath.exp32``). Any other device
raises. There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..dtypes import resolve_device
from .black_scholes import is_call_mask
from .fastmath import exp32
from .grid import build_grid
from .terminal_mc import _stream

__all__ = ["fd_lv_ladder_kernel", "fd_lv", "METHODS"]

GROUP = 8                      # the reference's grid-row padding
METHODS = {"pcr": 0, "thomas": 1}
_MAX_PCR_ROWS = 1024           # one thread per row in one block
_F32 = torch.float32


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


def fd_lv(params, K, sign, sig_tab, *, n_t: int, m: int, m_pad: int,
          theta: float, american: bool, method: str = "pcr") -> torch.Tensor:
    """f32[m_pad, B]: the interior layer at t = 0 of every strike's march.

    ``params`` f32[6] (x_min, dx, dt, r, q, T); ``K`` and ``sign`` (+1 call,
    −1 put) f32[B]; ``sig_tab`` f32[n_t, m_pad], row n the σ column of step
    n. Kernels ``fd_lv_pcr_kernel`` / ``fd_lv_thomas_kernel`` in
    ``csrc/fd_lv.cu``; they replace
    ``optpricer_tpu/ops/pallas_fd_lv.py:_fd_lv_kernel`` (launched from
    ``_run_fd_lv``). PCR: one block per strike, one thread per row, the
    levels in shared memory. Thomas: one thread per strike, V and c' in an
    (m_pad, B) scratch. Both bound by operations (see the source).
    """
    _check(params, K, sign, sig_tab, n_t, m, m_pad, method)
    kw = dict(n_t=n_t, m=m, m_pad=m_pad, theta=theta, american=american,
              method=method)
    if params.device.type == "cpu":
        return _fd_lv_plain(params, K, sign, sig_tab, **kw)
    dev = params.device
    B = K.shape[0]
    out = torch.empty((m_pad, B), dtype=_F32, device=dev)
    scratch = torch.empty((m_pad, B) if method == "thomas" else (1,),
                          dtype=_F32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_fd_lv(
            params.data_ptr(), K.data_ptr(), sign.data_ptr(),
            sig_tab.data_ptr(), out.data_ptr(), scratch.data_ptr(), n_t, m,
            m_pad, B, float(np.float32(1.0 - theta)),
            float(np.float32(theta)), int(bool(american)), METHODS[method],
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"fd_lv kernel launch failed: CUDA error {err}")
    fd_lv.launches += 1
    return out


fd_lv.launches = 0


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

"""Finite-difference θ-scheme solver for the Black-Scholes PDE.

Counterpart of ``optpricer_tpu/models/pde.py``: uniform log-spot grid
x = ln S, θ time stepping (0 explicit, ½ Crank-Nicolson, 1 implicit),
Dirichlet boundaries with discounted-strike asymptotics, American
projection or PSOR, barrier nodes (after-step override or in-operator
Dirichlet rows), knock-in by parity, discrete cash dividends as jump
conditions, grid Greeks, local vol and strike ladders. Names, signatures
and results follow the reference; every entry point also takes
``device=`` (default ``"cuda"``). FD defaults to float64 (``dtypes.py``);
``dtype="float32"`` works everywhere.

The reference's ``lax.scan`` time march is a Python loop over the steps.
Per step, one of:

* the propagator (constant coefficients): V⁺ = P·V + ℓ·w₀ + ρ·w_M with
  P = (I−θdtL)⁻¹(I+(1−θ)dtL) built once from M tridiagonal solves through
  :func:`~optpricer_tpu_torch.ops.tridiag.tridiag_solve_thomas` (K7 on the
  card), then one dense ``torch.matmul`` per step — a plain matrix product,
  as the reference leaves it to XLA outside any kernel;
* a tridiagonal solve per step (local vol, PSOR's warm start, the
  per-step solvers). Which solver:

  ========================  =====================  =====================
  ``solver``                CUDA tensors           CPU tensors
  ========================  =====================  =====================
  ``"auto"``, other         K7                     ``tridiag_solve``
  ``"pallas"``              K7                     K7's plain version
  ``"thomas"``              K7                     K7's plain version
  ``"parallel"``            ``tridiag_solve``      ``tridiag_solve``
  ========================  =====================  =====================

  On the TPU ``"auto"`` sends only time-dependent steps to its Thomas
  kernel; here every per-step solve of a CUDA march goes to K7: the torch
  log-depth solve (:func:`~optpricer_tpu_torch.ops.tridiag.tridiag_solve`)
  is ~3·⌈log₂ M⌉ doubling passes of several launches each per step, where
  the reference's XLA scan is one fused program. K7 is one launch a step:
  one block per system, parallel cyclic reduction in shared memory, the
  step's ``(..., M)`` rows read and written where they lie. A single
  system (a local-vol or PSOR march) is bound by K7's ⌈log₂ M⌉ levels and
  its launch, a ladder by the bytes of its right-hand sides; the march
  around it, a dozen or more small launches a step, is host-bound. The
  CPU keeps the reference's CPU choice. As in the reference, PSOR's warm
  start under ``"pallas"`` on the CPU takes ``tridiag_solve``.

``solver="fused"`` / ``"fused_pcr"`` / ``"fused_thomas"`` of
:func:`fd_price_local_vol_batch` run the whole march in one kernel (K8,
``ops/fd_lv.py``), float32 like the reference's.

``sigma_func`` is a torch callable ``(S: Tensor, t: Tensor) -> Tensor``
(t a 0-d tensor of the grid's dtype), evaluated on the grid's device.
"""
from __future__ import annotations

from typing import Callable, Literal

import numpy as np
import torch

from ..core import CALL, PUT, OptionSpec
from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import is_call_mask
from ..ops.fd_lv import fd_lv_ladder_kernel
from ..ops.grid import build_grid as _build_grid
from ..ops.thomas import tridiag_solve_kernel_lastdim
from ..ops.tridiag import tridiag_solve, tridiag_solve_thomas

__all__ = ["fd_price", "fd_price_barrier", "fd_price_double_barrier",
           "fd_greeks", "fd_price_local_vol",
           "fd_price_batch", "fd_price_local_vol_batch"]


def _payoff(S, K, is_call):
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    return torch.where(is_call, torch.maximum(S - K, zero),
                       torch.maximum(K - S, zero))


def _readout(x_np, V, S0):
    """Interpolate the solved ladder at ln(S0), on the host in f64 (as the
    reference does)."""
    V_np = V.detach().cpu().numpy() if isinstance(V, torch.Tensor) \
        else np.asarray(V)
    x0 = np.log(S0)
    j = int(np.clip(np.searchsorted(x_np, x0) - 1, 0, len(x_np) - 2))
    w = (x0 - x_np[j]) / (x_np[j + 1] - x_np[j])
    return (1.0 - w) * V_np[..., j] + w * V_np[..., j + 1]


def _operator_tridiag(sig_int, dx, r, q):
    """Interior-operator tridiagonals (a_L, b_L, c_L):
    L V_j = α(V_{j−1} − 2V_j + V_{j+1}) + β(V_{j+1} − V_{j−1}) − rV_j
    with α = σ²/2dx², β = μ/2dx, μ = r − q − σ²/2."""
    alpha = 0.5 * sig_int**2 / dx**2
    mu = r - q - 0.5 * sig_int**2
    beta = mu / (2.0 * dx)
    return alpha - beta, -2.0 * alpha - r, alpha + beta


def _bc_values(tau, K, r, S_min, S_max, is_call):
    """Dirichlet boundary values with discounted-strike asymptotics."""
    disc_K = K * torch.exp(-r * tau)
    zero = torch.zeros((), dtype=disc_K.dtype, device=disc_K.device)
    bc_left = torch.where(is_call, zero, torch.maximum(disc_K - S_min, zero))
    bc_right = torch.where(is_call, torch.maximum(S_max - disc_K, zero), zero)
    return bc_left, bc_right


_SOLVERS = ("auto", "propagator", "parallel", "thomas", "pallas")
_SOLVERS_BATCH_LV = _SOLVERS + ("fused", "fused_pcr", "fused_thomas")


def _check_solver(solver: str, valid=_SOLVERS) -> str:
    if solver not in valid:
        raise ValueError(f"unknown solver {solver!r}; expected one of "
                         f"{', '.join(valid)}")
    return solver


def _step_solver(solver: str, on_card: bool, use_psor: bool = False):
    """The per-step tridiagonal solver (table in the module docstring)."""
    if solver == "parallel":
        return tridiag_solve
    if solver == "thomas":
        return tridiag_solve_thomas
    if solver == "pallas" and not use_psor:
        return tridiag_solve_kernel_lastdim
    return tridiag_solve_kernel_lastdim if on_card else tridiag_solve


def _dense(sub, main, sup):
    return (torch.diag(main) + torch.diag(sub[1:], -1)
            + torch.diag(sup[:-1], 1))


def _fd_solve(x_grid, dt, K, r, q, sigma, is_call, theta,
              barrier_mask, barrier_value, div_amts=None,
              *, N_t: int, american: bool, two_layers: bool,
              sigma_func: Callable | None = None, solver: str = "auto",
              american_method: str = "projection", psor_sweeps: int = 30,
              barrier_operator: bool = False, has_divs: bool = False):
    """Backward θ-scheme march. Returns (V, V at n = 1) when
    ``two_layers``, else (V, V).

    Every array argument is a tensor on the march's device (scalars 0-d,
    of the grid's dtype); ``K``/``is_call`` may be (B,) for a ladder on one
    grid, one propagator and one march. ``barrier_mask`` is a node mask
    (``None`` for vanilla) forced to ``barrier_value`` after each step;
    ``barrier_operator`` also makes the masked rows identity rows of the
    implicit system. ``div_amts`` is the (N_t+1,) numpy schedule of
    ``_div_schedule_np``.
    """
    N_S = x_grid.shape[0] - 1
    M = N_S - 1
    dev, dtype = x_grid.device, x_grid.dtype
    dx = x_grid[1] - x_grid[0]
    S_grid = torch.exp(x_grid)
    S_min, S_max = S_grid[0], S_grid[-1]
    if K.dim() == 1:
        K_b, call_b = K[:, None], is_call[:, None]
    else:
        K_b, call_b = K, is_call

    intrinsic = _payoff(S_grid, K_b, call_b)
    V0 = torch.where(barrier_mask, barrier_value, intrinsic) \
        if barrier_mask is not None else intrinsic

    const_coeff = sigma_func is None
    use_psor = american and american_method == "psor"
    # PSOR needs the explicit rhs each step, so it rides the tridiag branch
    use_prop = const_coeff and solver in ("auto", "propagator") \
        and not use_psor
    solve = _step_solver(solver, x_grid.is_cuda, use_psor)
    e = (1.0 - theta) * dt
    if const_coeff:
        sig_int = sigma.expand(M)
        a_L, b_L, c_L = _operator_tridiag(sig_int, dx, r, q)
        if barrier_operator and barrier_mask is not None:
            # knocked-out interior nodes become identity rows of the
            # θ-scheme system (true in-operator Dirichlet)
            m_int = barrier_mask[1:N_S]
            zero = torch.zeros((), dtype=dtype, device=dev)
            a_L = torch.where(m_int, zero, a_L)
            b_L = torch.where(m_int, zero, b_L)
            c_L = torch.where(m_int, zero, c_L)
        a_lhs = -theta * dt * a_L
        b_lhs = 1.0 - theta * dt * b_L
        c_lhs = -theta * dt * c_L
    if use_prop:
        # P = A_lhs⁻¹ A_rhs column by column: row k of A_rhsᵀ is column k
        # of A_rhs, and each solve gives a column of P
        A_rhs = _dense(e * a_L, 1.0 + e * b_L, e * c_L)
        P = tridiag_solve_thomas(a_lhs, b_lhs, c_lhs, A_rhs.T).T
        unit = torch.zeros((2, M), dtype=dtype, device=dev)
        unit[0, 0] = 1.0
        unit[1, M - 1] = 1.0
        w = tridiag_solve_thomas(a_lhs, b_lhs, c_lhs, unit)
        w_lo, w_hi = w[0], w[1]
        PT = P.T

    if has_divs:
        # PV of the dividends still to come as seen from each time node,
        # pv[n] = Σ_{k>n} D_k·e^{−r(k−n)dt}: the far-field boundaries carry
        # the forward stock net of future drops
        amts = torch.as_tensor(div_amts, dtype=dtype, device=dev)
        ks = torch.arange(N_t + 1, dtype=dtype, device=dev)
        wts = amts * torch.exp(-r * dt * ks)
        pv_divs = (torch.flip(torch.cumsum(torch.flip(wts, (0,)), 0), (0,))
                   - wts) * torch.exp(r * dt * ks)

    def div_remap(V, D):
        """Jump condition at an ex-dividend date: V(S, t⁻) = V(S − D, t⁺),
        linear interpolation of the carried layer at ln(max(S − D, S_min))."""
        x_new = torch.log(torch.maximum(S_grid - D, S_min))
        u = (x_new - x_grid[0]) / dx
        j = torch.clamp(torch.floor(u).to(torch.int64), 0, N_S - 1)
        wgt = torch.clamp(u - j.to(V.dtype), 0.0, 1.0)
        return V[..., j] * (1.0 - wgt) + V[..., j + 1] * wgt

    # the steps' time-to-expiry and time, as the reference's scan computes
    # them from n = N_t−1, …, 0
    ns = torch.arange(N_t - 1, -1, -1, dtype=dtype, device=dev)
    taus = (N_t - ns) * dt
    t_nows = ns * dt
    bcs = _bc_values(taus if K.dim() == 0 else taus[:, None], K, r, S_min,
                     S_max, is_call)
    if has_divs:
        disc_K = K * torch.exp(-r * (taus if K.dim() == 0 else taus[:, None]))
        pv = pv_divs[N_t - 1 - torch.arange(N_t, device=dev)]
        pv = pv if K.dim() == 0 else pv[:, None]
        zero = torch.zeros((), dtype=dtype, device=dev)
        bcs = (torch.where(is_call, zero, torch.maximum(
                   disc_K - torch.maximum(S_min - pv, zero), zero)),
               torch.where(is_call, torch.maximum(S_max - pv - disc_K, zero),
                           zero))

    if use_psor:
        omega = 1.6
        parity = (torch.arange(M, device=dev) % 2).to(torch.bool)

    V, V_dt = V0, V0
    for k in range(N_t):
        n = N_t - 1 - k
        if has_divs:
            # the carry is the t_{n+1}⁺ layer; a dividend AT t_{n+1} remaps
            # it to the t_{n+1}⁻ layer before stepping back
            D = float(div_amts[n + 1])
            if D > 0.0:
                V = div_remap(V, D)
            if american:
                # exercising at t⁻ must be offered explicitly
                V = torch.maximum(V, intrinsic)
        bc_left, bc_right = bcs[0][k], bcs[1][k]
        V_int = V[..., 1:N_S]

        if use_prop:
            lc = e * a_L[0] * V[..., 0] + theta * dt * a_L[0] * bc_left
            rc = e * c_L[-1] * V[..., N_S] + theta * dt * c_L[-1] * bc_right
            V_new_int = torch.matmul(V_int, PT) \
                + lc[..., None] * w_lo + rc[..., None] * w_hi
        else:
            if const_coeff:
                aL, bL, cL = a_L, b_L, c_L
                al, bl, cl = a_lhs, b_lhs, c_lhs
            else:
                sig = torch.as_tensor(sigma_func(S_grid, t_nows[k]), dtype=dtype,
                                      device=dev).expand(S_grid.shape)
                aL, bL, cL = _operator_tridiag(sig[1:N_S], dx, r, q)
                al = -theta * dt * aL
                bl = 1.0 - theta * dt * bL
                cl = -theta * dt * cL

            # RHS = (I + (1−θ)dt·L) V_old on the interior + boundary transfer
            rhs = (1.0 + e * bL) * V_int
            rhs[..., 1:] += e * aL[1:] * V[..., 1:N_S - 1]
            rhs[..., 0] += e * aL[0] * V[..., 0]
            rhs[..., :-1] += e * cL[:-1] * V[..., 2:N_S]
            rhs[..., -1] += e * cL[-1] * V[..., N_S]
            rhs[..., 0] += theta * dt * aL[0] * bc_left
            rhs[..., -1] += theta * dt * cL[-1] * bc_right
            V_new_int = solve(al, bl, cl, rhs)

            if use_psor:
                # the LCP min(A V − rhs, V − ψ) = 0 by projected red-black
                # SOR, warm-started from the European solve; tridiagonal
                # neighbours have opposite parity, so each half-sweep is one
                # vectorised update
                psi = intrinsic[..., 1:N_S]
                Vp = torch.maximum(V_new_int, psi)
                zero = torch.zeros_like(Vp[..., :1])
                for _ in range(psor_sweeps):
                    for mask in (~parity, parity):
                        # boundary contributions already live in rhs, so
                        # the out-of-range neighbours are zero
                        Vm1 = torch.cat([zero, Vp[..., :-1]], dim=-1)
                        Vp1 = torch.cat([Vp[..., 1:], zero], dim=-1)
                        gs = (rhs - al * Vm1 - cl * Vp1) / bl
                        cand = torch.maximum(psi, (1.0 - omega) * Vp
                                             + omega * gs)
                        Vp = torch.where(mask, cand, Vp)
                V_new_int = Vp

        lead = V_new_int.shape[:-1]
        V_new = torch.cat([bc_left.expand(lead)[..., None], V_new_int,
                           bc_right.expand(lead)[..., None]], dim=-1)
        if american:
            V_new = torch.maximum(V_new, intrinsic)
        if barrier_mask is not None:
            V_new = torch.where(barrier_mask, barrier_value, V_new)
        if two_layers and n == 1:
            V_dt = V_new
        V = V_new
    return (V, V_dt) if two_layers else (V, V)


def _prep_solve(S0, K, T, r, q, sigma, kind, N_S, N_t, theta, S_max_mult,
                dtype, device, grid_sigma=None):
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    x_grid_np, dx, dt = _build_grid(S0, T, grid_sigma or sigma, N_S, N_t,
                                    S_max_mult)
    t = lambda v: torch.as_tensor(v, dtype=dt_, device=dev)
    x_grid = t(x_grid_np)
    args = dict(x_grid=x_grid, dt=t(dt), K=t(K), r=t(r), q=t(q),
                sigma=t(sigma),
                is_call=torch.as_tensor(is_call_mask(kind), device=dev),
                theta=t(theta))
    return x_grid_np, x_grid, args


def _div_schedule_np(dividends, T, N_t) -> np.ndarray:
    """(N_t+1,) per-time-index cash dividend amounts from a
    [(t, amount), ...] list; each date snaps to its nearest time node
    (index 1..N_t), coincident dates accumulate. Host float64."""
    amts = np.zeros(N_t + 1)
    for t_d, D in dividends:
        if not 0.0 < t_d <= T:
            raise ValueError(f"dividend date {t_d} outside (0, T={T}]")
        if D < 0.0:
            raise ValueError(f"negative dividend {D}")
        amts[max(1, int(round(t_d / T * N_t)))] += D
    return amts


def _div_schedule(dividends, T, N_t, dtype, device=None):
    return torch.as_tensor(_div_schedule_np(dividends, T, N_t),
                           dtype=canonical(dtype),
                           device=resolve_device(device))


def _div_kw(dividends, T, N_t):
    if not dividends:
        return {}
    return dict(has_divs=True, div_amts=_div_schedule_np(dividends, T, N_t))


def fd_price(opt: OptionSpec, kind: Literal["call", "put"] = CALL, *,
             N_S: int = 200, N_t: int = 200, theta: float = 0.5,
             S_max_mult: float = 4.0, american: bool = False,
             dtype=None, solver: str = "auto",
             american_method: str = "projection",
             psor_sweeps: int = 30, dividends=None, device=None) -> float:
    """European/American vanilla price via the θ-scheme.

    ``american_method``: "projection" (project after each solve) or "psor"
    (the LCP by projected red-black SOR per step). ``dividends=[(t,
    amount), ...]`` prices under the piecewise-GBM discrete-cash-dividend
    model: each date snaps to its nearest time node and enters as the jump
    condition V(S, t⁻) = V(S − amount, t⁺)."""
    _check_solver(solver)
    x_np, x_grid, args = _prep_solve(opt.S0, opt.K, opt.T, opt.r, opt.q,
                                     opt.sigma, kind, N_S, N_t, theta,
                                     S_max_mult, dtype, device)
    V, _ = _fd_solve(**args, barrier_mask=None, barrier_value=0.0,
                     N_t=int(N_t), american=bool(american), two_layers=False,
                     solver=solver, american_method=american_method,
                     psor_sweeps=int(psor_sweeps),
                     **_div_kw(dividends, opt.T, int(N_t)))
    return float(_readout(x_np, V, opt.S0))


def fd_price_barrier(opt: OptionSpec, kind: Literal["call", "put"] = CALL,
                     barrier: float = 0.0,
                     barrier_type: str = "up-and-out", *,
                     rebate: float = 0.0, N_S: int = 200, N_t: int = 200,
                     theta: float = 0.5, S_max_mult: float = 4.0,
                     dtype=None, solver: str = "auto",
                     barrier_mode: str = "node",
                     rebate_mode: str = "expiry", device=None) -> float:
    """European barrier price: knock-out via Dirichlet nodes at/beyond the
    barrier; knock-in via parity V_in = V_vanilla − V_out.

    ``barrier_mode="node"`` overrides the knocked-out nodes after each
    solve (the reference scheme; discrete-monitoring-like),
    ``"operator"`` builds them into the θ-system as identity rows (true
    continuous monitoring, the barrier snapped onto a node).
    ``rebate_mode="expiry"`` pays the rebate at expiry, assembled from the
    discounted survival probability (a strike difference of two
    zero-rebate solves on the same grid); ``"node"`` uses the rebate as
    the Dirichlet value (paid at hit, undiscounted)."""
    _check_solver(solver)
    if barrier_mode not in ("node", "operator"):
        raise ValueError("barrier_mode must be 'node' or 'operator'")
    if rebate_mode not in ("expiry", "node"):
        raise ValueError("rebate_mode must be 'expiry' or 'node'")
    grid_kw = dict(N_S=N_S, N_t=N_t, theta=theta, S_max_mult=S_max_mult,
                   dtype=dtype, solver=solver, barrier_mode=barrier_mode,
                   rebate_mode=rebate_mode, device=device)
    if barrier_type.endswith("in"):
        out_type = barrier_type.replace("in", "out")
        vanilla = fd_price(opt, kind, **{k: v for k, v in grid_kw.items()
                                         if k not in ("barrier_mode",
                                                      "rebate_mode")})
        if rebate == 0.0 or rebate_mode == "node":
            knock_out = fd_price_barrier(opt, kind, barrier, out_type,
                                         rebate=rebate, **grid_kw)
            return vanilla - knock_out
        ko0, disc_psurv = _fd_barrier_ko_and_psurv(
            opt, kind, barrier, out_type, N_S, N_t, theta, S_max_mult,
            dtype, solver, barrier_mode, device)
        return vanilla - ko0 + rebate * disc_psurv

    if rebate != 0.0 and rebate_mode == "expiry":
        ko0, disc_psurv = _fd_barrier_ko_and_psurv(
            opt, kind, barrier, barrier_type, N_S, N_t, theta, S_max_mult,
            dtype, solver, barrier_mode, device)
        disc = float(np.exp(-opt.r * opt.T))
        return ko0 + rebate * (disc - disc_psurv)

    x_np, args, mask = _fd_barrier_setup(opt, kind, barrier, barrier_type,
                                         N_S, N_t, theta, S_max_mult,
                                         dtype, barrier_mode, device)
    V, _ = _fd_solve(**args, barrier_mask=mask,
                     barrier_value=torch.as_tensor(
                         rebate, dtype=args["x_grid"].dtype,
                         device=args["x_grid"].device),
                     N_t=int(N_t), american=False, two_layers=False,
                     solver=solver,
                     barrier_operator=barrier_mode == "operator")
    return float(_readout(x_np, V, opt.S0))


def _fd_barrier_setup(opt, kind, barrier, barrier_type, N_S, N_t, theta,
                      S_max_mult, dtype, barrier_mode, device=None):
    """Shared grid + knocked-node mask for a single-barrier solve."""
    x_np, x_grid, args = _prep_solve(opt.S0, opt.K, opt.T, opt.r, opt.q,
                                     opt.sigma, kind, N_S, N_t, theta,
                                     S_max_mult, dtype, device)
    x_barrier = np.log(barrier)
    if barrier_mode == "operator" and x_np[0] < x_barrier < x_np[-1]:
        # snap ln(barrier) onto a node (a barrier outside the grid stays
        # unsnapped: the empty/total mask degenerates correctly)
        x_np = x_np + (x_barrier
                       - x_np[int(np.argmin(np.abs(x_np - x_barrier)))])
        args["x_grid"] = torch.as_tensor(x_np, dtype=x_grid.dtype,
                                         device=x_grid.device)
    if barrier_type.startswith("up"):
        mask = x_np >= x_barrier - 1e-12
    else:
        mask = x_np <= x_barrier + 1e-12
    return x_np, args, torch.as_tensor(mask, device=x_grid.device)


def _fd_barrier_ko_and_psurv(opt, kind, barrier, out_type, N_S, N_t, theta,
                             S_max_mult, dtype, solver, barrier_mode,
                             device=None):
    """(KO(0), e^{−rT}·p_surv) for a single knock-OUT barrier; p_surv is a
    strike difference of two zero-rebate knock-out solves on the same grid
    (up: puts struck B and 2B differ by B on survivors; down: calls struck
    B/2 and B differ by B/2)."""
    x_np, args, mask = _fd_barrier_setup(opt, kind, barrier, out_type,
                                         N_S, N_t, theta, S_max_mult,
                                         dtype, barrier_mode, device)
    dt_, dev = args["x_grid"].dtype, args["x_grid"].device

    def solve(K, is_call):
        a = dict(args, K=torch.as_tensor(K, dtype=dt_, device=dev),
                 is_call=torch.as_tensor(bool(is_call), device=dev))
        V, _ = _fd_solve(**a, barrier_mask=mask,
                         barrier_value=torch.zeros((), dtype=dt_, device=dev),
                         N_t=int(N_t), american=False, two_layers=False,
                         solver=solver,
                         barrier_operator=barrier_mode == "operator")
        return float(_readout(x_np, V, opt.S0))

    ko0 = solve(opt.K, is_call_mask(kind))
    if out_type.startswith("up"):
        disc_psurv = (solve(2.0 * barrier, False)
                      - solve(barrier, False)) / barrier
    else:
        disc_psurv = (solve(0.5 * barrier, True)
                      - solve(barrier, True)) / (0.5 * barrier)
    disc = float(np.exp(-opt.r * opt.T))
    return ko0, float(np.clip(disc_psurv, 0.0, disc))


def fd_price_double_barrier(opt: OptionSpec,
                            kind: Literal["call", "put"] = CALL, *,
                            lower: float, upper: float,
                            knock: str = "out", rebate: float = 0.0,
                            N_S: int = 200, N_t: int = 200,
                            theta: float = 0.5, dtype=None,
                            solver: str = "auto", device=None) -> float:
    """European double-barrier price on an absorbing corridor: the grid is
    the corridor (ln lower and ln upper on nodes, two padding nodes beyond
    each), with the in-operator Dirichlet rows of
    ``fd_price_barrier(barrier_mode="operator")``. Rebates pay at expiry,
    from e^{−rT}·p_surv as the difference of two corridor puts struck
    beyond the upper barrier."""
    _check_solver(solver)
    if knock not in ("in", "out"):
        raise ValueError("knock must be 'in' or 'out'")
    if not 0.0 < lower < upper:
        raise ValueError("need 0 < lower < upper")
    disc = float(np.exp(-opt.r * opt.T))
    if not lower < opt.S0 < upper:          # already knocked
        if knock == "out":
            return rebate * disc
        return fd_price(opt, kind, N_S=N_S, N_t=N_t, theta=theta,
                        dtype=dtype, solver=solver, device=device)
    dev = resolve_device(device)
    dt_ = canonical(dtype)

    def corridor(K, kind_, reb):
        pad = 2
        dx = (np.log(upper) - np.log(lower)) / N_S
        x_np = np.log(lower) + dx * np.arange(-pad, N_S + pad + 1)
        t = lambda v: torch.as_tensor(v, dtype=dt_, device=dev)
        args = dict(x_grid=t(x_np), dt=t(opt.T / N_t), K=t(K), r=t(opt.r),
                    q=t(opt.q), sigma=t(opt.sigma),
                    is_call=torch.as_tensor(is_call_mask(kind_), device=dev),
                    theta=t(theta))
        # absolute floor in the tolerance: a barrier level of exactly 1.0
        # has log 0, and the upper node can land one ulp inside log(upper)
        tol_lo = 1e-12 * max(1.0, abs(np.log(lower)))
        tol_hi = 1e-12 * max(1.0, abs(np.log(upper)))
        mask = torch.as_tensor((x_np <= np.log(lower) + tol_lo)
                               | (x_np >= np.log(upper) - tol_hi),
                               device=dev)
        V, _ = _fd_solve(**args, barrier_mask=mask, barrier_value=t(reb),
                         N_t=int(N_t), american=False, two_layers=False,
                         solver=solver, barrier_operator=True)
        return float(_readout(x_np, V, opt.S0))

    ko0 = corridor(opt.K, kind, 0.0)
    disc_psurv = 0.0
    if rebate != 0.0 or knock == "in":
        disc_psurv = corridor(upper + 1.0, PUT, 0.0) - corridor(upper, PUT,
                                                                0.0)
    if knock == "out":
        return ko0 + rebate * (disc - disc_psurv)
    vanilla = fd_price(opt, kind, N_S=N_S, N_t=N_t, theta=theta,
                       dtype=dtype, solver=solver, device=device)
    return vanilla - ko0 + rebate * disc_psurv


def fd_greeks(opt: OptionSpec, kind: Literal["call", "put"] = CALL,
              **kwargs) -> dict:
    """Grid Greeks: delta = (1/S)∂V/∂x, gamma = (1/S²)(∂²V/∂x² − ∂V/∂x)
    (chain rule on the log grid), theta from the first two time layers."""
    N_S = kwargs.pop("N_S", 200)
    N_t = kwargs.pop("N_t", 200)
    theta_scheme = kwargs.pop("theta", 0.5)
    S_max_mult = kwargs.pop("S_max_mult", 4.0)
    american = kwargs.pop("american", False)
    dtype = kwargs.pop("dtype", None)
    dividends = kwargs.pop("dividends", None)
    solver = _check_solver(kwargs.pop("solver", "auto"))
    device = kwargs.pop("device", None)

    x_np, x_grid, args = _prep_solve(opt.S0, opt.K, opt.T, opt.r, opt.q,
                                     opt.sigma, kind, N_S, N_t, theta_scheme,
                                     S_max_mult, dtype, device)
    V_0, V_dt = _fd_solve(**args, barrier_mask=None, barrier_value=0.0,
                          N_t=int(N_t), american=bool(american),
                          two_layers=True, solver=solver,
                          **_div_kw(dividends, opt.T, int(N_t)))
    dx = x_np[1] - x_np[0]
    dt = opt.T / N_t
    x0 = np.log(opt.S0)
    j = int(np.searchsorted(x_np, x0))
    j = max(1, min(j, len(x_np) - 2))
    V_0 = V_0.cpu().numpy()
    V_dt = V_dt.cpu().numpy()

    dVdx = (V_0[j + 1] - V_0[j - 1]) / (2.0 * dx)
    d2Vdx2 = (V_0[j + 1] - 2.0 * V_0[j] + V_0[j - 1]) / dx**2
    S0 = opt.S0
    delta = dVdx / S0
    gamma = (d2Vdx2 - dVdx) / S0**2
    V0_val = float(np.interp(x0, x_np, V_0))
    Vdt_val = float(np.interp(x0, x_np, V_dt))
    theta_val = -(V0_val - Vdt_val) / dt
    return {"delta": float(delta), "gamma": float(gamma),
            "theta": float(theta_val)}


def fd_price_local_vol(S0: float, K: float, T: float, r: float, q: float,
                       sigma_func: Callable, kind: Literal["call", "put"] = CALL,
                       *, N_S: int = 200, N_t: int = 200, theta: float = 0.5,
                       S_max_mult: float = 4.0, ref_vol: float = 0.3,
                       dtype=None, solver: str = "auto",
                       device=None) -> float:
    """Local-vol FD price: node-wise σ(S, t) from ``sigma_func`` evaluated
    every step; ``ref_vol`` only shapes the grid."""
    _check_solver(solver)
    x_np, x_grid, args = _prep_solve(S0, K, T, r, q, 0.0, kind, N_S, N_t,
                                     theta, S_max_mult, dtype, device,
                                     grid_sigma=ref_vol)
    V, _ = _fd_solve(**args, barrier_mask=None, barrier_value=0.0,
                     N_t=int(N_t), american=False, two_layers=False,
                     sigma_func=sigma_func, solver=solver)
    return float(_readout(x_np, V, S0))


# ---------------------------------------------------------------------------
# Batched pricing (strike ladders on one grid)
# ---------------------------------------------------------------------------
def _ladder_args(S0, K, T, r, q, sigma, kind, N_S, N_t, theta, S_max_mult,
                 grid_sigma, dtype, device):
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    K_arr = np.atleast_1d(np.asarray(K, dtype=float))
    mask = np.broadcast_to(np.atleast_1d(is_call_mask(kind)), K_arr.shape)
    x_np, dx, dt = _build_grid(S0, T, grid_sigma, N_S, N_t, S_max_mult)
    t = lambda v: torch.as_tensor(v, dtype=dt_, device=dev)
    args = dict(x_grid=t(x_np), dt=t(dt), K=t(K_arr), r=t(r), q=t(q),
                sigma=t(sigma), is_call=torch.as_tensor(mask.copy(),
                                                        device=dev),
                theta=t(theta))
    return x_np, K_arr, args


def fd_price_batch(S0, K, T, r, q, sigma, kind, *, N_S: int = 200,
                   N_t: int = 200, theta: float = 0.5, S_max_mult: float = 4.0,
                   american: bool = False, dtype=None,
                   device=None) -> torch.Tensor:
    """Price a strike/kind ladder on a shared grid in one march (one grid,
    one propagator, the ladder as the batch of the per-step product).
    Returns a tensor of K's shape on the device."""
    x_np, K_arr, args = _ladder_args(S0, K, T, r, q, sigma, kind, N_S, N_t,
                                     theta, S_max_mult, sigma, dtype, device)
    V, _ = _fd_solve(**args, barrier_mask=None, barrier_value=0.0,
                     N_t=int(N_t), american=bool(american), two_layers=False)
    return torch.as_tensor(_readout(x_np, V, S0).reshape(np.shape(K_arr)),
                           dtype=args["x_grid"].dtype,
                           device=args["x_grid"].device)


def fd_price_local_vol_batch(S0, K, T, r, q, sigma_func, kind, *,
                             N_S: int = 200, N_t: int = 200,
                             theta: float = 0.5, S_max_mult: float = 4.0,
                             ref_vol: float = 0.3, dtype=None,
                             solver: str = "auto", device=None):
    """Local-vol strike/kind ladder on a shared grid in one march.

    The per-step system (σ(S, t) shared by the ladder) is solved for every
    strike at once: on the card by K7, one launch a step. ``solver="fused"``
    (or ``"fused_pcr"``) runs the whole march in one K8 launch with a
    parallel-cyclic-reduction solve per step; ``"fused_thomas"`` selects
    K8's sequential Thomas walk. The fused routes are float32 and return a
    (B,) float64 numpy array, as the reference's do; the others a tensor
    of K's shape on the device. ``ref_vol`` shapes the grid.
    """
    _check_solver(solver, _SOLVERS_BATCH_LV)
    if solver in ("fused", "fused_pcr", "fused_thomas"):
        return fd_lv_ladder_kernel(
            S0, K, T, r, q, sigma_func, kind, N_S=N_S, N_t=N_t,
            theta=theta, S_max_mult=S_max_mult, ref_vol=ref_vol,
            method="thomas" if solver == "fused_thomas" else "pcr",
            device=device)
    x_np, K_arr, args = _ladder_args(S0, K, T, r, q, 0.0, kind, N_S, N_t,
                                     theta, S_max_mult, ref_vol, dtype,
                                     device)
    V, _ = _fd_solve(**args, barrier_mask=None, barrier_value=0.0,
                     N_t=int(N_t), american=False, two_layers=False,
                     sigma_func=sigma_func, solver=solver)
    return torch.as_tensor(_readout(x_np, V, S0).reshape(np.shape(K_arr)),
                           dtype=args["x_grid"].dtype,
                           device=args["x_grid"].device)

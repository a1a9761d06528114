"""1-D Galerkin finite-element solver for the Black-Scholes PDE.

Counterpart of ``optpricer_tpu/models/fem.py``: piecewise-linear hat
basis on a uniform log-spot grid, consistent mass matrix (2h/3, h/6),
stiffness = diffusion (σ²/h, −σ²/2h) + skew-symmetric convection (∓μ/2) +
reaction (2rh/3, rh/6), θ time stepping, European only. Float64 by
default, ``device=`` as every engine of the port.

Mass, stiffness and the θ-combined tridiagonals are assembled once. With
``solver="auto"`` / ``"propagator"`` the dense propagator P = L⁻¹R is built
from M tridiagonal solves through ``tridiag_solve_thomas`` (K7 on the
card) and each step is one ``torch.matmul``; the other solvers take one
tridiagonal solve per step, chosen as in ``models/pde.py``.
"""
from __future__ import annotations

from typing import Literal

import torch

from ..core import CALL, OptionSpec
from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import is_call_mask
from ..ops.tridiag import tridiag_solve_thomas
from .pde import _bc_values, _build_grid, _dense, _payoff, _readout, \
    _step_solver

__all__ = ["fem_price"]


def _assemble(h, r, q, sigma, M_int, dtype):
    """Mass + stiffness tridiagonals on the interior; returns
    (M_sub, M_main, M_sup, K_sub, K_main, K_sup)."""
    s2 = sigma**2
    mu = r - q - 0.5 * s2
    full = lambda v: v.to(dtype).expand(M_int)
    M_main = full(2.0 * h / 3.0)
    M_off = full(h / 6.0)
    Kd_main = full(s2 / h)
    Kd_off = full(-s2 / (2.0 * h))
    Kr_main = full(2.0 * r * h / 3.0)
    Kr_off = full(r * h / 6.0)
    K_sub = Kd_off + full(mu / 2.0) + Kr_off
    K_main = Kd_main + Kr_main
    K_sup = Kd_off + full(-mu / 2.0) + Kr_off
    return M_off, M_main, M_off, K_sub, K_main, K_sup


def _fem_solve(x_grid, dt, K_strike, r, q, sigma, is_call, theta,
               *, N_t: int, solver: str = "auto"):
    N_S = x_grid.shape[0] - 1
    M_int = N_S - 1
    dev, dtype = x_grid.device, x_grid.dtype
    h = x_grid[1] - x_grid[0]
    S_grid = torch.exp(x_grid)
    S_min, S_max = S_grid[0], S_grid[-1]
    solve = _step_solver(solver, x_grid.is_cuda)
    use_prop = solver in ("auto", "propagator")

    (M_sub, M_main, M_sup, K_sub, K_main, K_sup) = _assemble(
        h, r, q, sigma, M_int, dtype)

    # LHS = M + θ·dt·K ; RHS-matrix = M − (1−θ)·dt·K (assembled once)
    L_sub = M_sub + theta * dt * K_sub
    L_main = M_main + theta * dt * K_main
    L_sup = M_sup + theta * dt * K_sup
    e = (1.0 - theta) * dt
    R_sub = M_sub - e * K_sub
    R_main = M_main - e * K_main
    R_sup = M_sup - e * K_sup

    if use_prop:
        R_dense = _dense(R_sub, R_main, R_sup)
        P = tridiag_solve_thomas(L_sub, L_main, L_sup, R_dense.T).T
        unit = torch.zeros((2, M_int), dtype=dtype, device=dev)
        unit[0, 0] = 1.0
        unit[1, M_int - 1] = 1.0
        w = tridiag_solve_thomas(L_sub, L_main, L_sup, unit)
        w_lo, w_hi = w[0], w[1]

    V = _payoff(S_grid, K_strike, is_call)
    ns = torch.arange(N_t - 1, -1, -1, dtype=dtype, device=dev)
    bcs = _bc_values((N_t - ns) * dt, K_strike, r, S_min, S_max, is_call)
    for k in range(N_t):
        bc_left, bc_right = bcs[0][k], bcs[1][k]
        V_int = V[1:N_S]
        if use_prop:
            lc = R_sub[0] * V[0] - L_sub[0] * bc_left
            rc = R_sup[-1] * V[N_S] - L_sup[-1] * bc_right
            V_new_int = torch.matmul(P, V_int) + lc * w_lo + rc * w_hi
        else:
            rhs = R_main * V_int
            rhs[1:] += R_sub[1:] * V_int[:-1]
            rhs[:-1] += R_sup[:-1] * V_int[1:]
            # explicit-part boundary contributions (old boundary values)
            rhs[0] += R_sub[0] * V[0]
            rhs[-1] += R_sup[-1] * V[N_S]
            # implicit-part boundary contributions moved from LHS to RHS
            rhs[0] += -L_sub[0] * bc_left
            rhs[-1] += -L_sup[-1] * bc_right
            V_new_int = solve(L_sub, L_main, L_sup, rhs)
        V = torch.cat([bc_left[None], V_new_int, bc_right[None]])
    return V


def fem_price(opt: OptionSpec, kind: Literal["call", "put"] = CALL, *,
              N_S: int = 200, N_t: int = 200, theta: float = 0.5,
              S_max_mult: float = 4.0, dtype=None,
              solver: str = "auto", device=None) -> float:
    """European vanilla price via 1-D Galerkin FEM."""
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    x_np, dx, dt = _build_grid(opt.S0, opt.T, opt.sigma, N_S, N_t, S_max_mult)
    t = lambda v: torch.as_tensor(v, dtype=dt_, device=dev)
    V = _fem_solve(t(x_np), t(dt), t(opt.K), t(opt.r), t(opt.q),
                   t(opt.sigma), torch.as_tensor(is_call_mask(kind),
                                                 device=dev),
                   t(theta), N_t=int(N_t), solver=solver)
    return float(_readout(x_np, V, opt.S0))

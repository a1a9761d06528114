"""2-D ADI finite-difference solver for the Heston PDE.

    V_τ = ½v V_xx + (r−q−½v) V_x + κ(θ−v) V_v + ½ξ²v V_vv + ρξv V_xv − rV

Counterpart of ``optpricer_tpu/models/heston_pde.py``: a uniform x = ln S
grid and a sinh-stretched v grid, marched backward from the payoff by the
Douglas ADI splitting (the mixed term explicit, the x and v operators
implicit in alternating half-steps), with the reference's boundaries:
Dirichlet in x from the discounted-forward asymptotics, upwinded
convection-only rows at v = 0 and v = v_max.

* **Propagators built once, on the device.** The coefficients do not
  depend on time, so (I − θΔt·A_x(v_j))⁻¹ for every variance level and
  (I − θΔt·A_v)⁻¹ are built once from host-f64 stencil vectors
  (:func:`_stencil_vectors`) assembled into bands in the march dtype and
  inverted by ``ops.tridiag.tridiag_inv``: on the card one K7 launch for
  the n_v x-inverses and one for the v-inverse. The host f64 builder
  :func:`_build_operators` stays as the oracle.
* **The march is a loop of batched products over a (n_v, n_x, B) state**,
  B the strikes of a ladder (1 for a single contract): A_x applied as a
  band product, the x half-step one batched (n_v) matmul of the
  (n_x, n_x) propagators against the (n_x, B) slices, the v operators
  dense (n_v, n_v) products. A ladder shares one set of propagators
  (the reference ``vmap``s the march over strikes). Every float32 product
  runs with TF32 off (``dtypes.full_f32``): lower precision accumulates
  per-step rounding into divergence over hundreds of steps. The loop
  enqueues its steps with no host sync; what varies by step (the
  Dirichlet values, a dividend, a Bermudan date) is host data decided
  before the step is enqueued.
* **The mixed term** is a central/central stencil with zeroed borders.

Every entry point takes ``device=`` (default ``"cuda"``) and returns host
float64 numbers, as the reference does; the grid and the read-outs are
host f64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dtypes import canonical, full_f32, resolve_device
from ..ops.tridiag import tridiag_inv

__all__ = ["heston_fd_price", "heston_fd_grid", "heston_fd_greeks",
           "heston_fd_price_batch", "heston_fd_price_barrier"]


def _diff_ops(nodes: np.ndarray):
    """(D1, D2) dense difference operators on an arbitrary (possibly
    non-uniform) node array, second-order 3-point stencils, ZERO boundary
    rows (boundary handling is the caller's job)."""
    n = len(nodes)
    hm = nodes[1:-1] - nodes[:-2]            # h⁻_i
    hp = nodes[2:] - nodes[1:-1]             # h⁺_i
    D1 = np.zeros((n, n))
    D2 = np.zeros((n, n))
    i = np.arange(1, n - 1)
    D1[i, i - 1] = -hp / (hm * (hm + hp))
    D1[i, i] = (hp - hm) / (hm * hp)
    D1[i, i + 1] = hm / (hp * (hm + hp))
    D2[i, i - 1] = 2.0 / (hm * (hm + hp))
    D2[i, i] = -2.0 / (hm * hp)
    D2[i, i + 1] = 2.0 / (hp * (hm + hp))
    return D1, D2


def _stencil_vectors(nodes: np.ndarray):
    """Host f64 3-point stencil coefficient vectors (length n−2 each) for
    the interior rows of ``_diff_ops`` — the only part of the operator
    build that is rounding-sensitive (differences of nearby nodes)."""
    hm = nodes[1:-1] - nodes[:-2]
    hp = nodes[2:] - nodes[1:-1]
    d1 = (-hp / (hm * (hm + hp)), (hp - hm) / (hm * hp),
          hm / (hp * (hm + hp)))
    d2 = (2.0 / (hm * (hm + hp)), -2.0 / (hm * hp),
          2.0 / (hp * (hm + hp)))
    return d1, d2


def _step_bands(x, v, r, q, kappa, theta, xi, dt, theta_s, ko_mask=None,
                dtype=torch.float64, device=None):
    """The operators' bands on the device in the march dtype.

    Returns ``(ax, av, step_x, step_v)``, each a (lo, mid, hi) triple:
    ``ax`` the bands of A_x, each (n_v, n_x) (row j acts along x at
    variance level v_j), ``av`` those of the v operator A_v, each (n_v,),
    and ``step_x`` / ``step_v`` those of the implicit steps
    I − θ_sΔt·A_x(v_j) and I − θ_sΔt·A_v. The host does only the O(n) f64
    stencil and boundary arithmetic. ``ko_mask`` zeroes the A_x rows of
    knocked-out spot nodes (see :func:`_build_operators`)."""
    dev = resolve_device(device)
    d1x, d2x = _stencil_vectors(np.asarray(x, np.float64))
    d1v, d2v = _stencil_vectors(np.asarray(v, np.float64))
    dv0 = v[1] - v[0]
    dv_top = v[-1] - v[-2]
    drift_top = kappa * (theta - v[-1])
    bc_v = np.array([-kappa * theta / dv0 - 0.5 * r,
                     kappa * theta / dv0,
                     drift_top / dv_top - 0.5 * r,
                     -drift_top / dv_top], np.float64)
    n_x, n_v = len(x), len(v)
    if ko_mask is None:
        ko_mask = np.zeros(n_x, bool)
    t = lambda a: torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                                  device=dev)
    r, q, kappa, theta, xi = (t(a) for a in (r, q, kappa, theta, xi))
    vt = t(v)
    zx = torch.zeros((n_v, 1), dtype=dtype, device=dev)
    pad = lambda w: torch.cat([zx, w, zx], dim=-1)
    cv = 0.5 * vt[:, None]                      # ½v  (D2 weight)
    bv = (r - q) - cv                           # r−q−½v  (D1 weight)
    live = (~torch.as_tensor(ko_mask, device=dev)).to(dtype)[None, :]
    ax_lo = pad(cv * t(d2x[0])[None] + bv * t(d1x[0])[None]) * live
    ax_mid = pad(cv * t(d2x[1])[None] + bv * t(d1x[1])[None]
                 - 0.5 * r) * live
    ax_hi = pad(cv * t(d2x[2])[None] + bv * t(d1x[2])[None]) * live

    zv = torch.zeros((1,), dtype=dtype, device=dev)
    padv = lambda w: torch.cat([zv, w, zv])
    cvv = ((0.5 * xi ** 2) * vt)[1:-1]          # interior ½ξ²v_i
    bvv = (kappa * (theta - vt))[1:-1]          # interior κ(θ−v_i)
    av_lo = padv(cvv * t(d2v[0]) + bvv * t(d1v[0]))
    av_mid = padv(cvv * t(d2v[1]) + bvv * t(d1v[1])) \
        - 0.5 * r * torch.ones((n_v,), dtype=dtype, device=dev)
    av_hi = padv(cvv * t(d2v[2]) + bvv * t(d1v[2]))
    # upwinded boundary rows (coefficients host f64); av_mid's −½r term
    # applies on every row, the boundary values carry it
    bc = t(bc_v)
    av_mid[0], av_mid[-1] = bc[0], bc[2]
    av_hi[0] = bc[1]
    av_lo[-1] = bc[3]
    sd = t(theta_s * dt)
    step = lambda lo, mid, hi: (-sd * lo, 1.0 - sd * mid, -sd * hi)
    return ((ax_lo, ax_mid, ax_hi), (av_lo, av_mid, av_hi),
            step(ax_lo, ax_mid, ax_hi), step(av_lo, av_mid, av_hi))


def _build_operators_dev(x, v, r, q, kappa, theta, xi, dt, theta_s,
                         ko_mask=None, dtype=torch.float64, device=None):
    """Build the operators on the device in the march dtype.

    Returns ``(ax, Px, Av, Pv)``: ``ax`` the (lo, mid, hi) bands of A_x,
    each (n_v, n_x), Px the (n_v, n_x, n_x) inverses of I − θ_sΔt·A_x(v_j),
    Av the dense (n_v, n_v) v operator and Pv its implicit-step inverse.
    The bands come from :func:`_step_bands`; assembly and inversion
    (:func:`~optpricer_tpu_torch.ops.tridiag.tridiag_inv`, K7 on the card)
    run on ``device``."""
    ax, (av_lo, av_mid, av_hi), step_x, step_v = _step_bands(
        x, v, r, q, kappa, theta, xi, dt, theta_s, ko_mask, dtype, device)
    Av = (torch.diag(av_mid) + torch.diag(av_lo[1:], -1)
          + torch.diag(av_hi[:-1], 1))
    return ax, tridiag_inv(*step_x), Av, tridiag_inv(*step_v)


def _build_operators(x, v, r, q, kappa, theta, xi, dt, theta_s,
                     ko_mask=None):
    """Host-side f64 operator/propagator construction, the oracle of
    :func:`_build_operators_dev`.

    Returns (Ax, Px, Av, Pv): Ax (n_v, n_x, n_x) acts along x per
    variance level, Av (n_v, n_v) acts along v (coefficients depend on v
    only), Px/Pv the corresponding implicit-step inverses. ``ko_mask``
    zeroes the Ax rows of knocked-out spot nodes, making the barrier a
    true Dirichlet boundary of the implicit solve (pinning only after each
    step lets value diffuse into the dead zone and converges like discrete
    monitoring).
    """
    n_x, n_v = len(x), len(v)

    D1x, D2x = _diff_ops(x)
    Ix = np.eye(n_x)
    Ix_int = Ix.copy()
    Ix_int[0, 0] = Ix_int[-1, -1] = 0.0      # no reaction on Dirichlet rows
    # A_x(v_j) = ½v D2 + (r−q−½v) D1 − ½r I   (half the rV term here)
    Ax = (0.5 * v[:, None, None] * D2x[None]
          + (r - q - 0.5 * v)[:, None, None] * D1x[None]
          - 0.5 * r * Ix_int[None])
    if ko_mask is not None and ko_mask.any():
        Ax[:, ko_mask, :] = 0.0
    Px = np.linalg.inv(np.eye(n_x)[None] - theta_s * dt * Ax)

    # A_v: interior central on the (sinh-stretched) v grid; v=0 row
    # upwind-forward convection, v_max row upwind-backward
    D1v, D2v = _diff_ops(v)
    Av = (0.5 * xi**2 * v[:, None] * D2v
          + kappa * (theta - v)[:, None] * D1v
          - 0.5 * r * np.eye(n_v))
    dv0 = v[1] - v[0]
    Av[0, :] = 0.0
    Av[0, 0] = -kappa * theta / dv0 - 0.5 * r
    Av[0, 1] = kappa * theta / dv0
    dv_top = v[-1] - v[-2]
    Av[-1, :] = 0.0
    drift_top = kappa * (theta - v[-1])      # ≤ 0 for v_max > θ
    Av[-1, -1] = drift_top / dv_top - 0.5 * r
    Av[-1, -2] = -drift_top / dv_top
    Pv = np.linalg.inv(np.eye(n_v) - theta_s * dt * Av)
    return Ax, Px, Av, Pv


def _adi_march(U0, ax, Px, Av, Pv, mix_c, bc_left, bc_right, intrinsic, *,
               n_t: int, american: bool, inv_theta: float, ko_mask=None,
               rebate: float = 0.0, div_per_iter=None, x_grid=None,
               ex_per_iter=None):
    """Douglas ADI time march over a (n_v, n_x, B) state; returns it at
    t = 0.

    ``ax`` (the A_x bands) and ``Av`` arrive pre-scaled by θ_sΔt, so the
    implicit right-hand sides are direct, and ``inv_theta`` = 1/θ_s
    recovers the explicit ΔtA application; ``mix_c`` (n_v,) is the mixed
    coefficient ρξv_jΔt/(4ΔxΔv). ``bc_left`` / ``bc_right`` are (n_t, B)
    Dirichlet values at τ_{n+1}; ``intrinsic`` (n_x, B) the exercise value.
    ``ko_mask`` ((n_x,) bool tensor) pins knocked-out spot nodes to
    ``rebate`` after every step. ``div_per_iter`` (host (n_t,)) is the cash
    dividend paid at the carried layer's time at each iteration: the jump
    condition V(S, t⁻) = V(S − D, t⁺) remaps every variance row along x
    before the step, followed by the cum-dividend exercise; a zero
    dividend leaves the layer as it is (f32 log/exp is not an identity).
    ``ex_per_iter`` (host (n_t,) bool) marks the iterations whose produced
    layer is a Bermudan exercise date."""
    has_divs = div_per_iter is not None
    has_bermudan = ex_per_iter is not None
    ax_lo, ax_mid, ax_hi = (a[..., None] for a in ax)
    n_v, n_x, B = U0.shape
    mix = mix_c[1:-1, None, None]

    def apply_ax(U):
        out = ax_mid * U
        out[:, 1:] += ax_lo[:, 1:] * U[:, :-1]
        out[:, :-1] += ax_hi[:, :-1] * U[:, 1:]
        return out

    def apply_v(P, U):
        return (P @ U.reshape(n_v, n_x * B)).reshape(n_v, n_x, B)

    def mixed(U):
        # ρξv ∂²/∂x∂v, central/central, zero on every boundary
        out = torch.zeros_like(U)
        out[1:-1, 1:-1] = mix * (U[2:, 2:] - U[2:, :-2] - U[:-2, 2:]
                                 + U[:-2, :-2])
        return out

    if has_divs:
        dx = x_grid[1] - x_grid[0]
        S_row = torch.exp(x_grid)

        def div_remap(U, D):
            x_new = torch.log(torch.maximum(S_row - D, S_row[0]))
            u = (x_new - x_grid[0]) / dx
            j = torch.clamp(torch.floor(u).to(torch.int64), 0, n_x - 2)
            w = torch.clamp(u - j.to(U.dtype), 0.0, 1.0)[:, None]
            return U[:, j] * (1.0 - w) + U[:, j + 1] * w

    U = U0
    with full_f32():
        for k in range(n_t):
            if has_divs:
                if div_per_iter[k] > 0.0:
                    U = div_remap(U, float(div_per_iter[k]))
                if american:
                    # the cum-dividend exercise right at t⁻
                    U = torch.maximum(U, intrinsic)
                elif has_bermudan and ex_per_iter[k]:
                    U = torch.maximum(U, intrinsic)
            AxU = apply_ax(U)
            AvU = apply_v(Av, U)
            Y0 = U + inv_theta * (AxU + AvU) + mixed(U)
            Y1 = torch.matmul(Px, Y0 - AxU)
            Y2 = apply_v(Pv, Y1 - AvU)
            Y2[:, 0] = bc_left[k]
            Y2[:, -1] = bc_right[k]
            if american or (has_bermudan and ex_per_iter[k]):
                Y2 = torch.maximum(Y2, intrinsic)
            if ko_mask is not None:
                Y2 = torch.where(ko_mask[None, :, None], rebate, Y2)
            U = Y2
    return U


def _grids(S0, T, v0, theta, n_x, n_v, n_t, x_mult, v_mult):
    """Host f64 (x, v, dt): x uniform over ln S0 ± x_mult·√(v̄T), v
    sinh-stretched over [0, v_mult·v̄] toward v = 0 (where the variance
    density piles up when Feller is violated), v̄ = max(v0, θ, 1e-4)."""
    vbar = max(v0, theta, 1e-4)
    x_half = x_mult * np.sqrt(vbar * T)
    x = np.linspace(np.log(S0) - x_half, np.log(S0) + x_half, n_x)
    c_str = 3.0
    u = np.linspace(0.0, 1.0, n_v)
    v = v_mult * vbar * np.sinh(c_str * u) / np.sinh(c_str)
    return x, v, T / n_t


def _mix_coefficient(x, v, rho, xi):
    """ρξv_j / (2Δx(v_{j+1} − v_{j−1})) on the interior levels, 0 on the
    v boundaries: the central/central mixed stencil's weight."""
    mix_c = np.zeros(len(v))
    mix_c[1:-1] = rho * xi * v[1:-1] / (2.0 * (x[1] - x[0])
                                        * (v[2:] - v[:-2]))
    return mix_c


def _march(x, v, dt, ops, U0, payoff, bc_left, bc_right, mix_c, *, n_t,
           american, theta_scheme, dtype, device, **kw):
    """Scale the built operators and march; (n_v, n_x, B) host f64."""
    ax, Px, Av, Pv = ops
    t = lambda a: torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                                  device=device)
    th = theta_scheme
    U = _adi_march(t(U0), tuple(a * (th * dt) for a in ax), Px,
                   Av * (th * dt), Pv, t(dt * mix_c), t(bc_left.T),
                   t(bc_right.T), t(payoff), n_t=int(n_t),
                   american=bool(american), inv_theta=1.0 / th, **kw)
    return U.cpu().numpy().astype(np.float64)


def heston_fd_grid(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi, rho,
                   kind: str = "call", american: bool = False,
                   n_x: int = 256, n_v: int = 96, n_t: int = 512,
                   x_mult: float = 6.0, v_mult: float = 10.0,
                   theta_scheme: float = 0.5, dtype=None,
                   barrier: float = 0.0, barrier_up: bool = True,
                   rebate: float = 0.0, dividends=None,
                   exercise_dates=None, device=None):
    """Solve the Heston PDE; returns ``(x_grid, v_grid, V)`` with V the
    full (n_v, n_x) t=0 surface (host f64) — delta/gamma/vega come from
    the same solve (:func:`heston_fd_greeks`).

    Douglas ADI (θ-scheme parameter ``theta_scheme``; ½ the standard
    choice) on x ∈ ln S0 ± x_mult·√(v̄T), v ∈ [0, v_mult·v̄] with
    v̄ = max(v0, θ). American exercise by projection; a barrier > 0
    knocks out the spot nodes at or beyond it (the grid shifted so that
    ln(barrier) is a node when it lies inside); ``dividends=[(t, amount),
    …]`` cash dividends by the jump condition; ``exercise_dates=[t_1, …]``
    a Bermudan (snapped to the nearest time level; exclusive with
    ``american=True``).
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if not (0.0 < theta_scheme <= 1.0):
        raise ValueError("theta_scheme must be in (0, 1]")
    if exercise_dates is not None and american:
        raise ValueError("exercise_dates (Bermudan) and american=True "
                         "are mutually exclusive")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    is_call = kind == "call"
    S0, K, T, r, q = (float(a) for a in (S0, K, T, r, q))
    v0, kappa, theta, xi, rho = (
        float(a) for a in (v0, kappa, theta, xi, rho))

    x, v, dt = _grids(S0, T, v0, theta, n_x, n_v, n_t, x_mult, v_mult)
    if barrier > 0.0 and x[0] < np.log(barrier) < x[-1]:
        # shift the grid so ln(barrier) sits exactly on a node (the
        # knock-out override is first-order in the barrier-to-node offset
        # otherwise); a barrier outside the grid is left unsnapped
        xb = np.log(barrier)
        x = x + (xb - x[int(np.argmin(np.abs(x - xb)))])

    S_grid = np.exp(x)
    sign = 1.0 if is_call else -1.0
    payoff = np.maximum(sign * (S_grid - K), 0.0)
    has_barrier = barrier > 0.0
    ko_mask = np.zeros(n_x, bool)
    if has_barrier:
        ko_mask = (S_grid >= barrier * (1.0 - 1e-12)) if barrier_up \
            else (S_grid <= barrier * (1.0 + 1e-12))
        payoff = np.where(ko_mask, rebate, payoff)
    ops = _build_operators_dev(
        x, v, r, q, kappa, theta, xi, dt, theta_scheme,
        ko_mask=ko_mask if has_barrier else None, dtype=dt_, device=dev)
    U0 = np.broadcast_to(payoff[None, :, None], (n_v, n_x, 1))

    # Dirichlet x boundaries at τ_{n+1}: discounted-forward asymptotics
    tau = (np.arange(n_t) + 1.0) * dt
    pv_divs = np.zeros(n_t)
    kw = {}
    if dividends:
        from .pde import _div_schedule_np

        amts = _div_schedule_np(dividends, T, n_t)
        # iteration k carries the t_{n_t−k}⁺ layer: remap with the
        # dividend paid at that node
        kw["div_per_iter"] = amts[::-1][:n_t].copy()
        kw["x_grid"] = torch.as_tensor(x, dtype=dt_, device=dev)
        # PV of dividends still ahead of the layer produced at iteration
        # k: the far-field asymptotes carry the forward net of them
        ks = np.arange(n_t + 1)
        w = amts * np.exp(-r * dt * ks)
        suffix = np.cumsum(w[::-1])[::-1] - w
        pv_divs = (suffix * np.exp(r * dt * ks))[n_t - 1::-1]
    if is_call:
        bc_left = np.zeros(n_t)
        bc_right = np.maximum(
            S_grid[-1] * np.exp(-q * tau) - pv_divs - K * np.exp(-r * tau),
            0.0)
        if american:
            bc_right = np.maximum(bc_right, S_grid[-1] - K)
    else:
        bc_left = K * np.exp(-r * tau) \
            - np.maximum(S_grid[0] * np.exp(-q * tau) - pv_divs, 0.0)
        if american:
            bc_left = np.maximum(bc_left, K - S_grid[0])
        bc_right = np.zeros(n_t)

    if exercise_dates is not None:
        # iteration i produces the layer at time index n_t−1−i; exercise
        # dates snap to the nearest level (t = 0 and maturity are no-ops)
        ex_idx = {int(round(float(t) / dt)) for t in exercise_dates}
        ex_idx = {m for m in ex_idx if 1 <= m <= n_t - 1}
        ex_per_iter = np.array([(n_t - 1 - i) in ex_idx
                                for i in range(n_t)], bool)
        # far-field Dirichlet values may exercise only at those dates
        if is_call:
            bc_right = np.where(ex_per_iter,
                                np.maximum(bc_right, S_grid[-1] - K),
                                bc_right)
        else:
            bc_left = np.where(ex_per_iter,
                               np.maximum(bc_left, K - S_grid[0]),
                               bc_left)
        kw["ex_per_iter"] = ex_per_iter
    if has_barrier:
        kw.update(ko_mask=torch.as_tensor(ko_mask, device=dev),
                  rebate=float(rebate))
    U = _march(x, v, dt, ops, U0, payoff[:, None], bc_left[None],
               bc_right[None], _mix_coefficient(x, v, rho, xi), n_t=n_t,
               american=american, theta_scheme=theta_scheme, dtype=dt_,
               device=dev, **kw)
    return x, v, U[..., 0]


def heston_fd_price_barrier(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi,
                            rho, barrier: float,
                            barrier_type: str = "up-and-out",
                            rebate: float = 0.0, kind: str = "call",
                            american: bool = False, **grid_kw) -> float:
    """Continuously monitored barrier option under Heston by the ADI
    march: knock-out by Dirichlet rows at the spot nodes at or beyond the
    barrier; knock-in by the European parity V_in = V_vanilla − V_out
    (zero rebate, European only)."""
    hp = dict(v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho)
    if barrier_type not in ("up-and-out", "down-and-out",
                            "up-and-in", "down-and-in"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    if barrier_type.endswith("in"):
        if american:
            raise ValueError("knock-in parity requires European exercise")
        if rebate != 0.0:
            raise ValueError("knock-in parity requires zero rebate")
        vanilla = heston_fd_price(S0, K, T, r, q, **hp, kind=kind,
                                  **grid_kw)
        out = heston_fd_price_barrier(
            S0, K, T, r, q, **hp, barrier=barrier,
            barrier_type=barrier_type.replace("in", "out"), kind=kind,
            **grid_kw)
        return vanilla - out
    x, v, V = heston_fd_grid(
        S0, K, T, r, q, **hp, kind=kind, american=american,
        barrier=float(barrier),
        barrier_up=barrier_type.startswith("up"), rebate=float(rebate),
        **grid_kw)
    return _bilinear_readout(x, v, V, S0, v0)


def heston_fd_price_batch(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi,
                          rho, kind="call", american: bool = False,
                          n_x: int = 256, n_v: int = 96, n_t: int = 512,
                          x_mult: float = 6.0, v_mult: float = 10.0,
                          theta_scheme: float = 0.5, dtype=None,
                          device=None):
    """Heston ADI strike/kind ladder: one set of propagators, the whole
    ladder marched together as a (n_v, n_x, B) state (the implicit-step
    inverses and the mixed stencil are strike-independent). ``K`` /
    ``kind`` broadcast; returns host f64 of ``K``'s shape."""
    if not (0.0 < theta_scheme <= 1.0):
        raise ValueError("theta_scheme must be in (0, 1]")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    K_arr = np.atleast_1d(np.asarray(K, np.float64))
    kinds = np.broadcast_to(np.atleast_1d(kind), K_arr.shape)
    if not all(k in ("call", "put") for k in kinds):
        raise ValueError("kind must be 'call' or 'put'")
    sign = np.where(kinds == "call", 1.0, -1.0)
    S0, T, r, q = (float(a) for a in (S0, T, r, q))
    v0, kappa, theta, xi, rho = (
        float(a) for a in (v0, kappa, theta, xi, rho))

    x, v, dt = _grids(S0, T, v0, theta, n_x, n_v, n_t, x_mult, v_mult)
    ops = _build_operators_dev(x, v, r, q, kappa, theta, xi, dt,
                               theta_scheme, dtype=dt_, device=dev)
    S_grid = np.exp(x)
    payoff = np.maximum(sign[None, :] * (S_grid[:, None] - K_arr[None, :]),
                        0.0)                                   # (n_x, B)
    U0 = np.broadcast_to(payoff[None], (n_v, n_x, K_arr.size))
    tau = (np.arange(n_t) + 1.0) * dt
    disc_K = K_arr[:, None] * np.exp(-r * tau)[None, :]        # (B, n_t)
    fwd_lo = S_grid[0] * np.exp(-q * tau)[None, :]
    fwd_hi = S_grid[-1] * np.exp(-q * tau)[None, :]
    is_call_b = sign > 0
    bc_left = np.where(is_call_b[:, None], 0.0,
                       np.maximum(disc_K - fwd_lo, 0.0))
    bc_right = np.where(is_call_b[:, None],
                        np.maximum(fwd_hi - disc_K, 0.0), 0.0)
    if american:
        bc_left = np.maximum(bc_left, np.where(
            is_call_b[:, None], 0.0, K_arr[:, None] - S_grid[0]))
        bc_right = np.maximum(bc_right, np.where(
            is_call_b[:, None], S_grid[-1] - K_arr[:, None], 0.0))
    V = _march(x, v, dt, ops, U0, payoff, bc_left, bc_right,
               _mix_coefficient(x, v, rho, xi), n_t=n_t, american=american,
               theta_scheme=theta_scheme, dtype=dt_, device=dev)
    out = np.array([_bilinear_readout(x, v, V[..., b], S0, v0)
                    for b in range(K_arr.size)])
    return out.reshape(np.shape(K))


def _bilinear_readout(x, v, V, S0, v0):
    """Host f64 bilinear interpolation of the (n_v, n_x) surface at
    (ln S0, v0)."""
    x0 = np.log(float(S0))
    i = int(np.clip(np.searchsorted(x, x0) - 1, 0, len(x) - 2))
    j = int(np.clip(np.searchsorted(v, float(v0)) - 1, 0, len(v) - 2))
    wx = (x0 - x[i]) / (x[i + 1] - x[i])
    wv = (float(v0) - v[j]) / (v[j + 1] - v[j])
    return float((1 - wv) * ((1 - wx) * V[j, i] + wx * V[j, i + 1])
                 + wv * ((1 - wx) * V[j + 1, i] + wx * V[j + 1, i + 1]))


def heston_fd_price(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi, rho,
                    kind: str = "call", american: bool = False,
                    n_x: int = 256, n_v: int = 96, n_t: int = 512,
                    x_mult: float = 6.0, v_mult: float = 10.0,
                    theta_scheme: float = 0.5, dtype=None,
                    dividends=None, exercise_dates=None,
                    device=None) -> float:
    """Heston price by the Douglas ADI march (European, American or
    Bermudan; ``dividends=[(t, amount), ...]`` cash dividends by the jump
    condition, an x-remap of every variance row)."""
    x, v, V = heston_fd_grid(
        S0, K, T, r, q, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho,
        kind=kind, american=american, n_x=n_x, n_v=n_v, n_t=n_t,
        x_mult=x_mult, v_mult=v_mult, theta_scheme=theta_scheme,
        dtype=dtype, dividends=dividends, exercise_dates=exercise_dates,
        device=device)
    return _bilinear_readout(x, v, V, S0, v0)


def heston_fd_greeks(S0, K, T, r, q=0.0, *, v0, kappa, theta, xi, rho,
                     kind: str = "call", american: bool = False,
                     **grid_kw) -> dict:
    """Grid Greeks from one ADI solve: delta, gamma (x chain rule, as in
    ``pde.fd_greeks``) and vega_v0 = ∂V/∂v0 (the v direction is on the
    grid: no re-solve)."""
    x, v, V = heston_fd_grid(
        S0, K, T, r, q, v0=v0, kappa=kappa, theta=theta, xi=xi, rho=rho,
        kind=kind, american=american, **grid_kw)
    price = _bilinear_readout(x, v, V, S0, v0)
    dx = x[1] - x[0]
    x0 = np.log(float(S0))
    j = int(np.clip(np.searchsorted(v, v0), 1, len(v) - 2))

    # centred x-derivative arrays at the v-level, interpolated at ln S0
    # (reading at the nearest node leaves a half-cell offset in delta)
    row = V[j, :]
    dVdx_n = np.empty_like(row)
    d2Vdx2_n = np.empty_like(row)
    dVdx_n[1:-1] = (row[2:] - row[:-2]) / (2 * dx)
    d2Vdx2_n[1:-1] = (row[2:] - 2 * row[1:-1] + row[:-2]) / dx**2
    dVdx_n[0] = dVdx_n[1]
    dVdx_n[-1] = dVdx_n[-2]
    d2Vdx2_n[0] = d2Vdx2_n[1]
    d2Vdx2_n[-1] = d2Vdx2_n[-2]
    dVdx = float(np.interp(x0, x, dVdx_n))
    d2Vdx2 = float(np.interp(x0, x, d2Vdx2_n))
    delta = dVdx / S0
    gamma = (d2Vdx2 - dVdx) / S0**2
    # vega: non-uniform-v 3-point first derivative per node, interp in x
    hm, hp_ = v[j] - v[j - 1], v[j + 1] - v[j]
    vega_n = (-hp_ / (hm * (hm + hp_)) * V[j - 1, :]
              + (hp_ - hm) / (hm * hp_) * V[j, :]
              + hm / (hp_ * (hm + hp_)) * V[j + 1, :])
    vega_v0 = float(np.interp(x0, x, vega_n))
    return {"price": price, "delta": float(delta), "gamma": float(gamma),
            "vega_v0": float(vega_v0)}

"""Local-stochastic volatility (LSV): Heston dynamics under a Dupire
leverage function, calibrated by the particle method.

Counterpart of ``optpricer_tpu/models/lsv.py``:

    dS/S = (r − q) dt + L(S, t)·√v dW1
    dv   = κ(θ − v) dt + ξ√v dW2,  d⟨W1, W2⟩ = ρ dt

with L²(S, t) = σ_Dup²(S, t) / E[v_t | S_t = S] (Gyöngy). The particle
calibrator estimates E[v | x] on a fixed log-moneyness grid from the
ensemble itself while stepping it forward: per step the binned sums of
(1, xc, xc², v, xc·v) with xc relative to each particle's own bin centre,
smoothed by a small binomial kernel with re-centring, and the local-linear
(or Nadaraya-Watson) intercept at each bin centre. The reference's
``lax.scan`` recursions are Python loops over the steps here. The binned
sums are a stable sort by bin and a sequential sum per bin
(``torch.segment_reduce``): deterministic on the card, where
``index_add_`` would add with float atomics in a varying order. The
smoothing is a sum of shifted rows (a true convolution, as
``jnp.convolve``; no cuDNN, so no TF32).

Pricing (:func:`lsv_price_mc`) runs the path kernel's ``lsv``/``lsv_qe``
branches (``ops/path_mc``, K4) on the kernel route — the leverage rows as
per-step degree-12 polynomials (:func:`_leverage_poly`) — or the torch
scan ``_lsv_paths`` with the table interpolated per particle.
:func:`lsv_greeks_mc` differentiates the scan with ``torch.func.jacfwd``.

The scans take their standard normals from a callable ``normals(k) ->
(z2, zp)``; the public functions draw them from a ``torch.Generator`` on
the target device seeded from ``seed``, step by step, so a seed gives
another sample than the reference's ``jax.random`` keys. ``mesh=`` (a
:class:`~optpricer_tpu_torch.parallel.mesh.Mesh`) on the pricers splits
the paths over its devices: the path kernel's sharded entry on the kernel
route, else each shard's scan drawing from a generator keyed by (seed,
shard index), the sums added in mesh order. Every entry point takes
``device=`` (default ``"cuda"``), where a run without a mesh goes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..dtypes import MC_DTYPE, canonical, resolve_device
from ..ops.path_mc import path_mc_sumstats_kernel
from .exotics import _price_from_payoff
from ..ops.path_mc import path_mc_sumstats_kernel_sharded
from .mc_fused import (_estimate_from_stats, _exp_for, _log_for, _shards,
                       _sqrt0, _terminal_payoff)
from .monte_carlo import resolve_seed

__all__ = ["LSVModel", "lsv_calibrate", "lsv_greeks_mc",
           "lsv_path_matrix", "lsv_price_mc"]

_PAYOFFS = ("vanilla", "barrier", "asian", "digital", "lookback")


@dataclass(frozen=True)
class LSVModel:
    """Calibrated LSV model: Heston parameters + leverage table.

    ``leverage`` is an ``(n_steps, n_bins)`` tensor of L values on the
    ``x_bins`` log-moneyness grid (x = ln(S / F_t), F_t the analytic
    forward S0·e^{(r−q)t}); row k applies on the step from t_k to
    t_{k+1}. ``scheme`` is the variance discretisation the table was
    calibrated under ("euler" | "qe"); pricing follows it.
    """

    S0: float
    r: float
    q: float
    T: float
    v0: float
    kappa: float
    theta: float
    xi: float
    rho: float
    x_bins: torch.Tensor      # (n_bins,) bin centres in log-moneyness
    leverage: torch.Tensor    # (n_steps, n_bins)
    scheme: str = "euler"

    @property
    def n_steps(self) -> int:
        return int(self.leverage.shape[0])

    @property
    def heston(self) -> dict:
        return dict(v0=self.v0, kappa=self.kappa, theta=self.theta,
                    xi=self.xi, rho=self.rho)


def _smooth_kernel(dtype, taps: int = 5, device=None) -> torch.Tensor:
    """Binomial smoothing kernel (the kernel-regression bandwidth of the
    binned conditional expectation). ``taps`` odd; 1 disables smoothing."""
    row = np.array([1.0])
    for _ in range(taps - 1):
        row = np.convolve(row, [0.5, 0.5])
    return torch.as_tensor(row, dtype=dtype, device=device)


def _qe_v_step(v, z2, kappa, theta_v, xi, dt):
    """Andersen QE variance transition driven by one normal ``z2``: the
    quadratic branch uses z2 directly, the exponential branch inverts its
    CDF on u = Φ(z2), so the antithetic −z2 mirrors the uniform exactly.
    Degenerate ξ→0 / κ→0 limits collapse to the deterministic mean."""
    eps = 1e-12
    kap = torch.clamp(kappa, min=eps)
    emkt = torch.exp(-kap * dt)
    c1 = xi * xi * emkt * (1.0 - emkt) / kap
    c2 = theta_v * xi * xi * (1.0 - emkt) ** 2 / (2.0 * kap)
    m = theta_v + (v - theta_v) * emkt
    s2 = v * c1 + c2
    psi = s2 / torch.clamp(m * m, min=eps)
    two_over = 2.0 / torch.clamp(torch.clamp(psi, max=1.5), min=eps)
    b2 = (two_over - 1.0 + torch.sqrt(two_over)
          * torch.sqrt(torch.clamp(two_over - 1.0, min=0.0)))
    a = m / (1.0 + b2)
    bz = torch.sqrt(torch.clamp(b2, min=0.0)) + z2
    u = torch.special.ndtr(z2)
    psi_e = torch.clamp(psi, min=1.5)
    p = (psi_e - 1.0) / (psi_e + 1.0)
    beta_e = (1.0 - p) / torch.clamp(m, min=eps)
    v_exp = torch.where(
        u <= p, torch.zeros_like(u),
        torch.log((1.0 - p) / torch.clamp(1.0 - u, min=eps)) / beta_e)
    return torch.where(psi <= 1.5, a * bz * bz, v_exp)


def _qe_asset_coupling(v_eff, v_new, kappa, theta_v, xi, rho, dt):
    """(v̄, ρ-coupling drift term) of the QE asset step: Andersen's
    substitution ∫√v dW₂ = (v⁺ − v − κθΔ + κ∫v)/ξ with the central
    ∫v ≈ v̄Δ, for a unit-leverage asset (the caller multiplies by its
    local leverage); ξ→0 sends the coupling to zero."""
    vbar = 0.5 * (v_eff + v_new)
    inc = v_new - v_eff - kappa * (theta_v - vbar) * dt
    coup = torch.where(xi > 1e-8, rho * inc / torch.clamp(xi, min=1e-8),
                       torch.zeros_like(inc))
    return vbar, coup


def _advance_particles(S, v, L, z2, zp, *, mu, kappa, theta_v, xi, rho,
                       rho_perp, dt, sqrt_dt, exp_, scheme):
    """ONE particle advance shared by the calibrator and the pricer (the
    Gyöngy repricing contract needs the same discretisation in both).
    ``scheme="qe"``: Andersen QE variance + leverage-scaled central asset
    step; ``"euler"``: full-truncation Euler + log-Euler asset."""
    v_eff = torch.clamp(v, min=0.0)
    if scheme == "qe":
        v_new = _qe_v_step(v_eff, z2, kappa, theta_v, xi, dt)
        vbar, coup = _qe_asset_coupling(v_eff, v_new, kappa, theta_v, xi,
                                        rho, dt)
        S_new = S * exp_(mu * dt - 0.5 * L * L * vbar * dt
                         + L * coup
                         + L * _sqrt0(rho_perp * rho_perp * vbar * dt)
                         * zp)
    else:
        z1 = rho * z2 + rho_perp * zp
        sig_eff = L * _sqrt0(v_eff)
        S_new = S * exp_((mu - 0.5 * sig_eff * sig_eff) * dt
                         + sig_eff * sqrt_dt * z1)
        v_new = torch.clamp(
            v + kappa * (theta_v - v_eff) * dt
            + xi * _sqrt0(v_eff) * sqrt_dt * z2, min=0.0)
    return S_new, v_new


def _interp_row(row, u, n_bins: int):
    """Linear interpolation of a table row at the fractional bin
    coordinate u (clamped at the grid ends)."""
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, n_bins - 2)
    frac = torch.clamp(u - i.to(u.dtype), 0.0, 1.0)
    return row[i] * (1.0 - frac) + row[i + 1] * frac


def _convolve_same(row, kern):
    """``jnp.convolve(row, kern, mode="same")`` for an odd kernel:
    out[n] = Σ_j row[n + j]·kern[p − j], p the kernel's midpoint."""
    p = (kern.shape[0] - 1) // 2
    n = row.shape[0]
    padded = torch.nn.functional.pad(row, (p, p))
    out = kern[2 * p] * padded[0:n]
    for j in range(-p + 1, p + 1):
        out = out + kern[p - j] * padded[p + j:p + j + n]
    return out


def _bin_sums(raw, idx, n_bins: int):
    """(n_bins, 5) per-bin sums of the (n, 5) rows of ``raw``: a stable
    sort by bin, then a sequential sum per bin, in the particles' order."""
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=n_bins)
    return torch.segment_reduce(raw[order], "sum", lengths=counts, axis=0)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.tensor(float(value), dtype=dtype, device=device)


def _anti(z, antithetic: bool):
    return torch.cat([z, -z]) if antithetic else z


def _calibrate_scan(normals: Callable, sig_grid, fixed, *, n_steps: int,
                    n_paths: int, n_bins: int, antithetic: bool, dtype,
                    regression: str = "local_linear", smooth: int = 5,
                    scheme: str = "euler"):
    """Particle calibration: returns the (n_steps, n_bins) leverage table
    and the terminal (S, v) ensemble.

    ``sig_grid[k, j]`` = Dupire σ at (t_k, F_{t_k}·e^{x_j}). Step k
    estimates E[v | bin] from the ensemble at t_k, forms
    L_k = σ_Dup / √E[v | bin], then advances every particle with its own
    interpolated L. ``normals(k)`` gives step k's (z2, zp), each
    (n_paths,).
    """
    dt_ = dtype
    dev = sig_grid.device
    dt = fixed["T"] / n_steps
    sqrt_dt = torch.sqrt(dt)
    n_cols = 2 * n_paths if antithetic else n_paths
    exp_, log_ = _exp_for(dt_), _log_for(dt_)
    x0, dx = fixed["x0"], fixed["dx"]
    kern = _smooth_kernel(dt_, smooth, dev)

    rho = fixed["rho"]
    rho_perp = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
    mu = fixed["r"] - fixed["q"]

    S = torch.full((n_cols,), float(fixed["S0"]), dtype=dt_, device=dev)
    v = torch.full((n_cols,), float(torch.clamp(fixed["v0"], min=0.0)),
                   dtype=dt_, device=dev)
    x_centers = x0 + dx * torch.arange(n_bins, dtype=dt_, device=dev)

    # Shifted smoothing kernels: with out[n] = Σ_j row[n+j]·kern[p−j],
    # source bin n+j sits at offset δ = j·dx from target centre n; kern1 /
    # kern2 carry the δ and δ² weights, so own-centre per-bin moments are
    # translated to the target centre inside the convolution and every
    # x-like quantity stays O(dx) (no f32 cancellation).
    p_mid = (kern.shape[0] - 1) // 2
    j_of = (p_mid - torch.arange(kern.shape[0], dtype=dt_, device=dev)) * dx
    kern1 = kern * j_of
    kern2 = kern * j_of * j_of
    log_S0 = log_(fixed["S0"])

    def leverage_row(S, v, k, sig_row):
        # E[v | x-bin] by local-linear kernel regression on own-centre
        # moments, re-centred in the smoothing; the local-linear intercept
        # where the window has spread in x, Nadaraya-Watson elsewhere
        x = log_(S) - (log_S0 + mu * (_scalar(k, dt_, dev) * dt))
        u = (x - x0) / dx
        idx = torch.clamp(torch.round(u).to(torch.int64), 0, n_bins - 1)
        xc = x - x_centers[idx]
        v_eff = torch.clamp(v, min=0.0)
        ones = torch.ones_like(S)
        raw = torch.stack([ones, xc, xc * xc, v_eff, xc * v_eff], dim=1)
        s0, s1, s2, t0, t1 = _bin_sums(raw, idx, n_bins).unbind(dim=1)
        m0 = _convolve_same(s0, kern)
        m1c = _convolve_same(s1, kern) + _convolve_same(s0, kern1)
        m2c = _convolve_same(s2, kern) + 2.0 * _convolve_same(s1, kern1) \
            + _convolve_same(s0, kern2)
        q0 = _convolve_same(t0, kern)
        q1c = _convolve_same(t1, kern) + _convolve_same(t0, kern1)
        det = m0 * m2c - m1c * m1c
        vbar = torch.mean(v_eff)
        Ev_nw = torch.where(m0 > 0.5, q0 / torch.clamp(m0, min=1e-6), vbar)
        Ev_ll = (m2c * q0 - m1c * q1c) / torch.where(det > 0, det,
                                                     torch.ones_like(det))
        if regression == "local_linear":
            Ev = torch.where(det > 1e-10 * torch.clamp(m0 * m2c, min=1e-30),
                             Ev_ll, Ev_nw)
        else:
            Ev = Ev_nw
        Ev = torch.clamp(Ev, 0.05 * vbar, 20.0 * vbar)
        L = sig_row / torch.sqrt(torch.clamp(Ev, min=1e-8))
        return torch.clamp(L, 0.05, 20.0), u

    rows = []
    for k in range(n_steps):
        L_row, u = leverage_row(S, v, k, sig_grid[k])
        L = _interp_row(L_row, u, n_bins)
        z2, zp = normals(k)
        S, v = _advance_particles(
            S, v, L, _anti(z2, antithetic), _anti(zp, antithetic), mu=mu,
            kappa=fixed["kappa"], theta_v=fixed["theta"], xi=fixed["xi"],
            rho=rho, rho_perp=rho_perp, dt=dt, sqrt_dt=sqrt_dt, exp_=exp_,
            scheme=scheme)
        rows.append(L_row)
    return torch.stack(rows), S, v


def _step_draws(seed, n_paths: int, dtype, device,
                gen: Optional[torch.Generator] = None) -> Callable:
    """``normals(k) -> (z2, zp)``: two (n_paths,) standard-normal draws a
    step from one ``torch.Generator`` (``gen``, or one seeded from
    ``seed``), in step order."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(
            resolve_seed(seed) % 2**63)

    def normals(k):
        return tuple(torch.randn(int(n_paths), generator=gen, dtype=dtype,
                                 device=device) for _ in range(2))

    return normals


def lsv_calibrate(surface, heston: dict, S0: float, r: float,
                  q: float = 0.0, *, T: float, n_steps: int = 96,
                  n_paths: int = 131_072, n_bins: int = 128,
                  x_width: Optional[float] = None, antithetic: bool = True,
                  seed: Optional[int] = None, dtype=None,
                  regression: str = "local_linear",
                  smooth: int = 3, scheme: str = "euler",
                  device=None) -> LSVModel:
    """Calibrate the LSV leverage function to a Dupire surface.

    ``surface`` is a calibrated
    :class:`~optpricer_tpu_torch.models.calibration.VolSurface`;
    ``heston`` holds ``{'v0','kappa','theta','xi','rho'}``. The table is
    computed on an ``n_bins`` log-moneyness grid spanning ``±x_width``
    (default: 4 ATM-vol standard deviations at T, + 0.1) and ``n_steps``
    time points by the particle method. The dominant calibration error is
    the kernel bandwidth in x (the O(h²·∂²E[v|x]) smoothing bias scales
    with ξ², independent of ``n_paths`` and ``n_steps``).
    ``regression="nw"`` selects plain Nadaraya-Watson; ``scheme="qe"``
    advances the particles with Andersen's QE variance transition and the
    leverage-scaled central asset step, and pricing follows it.
    ``dtype`` defaults to float64; the card's float32 is
    ``dtype="float32"``.
    """
    from .calibration import dupire_local_vol

    if scheme not in ("euler", "qe"):
        raise ValueError("scheme must be 'euler' or 'qe'")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    if x_width is None:
        atm = float(surface.iv_from_logm(0.0, T))
        x_width = 4.0 * atm * float(np.sqrt(T)) + 0.1
    x_bins = torch.linspace(-x_width, x_width, n_bins, dtype=dt_,
                            device=dev)
    dx = float(x_bins[1] - x_bins[0])

    # Dupire σ on the (t_k, bin) grid, evaluated once before the scan
    t_grid = torch.arange(n_steps, dtype=dt_, device=dev) * (T / n_steps)
    t_safe = torch.clamp(t_grid, min=1e-6)
    rows = []
    for t in t_safe:
        F_t = S0 * torch.exp((r - q) * t)
        rows.append(dupire_local_vol(surface, F_t * torch.exp(x_bins), t, r,
                                     q).to(dt_))
    sig_grid = torch.stack(rows)                       # (n_steps, n_bins)

    def scalar(value):
        return _scalar(value, dt_, dev)

    fixed = dict(S0=scalar(S0), r=scalar(r), q=scalar(q), T=scalar(T),
                 v0=scalar(heston["v0"]), kappa=scalar(heston["kappa"]),
                 theta=scalar(heston["theta"]), xi=scalar(heston["xi"]),
                 rho=scalar(heston["rho"]), x0=x_bins[0], dx=scalar(dx))
    L_table, _, _ = _calibrate_scan(
        _step_draws(seed, n_paths, dt_, dev), sig_grid, fixed,
        n_steps=int(n_steps), n_paths=int(n_paths), n_bins=int(n_bins),
        antithetic=bool(antithetic), dtype=dt_, regression=regression,
        smooth=int(smooth), scheme=scheme)
    return LSVModel(S0=float(S0), r=float(r), q=float(q), T=float(T),
                    v0=float(heston["v0"]), kappa=float(heston["kappa"]),
                    theta=float(heston["theta"]), xi=float(heston["xi"]),
                    rho=float(heston["rho"]), x_bins=x_bins,
                    leverage=L_table, scheme=scheme)


def _lsv_paths(normals: Callable, model: LSVModel, fixed: dict, *,
               payoff: str, kind: str, n_steps: int, n_paths: int,
               antithetic: bool, barrier_type: str, average_type: str,
               strike_type: str, dtype):
    """Fused LSV path loop: O(1) state per path (spot, running sum /
    log-sum / max / min, barrier flag, variance) with the frozen leverage
    table's row k interpolated per particle on step k. Returns the
    undiscounted payoff per path and the terminal spots. Heston parameters
    come from ``fixed`` (``h_v0`` … ``h_rho``) when present — the
    differentiated inputs of :func:`lsv_greeks_mc` — and from the model
    otherwise."""
    dt_ = dtype
    dev = fixed["S0"].device
    dt = fixed["T"] / n_steps
    sqrt_dt = torch.sqrt(dt)
    n_cols = 2 * n_paths if antithetic else n_paths
    exp_, log_ = _exp_for(dt_), _log_for(dt_)
    lev = torch.as_tensor(model.leverage, dtype=dt_, device=dev)
    x_bins = torch.as_tensor(model.x_bins, dtype=dt_, device=dev)
    n_bins = lev.shape[1]
    x0 = x_bins[0]
    dx = x_bins[1] - x_bins[0]
    mu = fixed["r"] - fixed["q"]

    def param(name, default):
        return torch.as_tensor(fixed.get(name, default), dtype=dt_,
                               device=dev)

    rho = param("h_rho", model.rho)
    rho_perp = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
    kappa = param("h_kappa", model.kappa)
    theta_v = param("h_theta", model.theta)
    xi = param("h_xi", model.xi)

    zeros = torch.zeros(n_cols, dtype=dt_, device=dev)
    S = zeros + fixed["S0"]
    v = zeros + torch.clamp(param("h_v0", model.v0), min=0.0)
    up = barrier_type.startswith("up")
    if payoff == "barrier":
        crossed = (S >= fixed["barrier"]) if up else (S <= fixed["barrier"])
    else:
        crossed = zeros > 1.0
    rsum, rlog, rmax, rmin = zeros, zeros, S, S
    log_S0 = log_(fixed["S0"])
    for k in range(n_steps):
        x = log_(S) - (log_S0 + mu * (_scalar(k, dt_, dev) * dt))
        L = _interp_row(lev[k], (x - x0) / dx, n_bins)
        z2, zp = normals(k)
        S, v = _advance_particles(
            S, v, L, _anti(z2, antithetic), _anti(zp, antithetic), mu=mu,
            kappa=kappa, theta_v=theta_v, xi=xi, rho=rho, rho_perp=rho_perp,
            dt=dt, sqrt_dt=sqrt_dt, exp_=exp_, scheme=model.scheme)
        if payoff == "asian":
            rsum = rsum + S
            if average_type == "geometric":
                rlog = rlog + log_(S)
        if payoff == "lookback":
            rmax = torch.maximum(rmax, S)
            rmin = torch.minimum(rmin, S)
        if payoff == "barrier":
            hit = (S >= fixed["barrier"]) if up else (S <= fixed["barrier"])
            crossed = torch.logical_or(crossed, hit)
    pay = _terminal_payoff(
        payoff, (S, rsum, rlog, rmax, rmin, crossed), K=fixed["K"],
        kind=kind, n_steps=n_steps, barrier_type=barrier_type,
        rebate=fixed["rebate"], average_type=average_type,
        strike_type=strike_type, payout=fixed["payout"])
    return pay, S


def lsv_path_matrix(model: LSVModel, *, n_paths: int = 100_000,
                    T: Optional[float] = None, antithetic: bool = True,
                    seed: Optional[int] = None, dtype=None, device=None):
    """(S, v) path matrices under the calibrated LSV dynamics.

    Returns ``(S_paths, v_paths)``, each ``(n_use + 1, n_paths_eff)`` with
    the t = 0 row, antithetic doubling the columns. The time grid is the
    leverage table's own (dt = model.T / model.n_steps); ``T`` (default
    ``model.T``) may be any earlier point on that grid, and the first
    n_use = T/dt leverage rows drive the steps.
    """
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    return _lsv_matrix(_step_draws(seed, n_paths, dt_, dev), model,
                       n_paths=n_paths, T=T, antithetic=antithetic,
                       dtype=dt_, device=dev)


def _lsv_matrix(normals: Callable, model: LSVModel, *, n_paths: int, T,
                antithetic: bool, dtype, device):
    """The deterministic core of :func:`lsv_path_matrix`."""
    dt_, dev = dtype, device
    n_steps = model.n_steps
    dt_f = model.T / n_steps
    T = model.T if T is None else float(T)
    n_use = int(round(T / dt_f))
    if not (0 < n_use <= n_steps) or abs(n_use * dt_f - T) > 1e-9 * model.T:
        raise ValueError(
            f"T={T} must be a positive multiple of the leverage grid "
            f"step {dt_f} (model.T={model.T}, n_steps={n_steps})")

    def scalar(value):
        return _scalar(value, dt_, dev)

    x_bins = torch.as_tensor(model.x_bins, device=dev)
    lev = torch.as_tensor(model.leverage, dtype=dt_, device=dev)
    dt = scalar(dt_f)
    sqrt_dt = torch.sqrt(dt)
    exp_, log_ = _exp_for(dt_), _log_for(dt_)
    n_bins = lev.shape[1]
    x0 = x_bins[0].to(dt_)
    dx = (x_bins[1] - x_bins[0]).to(dt_)
    mu = scalar(model.r - model.q)
    rho = scalar(model.rho)
    rho_perp = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
    S0 = scalar(model.S0)
    n_cols = 2 * n_paths if antithetic else n_paths
    S = torch.full((n_cols,), float(model.S0), dtype=dt_, device=dev)
    v = torch.full((n_cols,), max(model.v0, 0.0), dtype=dt_, device=dev)
    S_rows, v_rows = [S], [v]
    log_S0 = log_(S0)
    for k in range(n_use):
        x = log_(S) - (log_S0 + mu * (scalar(k) * dt))
        L = _interp_row(lev[k], (x - x0) / dx, n_bins)
        z2, zp = normals(k)
        S, v = _advance_particles(
            S, v, L, _anti(z2, antithetic), _anti(zp, antithetic), mu=mu,
            kappa=scalar(model.kappa), theta_v=scalar(model.theta),
            xi=scalar(model.xi), rho=rho, rho_perp=rho_perp, dt=dt,
            sqrt_dt=sqrt_dt, exp_=exp_, scheme=model.scheme)
        S_rows.append(S)
        v_rows.append(v)
    return torch.stack(S_rows), torch.stack(v_rows)


def _leverage_poly(model: LSVModel, deg: int = 12):
    """Per-step monomial coefficients (DESCENDING, for Horner) of the
    leverage rows on u = x/x_width ∈ [−1, 1]: a Chebyshev least-squares
    fit on the bin grid, converted to monomial form, so the path kernel
    evaluates L as ``deg`` multiply-adds instead of gathering from the
    table. Returns ``(coeffs f32 (n_steps, deg+1), x_width)``."""
    x_bins = np.asarray(torch.as_tensor(model.x_bins).detach().cpu(),
                        np.float64)
    x_width = float(max(abs(x_bins[0]), abs(x_bins[-1])))
    u = x_bins / x_width
    lev = np.asarray(torch.as_tensor(model.leverage).detach().cpu(),
                     np.float64)
    deg = int(min(deg, len(u) - 1))
    C = np.polynomial.chebyshev.chebfit(u, lev.T, deg)  # (deg+1, n_steps)
    coeffs = np.stack([np.polynomial.chebyshev.cheb2poly(C[:, k])[::-1]
                       for k in range(lev.shape[0])])
    return coeffs.astype(np.float32), x_width


def lsv_price_mc(payoff: str, model: LSVModel, K: float, *,
                 kind: str = "call", n_paths: int = 100_000,
                 barrier: float = 0.0, barrier_type: str = "up-and-out",
                 rebate: float = 0.0, average_type: str = "arithmetic",
                 strike_type: str = "fixed", payout: float = 1.0,
                 antithetic: bool = True, seed: Optional[int] = None,
                 dtype=None, mesh=None, backend: str = "auto",
                 device=None):
    """Price a (path-dependent) option under the calibrated LSV model.

    ``payoff`` in {"vanilla", "barrier", "asian", "digital", "lookback"}
    with the conventions of :func:`~optpricer_tpu_torch.models.mc_fused.
    exotic_price_mc`; the leverage table is frozen and fixes the time grid
    (``model.n_steps``). ``backend``: "auto" and "pallas" run the path
    kernel's LSV branch (K4 ``lsv``, or ``lsv_qe`` for a QE model; the
    leverage rows as per-step polynomials; the spot control variate) for
    an even step count in float32 (``dtype=None`` means float32 there);
    "pallas" raises where the kernel cannot run; "xla", and "auto" for an
    odd step count or float64, run the torch scan with the table
    interpolated per particle (float64 unless ``dtype=`` says otherwise).
    Returns ``(price, stderr)``.
    """
    if payoff not in _PAYOFFS:
        raise ValueError(f"unknown payoff {payoff!r}")
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device) if mesh is None else None
    n_steps = model.n_steps
    kernel_ok = n_steps % 2 == 0 and (dtype is None
                                      or canonical(dtype) == MC_DTYPE)
    if backend == "pallas" and not kernel_ok:
        raise ValueError("backend='pallas' requires even n_steps and f32")
    if kernel_ok and backend != "xla":
        coeffs, x_width = _leverage_poly(model)
        lsv_kw = dict(model.heston, coeffs=coeffs, x_width=x_width,
                      scheme=model.scheme)
        args = (resolve_seed(seed), int(n_paths), int(n_steps), model.S0, K,
                model.T, model.r, model.q, 0.0, kind == "call")
        pk = dict(payoff=payoff, antithetic=bool(antithetic),
                  barrier=barrier, barrier_type=barrier_type, rebate=rebate,
                  average_type=average_type, strike_type=strike_type,
                  payout=payout, lsv=lsv_kw)
        stats = path_mc_sumstats_kernel_sharded(mesh, *args, **pk) \
            if mesh is not None else \
            path_mc_sumstats_kernel(*args, device=dev, **pk)
        return _estimate_from_stats(stats, model.S0, K, model.T, model.r,
                                    model.q, 0.0, kind == "call", "lsv",
                                    True)
    dt_ = canonical(dtype)
    static = dict(payoff=payoff, kind=kind, n_steps=n_steps,
                  antithetic=bool(antithetic), barrier_type=barrier_type,
                  average_type=average_type, strike_type=strike_type,
                  dtype=dt_)
    parts = []
    for dev_d, gen, n_local in _shards(mesh, resolve_seed(seed), n_paths,
                                       dev):
        def scalar(value, d=dev_d):
            return _scalar(value, dt_, d)

        fixed = dict(S0=scalar(model.S0), K=scalar(K), T=scalar(model.T),
                     r=scalar(model.r), q=scalar(model.q),
                     barrier=scalar(barrier), rebate=scalar(rebate),
                     payout=scalar(payout))
        pay, _ = _lsv_paths(_step_draws(None, n_local, dt_, dev_d, gen),
                            model, fixed, n_paths=n_local, **static)
        if mesh is None:
            return _price_from_payoff(pay, model.r, model.T)
        X = _exp_for(dt_)(-fixed["r"] * fixed["T"]) * pay
        parts.append(torch.stack([
            torch.tensor(float(X.numel()), dtype=dt_, device=dev_d),
            torch.sum(X), torch.sum(X * X)]))
    from ..parallel.mesh import mesh_sum

    s = mesh_sum(parts).detach().cpu().numpy().astype(np.float64)
    m = s[1] / s[0]
    var = max(0.0, s[2] / s[0] - m * m)
    return float(m), float(np.sqrt(var / s[0]))


def lsv_greeks_mc(payoff: str, model: LSVModel, K: float, *,
                  kind: str = "call", n_paths: int = 100_000,
                  average_type: str = "arithmetic",
                  strike_type: str = "fixed", antithetic: bool = True,
                  seed: Optional[int] = None, dtype=None,
                  mesh=None, device=None) -> dict:
    """Pathwise-AD Greeks under the calibrated LSV model.

    One ``torch.func.jacfwd`` through the LSV scan gives per-path
    derivatives of the discounted payoff w.r.t. (S0, r, T) and the Heston
    parameters (v0, κ, θ, ξ, ρ): keys ``delta``/``rho``/``theta``/
    ``d_v0``/``d_kappa``/``d_theta``/``d_xi``/``d_rho``, each with a
    ``*_stderr``. Sticky-leverage Greeks: the calibrated table is frozen
    while the parameters move. Continuous payoffs only (vanilla / asian /
    lookback) and a ``scheme="euler"`` model. The normals are drawn before
    the differentiated function, so ``jacfwd`` never vmaps over a
    generator. Float64 unless ``dtype=`` says otherwise.
    """
    if payoff not in ("vanilla", "asian", "lookback"):
        raise ValueError(
            "pathwise AD Greeks need a continuous payoff (one of "
            "('vanilla', 'asian', 'lookback')); barrier/digital under LSV "
            "require bump-and-reprice with common random numbers")
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if model.scheme != "euler":
        raise ValueError(
            "lsv_greeks_mc requires a scheme='euler' model: the QE "
            "variance transition has a point mass at zero, so pathwise "
            "AD is invalid across it — use CRN bump-and-reprice on the "
            "QE model instead")
    from ..parallel.mesh import mesh_sum

    dt_ = canonical(dtype)
    n_steps = model.n_steps
    exp_ = _exp_for(dt_)
    names = (("delta", "S0"), ("rho", "r"), ("theta", "T"),
             ("d_v0", "h_v0"), ("d_kappa", "h_kappa"),
             ("d_theta", "h_theta"), ("d_xi", "h_xi"), ("d_rho", "h_rho"))
    vals = dict(S0=model.S0, r=model.r, T=model.T, h_v0=model.v0,
                h_kappa=model.kappa, h_theta=model.theta, h_xi=model.xi,
                h_rho=model.rho)
    keys_ = [k for _, k in names]

    def local_sums(dev, gen, n_local):
        draw = _step_draws(None, n_local, dt_, dev, gen)
        draws = [draw(k) for k in range(n_steps)]

        def scalar(value):
            return _scalar(value, dt_, dev)

        base = dict(K=scalar(K), q=scalar(model.q), barrier=scalar(0.0),
                    rebate=scalar(0.0), payout=scalar(1.0))
        theta0 = torch.stack([scalar(vals[k]) for k in keys_])

        def path_X(th):
            f2 = dict(base)
            for i, k in enumerate(keys_):
                f2[k] = th[i]
            pay, _ = _lsv_paths(lambda k: draws[k], model, f2,
                                payoff=payoff, kind=kind, n_steps=n_steps,
                                n_paths=n_local,
                                antithetic=bool(antithetic),
                                barrier_type="up-and-out",
                                average_type=average_type,
                                strike_type=strike_type, dtype=dt_)
            X = exp_(-f2["r"] * f2["T"]) * pay
            return X, X

        J, X = torch.func.jacfwd(path_X, has_aux=True)(theta0)
        cols = torch.cat([X[:, None], J], dim=1)
        return torch.cat([torch.tensor([float(X.shape[0])], dtype=dt_,
                                       device=dev),
                          torch.sum(cols, dim=0),
                          torch.sum(cols * cols, dim=0)])

    shards = _shards(mesh, resolve_seed(seed), n_paths,
                     None if mesh is not None else device)
    s = mesh_sum([local_sums(*shard) for shard in shards])
    s = s.detach().cpu().numpy().astype(np.float64)
    k = len(names)
    n, mean, sq = s[0], s[1:2 + k] / s[0], s[2 + k:] / s[0]
    se = np.sqrt(np.maximum(0.0, sq - mean * mean) / n)
    out = {"price": float(mean[0]), "stderr": float(se[0])}
    for i, (nm, _) in enumerate(names):
        sgn = -1.0 if nm == "theta" else 1.0     # theta = −dV/dT
        out[nm] = float(sgn * mean[1 + i])
        out[f"{nm}_stderr"] = float(se[1 + i])
    return out

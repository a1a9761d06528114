"""Fused path-dependent Monte-Carlo pricing: ``exotic_price_mc``,
``exotic_price_mc_dupire`` and ``exotic_greeks_mc``.

Counterpart of ``optpricer_tpu/models/mc_fused.py``. Every price comes from
sufficient statistics, or per-path payoffs, reduced on the device and a
float64 estimator on the host. Two engines:

* the path kernel (``ops/path_mc.path_mc``, K4, 21 stats), which
  ``backend="auto"`` and ``"pallas"`` take for float32 runs with an even
  ``n_steps`` under GBM (``sigma=``), Heston (``heston=``, full-truncation
  Euler or Andersen QE with ``scheme="qe"``) or SABR (``sabr=``, β = 1
  log-Euler or β < 1 clamped Euler), with the dual control variate under
  GBM, the spot control variate under stochastic volatility and, for the
  fixed-strike arithmetic Asian under GBM, the geometric-Asian control
  variate; ``exotic_greeks_mc`` under GBM reads price, delta, gamma, vega,
  rho and theta from its Greek moments, and ``exotic_price_mc_dupire``
  ships a calibrated surface's SVI slices into it;
* the scan engine :func:`_fused_paths`, which ``backend="xla"`` takes and
  every run the kernel cannot price: a ``sigma_loc(S, t)`` closure (log-
  Euler or Milstein), ``merton=``, ``vg=``, ``nig=``, ``dividends=``, an
  odd ``n_steps``, float64 (``dtype=None`` is float64 there). It walks the
  steps in a Python loop with O(n_paths) state: spot, running sum / log-sum
  / max / min, the barrier flag and the variance (or SABR σ). Beside it,
  ``scheme="exact"`` runs the dual-BESQ exact CEV sampler
  (:func:`_cev_exact_sumstats`), ``exotic_greeks_mc`` under non-GBM
  dynamics the forward-mode pathwise Greeks (:func:`_ad_exotic_greeks`,
  ``torch.func.jacfwd`` through the scan), and ``backend="qmc"`` in float64
  the staged Sobol → Φ⁻¹ → Brownian bridge → payoff route
  (:func:`_qmc_replicate`); float32 QMC runs the path-QMC kernel
  (``ops/qmc_path``).

``mesh=`` (a :class:`~optpricer_tpu_torch.parallel.mesh.Mesh`) splits the
kernel's grid (``path_mc_sumstats_kernel_sharded``) or the scan's paths
over its devices, each shard's draws from (seed, shard index), with the
stats summed in mesh order.

**Seed semantics.** The path kernel is bit-reproducible given
``(seed, n_paths, n_steps, antithetic)`` and draws exactly the JAX path
kernel's ``sw_prng`` stream, so a seed prices the same sample here as JAX
``exotic_price_mc(..., backend="pallas")`` does on the CPU. The scan
engine draws from a ``torch.Generator`` on its device seeded from ``seed``
(a CUDA and a CPU generator give different streams), step by step, and
hands the draws to a deterministic core: :func:`_fused_paths` takes a
``draws(k)`` callable, :func:`_cev_exact_sumstats` a sampler object. The
JAX package's scan draws from ``jax.random`` keys, whose stream torch does
not reproduce, so a seed gives another sample than its XLA engine; fed the
reference's own draws, the cores give its paths. The QMC routes randomise
the reference's Sobol point set with the reference's digital shifts.

Returns ``(price, stderr)`` like the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..dtypes import MC_DTYPE, canonical, resolve_device
from ..ops import stats as stats_ops
from ..ops.fastmath import exp32, log32
from ..ops.path_mc import (path_mc_sumstats_kernel,
                           path_mc_sumstats_kernel_sharded)
from ..ops.qmc_path import path_qmc_sumstats_kernel, qmc_path_estimate
from ..ops.terminal_mc import terminal_estimate
from .analytic import geometric_asian_price_f64
from .exotics import _price_from_payoff
from .monte_carlo import keyed_generator, resolve_seed

__all__ = ["exotic_price_mc", "exotic_price_mc_dupire", "exotic_greeks_mc"]

_PAYOFFS = ("vanilla", "barrier", "asian", "digital", "lookback")
# payoffs whose pathwise delta the homogeneity argument covers; barrier and
# digital payoffs are discontinuous and use likelihood-ratio estimators
_PATHWISE_OK = ("vanilla", "asian", "lookback")
_LR_OK = ("barrier", "digital")
_BACKENDS = ("auto", "pallas", "qmc", "xla")
_SV_KINDS = ("heston", "heston_qe", "sabr_ln", "sabr_cev")


def _exp_for(dtype):
    """exp for the engine dtype: the bias-free ``exp32`` in float32 (the
    kernels' and the reference's f32 choice), ``torch.exp`` otherwise."""
    return exp32 if dtype == torch.float32 else torch.exp


def _log_for(dtype):
    return log32 if dtype == torch.float32 else torch.log


class _Sqrt0(torch.autograd.Function):
    """sqrt with subgradient 0 at x == 0.

    Full-truncation Heston parks variance exactly at 0 with positive
    probability, and Merton draws zero jump counts; there the chain rule
    meets sqrt'(0) = ∞ against a zero tangent and pathwise AD returns
    NaN. The one-sided derivative from the truncated region is 0, the
    reference's custom JVP. Forward mode (``jvp``) serves
    ``torch.func.jacfwd``, which vmaps it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x, output)
        ctx.save_for_forward(x, output)

    @staticmethod
    def _slope(x, y):
        return torch.where(x > 0, 0.5 / torch.where(y > 0, y, 1.0), 0.0)

    @staticmethod
    def jvp(ctx, t):
        x, y = ctx.saved_tensors
        return _Sqrt0._slope(x, y) * t

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _Sqrt0._slope(x, y) * g


def _sqrt0(x):
    return _Sqrt0.apply(x)


def _terminal_payoff(payoff, carry, *, K, kind, n_steps, barrier_type,
                     rebate, average_type, strike_type, payout):
    """The payoff of a scan's terminal carry (S, running sum, running
    log-sum, running max, running min, crossed)."""
    S, run_sum, run_logsum, run_max, run_min, crossed = carry
    is_call = kind == "call"
    zero = torch.zeros((), dtype=S.dtype, device=S.device)

    def relu(x):
        # jnp.maximum's tangent rule: half of each side's at a tie (a
        # lookback whose running max stays at S0 = K)
        return torch.maximum(x, zero)

    def vanilla(ST):
        return relu(ST - K) if is_call else relu(K - ST)

    def full(value):
        return torch.as_tensor(value, dtype=S.dtype,
                               device=S.device).expand_as(S)

    if payoff == "vanilla":
        return vanilla(S)
    if payoff == "digital":
        itm = (S > K) if is_call else (S < K)
        return torch.where(itm, full(payout), full(0.0))
    if payoff == "barrier":
        if barrier_type.endswith("out"):
            return torch.where(crossed, full(rebate), vanilla(S))
        return torch.where(crossed, vanilla(S), full(rebate))
    if payoff == "asian":
        if average_type == "arithmetic":
            avg = run_sum / n_steps
        else:
            avg = _exp_for(S.dtype)(run_logsum / n_steps)
        if strike_type == "fixed":
            return vanilla(avg)
        return relu(S - avg) if is_call else relu(avg - S)
    if payoff == "lookback":
        if strike_type == "floating":
            return (S - run_min) if is_call else (run_max - S)
        return relu(run_max - K) if is_call else relu(K - run_min)
    raise ValueError(f"unknown payoff {payoff!r}")


def _estimate_from_stats(stats_vec, S0, K, T, r, q, sigma, is_call: bool,
                         dynamics: str, control_variate: bool,
                         geo_ey=None):
    """(price, stderr) from the stats vector, dynamics-aware.

    Under GBM both control-variate means are known in closed form (dual
    CV). Under stochastic volatility or local vol only the spot mean
    E[e^{−rT}S_T] = S0·e^{−qT} is model-free, so a single CV is used.
    Without CV, the plain mean/stderr. ``geo_ey`` (arithmetic Asian only):
    the Y1 slot holds the geometric-Asian payoff whose closed-form mean
    this is — single CV on it.
    """
    s = stats_vec
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    s = np.asarray(s, np.float64)
    n = s[0]
    if n == 0:
        return float("nan"), float("nan")
    if not control_variate:
        mX = s[1] / n
        vX = max(0.0, s[2] / n - mX * mX)
        return float(mX), float(np.sqrt(vX / n))
    if geo_ey is not None:
        mean, se = stats_ops.cv_mean_se_np(s[:6], geo_ey)
        # f32 moment-roundoff floor
        return mean, max(se, 2e-6 * (1.0 + abs(mean)))
    if dynamics == "gbm":
        return terminal_estimate(s, S0, K, T, r, q, sigma, is_call, True)
    mean, se = stats_ops.cv_mean_se_np(s[:6], S0 * np.exp(-q * T))
    return mean, se




def _pathwise_dinner(payoff, pay, S_T, rlog, rmax, rmin, W, g1, g2, g3, g4,
                     *, K, sigma, r, q, T, kind, n_steps, average_type,
                     strike_type):
    """Per-path d(inner)/d(σ, r, T) for continuous payoffs under GBM,
    already multiplied by the exercise indicator.

    Inputs are the carries of ``_fused_paths(with_greeks=True)``: W the
    Brownian path at T; accumulators by payoff — asian arithmetic:
    g1 = Σ S_k·W_k, g2 = Σ S_k·t_k; asian geometric: g1 = Σ W_k; lookback:
    (g1, g3) = (W, t) at the running max, (g2, g4) at the min. From
    ln S_t = ln S0 + c·t + σW_t with c = r − q − σ²/2 and W_t = √T·B_{t/T}:
    dS_t/dσ = S_t·(W_t − σt), dS_t/dr = S_t·t,
    dS_t/dT = S_t·(c·t + σW_t/2)/T. Returns ``(dσ, dr, dT)``.
    """
    sign = 1.0 if kind == "call" else -1.0
    c = r - q - 0.5 * sigma * sigma
    itm = (pay > 0.0).to(pay.dtype)

    def dS_terminal():
        return (S_T * (W - sigma * T), S_T * T,
                S_T * (c * T + 0.5 * sigma * W) / T)

    if payoff == "vanilla":
        ds, dr, dT = dS_terminal()
        dinner = (sign * ds, sign * dr, sign * dT)
    elif payoff == "asian":
        m = n_steps
        if average_type == "geometric":
            avg = torch.exp(rlog / m)
            tsum = (T / m) * (m * (m + 1.0) / 2.0)
            davg = (avg * (g1 - sigma * tsum) / m,
                    avg * tsum / m,
                    avg * (c * tsum + 0.5 * sigma * g1) / (m * T))
        else:
            davg = ((g1 - sigma * g2) / m,
                    g2 / m,
                    (c * g2 + 0.5 * sigma * g1) / (m * T))
        if strike_type == "floating":
            ds = dS_terminal()
            dinner = tuple(sign * (a - b) for a, b in zip(ds, davg))
        else:
            dinner = tuple(sign * d for d in davg)
    elif payoff == "lookback":
        dmax = (rmax * (g1 - sigma * g3), rmax * g3,
                rmax * (c * g3 + 0.5 * sigma * g1) / T)
        dmin = (rmin * (g2 - sigma * g4), rmin * g4,
                rmin * (c * g4 + 0.5 * sigma * g2) / T)
        if strike_type == "floating":
            ds = dS_terminal()
            if kind == "call":
                dinner = tuple(a - b for a, b in zip(ds, dmin))
            else:
                dinner = tuple(a - b for a, b in zip(dmax, ds))
        else:
            dinner = dmax if kind == "call" else tuple(-d for d in dmin)
    else:
        raise ValueError(f"no pathwise derivative for payoff {payoff!r}")
    return tuple(itm * d for d in dinner)


# ---------------------------------------------------------------------------
# the scan engine: a draw step and a deterministic core
# ---------------------------------------------------------------------------
def _anti(x, antithetic: bool, negate: bool = True):
    if not antithetic:
        return x
    return torch.cat([x, -x if negate else x])


def _scan_draws(gen, model_kind: str, n_paths: int, *, T: float,
                n_steps: int, dtype, device, m_lam: float = 0.0,
                v_nu: float = 1.0, with_grad: bool = False) -> Callable:
    """``draws(k)``: step k's draws for :func:`_fused_paths` from ``gen``,
    in step order — stochastic volatility (z2, zp); Merton (z, Poisson
    counts at rate λΔt, zj); VG (the unit-scale gamma clock G at shape
    Δt/ν, ∂G/∂shape when ``with_grad`` else None, z); NIG (the IG
    sampler's normal and uniform, z); else (z,). Each (n_paths,)."""
    n = int(n_paths)
    dt = float(T) / int(n_steps)

    def normal():
        return torch.randn(n, generator=gen, dtype=dtype, device=device)

    if model_kind in _SV_KINDS:
        return lambda k: (normal(), normal())
    if model_kind == "merton":
        rate = torch.full((n,), m_lam * dt, dtype=dtype, device=device)
        return lambda k: (normal(), torch.poisson(rate, generator=gen),
                          normal())
    if model_kind == "vg":
        from .levy import _gamma_sample_grad, _standard_gamma

        shape = dt / v_nu

        def vg_draws(k):
            G = _standard_gamma(gen, shape, (n,), dtype, device)
            dG = _gamma_sample_grad(
                torch.tensor(shape, dtype=dtype, device=device), G) \
                if with_grad else None
            return G, dG, normal()
        return vg_draws
    if model_kind == "nig":
        return lambda k: (normal(), torch.rand(n, generator=gen, dtype=dtype,
                                               device=device), normal())
    return lambda k: (normal(),)


def _fused_paths(draws: Callable, fixed, *, payoff, kind, n_steps, n_paths,
                 antithetic, barrier_type, average_type, strike_type,
                 model_kind, sigma_loc, dtype, with_greeks: bool = False,
                 with_geo: bool = False):
    """The scan engine's deterministic core: ``n_steps`` steps of the
    ``model_kind`` dynamics on ``n_paths`` paths (doubled by
    ``antithetic``), step k's draws from ``draws(k)`` (the layout of
    :func:`_scan_draws`), market and model values from ``fixed`` (0-d
    tensors on one device; under ``_ad_exotic_greeks`` some carry
    tangents). Returns ``(pay, S_T)`` undiscounted.

    ``with_greeks`` (GBM only) also carries the Brownian path W_t and the
    payoff's pathwise accumulators, returning ``(pay, S_T, (dσ, dr, dT,
    z₁))`` for the continuous payoffs (:func:`_pathwise_dinner`) and
    ``(pay, S_T, (z₁, W, Σz²))`` for barrier and digital. ``with_geo``
    (arithmetic asian) also accumulates the log-sum and returns ``(pay,
    S_T, pay_geo)`` with the geometric-average payoff of the same kind.
    """
    dt_ = dtype
    dev = fixed["S0"].device
    dt = fixed["T"] / n_steps
    sqrt_dt = torch.sqrt(dt)
    n_cols = 2 * n_paths if antithetic else n_paths
    S_init = fixed["S0"] * torch.ones(n_cols, dtype=dt_, device=dev)
    zeros = S_init * 0.0

    up = barrier_type.startswith("up")
    crossed0 = (S_init >= fixed["barrier"]) if up else \
        (S_init <= fixed["barrier"])
    # v carries the stochastic-vol state: variance (Heston) or σ (SABR)
    state0 = fixed["s_alpha0"] if model_kind.startswith("sabr") \
        else torch.clamp(fixed["h_v0"], min=0.0)
    v = zeros + state0
    if with_greeks and model_kind != "gbm":
        raise ValueError("pathwise Greek accumulators require GBM dynamics")
    if with_greeks and payoff not in _PATHWISE_OK + _LR_OK:
        raise ValueError(f"no Greek estimator for payoff {payoff!r}")
    S, rsum, rlog, rmax, rmin = S_init, zeros, zeros, S_init, S_init
    crossed = crossed0 if payoff == "barrier" else zeros > 1.0
    if with_greeks:
        W = g1 = g2 = g3 = g4 = z1c = zeros

    exp_, log_ = _exp_for(dt_), _log_for(dt_)
    r, q = fixed["r"], fixed["q"]

    def gbm_step(S, z, t_now):
        mu = (r - q - 0.5 * fixed["sigma"] ** 2) * dt
        return S * exp_(mu + fixed["sigma"] * sqrt_dt * z)

    def lv_log_euler_step(S, z, t_now):
        sig = torch.clamp(torch.as_tensor(sigma_loc(S, t_now), dtype=dt_),
                          min=0.0)
        return S * exp_((r - q - 0.5 * sig * sig) * dt + sig * sqrt_dt * z)

    def lv_milstein_step(S, z, t_now):
        sig = torch.clamp(torch.as_tensor(sigma_loc(S, t_now), dtype=dt_),
                          1e-8, 10.0)
        eps = fixed["bump"] * S
        S_up = S + eps
        S_dn = torch.clamp(S - eps, min=1e-10)
        sig_up = torch.as_tensor(sigma_loc(S_up, t_now), dtype=dt_)
        sig_dn = torch.as_tensor(sigma_loc(S_dn, t_now), dtype=dt_)
        da_dS = (sig_up * S_up - sig_dn * S_dn) / (S_up - S_dn)
        a_t = sig * S
        S_n = (S + (r - q) * S * dt + a_t * sqrt_dt * z
               + 0.5 * a_t * da_dS * (z * z - 1.0) * dt)
        return torch.clamp(S_n, min=1e-10)

    def heston_step(S, v, z1, z2):
        v_eff = torch.clamp(v, min=0.0)  # full truncation
        S_new = S * exp_((r - q - 0.5 * v_eff) * dt
                         + _sqrt0(v_eff) * sqrt_dt * z1)
        v_new = torch.clamp(
            v + fixed["h_kappa"] * (fixed["h_theta"] - v_eff) * dt
            + fixed["h_xi"] * _sqrt0(v_eff) * sqrt_dt * z2, min=0.0)
        return S_new, v_new

    def heston_qe_step(S, v, zv, zs):
        # Andersen (2008) QE: moment-matched variance transition + central
        # log-asset step, ρ carried by the v-increment
        kap, th = fixed["h_kappa"], fixed["h_theta"]
        xi, rho = fixed["h_xi"], fixed["h_rho"]
        emkt = exp_(-kap * dt)
        c1 = xi * xi * emkt * (1.0 - emkt) / kap
        c2 = th * xi * xi * (1.0 - emkt) ** 2 / (2.0 * kap)
        tiny = 1e-12
        m = th + (v - th) * emkt
        s2 = v * c1 + c2
        psi = s2 / torch.clamp(m * m, min=tiny)
        two_over = 2.0 / torch.clamp(torch.clamp(psi, max=1.5), min=tiny)
        b2 = (two_over - 1.0 + torch.sqrt(two_over)
              * torch.sqrt(torch.clamp(two_over - 1.0, min=0.0)))
        a = m / (1.0 + b2)
        bz = torch.sqrt(torch.clamp(b2, min=0.0)) + zv
        u = torch.special.ndtr(zv)
        psi_e = torch.clamp(psi, min=1.5)
        p = (psi_e - 1.0) / (psi_e + 1.0)
        beta_e = (1.0 - p) / torch.clamp(m, min=tiny)
        v_exp = torch.where(
            u <= p, zeros,
            torch.log((1.0 - p) / torch.clamp(1.0 - u, min=tiny)) / beta_e)
        v_new = torch.where(psi <= 1.5, a * bz * bz, v_exp)
        g = 0.5
        K0 = -rho * kap * th * dt / xi
        K1 = g * dt * (kap * rho / xi - 0.5) - rho / xi
        K2 = g * dt * (kap * rho / xi - 0.5) + rho / xi
        K34 = g * dt * (1.0 - rho * rho)
        S_new = S * exp_((r - q) * dt + K0 + K1 * v + K2 * v_new
                         + _sqrt0(K34 * (v + v_new)) * zs)
        return S_new, v_new

    def sabr_step(S, sig, z1, z2):
        # asset step with the PRE-update σ, then the exact lognormal σ
        # update (processes._sabr_core's order)
        nu = fixed["s_nu"]
        if model_kind == "sabr_ln":
            S_n = S * exp_((r - q - 0.5 * sig * sig) * dt
                           + sig * sqrt_dt * z1)
        else:  # CEV beta < 1: Euler with positivity clamp
            S_n = S + (r - q) * S * dt \
                + sig * (S ** fixed["s_beta"]) * sqrt_dt * z1
            S_n = torch.clamp(S_n, min=1e-12)
        sig_n = sig * exp_(nu * sqrt_dt * z2 - 0.5 * nu * nu * dt)
        return S_n, sig_n

    def merton_step(S, z, counts, zj):
        # GBM + compound Poisson in log space with the λκ compensator
        kappa_j = torch.exp(fixed["m_mJ"] + 0.5 * fixed["m_sJ"] ** 2) - 1.0
        drift = (r - q - 0.5 * fixed["sigma"] ** 2
                 - fixed["m_lam"] * kappa_j) * dt
        y_sum = fixed["m_mJ"] * counts + fixed["m_sJ"] * _sqrt0(counts) * zj
        return S * exp_(drift + fixed["sigma"] * sqrt_dt * z + y_sum)

    def vg_step(S, clock, z):
        th, nu = fixed["v_theta"], fixed["v_nu"]
        sig = fixed["v_sigma"]
        om = torch.log1p(-(th * nu + 0.5 * sig * sig * nu)) / nu
        return S * exp_((r - q + om) * dt + th * clock
                        + sig * _sqrt0(clock) * z)

    def nig_step(S, clock, z):
        al, be = fixed["n_alpha"], fixed["n_beta"]
        de = fixed["n_delta"]
        gam = torch.sqrt(al * al - be * be)
        om = de * (torch.sqrt(al * al - (be + 1.0) ** 2) - gam)
        return S * exp_((r - q + om) * dt + be * clock + _sqrt0(clock) * z)

    sv_model = model_kind in _SV_KINDS
    rho_sv = fixed["s_rho"] if model_kind.startswith("sabr") \
        else fixed["h_rho"]
    rho_perp = torch.sqrt(torch.clamp(1.0 - rho_sv * rho_sv, min=0.0))
    step_fn = dict(gbm=gbm_step, lv_euler=lv_log_euler_step,
                   lv_milstein=lv_milstein_step).get(model_kind)
    div_amts = fixed.get("div_amts")

    for k in range(n_steps):
        t_now = k * dt
        raw = draws(k)
        if sv_model:
            z2, zp = (_anti(x, antithetic) for x in raw)
            if model_kind == "heston_qe":
                S_new, v = heston_qe_step(S, v, z2, zp)
            else:
                z1 = rho_sv * z2 + rho_perp * zp
                sv_step = heston_step if model_kind == "heston" \
                    else sabr_step
                S_new, v = sv_step(S, v, z1, z2)
        elif model_kind == "merton":
            z, counts, zj = raw
            S_new = merton_step(S, _anti(z, antithetic),
                                _anti(counts, antithetic, negate=False),
                                _anti(zj, antithetic))
        elif model_kind in ("vg", "nig"):
            if model_kind == "vg":
                G, dG, z = raw
                if dG is not None:
                    # implicit reparameterisation: the clock's tangent
                    # along its shape Δt/ν, the value G exactly
                    a = dt / fixed["v_nu"]
                    G = G + dG * (a - a.detach())
                clock = G * fixed["v_nu"]
            else:
                from .levy import _ig_core

                Zc, U, z = raw
                gam = torch.sqrt(fixed["n_alpha"] ** 2
                                 - fixed["n_beta"] ** 2)
                clock = _ig_core(Zc, U, fixed["n_delta"] * dt / gam,
                                 (fixed["n_delta"] * dt) ** 2)
            # pairs share the subordinator clock; the Gaussian is negated
            clock = _anti(clock, antithetic, negate=False)
            z = _anti(z, antithetic)
            S_new = (vg_step if model_kind == "vg" else nig_step)(S, clock,
                                                                  z)
        else:
            z = _anti(raw[0], antithetic)
            S_new = step_fn(S, z, t_now)
            if div_amts is not None:
                # cash dividend at node t_{k+1}, before the node is observed
                S_new = torch.clamp(S_new - div_amts[k + 1], min=1e-12)
        if with_greeks:
            W = W + sqrt_dt * z
            t_new = (k + 1.0) * dt
            if k == 0:
                z1c = z                     # the first shock
            if payoff in _LR_OK:
                g2 = g2 + z * z             # the LR scores' Σz²
            if payoff == "asian":
                if average_type == "geometric":
                    g1 = g1 + W
                else:
                    g1 = g1 + S_new * W
                    g2 = g2 + S_new * t_new
            if payoff == "lookback":
                # (W, t) at the step that sets a new extremum
                newmax = S_new > rmax
                newmin = S_new < rmin
                g1 = torch.where(newmax, W, g1)
                g3 = torch.where(newmax, t_new + zeros, g3)
                g2 = torch.where(newmin, W, g2)
                g4 = torch.where(newmin, t_new + zeros, g4)
        if payoff == "asian":
            rsum = rsum + S_new
            if average_type == "geometric" or with_geo:
                rlog = rlog + log_(S_new)
        if payoff == "lookback":
            rmax = torch.maximum(rmax, S_new)
            rmin = torch.minimum(rmin, S_new)
        if payoff == "barrier":
            hit = (S_new >= fixed["barrier"]) if up else \
                (S_new <= fixed["barrier"])
            crossed = crossed | hit
        S = S_new

    pay = _terminal_payoff(
        payoff, (S, rsum, rlog, rmax, rmin, crossed), K=fixed["K"],
        kind=kind, n_steps=n_steps, barrier_type=barrier_type,
        rebate=fixed["rebate"], average_type=average_type,
        strike_type=strike_type, payout=fixed["payout"])
    if not with_greeks:
        if with_geo:
            geo = exp_(rlog / n_steps)
            sgn = 1.0 if kind == "call" else -1.0
            pay_geo = torch.clamp(sgn * (geo - fixed["K"]), min=0.0)
            return pay, S, pay_geo
        return pay, S
    if payoff in _LR_OK:
        return pay, S, (z1c, W, g2)
    dinner = _pathwise_dinner(
        payoff, pay, S, rlog, rmax, rmin, W, g1, g2, g3, g4,
        K=fixed["K"], sigma=fixed["sigma"], r=r, q=q, T=fixed["T"],
        kind=kind, n_steps=n_steps, average_type=average_type,
        strike_type=strike_type)
    return pay, S, dinner + (z1c,)


def _fixed(dtype, device, *, S0, K, T, r, q, sigma=None, barrier=0.0,
           rebate=0.0, payout=1.0, bump=0.01, heston=None, merton=None,
           sabr=None, vg=None, nig=None) -> dict:
    """The scan's market and model values as 0-d tensors, with the
    reference's neutral entries for the dynamics not in use."""
    def val(v):
        return torch.tensor(float(v), dtype=dtype, device=device)

    return dict(
        S0=val(S0), K=val(K), T=val(T), r=val(r), q=val(q),
        sigma=val(0.0 if sigma is None else sigma), barrier=val(barrier),
        rebate=val(rebate), payout=val(payout), bump=val(bump),
        h_v0=val(heston["v0"] if heston else 0.0),
        h_kappa=val(heston["kappa"] if heston else 0.0),
        h_theta=val(heston["theta"] if heston else 0.0),
        h_xi=val(heston["xi"] if heston else 0.0),
        h_rho=val(heston["rho"] if heston else 0.0),
        m_lam=val(merton["lam"] if merton else 0.0),
        m_mJ=val(merton["mJ"] if merton else 0.0),
        m_sJ=val(merton["sJ"] if merton else 0.0),
        s_alpha0=val(sabr["alpha0"] if sabr else 0.0),
        s_beta=val(sabr["beta"] if sabr else 1.0),
        s_nu=val(sabr["nu"] if sabr else 0.0),
        s_rho=val(sabr["rho"] if sabr else 0.0),
        v_sigma=val(vg["sigma"] if vg else 0.0),
        v_theta=val(vg["theta"] if vg else 0.0),
        v_nu=val(vg["nu"] if vg else 1.0),
        n_alpha=val(nig["alpha"] if nig else 1.0),
        n_beta=val(nig["beta"] if nig else 0.0),
        n_delta=val(nig["delta"] if nig else 0.0))


def _model_kind(heston, sabr, merton, vg, nig, sigma_loc, scheme) -> str:
    if heston is not None:
        return "heston_qe" if scheme == "qe" else "heston"
    if sabr is not None:
        # β = 1 admits the exact log-Euler asset step; β < 1 an Euler step
        # with a positivity clamp
        return "sabr_ln" if float(sabr["beta"]) == 1.0 else "sabr_cev"
    if merton is not None:
        return "merton"
    if vg is not None:
        return "vg"
    if nig is not None:
        return "nig"
    if sigma_loc is not None:
        return "lv_milstein" if scheme == "milstein" else "lv_euler"
    return "gbm"


def _shards(mesh, seed: int, n_paths: int, device, salt: int = 0):
    """[(device, generator, paths)] of a scan run: one shard on ``device``
    seeded from ``seed``, or ⌈n_paths / n_dev⌉ paths on each device of
    ``mesh`` seeded from (seed, salt + shard index)."""
    if mesh is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
        return [(dev, gen, int(n_paths))]
    devices = mesh.device_list
    n_local = -(-int(n_paths) // len(devices))
    return [(dev, keyed_generator(seed, salt + d, dev), n_local)
            for d, dev in enumerate(devices)]


def _on(fixed: dict, device) -> dict:
    return {k: v.to(device) for k, v in fixed.items()}


# ---------------------------------------------------------------------------
# exact CEV: a sampler and a deterministic core
# ---------------------------------------------------------------------------
def _poisson(gen, lam: torch.Tensor) -> torch.Tensor:
    """Poisson(λ) draws from ``gen``, one rate per entry, exact at every
    rate, as JAX samples them: Knuth's product of uniforms below λ = 10,
    Hörmann's transformed rejection (PTRS) from 10 on. Each round redraws
    only the entries left, one host sync a round. (``torch.poisson`` on a
    CUDA device approximates large rates: the exact CEV sampler's counts
    run to thousands, and its price then drifts by several stderrs.)"""
    from .levy import _split_accepted

    dt, dev = lam.dtype, lam.device
    lam = lam.reshape(-1)
    out = torch.zeros_like(lam)

    def uniform(m):
        return torch.rand(m, generator=gen, dtype=dt, device=dev)

    todo = torch.nonzero((lam > 0.0) & (lam < 10.0)).reshape(-1)
    k = torch.zeros_like(lam[todo])
    log_prod = torch.zeros_like(k)
    while todo.numel():
        log_prod = log_prod + torch.log(uniform(todo.numel()))
        k = k + 1.0
        done, rest = _split_accepted(log_prod <= -lam[todo])
        out[todo[done]] = k[done] - 1.0
        todo, k, log_prod = todo[rest], k[rest], log_prod[rest]
    todo = torch.nonzero(lam >= 10.0).reshape(-1)
    while todo.numel():
        lt = lam[todo]
        b = 0.931 + 2.53 * torch.sqrt(lt)
        a = -0.059 + 0.02483 * b
        inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
        v_r = 0.9277 - 3.6224 / (b - 2.0)
        u = uniform(todo.numel()) - 0.5
        v = uniform(todo.numel())
        us = 0.5 - torch.abs(u)
        kk = torch.floor((2.0 * a / us + b) * u + lt + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lt + kk * torch.log(lt) - torch.lgamma(kk + 1.0)
        reject = (kk < 0.0) | ((us < 0.013) & (v > us))
        ok = ((us >= 0.07) & (v <= v_r)) | (~reject & (s <= t))
        done, rest = _split_accepted(ok)
        out[todo[done]] = kk[done]
        todo = todo[rest]
    return out


class _CevDraws:
    """The exact CEV scan's draws from one ``torch.Generator``, step by
    step in the core's order: the α normal (ν > 0), the Poisson counts at
    the state's rates (:func:`_poisson`), the gamma draws at the per-path
    shapes."""

    def __init__(self, gen, n_paths: int, dtype, device):
        self.gen, self.n, self.dtype, self.device = gen, n_paths, dtype, device

    def normal(self, k):
        return torch.randn(self.n, generator=self.gen, dtype=self.dtype,
                           device=self.device)

    def poisson(self, k, rate):
        return _poisson(self.gen, rate)

    def gamma(self, k, shape):
        from .levy import _standard_gamma

        return _standard_gamma(self.gen, shape, (self.n,), self.dtype,
                               self.device)


def _cev_exact_sumstats(draws, fixed, *, payoff, n_steps, n_paths,
                        barrier_up, knock_in, dtype, has_vol=False):
    """EXACT absorbed-CEV path transitions with dual-BESQ importance
    weights — (6,) CV sufficient statistics for a CALL-side payoff.

    The absorbed BESQ^δ (δ < 2) transition sub-density is the BESQ^{4−δ}
    density times (y/x)^{δ/2−1}, so the scan samples the dual — a Poisson
    (x/2) mixture of Gamma((4−δ)/2 + N) draws, never absorbing — and
    carries the weight Πw. Drift rides the per-step time change
    τ̂(Δ) = (e^{2μ(1−β)Δ}−1)/(2μ(1−β)), the carry scaled by e^{μΔ} before
    each transition. With ν > 0 the step is Islah's conditional shifted
    CEV given the exact lognormal α endpoints (the trapezoid ∫α² its one
    O(Δ²) bias). ``draws`` supplies ``normal(k)``, ``poisson(k, rate)``
    and ``gamma(k, shape)`` (:class:`_CevDraws`). Valid for payoffs that
    vanish on absorbed paths; Y = e^{−rT}·w·S_T (E[Y] = S0·e^{−qT}).
    """
    dt_ = dtype
    dev = fixed["S0"].device
    dt = fixed["T"] / n_steps
    om = 1.0 - fixed["s_beta"]
    rho = fixed["s_rho"]
    if has_vol:
        delta = (1.0 - 2.0 * fixed["s_beta"] - rho * rho * om) \
            / (om * (1.0 - rho * rho))
    else:
        delta = (1.0 - 2.0 * fixed["s_beta"]) / om
    w_exp = 0.5 * delta - 1.0
    mu = fixed["r"] - fixed["q"]
    drift2 = 2.0 * mu * om
    small = torch.abs(drift2) < 1e-12
    tau_hat = torch.where(
        small, dt,
        (torch.exp(torch.where(small, 0.0, drift2) * dt) - 1.0)
        / torch.where(small, 1.0, drift2))
    e_mu_dt = torch.exp(mu * dt)
    nu_sabr = fixed["s_nu"]

    ones = torch.ones(n_paths, dtype=dt_, device=dev)
    S = fixed["S0"] * ones
    alpha = fixed["s_alpha0"] * ones
    logw = ones * 0.0
    crossed = (S >= fixed["barrier"]) if barrier_up \
        else (S <= fixed["barrier"])
    for k in range(n_steps):
        S_eff = S * e_mu_dt
        if has_vol:
            za = draws.normal(k)
            alpha_new = alpha * torch.exp(nu_sabr * torch.sqrt(dt) * za
                                          - 0.5 * nu_sabr * nu_sabr * dt)
            Vh = 0.5 * dt * (alpha * alpha * e_mu_dt ** (2.0 * om)
                             + alpha_new * alpha_new)
            A = torch.clamp(S_eff ** om / om
                            + (rho / nu_sabr) * (alpha_new - alpha),
                            min=1e-12)
            scale = (1.0 - rho * rho) * Vh
            x = A * A / scale
        else:
            alpha_new = alpha
            scale = alpha * alpha * tau_hat
            x = S_eff ** (2.0 * om) / (om * om * scale)
        N = draws.poisson(k, 0.5 * x).to(dt_)
        G = draws.gamma(k, 0.5 * (4.0 - delta) + N)
        y = 2.0 * G
        logw = logw + w_exp * (torch.log(torch.clamp(y, min=1e-300))
                               - torch.log(x))
        S = (om * om * scale * y) ** (1.0 / (2.0 * om))
        alpha = alpha_new
        hit = (S >= fixed["barrier"]) if barrier_up \
            else (S <= fixed["barrier"])
        crossed = crossed | hit
    w = torch.exp(logw)
    vanilla = torch.clamp(S - fixed["K"], min=0.0)
    if payoff == "digital":
        pay = torch.where(S > fixed["K"], fixed["payout"] * ones, 0.0 * ones)
    elif payoff == "barrier":
        pay = torch.where(crossed, 0.0 * ones, vanilla) if not knock_in \
            else torch.where(crossed, vanilla, 0.0 * ones)
    else:
        pay = vanilla
    df = torch.exp(-fixed["r"] * fixed["T"])
    X = df * w * pay
    Y = df * w * S
    n = torch.tensor(float(n_paths), dtype=dt_, device=dev)
    return torch.stack([n, torch.sum(X), torch.sum(X * X), torch.sum(Y),
                        torch.sum(Y * Y), torch.sum(X * Y)])


# ---------------------------------------------------------------------------
# float64 randomised QMC: Sobol → Φ⁻¹ → Brownian bridge → payoff
# ---------------------------------------------------------------------------
def _qmc_replicate(seed: int, index: int, fixed, *, payoff, kind, n_steps,
                   n_points, barrier_type, average_type, strike_type,
                   dtype):
    """One randomised-QMC estimate: the reference's Sobol point set under
    the digital shift ``bits(fold_in(key(seed), index))``, Φ⁻¹, the
    Brownian bridge, the exact GBM path matrix and the payoff mean, as
    the reference stages it (``_qmc_replicate``). Returns a 0-d tensor."""
    from ..ops.sobol import bridge_paths, sobol_uniforms

    dev = fixed["S0"].device
    u = sobol_uniforms(n_points, n_steps, seed, index, dtype=dtype,
                       device=dev)
    z = torch.special.ndtri(u)
    W = bridge_paths(z, fixed["T"])
    return _qmc_payoff(W, fixed, payoff=payoff, kind=kind, n_steps=n_steps,
                       n_points=n_points, barrier_type=barrier_type,
                       average_type=average_type, strike_type=strike_type,
                       dtype=dtype)


def _qmc_payoff(W, fixed, *, payoff, kind, n_steps, n_points, barrier_type,
                average_type, strike_type, dtype):
    dt_ = dtype
    dev = W.device
    dt_step = fixed["T"] / n_steps
    t = torch.arange(1, n_steps + 1, dtype=dt_, device=dev) * dt_step
    c = fixed["r"] - fixed["q"] - 0.5 * fixed["sigma"] ** 2
    exp_, log_ = _exp_for(dt_), _log_for(dt_)
    logS = log_(fixed["S0"]) + c * t[None, :] + fixed["sigma"] * W
    S = exp_(logS)                                        # (n, d), t > 0
    S0v = fixed["S0"] * torch.ones(n_points, dtype=dt_, device=dev)
    up = barrier_type.startswith("up")
    hit = (S >= fixed["barrier"]) if up else (S <= fixed["barrier"])
    hit0 = (S0v >= fixed["barrier"]) if up else (S0v <= fixed["barrier"])
    carry = (S[:, -1], torch.sum(S, dim=1), torch.sum(logS, dim=1),
             torch.maximum(torch.amax(S, dim=1), S0v),
             torch.minimum(torch.amin(S, dim=1), S0v),
             torch.any(hit, dim=1) | hit0)
    pay = _terminal_payoff(
        payoff, carry, K=fixed["K"], kind=kind, n_steps=n_steps,
        barrier_type=barrier_type, rebate=fixed["rebate"],
        average_type=average_type, strike_type=strike_type,
        payout=fixed["payout"])
    return exp_(-fixed["r"] * fixed["T"]) * torch.mean(pay)


# ---------------------------------------------------------------------------
# pathwise-AD Greeks under non-GBM dynamics
# ---------------------------------------------------------------------------
_AD_PARAMS = {
    # model_kind → ((output name, fixed-dict key), ...); delta/rho/theta
    # come first for every dynamics. Merton's λ is left out: the Poisson
    # counts' law depends on it, so pathwise differentiation is invalid.
    # VG's ν enters through the gamma clock's implicit reparameterisation.
    # NIG admits none (exotic_greeks_mc refuses it).
    "heston": (("d_v0", "h_v0"), ("d_kappa", "h_kappa"),
               ("d_theta", "h_theta"), ("d_xi", "h_xi"),
               ("d_rho", "h_rho")),
    "sabr_ln": (("vega", "s_alpha0"), ("d_nu", "s_nu"), ("d_rho", "s_rho")),
    "sabr_cev": (("vega", "s_alpha0"), ("d_nu", "s_nu"),
                 ("d_rho", "s_rho")),
    "merton": (("vega", "sigma"), ("d_mJ", "m_mJ"), ("d_sJ", "m_sJ")),
    "vg": (("vega", "v_sigma"), ("d_theta", "v_theta"),
           ("d_nu", "v_nu")),
    "lv_euler": (), "lv_milstein": (),
    "gbm": (("vega", "sigma"),),
}


def _ad_local_sums(draw_list, fixed, names, n_local, static, exp_):
    """[n, Σcols, Σcols²] of the per-path discounted payoff and its
    forward-mode Jacobian (``torch.func.jacfwd``) over the named
    ``fixed`` entries, the draws held fixed outside the differentiated
    function."""
    keys_ = [k for _, k in names]
    theta0 = torch.stack([fixed[k] for k in keys_])

    def path_X(th):
        f2 = dict(fixed)
        for i, k in enumerate(keys_):
            f2[k] = th[i]
        pay, _ = _fused_paths(lambda k: draw_list[k], f2, n_paths=n_local,
                              **static)
        X = exp_(-f2["r"] * f2["T"]) * pay
        return X, X

    J, X = torch.func.jacfwd(path_X, has_aux=True)(theta0)
    cols = torch.cat([X[:, None], J], dim=1)
    n = torch.tensor([float(X.shape[0])], dtype=X.dtype, device=X.device)
    return torch.cat([n, torch.sum(cols, dim=0),
                      torch.sum(cols * cols, dim=0)])


def _ad_exotic_greeks(payoff, S0, K, T, r, q, *, kind, strike_type,
                      heston=None, sabr=None, merton=None, sigma_loc=None,
                      vg=None, sigma=None, scheme="milstein",
                      n_paths=100_000, n_steps=252, antithetic=True,
                      seed=None, average_type="arithmetic",
                      barrier_type="up-and-out", mesh=None, dtype=None,
                      device=None, **_ignored) -> dict:
    """Pathwise-AD Greeks for CONTINUOUS payoffs under non-GBM dynamics.

    One forward-mode Jacobian (``torch.func.jacfwd``) through the scan
    engine gives per-path derivatives of the discounted payoff w.r.t.
    (S0, r, T) plus every differentiable model parameter — Heston
    (v0, κ, θ, ξ, ρ), SABR (α₀, ν, ρ), Merton (σ, m_J, s_J; not λ), VG
    (σ, θ, ν) and local vol (spot, rate and maturity only). The draws are
    made before the differentiated function (a step's draws for all
    paths, kept for the run), so ``jacfwd`` never vmaps over a generator;
    forward mode keeps one step's state per tangent, where reverse mode
    would keep every step. With ``mesh=`` each shard's
    [n, ΣX, ΣX², ΣJ, ΣJ²] sums are added in mesh order.
    """
    if payoff not in _PATHWISE_OK:
        raise ValueError(
            f"pathwise AD Greeks need a continuous payoff (one of "
            f"{_PATHWISE_OK}); {payoff!r} under non-GBM dynamics requires "
            "bump-and-reprice with common random numbers")
    from ..parallel.mesh import mesh_sum

    dt_ = canonical(dtype)
    seed_val = resolve_seed(seed)
    if merton is not None and sigma is None:
        sigma = merton["sigma"]
    # the reference differentiates Euler Heston whatever the scheme
    model_kind = _model_kind(heston, sabr, merton, vg, None, sigma_loc,
                             "milstein" if scheme == "milstein"
                             else "log_euler")
    fixed = _fixed(dt_, "cpu", S0=S0, K=K, T=T, r=r, q=q, sigma=sigma,
                   heston=heston, merton=merton, sabr=sabr, vg=vg)
    names = (("delta", "S0"), ("rho", "r"), ("theta", "T")) \
        + _AD_PARAMS[model_kind]
    static = dict(payoff=payoff, kind=kind, n_steps=int(n_steps),
                  antithetic=bool(antithetic), barrier_type=barrier_type,
                  average_type=average_type, strike_type=strike_type,
                  model_kind=model_kind, sigma_loc=sigma_loc, dtype=dt_)
    exp_ = _exp_for(dt_)
    parts = []
    for dev, gen, n_local in _shards(mesh, seed_val, n_paths, device):
        draw = _scan_draws(gen, model_kind, n_local, T=T, n_steps=n_steps,
                           dtype=dt_, device=dev,
                           m_lam=merton["lam"] if merton else 0.0,
                           v_nu=vg["nu"] if vg else 1.0, with_grad=True)
        draw_list = [draw(k) for k in range(int(n_steps))]
        parts.append(_ad_local_sums(draw_list, _on(fixed, dev), names,
                                    n_local, static, exp_))
    s = mesh_sum(parts).detach().cpu().numpy().astype(np.float64)
    k = len(names)
    n, mean, sq = s[0], s[1:2 + k] / s[0], s[2 + k:] / s[0]
    se = np.sqrt(np.maximum(0.0, sq - mean * mean) / n)
    out = {"price": float(mean[0]), "stderr": float(se[0])}
    for i, (nm, _) in enumerate(names):
        sgn = -1.0 if nm == "theta" else 1.0     # theta = −dV/dT
        out[nm] = float(sgn * mean[1 + i])
        out[f"{nm}_stderr"] = float(se[1 + i])
    return out


def _scan_greeks_gbm(payoff, S0, K, T, r, q, sigma, *, kind, strike_type,
                     n_paths, n_steps, antithetic, average_type, barrier,
                     barrier_type, rebate, payout, seed, dtype, device):
    """The GBM Greek moments from the scan engine's per-path observables:
    (price, se, mY3, Greeks dict) with the likelihood-ratio scores for
    barrier/digital and the pathwise derivatives plus the mixed
    pathwise-LR gamma for the continuous payoffs."""
    dt_ = canonical(dtype)
    (dev, gen, n_local), = _shards(None, seed, n_paths, device)
    fixed = _fixed(dt_, dev, S0=S0, K=K, T=T, r=r, q=q, sigma=sigma,
                   barrier=barrier, rebate=rebate, payout=payout)
    pay, _, dinner = _fused_paths(
        _scan_draws(gen, "gbm", n_local, T=T, n_steps=n_steps, dtype=dt_,
                    device=dev), fixed,
        n_paths=n_local, payoff=payoff, kind=kind, n_steps=int(n_steps),
        antithetic=bool(antithetic), barrier_type=barrier_type,
        average_type=average_type, strike_type=strike_type,
        model_kind="gbm", sigma_loc=None, dtype=dt_, with_greeks=True)
    pay = pay.detach().cpu().numpy().astype(np.float64)
    obs = tuple(d.detach().cpu().numpy().astype(np.float64) for d in dinner)
    df = np.exp(-r * T)
    X = df * pay
    n, mX = X.size, X.mean()
    mY3 = df * float((pay > 0.0).mean())
    price, se = float(mX), float(X.std(ddof=1) / np.sqrt(n))

    def _obs(Y):
        return float(Y.mean()), float(Y.std(ddof=1) / np.sqrt(n))

    g = {}
    if payoff in _LR_OK:
        z1, W, Q = obs
        m = float(n_steps)
        sdt = sigma * np.sqrt(T / m)
        c = r - q - 0.5 * sigma * sigma
        g["delta"] = _obs(X * z1 / (S0 * sdt))
        g["vega"] = _obs(X * ((Q - m) / sigma - W))
        g["rho"] = _obs(X * (W / sigma) - T * X)
        g["theta"] = _obs(r * X - X * ((Q - m) / (2.0 * T)
                                       + c * W / (sigma * T)))
        g["gamma"] = _obs(X * ((z1 * z1 - 1.0) / (S0 * S0 * sdt * sdt)
                               - z1 / (S0 * S0 * sdt)))
    else:
        d_sig, d_r, d_T, z1 = obs
        g["vega"] = _obs(df * d_sig)
        g["rho"] = _obs(-T * X + df * d_r)      # dX/dr
        g["theta"] = _obs(r * X - df * d_T)     # −dX/dT
        # mixed pathwise-LR gamma on the homogeneity delta observable
        sdt = sigma * np.sqrt(T / float(n_steps))
        sgn = 1.0 if kind == "call" else -1.0
        Ke = 0.0 if strike_type == "floating" else K
        D = (X + sgn * Ke * df * (pay > 0.0)) / S0
        g["gamma"] = _obs(D * z1 / (S0 * sdt) - D / S0)
    return price, se, mY3, g


def _kernel_dtype(dtype) -> bool:
    """Whether ``dtype`` lets a run take the float32 kernels: ``None``
    (the kernels' own float32) or float32."""
    return dtype is None or canonical(dtype) == MC_DTYPE


def exotic_price_mc(
    payoff: str,
    S0: float, K: float, T: float, r: float, q: float = 0.0, *,
    sigma: Optional[float] = None,
    sigma_loc: Optional[Callable] = None,
    heston: Optional[dict] = None,
    merton: Optional[dict] = None,
    sabr: Optional[dict] = None,
    vg: Optional[dict] = None,
    nig: Optional[dict] = None,
    kind: str = "call",
    n_steps: int = 252,
    n_paths: int = 100_000,
    barrier: float = 0.0,
    barrier_type: str = "up-and-out",
    rebate: float = 0.0,
    average_type: str = "arithmetic",
    strike_type: str = "fixed",
    payout: float = 1.0,
    scheme: str = "log_euler",
    antithetic: bool = True,
    seed: Optional[int] = None,
    dS_bump: float = 0.01,
    dtype=None,
    backend: str = "auto",
    control_variate: bool = False,
    dividends=None,
    mesh=None,
    device=None,
):
    """Price a path-dependent option without materialising paths.

    ``payoff`` ∈ {"vanilla", "barrier", "asian", "digital", "lookback"};
    discrete monitoring at the n_steps grid, t = 0 excluded from Asian
    averages, both endpoints monitored for barrier and lookback. Dynamics:
    constant ``sigma`` (exact GBM step); ``sigma_loc(S, t)``, a closure on
    torch tensors such as ``dupire_local_vol_func``'s (log-Euler, or
    Milstein with ``scheme="milstein"``);
    ``heston={'v0','kappa','theta','xi','rho'}`` (full-truncation Euler
    variance + log-Euler asset, or Andersen QE with ``scheme="qe"``);
    ``sabr={'alpha0','beta','nu','rho'}`` (exact lognormal σ, log-Euler
    asset for β = 1, clamped Euler for β < 1, or ``scheme="exact"`` for
    0 < β < 1: the dual-BESQ exact absorbed-CEV sampler, call-side
    vanilla/digital/zero-rebate barrier, vanilla puts by parity);
    ``merton={'sigma','lam','mJ','sJ'}``; the exact subordinated Lévy
    transitions ``vg={'sigma','theta','nu'}`` and
    ``nig={'alpha','beta','delta'}``. ``dividends=[(t, amount), ...]``
    (GBM, scan engine) drops the spot by each amount at its ex-date,
    snapped to the step grid as ``fd_price`` snaps it.

    ``control_variate``: dual CV under GBM, spot CV under other dynamics,
    the geometric-Asian CV for the fixed-strike arithmetic Asian under
    GBM. ``backend``: "auto"/"pallas" take the path kernel where it can
    price the run (float32, even n_steps, GBM/Heston/SABR) and the scan
    engine otherwise; "xla" the scan engine; "qmc" (GBM) ``n_paths``
    points per replicate, 8 replicates, on the path-QMC kernel in float32
    or the staged float64 route. ``mesh`` splits either engine over its
    devices; ``device`` (default ``"cuda"``) is where a run without a
    mesh goes. See the module docstring for the seed semantics.
    """
    if payoff not in _PAYOFFS:
        raise ValueError(f"payoff must be one of {_PAYOFFS}, got {payoff!r}")
    n_models = sum(x is not None
                   for x in (sigma, sigma_loc, heston, merton, sabr, vg,
                             nig))
    if n_models != 1:
        raise ValueError(
            "provide exactly one of sigma / sigma_loc / heston / merton"
            " / sabr / vg / nig")
    if (vg is not None or nig is not None) and scheme != "log_euler":
        raise ValueError("vg=/nig= use the exact subordinated transition "
                         "(no scheme choice)")
    if nig is not None and not (float(nig["alpha"]) > abs(float(nig["beta"]))
                                and float(nig["alpha"])
                                > abs(float(nig["beta"]) + 1.0)):
        raise ValueError("NIG needs alpha > |beta| (real gamma) and "
                         "alpha > |beta + 1| (martingale moment)")
    if vg is not None and not (float(vg["theta"]) * float(vg["nu"])
                               + 0.5 * float(vg["sigma"]) ** 2
                               * float(vg["nu"]) < 1.0):
        raise ValueError("VG martingale moment condition violated: need "
                         "theta*nu + sigma^2*nu/2 < 1")
    if merton is not None and sigma is None:
        sigma = merton["sigma"]
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if scheme == "qe" and heston is None:
        raise ValueError("scheme='qe' is the Andersen QE Heston scheme — "
                         "it requires heston=")
    if scheme == "exact":
        if sabr is None or not (0.0 < float(sabr["beta"]) < 1.0):
            raise ValueError(
                "scheme='exact' is the dual-BESQ absorbed-CEV sampler — "
                "it requires sabr= with 0 < beta < 1")
        if abs(float(sabr["rho"])) >= 1.0:
            raise ValueError("scheme='exact' requires |rho| < 1")
        if payoff not in ("vanilla", "digital", "barrier"):
            raise ValueError(
                "scheme='exact' prices payoffs that vanish on absorbed "
                "paths: vanilla, digital, barrier (Asian/lookback "
                "averages see pre-absorption states — use the Euler "
                "backbone)")
        if payoff == "barrier" and (rebate != 0.0 or kind == "put"):
            raise ValueError("scheme='exact' barriers: calls, zero rebate")
        if payoff == "digital" and kind == "put":
            raise ValueError("scheme='exact' digitals: calls (puts via "
                             "payout·df − call parity)")
        if mesh is not None or backend == "pallas":
            raise ValueError("scheme='exact' runs on the single-device "
                             "XLA engine (Poisson/Gamma sampling)")
    if dividends:
        if sigma is None or merton is not None:
            raise ValueError("dividends= requires GBM dynamics (sigma=)")
        if control_variate:
            raise ValueError("control_variate has no closed-form mean "
                             "under discrete dividends")
        if backend in ("pallas", "qmc"):
            raise ValueError("dividends price on the XLA scan engine "
                             "(backend='auto'/'xla')")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")

    seed_val = resolve_seed(seed)
    dt_ = canonical(dtype)

    if scheme == "exact":
        (dev, gen, _), = _shards(None, seed_val, n_paths, device)
        fixed_e = {k: torch.tensor(float(v), dtype=dt_, device=dev)
                   for k, v in (("S0", S0), ("K", K), ("T", T), ("r", r),
                                ("q", q), ("barrier", barrier),
                                ("payout", payout),
                                ("s_beta", sabr["beta"]),
                                ("s_alpha0", sabr["alpha0"]),
                                ("s_nu", sabr["nu"]), ("s_rho", sabr["rho"]))}
        stats = _cev_exact_sumstats(
            _CevDraws(gen, int(n_paths), dt_, dev), fixed_e, payoff=payoff,
            n_steps=int(n_steps), n_paths=int(n_paths),
            barrier_up=barrier_type.startswith("up"),
            knock_in=barrier_type.endswith("in"), dtype=dt_,
            has_vol=float(sabr["nu"]) > 0.0)
        s = stats.detach().cpu().numpy().astype(np.float64)
        if control_variate:
            ey = float(S0) * np.exp(-float(q) * float(T))
            mean, se = stats_ops.cv_mean_se_np(s, ey)
        else:
            m1 = s[1] / s[0]
            var = max(0.0, s[2] / s[0] - m1 * m1)
            mean, se = float(m1), float(np.sqrt(var / s[0]))
        if kind == "put":   # vanilla only (validated above): parity off
            # the plain forward — the absorbed CEV is a true martingale
            fwd = float(S0) * np.exp((float(r) - float(q)) * float(T))
            mean -= np.exp(-float(r) * float(T)) * (fwd - float(K))
        return float(mean), float(se)

    # the fixed-strike arithmetic Asian under GBM takes the geometric-Asian
    # payoff as its control variate: corr ≈ 1 and E[Y_geo] is exact
    use_geo_cv = (bool(control_variate) and payoff == "asian"
                  and average_type == "arithmetic"
                  and strike_type == "fixed" and heston is None
                  and sabr is None and merton is None
                  and sigma_loc is None and vg is None and nig is None)
    geo_ey = None
    if use_geo_cv:
        geo_ey = geometric_asian_price_f64(S0, K, T, r, q, sigma, kind=kind,
                                           n_steps=int(n_steps))

    if backend == "qmc":
        if sigma is None or merton is not None:
            raise ValueError("backend='qmc' supports GBM dynamics (sigma=)")
        R = 8
        if _kernel_dtype(dtype):
            stats = path_qmc_sumstats_kernel(
                seed_val, int(n_paths), int(n_steps), S0, K, T, r, q, sigma,
                kind == "call", payoff=payoff, n_replicates=R,
                barrier=barrier, barrier_type=barrier_type, rebate=rebate,
                average_type=average_type, strike_type=strike_type,
                payout=payout, device=device)
            return qmc_path_estimate(stats, S0, q, T,
                                     control_variate=bool(control_variate))
        fixed_q = _fixed(dt_, resolve_device(device), S0=S0, K=K, T=T, r=r,
                         q=q, sigma=sigma, barrier=barrier, rebate=rebate,
                         payout=payout)
        est = torch.stack([_qmc_replicate(
            seed_val, i, fixed_q, payoff=payoff, kind=kind,
            n_steps=int(n_steps), n_points=int(n_paths),
            barrier_type=barrier_type, average_type=average_type,
            strike_type=strike_type, dtype=dt_) for i in range(R)])
        est = est.cpu().numpy().astype(np.float64)
        return float(est.mean()), float(est.std(ddof=1) / np.sqrt(R))

    kernel_ok = (sigma_loc is None and merton is None and vg is None
                 and nig is None and not dividends and n_steps % 2 == 0
                 and _kernel_dtype(dtype))
    if kernel_ok and backend in ("auto", "pallas"):
        pk = dict(payoff=payoff, antithetic=bool(antithetic),
                  barrier=barrier, barrier_type=barrier_type, rebate=rebate,
                  average_type=average_type, strike_type=strike_type,
                  payout=payout, scheme=scheme, dS_bump=dS_bump,
                  heston=heston, sabr=sabr, geo_cv=use_geo_cv)
        args = (seed_val, int(n_paths), int(n_steps), S0, K, T, r, q, sigma,
                kind == "call")
        stats_vec = path_mc_sumstats_kernel_sharded(mesh, *args, **pk) \
            if mesh is not None else \
            path_mc_sumstats_kernel(*args, device=device, **pk)
        dynamics = "gbm" if (heston is None and sabr is None) else "sv"
        return _estimate_from_stats(stats_vec, S0, K, T, r, q, sigma,
                                    kind == "call", dynamics,
                                    control_variate, geo_ey=geo_ey)

    model_kind = _model_kind(heston, sabr, merton, vg, nig, sigma_loc,
                             scheme)
    fixed = _fixed(dt_, "cpu", S0=S0, K=K, T=T, r=r, q=q, sigma=sigma,
                   barrier=barrier, rebate=rebate, payout=payout,
                   bump=dS_bump, heston=heston, merton=merton, sabr=sabr,
                   vg=vg, nig=nig)
    if dividends:
        from .pde import _div_schedule

        fixed["div_amts"] = _div_schedule(dividends, T, int(n_steps), dt_,
                                          "cpu")
    static = dict(payoff=payoff, kind=kind, n_steps=int(n_steps),
                  antithetic=bool(antithetic), barrier_type=barrier_type,
                  average_type=average_type, strike_type=strike_type,
                  model_kind=model_kind, sigma_loc=sigma_loc, dtype=dt_,
                  with_geo=use_geo_cv)
    draw_kw = dict(T=T, n_steps=int(n_steps), dtype=dt_,
                   m_lam=merton["lam"] if merton else 0.0,
                   v_nu=vg["nu"] if vg else 1.0)

    if mesh is None:
        (dev, gen, n_local), = _shards(None, seed_val, n_paths, device)
        out = _fused_paths(_scan_draws(gen, model_kind, n_local,
                                       device=dev, **draw_kw),
                           _on(fixed, dev), n_paths=n_local, **static)
        if not use_geo_cv:
            return _price_from_payoff(out[0], r, T)
        df = np.exp(-r * T)
        X = df * out[0].detach().cpu().numpy().astype(np.float64)
        Y = df * out[2].detach().cpu().numpy().astype(np.float64)
        s = np.array([X.size, X.sum(), (X * X).sum(), Y.sum(),
                      (Y * Y).sum(), (X * Y).sum()])
        return stats_ops.cv_mean_se_np(s, geo_ey)

    # mesh: per-device path shards, each drawing from (seed, shard index);
    # the full 10-stat layout (payoff, spot or geometric-Asian, digital
    # control variates) is summed in mesh order, so the estimator is the
    # one-device engines' design
    from ..parallel.mesh import mesh_sum

    sign = 1.0 if kind == "call" else -1.0
    exp_ = _exp_for(dt_)
    parts = []
    for dev, gen, n_local in _shards(mesh, seed_val, n_paths, device):
        f_d = _on(fixed, dev)
        out = _fused_paths(_scan_draws(gen, model_kind, n_local, device=dev,
                                       **draw_kw), f_d, n_paths=n_local,
                           **static)
        pay, ST = out[0], out[1]
        df = exp_(-f_d["r"] * f_d["T"])
        X = df * pay
        Y1 = df * (out[2] if use_geo_cv else ST)
        Y2 = df * (sign * (ST - f_d["K"]) > 0.0).to(X.dtype)
        parts.append(torch.stack([
            torch.tensor(float(X.numel()), dtype=X.dtype, device=dev),
            torch.sum(X), torch.sum(X * X),
            torch.sum(Y1), torch.sum(Y1 * Y1), torch.sum(X * Y1),
            torch.sum(Y2), torch.sum(Y2 * Y2), torch.sum(X * Y2),
            torch.sum(Y1 * Y2)]))
    return _estimate_from_stats(mesh_sum(parts), S0, K, T, r, q,
                                0.0 if sigma is None else sigma,
                                kind == "call", model_kind,
                                control_variate, geo_ey=geo_ey)


def exotic_price_mc_dupire(payoff: str, surface, S0, K, T, r, q=0.0, *,
                           scheme: str = "milstein", backend: str = "auto",
                           control_variate: bool = False, **kwargs):
    """Path-dependent pricing under Dupire local vol from a calibrated
    :class:`~optpricer_tpu_torch.models.calibration.VolSurface`.

    ``backend`` "auto" and "pallas", for an even ``n_steps`` in float32,
    ship the surface's SVI slices into the path kernel as its f32
    (6, n_slices) table: σ(S, t) is Gatheral's formula evaluated in
    registers, with the analytic forward S0·e^{(r−q)t}; ``scheme`` is
    ``"milstein"`` (σ′ by a central bump ``dS_bump``) or anything else
    for log-Euler; over ``mesh=`` the sharded kernel entry. Every other
    run goes to :func:`exotic_price_mc`'s scan engine with the surface's
    ``dupire_local_vol_func`` closure. Accepts :func:`exotic_price_mc`'s
    payoff kwargs, ``mesh=`` and ``device=``. The kernel's control variate
    is the spot one, E[e^{−rT}S_T] = S0·e^{−qT}.
    """
    from .calibration import dupire_local_vol_func

    if payoff not in _PAYOFFS:
        raise ValueError(f"payoff must be one of {_PAYOFFS}, got {payoff!r}")
    n_steps = int(kwargs.get("n_steps", 252))
    kind = kwargs.get("kind", "call")
    if backend in ("auto", "pallas") and n_steps % 2 == 0 \
            and _kernel_dtype(kwargs.get("dtype")):
        if kind not in ("call", "put"):
            raise ValueError("kind must be 'call' or 'put'")
        pk = dict(
            payoff=payoff, antithetic=bool(kwargs.get("antithetic", True)),
            barrier=kwargs.get("barrier", 0.0),
            barrier_type=kwargs.get("barrier_type", "up-and-out"),
            rebate=kwargs.get("rebate", 0.0),
            average_type=kwargs.get("average_type", "arithmetic"),
            strike_type=kwargs.get("strike_type", "fixed"),
            payout=kwargs.get("payout", 1.0),
            svi_slices=surface.svi_table(), scheme=scheme,
            dS_bump=kwargs.get("dS_bump", 0.01))
        args = (resolve_seed(kwargs.get("seed")),
                int(kwargs.get("n_paths", 100_000)), n_steps, S0, K, T, r, q,
                None, kind == "call")
        mesh = kwargs.get("mesh")
        stats_vec = path_mc_sumstats_kernel_sharded(mesh, *args, **pk) \
            if mesh is not None else \
            path_mc_sumstats_kernel(*args, device=kwargs.get("device"), **pk)
        return _estimate_from_stats(stats_vec, S0, K, T, r, q, 0.0,
                                    kind == "call", "local_vol",
                                    control_variate)
    sigma_loc = dupire_local_vol_func(surface, r, q)
    return exotic_price_mc(payoff, S0, K, T, r, q, sigma_loc=sigma_loc,
                           scheme=scheme, backend="xla", **kwargs)


def exotic_greeks_mc(payoff: str, S0, K, T, r, q=0.0, *, kind: str = "call",
                     strike_type: str = "fixed", **kwargs) -> dict:
    """Price + delta, gamma, vega, rho and theta from ONE run.

    Under GBM (``sigma=``) the path kernel (float32, even n_steps, "auto"
    or "pallas"; its sharded entry over ``mesh=``) or the scan engine
    ("xla", "qmc", float64, an odd n_steps) give the same observables:
    continuous payoffs (vanilla, asian, lookback) take pathwise vega, rho
    and theta through each payoff's smooth inner argument, with
    delta = (E[X] + sign·K_eff·E[Y3])/S0 (degree-1 homogeneity in S0) and
    the mixed pathwise-LR gamma on that delta observable; barrier and
    digital payoffs take likelihood-ratio estimators from the scores of
    (z₁, W, Σz²). Theta is −dV/dT. Under heston/sabr/merton/sigma_loc/vg
    dynamics, and for a GBM mesh run off the kernel, the forward-mode
    pathwise Greeks of :func:`_ad_exotic_greeks` (continuous payoffs).

    Accepts ``exotic_price_mc``'s kwargs (and ``device=``). Returns
    ``{"price", "stderr", "delta", "gamma", "gamma_stderr", "vega",
    "vega_stderr", "rho", "rho_stderr", "theta", "theta_stderr",
    "exercise_prob"}`` (plus ``delta_stderr`` on the LR payoffs) under
    GBM, and the AD set (``delta``/``rho``/``theta`` and the model's
    parameters, each with a ``*_stderr``) otherwise.
    """
    if payoff not in _PATHWISE_OK + _LR_OK:
        raise ValueError(f"unknown payoff {payoff!r}; expected one of "
                         f"{_PATHWISE_OK + _LR_OK}")
    if kwargs.get("dividends"):
        raise ValueError(
            "exotic_greeks_mc does not support dividends=; use CRN "
            "bump-and-reprice around exotic_price_mc(dividends=...)")
    if kwargs.get("nig") is not None:
        raise ValueError(
            "NIG admits no pathwise-AD Greeks: the inverse-Gaussian "
            "sampler's accept branch has a parameter-dependent selection "
            "probability pathwise differentiation cannot see — use CRN "
            "bump-and-reprice around exotic_price_mc(nig=...)")
    if any(kwargs.get(m) is not None
           for m in ("heston", "sabr", "merton", "sigma_loc", "vg")):
        return _ad_exotic_greeks(payoff, S0, K, T, r, q, kind=kind,
                                 strike_type=strike_type, **kwargs)
    if kwargs.get("sigma") is None:
        raise ValueError(
            "exotic_greeks_mc needs dynamics: sigma= (GBM) or one of "
            "heston=/sabr=/merton=/sigma_loc=")
    sigma = kwargs["sigma"]
    seed_val = resolve_seed(kwargs.get("seed"))
    n_steps = int(kwargs.get("n_steps", 252))
    backend = kwargs.get("backend", "auto")
    use_kernel = n_steps % 2 == 0 and backend in ("auto", "pallas") \
        and _kernel_dtype(kwargs.get("dtype"))
    control_variate = bool(kwargs.get("control_variate", False))
    use_lr = payoff in _LR_OK
    n_paths = int(kwargs.get("n_paths", 100_000))
    barrier = float(kwargs.get("barrier", 0.0))
    barrier_type = kwargs.get("barrier_type", "up-and-out")
    rebate = float(kwargs.get("rebate", 0.0))
    payout = float(kwargs.get("payout", 1.0))
    pk = dict(payoff=payoff,
              antithetic=bool(kwargs.get("antithetic", True)),
              average_type=kwargs.get("average_type", "arithmetic"),
              strike_type=strike_type, barrier=barrier,
              barrier_type=barrier_type, rebate=rebate, payout=payout)
    mesh = kwargs.get("mesh")
    if use_kernel:
        args = (seed_val, n_paths, n_steps, S0, K, T, r, q, sigma,
                kind == "call")
        raw = path_mc_sumstats_kernel_sharded(mesh, *args, greek_stats=True,
                                              **pk) \
            if mesh is not None else \
            path_mc_sumstats_kernel(*args, greek_stats=True,
                                    device=kwargs.get("device"), **pk)
        s = raw.detach().cpu().numpy().astype(np.float64)

        def _mom(i, n):
            m = s[i] / n
            return float(m), float(np.sqrt(max(0.0, s[i + 1] / n - m * m)
                                           / n))

        n, mY3 = s[0], s[10] / s[0]
        price, se = _estimate_from_stats(s, S0, K, T, r, q, sigma,
                                         kind == "call", "gbm",
                                         control_variate)
        g = dict(vega=_mom(11, n), rho=_mom(13, n), theta=_mom(15, n),
                 delta=_mom(17, n), gamma=_mom(19, n))
    elif mesh is not None:
        # a mesh run off the kernel: the AD Jacobian shards with a sum of
        # its moment sums; LR payoffs have no pathwise derivative
        if use_lr:
            raise ValueError(
                "mesh Greek runs for discontinuous payoffs need the "
                "Pallas backend (TPU); continuous payoffs shard anywhere")
        return _ad_exotic_greeks(payoff, S0, K, T, r, q, kind=kind,
                                 strike_type=strike_type, **kwargs)
    else:
        price, se, mY3, g = _scan_greeks_gbm(
            payoff, S0, K, T, r, q, sigma, kind=kind,
            strike_type=strike_type, n_paths=n_paths, n_steps=n_steps,
            antithetic=pk["antithetic"], average_type=pk["average_type"],
            barrier=barrier, barrier_type=barrier_type, rebate=rebate,
            payout=payout, seed=seed_val, dtype=kwargs.get("dtype"),
            device=kwargs.get("device"))
    out = {"price": float(price), "stderr": float(se),
           "gamma": g["gamma"][0], "gamma_stderr": g["gamma"][1],
           "vega": g["vega"][0], "vega_stderr": g["vega"][1],
           "rho": g["rho"][0], "rho_stderr": g["rho"][1],
           "theta": g["theta"][0], "theta_stderr": g["theta"][1],
           "exercise_prob": float(mY3 * np.exp(r * T))}
    if use_lr:
        out["delta"], out["delta_stderr"] = g["delta"]
    else:
        sign = 1.0 if kind == "call" else -1.0
        K_eff = 0.0 if strike_type == "floating" else K
        # the CV-corrected price in the E[X] slot when asked
        out["delta"] = float((price + sign * K_eff * mY3) / S0)
    return out

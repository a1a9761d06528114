"""Path-dependent Monte-Carlo sufficient statistics: the path kernel (K4).

Counterpart of ``optpricer_tpu/ops/pallas_path_mc.py``. Each path carries
its spot, running sum / log-sum / max / min, barrier flag and variance (or
SABR σ) state through ``n_steps`` steps — two steps per Box-Muller pair, so
``n_steps`` is even — and reduces its discounted payoff to 21 sufficient
statistics; nothing path-shaped reaches device memory. The draws are the
JAX kernel's ``sw_prng`` stream: Threefry keyed by (seed, global program
id) with counter (element, draw index), so a seed gives the reference's
sample and the statistics agree with it to f32 round-off.

Dynamics ported: ``gbm``, ``heston`` (full-truncation Euler), ``heston_qe``
(Andersen QE), ``sabr_ln`` (β = 1), ``sabr_cev`` (β < 1, Euler) and the
Dupire local vol of an SVI table (``svi_slices=``, (6, n_slices) rows a, b,
ρ, m, σ, T; at most ``MAX_SLICES`` slices): ``lv_euler`` (log-Euler) and
``lv_milstein`` (Milstein with the σ′ bump ``dS_bump``). σ_loc(S, t) is the
TPU kernel's: Gatheral's formula on the t-interpolated surface, the forward
S0·e^{(r−q)t} (one ``exp32`` here and in the kernel, where the TPU kernel
takes a scalar ``jnp.exp``: the two differ by an ulp of F at most), the
blend in T a select chain (``t > T[i−1]``, then ``t ≥ T[n−1]``) and ∂w/∂T
a centred difference at dT = 1e-4 of the un-floored blend. The chain's
branch depends on t alone, so both versions evaluate only the slices the
chosen branch reads. LSV (``lsv=``, the consumer ``models/lsv.py``):
``lsv`` (full-truncation Euler variance, log-Euler asset) and ``lsv_qe``
(Andersen QE variance, the leverage-scaled central asset step with the
ρ-coupling on the variance increment) under a leverage L = clip(Horner(
coeffs[k], clip(x/x_width, −1, 1)), 0.05, 20), x = log32(S/S0) − (r−q)t,
from the f32 (n_steps, deg+1) table of per-step polynomial coefficients
(deg ≤ 12, descending) that rides in the Dupire table's operand slot; k is
the step's row, two steps per Box-Muller pair.

Stats layout (``NSTAT = 21``): the dual-CV layout of ``ops/stats.py``
[n, ΣX, ΣX², ΣY1, ΣY1², ΣXY1, ΣY2, ΣY2², ΣXY2, ΣY1Y2], then ΣY3 (the
payoff's exercise indicator) and ΣY/ΣY² for the vega, rho, theta,
LR-delta and gamma observables Y4..Y8 (zero unless ``greek_stats``).
Under ``geo_cv`` Y1 is the geometric-Asian payoff instead of e^{−rT}S_T.

Names, JAX → port:

============================  ===========================
``path_mc_sumstats_pallas``   ``path_mc_sumstats_kernel``
``path_mc_sumstats_pallas_sharded``  ``path_mc_sumstats_kernel_sharded``
``_run_path_kernel``          ``path_mc`` (kernel wrapper)
``_common_params``            ``_common_params``
``_resolve_config``           ``_resolve_config``
============================  ===========================

``path_mc`` launches ``path_mc_kernel`` (``csrc/path_mc.cu``) for tensors
on a CUDA device and counts the launch in ``path_mc.launches``; for tensors
on the CPU it runs the plain torch version ``_path_mc_plain``, which walks
all programs and reps of the grid at once, one step pair at a time. Any
other device raises. ``_launch_plan`` is the kernel's grid: one block of
128 paths per (program, rep, block in tile) for every dynamics but the
Dupire ones, which keep one thread per (program, element) looping over the
reps.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..dtypes import MC_DTYPE, resolve_device
from . import stats as stats_ops
from .fastmath import exp32, log32, norminv32
from .swprng import threefry2x32
from .terminal_mc import (_MAX_TILE_INDEX, _plan_grid, _seed_pair,
                          _shard_plan, _stream)

__all__ = ["path_mc_sumstats_kernel", "path_mc", "TILE", "NSTAT",
           "PAYOFF_IDS", "DYNAMICS", "MAX_SLICES"]

BLOCK_R = 32            # rows of a path tile
LANES = 128
TILE = BLOCK_R * LANES  # paths per rep (4096)
NSTAT = stats_ops.STATS2_DIM + 11
NPARAM = 24

PAYOFF_IDS = {"vanilla": 0, "barrier": 1, "asian": 2, "digital": 3,
              "lookback": 4}
# dynamics name -> kernel id (csrc/path_mc.cu Dyn)
DYNAMICS = {"gbm": 0, "heston": 1, "heston_qe": 2, "sabr_ln": 3,
            "sabr_cev": 4, "lv_euler": 5, "lv_milstein": 6, "lsv": 7,
            "lsv_qe": 8}
_SV = ("heston", "heston_qe", "sabr_ln", "sabr_cev", "lsv", "lsv_qe")
_LV = ("lv_euler", "lv_milstein")
_LSV = ("lsv", "lsv_qe")
_QE = ("heston_qe", "lsv_qe")       # raw uniforms for the variance
MAX_SLICES = 16         # csrc/path_mc.cu MAX_SLICES: the SVI table's bound
MAX_COEFFS = 13         # csrc/path_mc.cu MAX_COEFFS: deg <= 12 leverage rows
LEV_WINDOW = 128        # csrc/path_mc.cu LEV_WINDOW: leverage rows staged

LV_PLAN_WORDS = 17      # csrc/path_mc.cu LvStep: a Dupire step's plan
_ROW = 24               # kernel stats rows are padded to 24 floats
_THREADS = 128          # csrc/path_mc.cu THREADS
_BLOCKS_PER_PROGRAM = TILE // _THREADS
_TINY = 2.0 ** -24
_TWO_PI = float(np.float32(6.283185307179586))

# flag bits of the kernel's runtime payoff switches (csrc/path_mc.cu Flag)
_FLAG_BITS = {"barrier_up": 1, "knock_out": 2, "average_geo": 4,
              "strike_floating": 8, "is_call": 16, "geo_cv": 32}


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------
def _common_params(n_paths, n_steps, S0, K, T, r, q, sigma, is_call,
                   barrier, rebate, payout, dS_bump, heston=None, sabr=None,
                   inv_xw=0.0) -> torch.Tensor:
    """Host f32[24]: S0, K, (r−q−σ²/2)dt, σ√dt, e^{−rT}, n_paths, sign,
    barrier, rebate, payout, dt, r−q, √dt, dS_bump, Heston (v0, κ, θ, ξ, ρ),
    SABR (α0, β, ν, ρ), 1/x_width."""
    dt = T / n_steps
    mu = (r - q - 0.5 * sigma * sigma) * dt
    sig = sigma * np.sqrt(dt)
    df = np.exp(-r * T)
    sign = 1.0 if is_call else -1.0
    h = heston or {}
    s = sabr or {}
    return torch.tensor(
        [S0, K, mu, sig, df, float(n_paths), sign, barrier, rebate, payout,
         dt, r - q, np.sqrt(dt), dS_bump,
         h.get("v0", 0.0), h.get("kappa", 0.0), h.get("theta", 0.0),
         h.get("xi", 0.0), h.get("rho", 0.0),
         s.get("alpha0", 0.0), s.get("beta", 1.0), s.get("nu", 0.0),
         s.get("rho", 0.0), inv_xw], dtype=MC_DTYPE)


def _resolve_config(n_paths, n_steps, S0, K, T, r, q, sigma, is_call,
                    payoff, antithetic, barrier, barrier_type, rebate,
                    average_type, strike_type, payout, svi_slices, scheme,
                    dS_bump, heston, sabr=None, geo_cv=False, lsv=None):
    """(params, static_kwargs) for ``path_mc``; n_steps must be even
    (two Box-Muller normals advance two steps per loop iteration). The
    reference's third result, its ``svi`` operand, rides in
    ``static_kwargs["svi"]``: the f32 (6, n_slices) Dupire table, the f32
    (n_steps, deg+1) leverage coefficients under ``lsv``, or None for the
    other dynamics. ``lsv`` is a dict with the Heston parameters
    (v0/kappa/theta/xi/rho), ``coeffs``, ``x_width`` and the ``scheme``
    the table was calibrated under ("qe" selects ``lsv_qe``)."""
    if n_steps % 2:
        raise ValueError("pallas path engine requires even n_steps")
    if geo_cv and not (payoff == "asian" and average_type == "arithmetic"
                       and strike_type == "fixed" and heston is None
                       and sabr is None and svi_slices is None
                       and lsv is None):
        raise ValueError("geo_cv requires a fixed-strike arithmetic asian "
                         "payoff under GBM dynamics")
    inv_xw = 0.0
    if lsv is not None:
        missing = [k for k in ("v0", "kappa", "theta", "xi", "rho", "coeffs",
                               "x_width") if k not in lsv]
        if missing:
            raise ValueError(f"lsv dict misses {missing}")
        heston = {k: float(lsv[k])
                  for k in ("v0", "kappa", "theta", "xi", "rho")}
        inv_xw = 1.0 / float(lsv["x_width"])
    params = _common_params(n_paths, n_steps, S0, K, T, r, q,
                            sigma if sigma is not None else 0.0,
                            is_call, barrier, rebate, payout, dS_bump,
                            heston, sabr, inv_xw)
    svi = None
    if lsv is not None:
        # the scheme the table was calibrated under selects the stepping
        dynamics = "lsv_qe" if lsv.get("scheme") == "qe" else "lsv"
        svi = torch.as_tensor(np.array(lsv["coeffs"], np.float32))
        _check_coeffs(svi, n_steps)
    elif svi_slices is not None:
        dynamics = "lv_milstein" if scheme == "milstein" else "lv_euler"
        svi = torch.as_tensor(np.array(svi_slices, np.float32))
        _check_svi(svi)
    elif heston is not None:
        dynamics = "heston_qe" if scheme == "qe" else "heston"
    elif sabr is not None:
        dynamics = "sabr_ln" if float(sabr["beta"]) == 1.0 else "sabr_cev"
    else:
        dynamics = "gbm"
    static = dict(
        n_steps=int(n_steps), antithetic=bool(antithetic),
        payoff_id=PAYOFF_IDS[payoff],
        barrier_up=barrier_type.startswith("up"),
        knock_out=barrier_type.endswith("out"),
        average_geo=(average_type == "geometric"),
        strike_floating=(strike_type == "floating"),
        is_call=bool(is_call), dynamics=dynamics, geo_cv=bool(geo_cv),
        svi=svi)
    return params, static


def _check_svi(svi: torch.Tensor):
    if svi.dtype != MC_DTYPE or svi.ndim != 2 or svi.shape[0] != 6 \
            or svi.shape[1] < 1:
        raise ValueError(f"svi_slices must be a float32 (6, n_slices) table, "
                         f"got {tuple(svi.shape)} {svi.dtype}")
    if svi.shape[1] > MAX_SLICES:
        raise ValueError(f"svi_slices has {svi.shape[1]} slices; the path "
                         f"kernel takes at most MAX_SLICES = {MAX_SLICES}")


def _check_coeffs(coeffs: torch.Tensor, n_steps: int):
    if coeffs.dtype != MC_DTYPE or coeffs.ndim != 2 \
            or coeffs.shape[0] != n_steps \
            or not 1 <= coeffs.shape[1] <= MAX_COEFFS:
        raise ValueError(f"lsv coeffs must be a float32 ({n_steps}, deg+1) "
                         f"table with deg <= {MAX_COEFFS - 1}, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")


def _check_inputs(seed, params, n_programs, reps, n_steps, dynamics,
                  with_greeks, payoff_id, geo_cv, svi):
    if geo_cv and payoff_id != PAYOFF_IDS["asian"]:
        raise ValueError("geo_cv needs the asian payoff")
    if n_programs < 1 or reps < 1:
        raise ValueError(f"empty grid: n_programs={n_programs}, reps={reps} "
                         "(n_paths must be positive)")
    if n_steps < 2 or n_steps % 2:
        raise ValueError(f"n_steps must be even and positive, got {n_steps}")
    if n_programs * reps >= _MAX_TILE_INDEX:
        raise ValueError("n_paths must stay below 2**24 tiles of TILE paths")
    if dynamics not in DYNAMICS:
        raise ValueError(f"unknown dynamics {dynamics!r}; known: "
                         f"{', '.join(DYNAMICS)}")
    if with_greeks and dynamics != "gbm":
        raise ValueError("greek_stats requires GBM dynamics")
    if seed.dtype != torch.int32 or seed.shape != (2,):
        raise ValueError("seed must be an int32 tensor of shape (2,)")
    if params.dtype != MC_DTYPE or params.shape != (NPARAM,):
        raise ValueError(f"params must be a float32 tensor of shape "
                         f"({NPARAM},)")
    if not (seed.is_contiguous() and params.is_contiguous()):
        raise ValueError("seed and params must be contiguous")
    if seed.device != params.device:
        raise ValueError(f"seed on {seed.device}, params on {params.device}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")
    if dynamics in _LV + _LSV:
        if svi is None:
            raise ValueError(f"dynamics {dynamics!r} needs its table "
                             "(the svi operand)")
        if dynamics in _LV:
            _check_svi(svi)
        else:
            _check_coeffs(svi, n_steps)
        if not svi.is_contiguous() or svi.device != params.device:
            raise ValueError("svi must be contiguous and on the params' "
                             "device")


# ---------------------------------------------------------------------------
# plain torch version (the CPU path and the kernel's on-card reference)
# ---------------------------------------------------------------------------
class _Scalars:
    """The f32[24] params as 0-d f32 tensors on the params' device, and the
    scalar-only terms of the step, each rounded to f32 in the kernel's
    order (so the kernel and this version round alike)."""

    def __init__(self, params: torch.Tensor, dynamics: str, svi=None):
        names = ("S0", "K", "mu", "sig", "df", "n_paths", "sign", "barrier",
                 "rebate", "payout", "dt", "rq", "sqrt_dt", "bump", "h_v0",
                 "h_kappa", "h_theta", "h_xi", "h_rho", "s_alpha0", "s_beta",
                 "s_nu", "s_rho", "inv_xw")
        for i, name in enumerate(names):
            setattr(self, name, params[i])
        rho = self.s_rho if dynamics.startswith("sabr") else self.h_rho
        self.rho_sv = rho
        self.rho_c = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
        if dynamics in _QE:
            kap, th, xi, dt = self.h_kappa, self.h_theta, self.h_xi, self.dt
            self.emkt = torch.exp(-kap * dt)
            om = 1.0 - self.emkt
            self.c1 = xi * xi * self.emkt * om / kap
            self.c2 = th * xi * xi * (om * om) / (2.0 * kap)
            self.K0c = -self.h_rho * kap * th * dt / xi
            half_dt = 0.5 * dt
            self.K1c = half_dt * (kap * self.h_rho / xi - 0.5) \
                - self.h_rho / xi
            self.K2c = half_dt * (kap * self.h_rho / xi - 0.5) \
                + self.h_rho / xi
            self.K34 = half_dt * (1.0 - self.h_rho * self.h_rho)
        if dynamics in _LV:
            # per slice (a, b, ρ, m, σ², bσ², T) as f32 values; σ² and bσ²
            # rounded as the kernel rounds sg*sg and (b*sg)*sg. The
            # divisors bσ², T and the ∂w/∂T step are 0-d tensors on the
            # device: a CUDA tensor divided by a Python number is multiplied
            # by its reciprocal, which rounds twice
            f = np.float32
            self.slices = [
                (float(a), float(b), float(rho), float(m), float(sg * sg),
                 self._dev(f((b * sg) * sg)), f(T))
                for a, b, rho, m, sg, T in svi.cpu().numpy().T.astype(f)]
            self.T_list = [sl[6] for sl in self.slices]
            self.T_dev = [self._dev(T) for T in self.T_list]
        if dynamics in _LSV:
            # the leverage coefficients, row k for step k, as f32 values
            self.coef = [[float(c) for c in row]
                         for row in svi.cpu().numpy().astype(np.float32)]

    def _dev(self, value) -> torch.Tensor:
        return torch.tensor(float(value), dtype=MC_DTYPE,
                            device=self.S0.device)


_F32 = np.float32


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (the kernel's ``sqrtf``):
    torch's vectorised CPU ``sqrt`` may miss by an ulp, which the f32
    difference quotient ∂w/∂T amplifies ~10⁴-fold. The f64 root of an f32
    value rounds to the f32 root exactly."""
    return torch.sqrt(x.to(torch.float64)).to(MC_DTYPE)


def _blend_plan(Ts, tau):
    """The branch the TPU kernel's select chain over the slices takes at
    time ``tau`` (f32): ``(lo, hi, alpha)`` for the interpolation between
    slices lo and hi, ``(lo, lo, None)`` for slice lo scaled by tau/T."""
    n = len(Ts)
    lo = hi = 0
    mid = False
    for i in range(1, n):
        if tau > Ts[i - 1]:
            lo, hi, mid = i - 1, i, True
    if tau >= Ts[n - 1]:
        lo = hi = n - 1
        mid = False
    if not mid:
        return lo, lo, None
    return lo, hi, (tau - Ts[lo]) / (Ts[hi] - Ts[lo])


def _blend(plan, T_dev, tau, v_lo, v_hi):
    lo, _, alpha = plan
    if alpha is None:
        return v_lo / T_dev[lo] * float(tau)
    return float(_F32(1.0) - alpha) * v_lo + float(alpha) * v_hi


def _sigma_loc(p: _Scalars, S, t):
    """σ_loc(S, t) of the path kernel's Dupire branches, in its f32 order
    (``pallas_path_mc.py:sigma_loc``); ``t`` is an f32 value."""
    Ts, Td = p.T_list, p.T_dev
    t = max(_F32(t), _F32(1e-8))
    F = p.S0 * exp32(p.rq * float(t))
    k = log32(S / F)
    vals = {}

    def slice_vals(i):
        if i not in vals:
            a, b, rho, m, sg2, bsg2, _ = p.slices[i]
            km = k - m
            root = _sqrt32(km * km + sg2)
            vals[i] = (a + b * (rho * km + root), b * (rho + km / root),
                       torch.div(bsg2, root * root * root))
        return vals[i]

    pt = _blend_plan(Ts, t)
    lo, hi = slice_vals(pt[0]), slice_vals(pt[1])
    w = torch.clamp(_blend(pt, Td, t, lo[0], hi[0]), min=1e-12)
    dw = _blend(pt, Td, t, lo[1], hi[1])
    d2w = _blend(pt, Td, t, lo[2], hi[2])
    t_up = t + _F32(1e-4)
    t_dn = max(t - _F32(1e-4), _F32(1e-8))
    pu, pd = _blend_plan(Ts, t_up), _blend_plan(Ts, t_dn)
    w_up = _blend(pu, Td, t_up, slice_vals(pu[0])[0], slice_vals(pu[1])[0])
    w_dn = _blend(pd, Td, t_dn, slice_vals(pd[0])[0], slice_vals(pd[1])[0])
    dwdT = (w_up - w_dn) / p._dev(t_up - t_dn)
    kw = k / w
    denom = (1.0 - kw * dw
             + 0.25 * (-0.25 - 1.0 / w + kw * kw) * dw * dw
             + 0.5 * d2w)
    s2 = torch.clamp(dwdT, min=1e-12) / torch.clamp(denom, min=1e-8)
    return torch.clamp(_sqrt32(torch.clamp(s2, min=0.0)), 0.01, 5.0)


def _qe_variance(p: _Scalars, v, u):
    """Andersen QE variance step on the raw uniform ``u`` (the quadratic
    branch's normal is Φ⁻¹(u))."""
    zq = norminv32(u)
    eps = 1e-12
    m = p.h_theta + (v - p.h_theta) * p.emkt
    s2 = v * p.c1 + p.c2
    psi = s2 / torch.clamp(m * m, min=eps)
    two_over = 2.0 / torch.clamp(torch.clamp(psi, max=1.5), min=eps)
    b2 = two_over - 1.0 + torch.sqrt(two_over) * torch.sqrt(
        torch.clamp(two_over - 1.0, min=0.0))
    a = m / (1.0 + b2)
    bz = torch.sqrt(torch.clamp(b2, min=0.0)) + zq
    psi_e = torch.clamp(psi, min=1.5)
    pe = (psi_e - 1.0) / (psi_e + 1.0)
    beta_e = (1.0 - pe) / torch.clamp(m, min=eps)
    v_exp = torch.where(
        u <= pe, 0.0,
        log32((1.0 - pe) / torch.clamp(1.0 - u, min=eps)) / beta_e)
    return torch.where(psi <= 1.5, a * bz * bz, v_exp)


def _leverage(p: _Scalars, S, t_now, k_idx):
    """L = clip(Horner(coeffs[k], clip(x/x_width, −1, 1)), 0.05, 20) at
    x = log32(S/S0) − (r−q)·t."""
    x = log32(S / p.S0) - p.rq * t_now
    u = torch.clamp(x * p.inv_xw, -1.0, 1.0)
    row = p.coef[k_idx]
    L = torch.full_like(S, row[0])
    for c in row[1:]:
        L = L * u + c
    return torch.clamp(L, 0.05, 20.0)   # the calibration's own clip


def _move(p: _Scalars, dynamics, S, v, z, zv, t_now=0.0, k_idx=0):
    """One step of the asset (and variance / σ) dynamics; ``k_idx`` is
    the step's row of the LSV leverage table."""
    if dynamics == "gbm":
        return S * exp32(p.mu + p.sig * z), v
    if dynamics == "lv_euler":
        s = _sigma_loc(p, S, t_now)
        return S * exp32((p.rq - 0.5 * s * s) * p.dt
                         + s * p.sqrt_dt * z), v
    if dynamics == "lv_milstein":
        # σ′ of a(S) = σ(S, t)·S by a central difference; only the centre
        # σ is clipped (processes.milstein_local_vol_paths)
        s = torch.clamp(_sigma_loc(p, S, t_now), 1e-8, 10.0)
        eps = p.bump * S
        S_up = S + eps
        S_dn = torch.clamp(S - eps, min=1e-10)
        s_up = _sigma_loc(p, S_up, t_now)
        s_dn = _sigma_loc(p, S_dn, t_now)
        da = (s_up * S_up - s_dn * S_dn) / (S_up - S_dn)
        a_t = s * S
        S_new = (S + p.rq * S * p.dt + a_t * p.sqrt_dt * z
                 + 0.5 * a_t * da * (z * z - 1.0) * p.dt)
        return torch.clamp(S_new, min=1e-10), v
    if dynamics == "heston":
        v_eff = torch.clamp(v, min=0.0)
        z1 = p.rho_sv * zv + p.rho_c * z
        sq = torch.sqrt(v_eff)
        S_new = S * exp32((p.rq - 0.5 * v_eff) * p.dt
                          + sq * p.sqrt_dt * z1)
        v_new = torch.clamp(
            v + p.h_kappa * (p.h_theta - v_eff) * p.dt
            + p.h_xi * sq * p.sqrt_dt * zv, min=0.0)
        return S_new, v_new
    if dynamics == "lsv":
        # Heston variance under the leverage function
        v_eff = torch.clamp(v, min=0.0)
        z1 = p.rho_sv * zv + p.rho_c * z
        sq = _sqrt32(v_eff)
        sig_e = _leverage(p, S, t_now, k_idx) * sq
        S_new = S * exp32((p.rq - 0.5 * sig_e * sig_e) * p.dt
                          + sig_e * p.sqrt_dt * z1)
        v_new = torch.clamp(
            v + p.h_kappa * (p.h_theta - v_eff) * p.dt
            + p.h_xi * sq * p.sqrt_dt * zv, min=0.0)
        return S_new, v_new
    if dynamics == "lsv_qe":
        # QE variance on the raw uniform zv; the leverage-scaled central
        # asset step, the ρ-coupling riding the variance increment
        v_new = _qe_variance(p, v, zv)
        L = _leverage(p, S, t_now, k_idx)
        vbar = 0.5 * (v + v_new)
        inc = v_new - v - p.h_kappa * (p.h_theta - vbar) * p.dt
        coup = torch.where(p.h_xi > 1e-8,
                           p.h_rho * inc / torch.clamp(p.h_xi, min=1e-8), 0.0)
        rp2 = 1.0 - p.h_rho * p.h_rho
        S_new = S * exp32(
            p.rq * p.dt - 0.5 * L * L * vbar * p.dt + L * coup
            + L * _sqrt32(torch.clamp(rp2 * vbar * p.dt, min=0.0)) * z)
        return S_new, v_new
    if dynamics == "heston_qe":
        v_new = _qe_variance(p, v, zv)
        S_new = S * exp32(
            p.rq * p.dt + p.K0c + p.K1c * v + p.K2c * v_new
            + torch.sqrt(torch.clamp(p.K34 * (v + v_new), min=0.0)) * z)
        return S_new, v_new
    # SABR: exact lognormal σ; the asset step uses the pre-update σ
    z1 = p.rho_sv * zv + p.rho_c * z
    if dynamics == "sabr_ln":
        S_new = S * exp32((p.rq - 0.5 * v * v) * p.dt + v * p.sqrt_dt * z1)
    else:
        Sb = exp32(p.s_beta * log32(torch.clamp(S, min=1e-12)))
        S_new = torch.clamp(S + p.rq * S * p.dt + v * Sb * p.sqrt_dt * z1,
                            min=1e-12)
    sig_n = v * exp32(p.s_nu * p.sqrt_dt * zv
                      - 0.5 * p.s_nu * p.s_nu * p.dt)
    return S_new, sig_n


def _advance(p, st, z, zv, t_now, k_idx, *, dynamics, payoff_id,
             barrier_up, average_geo, geo_cv, with_greeks):
    prev_max, prev_min = st["rmax"], st["rmin"]
    S, v = _move(p, dynamics, st["S"], st["v"], z, zv, t_now, k_idx)
    st = dict(st, S=S, v=v)
    if with_greeks:
        W = st["W"] + p.sqrt_dt * z
        st["W"] = W
        t_new = t_now + p.dt
        if t_now == 0.0:
            st["z1c"] = z  # the first shock
        if payoff_id in (1, 3):
            st["g2"] = st["g2"] + z * z
        if payoff_id == 2:
            if average_geo:
                st["g1"] = st["g1"] + W
            else:
                st["g1"] = st["g1"] + S * W
                st["g2"] = st["g2"] + S * t_new
        if payoff_id == 4:
            newmax = S > prev_max
            newmin = S < prev_min
            st["g1"] = torch.where(newmax, W, st["g1"])
            st["g3"] = torch.where(newmax, t_new, st["g3"])
            st["g2"] = torch.where(newmin, W, st["g2"])
            st["g4"] = torch.where(newmin, t_new, st["g4"])
    if payoff_id == 2:
        st["rsum"] = st["rsum"] + S
        if average_geo or geo_cv:
            st["rlog"] = st["rlog"] + log32(S)
    if payoff_id == 4:
        st["rmax"] = torch.maximum(st["rmax"], S)
        st["rmin"] = torch.minimum(st["rmin"], S)
    if payoff_id == 1:
        hit = (S >= p.barrier) if barrier_up else (S <= p.barrier)
        st["crossed"] = torch.maximum(st["crossed"], hit.to(MC_DTYPE))
    return st


def _payoff_obs(p, st, *, n_steps, payoff_id, knock_out, average_geo,
                strike_floating, is_call, geo_cv, with_greeks):
    """The nine per-path observables X, Y1..Y8 of one state."""
    S, rsum, rlog, rmax, rmin = (st[k] for k in ("S", "rsum", "rlog",
                                                 "rmax", "rmin"))
    sign, K, df = p.sign, p.K, p.df
    nsf = p._dev(n_steps)   # a 0-d divisor: true division on the card
    vanilla = torch.clamp(sign * (S - K), min=0.0)
    if payoff_id == 0:
        pay = vanilla
    elif payoff_id == 1:
        hit = st["crossed"] > 0.5
        pay = torch.where(hit, p.rebate, vanilla) if knock_out \
            else torch.where(hit, vanilla, p.rebate)
    elif payoff_id == 2:
        avg = exp32(rlog / nsf) if average_geo else rsum / nsf
        pay = torch.clamp(sign * (S - avg), min=0.0) if strike_floating \
            else torch.clamp(sign * (avg - K), min=0.0)
    elif payoff_id == 3:
        pay = torch.where(sign * (S - K) > 0.0, p.payout, 0.0)
    elif strike_floating:
        pay = (S - rmin) if is_call else (rmax - S)
    else:
        pay = torch.clamp(rmax - K, min=0.0) if is_call \
            else torch.clamp(K - rmin, min=0.0)
    X = df * pay
    if geo_cv:
        Y1 = df * torch.clamp(sign * (exp32(rlog / nsf) - K), min=0.0)
    else:
        Y1 = df * S
    Y2 = df * (sign * (S - K) > 0.0).to(MC_DTYPE)
    Y3 = df * (pay > 0.0).to(MC_DTYPE)
    zeros = torch.zeros_like(S)
    if not with_greeks:
        return X, Y1, Y2, Y3, zeros, zeros, zeros, zeros, zeros
    W, g1, g2, g3, g4, z1c = (st[k] for k in ("W", "g1", "g2", "g3", "g4",
                                              "z1c"))
    S0, sig = p.S0, p.sig
    m_f = float(n_steps)
    T_total = m_f * p.dt
    sig_ann = sig / p.sqrt_dt
    c_drift = p.rq - 0.5 * sig_ann * sig_ann
    r_rate = -torch.log(df) / T_total
    if payoff_id in (1, 3):
        # likelihood-ratio observables from (z1, W, Q = Σz²)
        Y4 = X * ((g2 - m_f) / sig_ann - W)
        Y5 = X * (W / sig_ann) - T_total * X
        Y6 = r_rate * X - X * ((g2 - m_f) / (2.0 * T_total)
                               + c_drift * W / (sig_ann * T_total))
        Y7 = X * z1c / (S0 * sig)
        Y8 = X * ((z1c * z1c - 1.0) / (S0 * S0 * sig * sig)
                  - z1c / (S0 * S0 * sig))
        return X, Y1, Y2, Y3, Y4, Y5, Y6, Y7, Y8

    def d_terminal():
        return (S * (W - sig_ann * T_total), S * T_total,
                S * (c_drift * T_total + 0.5 * sig_ann * W) / T_total)

    if payoff_id == 0:
        dinner = tuple(sign * d for d in d_terminal())
    elif payoff_id == 2:
        if average_geo:
            avg_v = exp32(rlog / nsf)
            tsum = p.dt * (m_f * (m_f + 1.0) / 2.0)
            davg = (avg_v * (g1 - sig_ann * tsum) / m_f,
                    avg_v * tsum / m_f,
                    avg_v * (c_drift * tsum + 0.5 * sig_ann * g1)
                    / (m_f * T_total))
        else:
            davg = ((g1 - sig_ann * g2) / m_f,
                    g2 / m_f,
                    (c_drift * g2 + 0.5 * sig_ann * g1) / (m_f * T_total))
        if strike_floating:
            dinner = tuple(sign * (a - b)
                           for a, b in zip(d_terminal(), davg))
        else:
            dinner = tuple(sign * d for d in davg)
    else:
        dmax = (rmax * (g1 - sig_ann * g3), rmax * g3,
                rmax * (c_drift * g3 + 0.5 * sig_ann * g1) / T_total)
        dmin = (rmin * (g2 - sig_ann * g4), rmin * g4,
                rmin * (c_drift * g4 + 0.5 * sig_ann * g2) / T_total)
        if strike_floating:
            dinner = tuple(a - b for a, b in zip(d_terminal(), dmin)) \
                if is_call else tuple(a - b for a, b in zip(dmax,
                                                            d_terminal()))
        else:
            dinner = dmax if is_call else tuple(-d for d in dmin)
    itm = (pay > 0.0).to(MC_DTYPE)
    Y4 = df * itm * dinner[0]
    Y5 = -T_total * X + df * itm * dinner[1]
    Y6 = r_rate * X - df * itm * dinner[2]
    K_eff = 0.0 if strike_floating else K
    D = (X + sign * K_eff * Y3) / S0
    Y8 = D * z1c / (S0 * sig) - D / S0
    return X, Y1, Y2, Y3, Y4, Y5, Y6, zeros, Y8


def _moments(obs, w):
    """The 21 sums over the last (tile) axis."""
    X, Y1, Y2, Y3, Y4, Y5, Y6, Y7, Y8 = obs
    WX, WY1, WY2 = X * w, Y1 * w, Y2 * w
    WY4, WY5, WY6, WY7, WY8 = Y4 * w, Y5 * w, Y6 * w, Y7 * w, Y8 * w
    terms = (w, WX, WX * X, WY1, WY1 * Y1, WX * Y1, WY2, WY2 * Y2, WX * Y2,
             WY1 * Y2, Y3 * w, WY4, WY4 * Y4, WY5, WY5 * Y5, WY6, WY6 * Y6,
             WY7, WY7 * Y7, WY8, WY8 * Y8)
    return torch.stack([t.sum(dim=-1) for t in terms], dim=-1)


def _path_mc_plain(seed, params, *, n_programs: int, reps: int, n_steps: int,
                   antithetic: bool, payoff_id: int, barrier_up: bool,
                   knock_out: bool, average_geo: bool, strike_floating: bool,
                   is_call: bool, dynamics: str = "gbm",
                   with_greeks: bool = False, geo_cv: bool = False,
                   svi=None) -> torch.Tensor:
    """Plain version of ``path_mc``: every (program, rep, element) path at
    once as a (n_programs, reps, TILE) tensor, one step pair at a time;
    tile sums, Kahan over reps, then the programs combined in order."""
    dev = params.device
    key0, offset = (int(v) for v in seed.tolist())
    p = _Scalars(params, dynamics, svi)
    n_half = n_steps // 2
    shape = (n_programs, reps, TILE)
    pid = (offset + torch.arange(n_programs, dtype=torch.int64,
                                 device=dev)).view(-1, 1, 1)
    rep = torch.arange(reps, dtype=torch.int64, device=dev).view(1, -1, 1)
    elem = torch.arange(TILE, dtype=torch.int64, device=dev).view(1, 1, -1)

    def bits(draw):
        return threefry2x32(key0, pid, elem, draw)

    def normals(draw):
        bits_a, bits_b = bits(draw)
        u1 = ((bits_a >> 8).to(MC_DTYPE) + 0.5) * _TINY
        u2 = (bits_b >> 8).to(MC_DTYPE) * _TINY
        rad = torch.sqrt(-2.0 * log32(u1))
        theta = _TWO_PI * u2
        return rad * torch.cos(theta), rad * torch.sin(theta)

    def uniforms(draw):
        bits_a, bits_b = bits(draw)
        return (((bits_a >> 8).to(MC_DTYPE) + 0.5) * _TINY,
                ((bits_b >> 8).to(MC_DTYPE) + 0.5) * _TINY)

    def init_state():
        S = p.S0.expand(shape)
        zeros = torch.zeros(shape, dtype=MC_DTYPE, device=dev)
        if payoff_id == 1:
            crossed = ((S >= p.barrier) if barrier_up
                       else (S <= p.barrier)).to(MC_DTYPE)
        else:
            crossed = zeros
        if dynamics.startswith("heston") or dynamics in _LSV:
            v = p.h_v0.expand(shape)
        elif dynamics.startswith("sabr"):
            v = p.s_alpha0.expand(shape)
        else:
            v = zeros
        st = dict(S=S, rsum=zeros, rlog=zeros, rmax=S, rmin=S,
                  crossed=crossed, v=v)
        if with_greeks:
            st.update(W=zeros, g1=zeros, g2=zeros, g3=zeros, g4=zeros,
                      z1c=zeros)
        return st

    adv = dict(dynamics=dynamics, payoff_id=payoff_id, barrier_up=barrier_up,
               average_geo=average_geo, geo_cv=geo_cv,
               with_greeks=with_greeks)
    st_p, st_m = init_state(), init_state()
    for t in range(n_half):
        d0 = (rep * n_half + t) * 2
        z1, z2 = normals(d0)
        if dynamics in _QE:
            zv1, zv2 = uniforms(d0 + 1)
        elif dynamics in _SV:
            zv1, zv2 = normals(d0 + 1)
        else:
            zv1, zv2 = z1, z2
        t0 = float(np.float32(2.0 * t) * np.float32(p.dt.item()))
        t1 = float(np.float32(t0) + np.float32(p.dt.item()))
        k0, k1 = 2 * t, 2 * t + 1
        st_p = _advance(p, st_p, z1, zv1, t0, k0, **adv)
        st_p = _advance(p, st_p, z2, zv2, t1, k1, **adv)
        if antithetic:
            if dynamics in _QE:
                mv1, mv2 = 1.0 - zv1, 1.0 - zv2
            else:
                mv1, mv2 = -zv1, -zv2
            st_m = _advance(p, st_m, -z1, mv1, t0, k0, **adv)
            st_m = _advance(p, st_m, -z2, mv2, t1, k1, **adv)

    pk = dict(n_steps=n_steps, payoff_id=payoff_id, knock_out=knock_out,
              average_geo=average_geo, strike_floating=strike_floating,
              is_call=is_call, geo_cv=geo_cv, with_greeks=with_greeks)
    obs = _payoff_obs(p, st_p, **pk)
    if antithetic:
        obs = tuple(0.5 * (a + b)
                    for a, b in zip(obs, _payoff_obs(p, st_m, **pk)))
    # tail mask by the per-tile remainder, in f32 as on the TPU
    prog_offset = (pid.to(MC_DTYPE) * reps + rep.to(MC_DTYPE)) * TILE
    w = (elem.to(MC_DTYPE) < p.n_paths - prog_offset).to(MC_DTYPE)
    s = _moments(obs, w)                            # (n_programs, reps, 21)
    acc = torch.zeros((n_programs, NSTAT), dtype=MC_DTYPE, device=dev)
    comp = torch.zeros_like(acc)
    for c in range(reps):
        acc, comp = stats_ops.kahan_add(acc, comp, s[:, c])
    return stats_ops.combine_scan(acc)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def _launch_plan(dynamics: str, n_programs: int, reps: int):
    """(blocks, rows per program) of ``path_mc_kernel``'s grid, as
    ``optpricer_path_mc`` launches it: a block of 128 paths per (program,
    rep, block in tile), or per (program, block in tile) for the Dupire
    branches, whose threads loop over the reps. Each block writes one
    stats row; the first combine pass Kahan-sums a program's rows."""
    rows = _BLOCKS_PER_PROGRAM * (1 if dynamics in _LV else reps)
    return n_programs * rows, rows


def blocks_per_sm(dynamics: str, payoff_id: int, with_greeks: bool,
                  antithetic: bool, n_coef: int = MAX_COEFFS) -> int:
    """Resident blocks per SM of the instantiation ``path_mc`` launches for
    these arguments (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on
    the current card); ``n_coef``: the LSV table's columns."""
    import ctypes

    lib = _build.load()
    n = ctypes.c_int(0)
    n_cols = n_coef if dynamics in _LSV else 1
    err = lib.optpricer_path_mc_occupancy(
        DYNAMICS[dynamics], int(payoff_id), n_cols, int(bool(with_greeks)),
        int(bool(antithetic)), ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"path_mc_kernel occupancy query failed: CUDA "
                           f"error {err}")
    return n.value


def path_mc(seed: torch.Tensor, params: torch.Tensor, *,
            n_programs: int, reps: int, n_steps: int, antithetic: bool,
            payoff_id: int, barrier_up: bool, knock_out: bool,
            average_geo: bool, strike_floating: bool, is_call: bool,
            dynamics: str = "gbm", with_greeks: bool = False,
            geo_cv: bool = False, svi=None) -> torch.Tensor:
    """f32[21] path-dependent sums over the (n_programs, reps) grid.

    Kernel ``path_mc_kernel`` in ``csrc/path_mc.cu``; it replaces
    ``optpricer_tpu/ops/pallas_path_mc.py:_path_kernel`` (launched from
    ``_run_path_kernel``). It is bound by integer and SFU issue (a
    Threefry block per step pair, two under stochastic volatility, an
    exp32 per step and state, the geometric CV's log32 with its IEEE
    division), so its grid fills the card: one thread prices one
    (program, rep, element) path with its state in registers, a block of
    128 paths writes one stats row and a combine pass Kahan-sums each
    program's rows in (rep, block) order (``_launch_plan``); with no
    per-thread Kahan state each instantiation of gbm, heston, sabr_ln,
    lsv and lsv_qe is compiled for the resident blocks its registers
    allow (heston_qe and sabr_cev keep ptxas' own allocation). The Dupire branches (``svi``:
    the f32 (6, n_slices) table) add three σ_loc evaluations a step under
    Milstein, one under log-Euler: a log32 and one or two SVI slices with
    their derivatives each, IEEE divisions and square roots; they keep
    one thread per (program, element) looping over the reps, the table
    sits in shared memory, and each step's plan (the forward, the three
    blends in T) is worked out once per launch by a one-pass pre-kernel
    into an (n_steps, ``LV_PLAN_WORDS``) scratch. The LSV branches
    (``svi``: the f32 (n_steps, deg+1) leverage coefficients) add a
    log32 and a deg-term Horner polynomial a step: each block stages the
    table in shared memory ``LEV_WINDOW`` steps at a time and reads a
    step's row once for both legs, the reference's degree 12 unrolled
    from registers.
    """
    _check_inputs(seed, params, n_programs, reps, n_steps, dynamics,
                  with_greeks, payoff_id, geo_cv, svi)
    kw = dict(n_programs=n_programs, reps=reps, n_steps=n_steps,
              antithetic=antithetic, payoff_id=payoff_id,
              barrier_up=barrier_up, knock_out=knock_out,
              average_geo=average_geo, strike_floating=strike_floating,
              is_call=is_call, dynamics=dynamics, with_greeks=with_greeks,
              geo_cv=geo_cv)
    if dynamics not in _LV + _LSV:
        svi = None
    if params.device.type == "cpu":
        return _path_mc_plain(seed, params, svi=svi, **kw)
    dev = params.device
    if svi is None:
        svi = torch.zeros((6, 1), dtype=MC_DTYPE, device=dev)
    flags = sum(bit for name, bit in _FLAG_BITS.items() if kw[name])
    blocks, _ = _launch_plan(dynamics, n_programs, reps)
    block_rows = torch.empty((blocks, _ROW), dtype=MC_DTYPE, device=dev)
    prog_rows = torch.empty((n_programs, _ROW), dtype=MC_DTYPE, device=dev)
    out = torch.empty((_ROW,), dtype=MC_DTYPE, device=dev)
    plans = torch.empty((n_steps, LV_PLAN_WORDS), dtype=MC_DTYPE,
                        device=dev) if dynamics in _LV else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.optpricer_path_mc(
            seed.data_ptr(), params.data_ptr(), svi.data_ptr(),
            None if plans is None else plans.data_ptr(),
            block_rows.data_ptr(), prog_rows.data_ptr(), out.data_ptr(),
            n_programs, reps, n_steps, int(svi.shape[1]),
            DYNAMICS[dynamics], int(payoff_id), flags,
            int(bool(with_greeks)), int(bool(antithetic)), _stream(dev))
    if err != 0:
        raise RuntimeError(f"path_mc_kernel launch failed: CUDA error {err}")
    path_mc.launches += 1
    return out[:NSTAT]


path_mc.launches = 0


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------
def path_mc_sumstats_kernel(
    seed: int, n_paths: int, n_steps: int, S0, K, T, r, q, sigma,
    is_call: bool, *, payoff: str, antithetic: bool,
    barrier: float = 0.0, barrier_type: str = "up-and-out",
    rebate: float = 0.0, average_type: str = "arithmetic",
    strike_type: str = "fixed", payout: float = 1.0,
    svi_slices=None, scheme: str = "log_euler", dS_bump: float = 0.01,
    heston=None, sabr=None, lsv=None, greek_stats: bool = False,
    geo_cv: bool = False, device=None,
) -> torch.Tensor:
    """(21,) f32 sufficient statistics for a path-dependent payoff.

    ``greek_stats=True`` (GBM only) fills moments [11..20] with ΣY/ΣY² of
    the vega/rho/theta/LR-delta/gamma observables — pathwise for the
    continuous payoffs, likelihood-ratio for barrier and digital.
    Dynamics: GBM by default, Heston with a ``heston`` dict (Euler, or
    Andersen QE under ``scheme="qe"``), SABR with a ``sabr`` dict, Dupire
    local vol with ``svi_slices`` (log-Euler, or Milstein under
    ``scheme="milstein"``), LSV with an ``lsv`` dict (Euler, or QE for its
    ``scheme="qe"``). n_steps must be even.
    """
    dev = resolve_device(device)
    params, static = _resolve_config(
        n_paths, n_steps, S0, K, T, r, q, sigma, is_call, payoff, antithetic,
        barrier, barrier_type, rebate, average_type, strike_type, payout,
        svi_slices, scheme, dS_bump, heston, sabr, geo_cv, lsv)
    reps, n_programs = _plan_grid(int(n_paths), TILE)
    if static["svi"] is not None:
        static["svi"] = static["svi"].to(dev)
    return path_mc(_seed_pair(seed, dev), params.to(dev),
                   n_programs=n_programs, reps=reps,
                   with_greeks=bool(greek_stats), **static)


def path_mc_sumstats_kernel_sharded(
    mesh, seed: int, n_paths: int, n_steps: int, S0, K, T, r, q, sigma,
    is_call: bool, *, payoff: str, antithetic: bool,
    barrier: float = 0.0, barrier_type: str = "up-and-out",
    rebate: float = 0.0, average_type: str = "arithmetic",
    strike_type: str = "fixed", payout: float = 1.0,
    svi_slices=None, scheme: str = "log_euler", dS_bump: float = 0.01,
    heston=None, sabr=None, lsv=None, geo_cv: bool = False,
    greek_stats: bool = False,
) -> torch.Tensor:
    """(21,) f32 stats of one global grid split over ``mesh``, the
    counterpart of ``path_mc_sumstats_pallas_sharded``: each device runs
    ``path_mc`` over its contiguous slice of the programs (offset in the
    second seed word), every shard is launched before any is waited for,
    and the stats are summed in mesh order on the first device
    (``parallel.mesh.mesh_sum``). ``greek_stats=True`` (GBM only) sums the
    full 21-moment layout, so a sharded Greek run is the one-device
    estimator. On a CPU mesh each shard runs the plain version."""
    from ..parallel.mesh import mesh_sum

    params, static = _resolve_config(
        n_paths, n_steps, S0, K, T, r, q, sigma, is_call, payoff, antithetic,
        barrier, barrier_type, rebate, average_type, strike_type, payout,
        svi_slices, scheme, dS_bump, heston, sabr, geo_cv, lsv)
    if greek_stats and static["dynamics"] != "gbm":
        raise ValueError("greek_stats requires GBM dynamics")
    reps, per, shards = _shard_plan(mesh, n_paths, TILE)
    svi = static.pop("svi")
    inputs = [(_seed_pair(seed, dev, off), params.to(dev),
               None if svi is None else svi.to(dev)) for dev, off in shards]
    return mesh_sum([path_mc(sd, prm, n_programs=per, reps=reps,
                             with_greeks=bool(greek_stats), svi=sv, **static)
                     for sd, prm, sv in inputs])

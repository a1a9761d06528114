"""Stochastic-process path generators.

Counterpart of ``optpricer_tpu/models/processes.py``, with its contract:
every generator returns a tensor of shape ``(n_steps+1, n_paths_eff)``
whose row 0 is S0, and ``antithetic=True`` doubles the columns (the
mirrored normals appended after the base ones). Each generator is split
into

* a draw step: the standard normals (and, for Merton and Bates, the
  Poisson jump counts) from a ``torch.Generator`` on the target device
  seeded from ``seed``. The JAX package draws from ``jax.random`` keys,
  whose stream torch does not reproduce, so a seed gives another sample
  than the reference's;
* a deterministic core (``_gbm_core``, ``_heston_core`` …) that maps the
  draws to paths exactly as the reference's jitted core does: the same
  operations in the same order, in the working dtype (float64 unless
  ``dtype=`` says otherwise).

The reference's ``lax.scan`` recursions are Python loops over the steps
that write each row into a preallocated path tensor (in place, so the
matrix is built once). ``sigma_loc(S, t)`` callbacks are torch callables
evaluated on the path tensor's device; the local-vol cores call them once
(log-Euler) or three times (Milstein) per step. On a CUDA card those cores
are host-driven loops of a few hundred small launches per step.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from .monte_carlo import resolve_seed

__all__ = [
    "gbm_paths",
    "merton_jump_paths",
    "heston_paths",
    "bates_paths",
    "sabr_paths",
    "local_vol_paths",
    "gbm_milstein_paths",
    "milstein_local_vol_paths",
    "qe_transition",
]

# the Bates jump stream's generator is keyed by (seed, this word), as the
# reference folds it into the path key
_JUMP_STREAM = 0x9E3779B9


def _validate(n_steps: int, n_paths: int):
    if n_steps <= 0 or n_paths <= 0:
        raise ValueError("n_steps and n_paths must be positive.")


def _generator(seed: Optional[int], device, stream: Optional[int] = None
               ) -> torch.Generator:
    seed = resolve_seed(seed)
    if stream is not None:
        seed = int(np.random.SeedSequence([seed % 2**63, stream])
                   .generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def _normals(gen, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _poisson(gen, rate, shape, dtype, device) -> torch.Tensor:
    rates = torch.full(shape, float(rate), dtype=dtype, device=device)
    return torch.poisson(rates, generator=gen)


def _anti(Z: torch.Tensor, antithetic: bool) -> torch.Tensor:
    """Antithetic doubling along the path axis (axis 1)."""
    return torch.cat([Z, -Z], dim=1) if antithetic else Z


def _with_s0_row(log_paths: torch.Tensor, S0) -> torch.Tensor:
    S = S0 * torch.exp(log_paths)
    return torch.cat([torch.full_like(S[:1], float(S0)), S], dim=0)


def _scalars(dtype, device, *values):
    return [torch.as_tensor(float(v), dtype=dtype, device=device)
            for v in values]


def _setup(dtype, device):
    return canonical(dtype), resolve_device(device)


# -----------------------------
# 1) Geometric Brownian Motion
# -----------------------------
def _gbm_core(Z, S0, r, q, sigma, T, *, antithetic: bool):
    n_steps = Z.shape[0]
    dt = T / n_steps
    drift = (r - q - 0.5 * sigma * sigma) * dt
    vol = sigma * torch.sqrt(dt)
    log_paths = torch.cumsum(drift + vol * _anti(Z, antithetic), dim=0)
    return _with_s0_row(log_paths, S0)


def gbm_paths(S0, r, q, sigma, T, n_steps, n_paths, *,
              antithetic: bool = True, seed: Optional[int] = None,
              dtype=None, device=None) -> torch.Tensor:
    """Exact-discretisation GBM paths."""
    _validate(n_steps, n_paths)
    dt, dev = _setup(dtype, device)
    Z = _normals(_generator(seed, dev), (int(n_steps), int(n_paths)), dt,
                 dev)
    return _gbm_core(Z, *_scalars(dt, dev, S0, r, q, sigma, T),
                     antithetic=bool(antithetic))


# ------------------------------------
# 2) Merton Jump-Diffusion (lognormal)
# ------------------------------------
def _merton_core(Z, K_base, ZJ_base, S0, r, q, sigma, T, lam, mJ, sJ, *,
                 antithetic: bool):
    n_steps = Z.shape[0]
    dt = T / n_steps
    kappa = torch.exp(mJ + 0.5 * sJ * sJ) - 1.0
    drift = (r - q - 0.5 * sigma * sigma - lam * kappa) * dt
    vol = sigma * torch.sqrt(dt)
    Z = _anti(Z, antithetic)
    # jumps drawn before antithetic doubling, so pairs share Poisson counts
    if antithetic:
        K = torch.cat([K_base, K_base], dim=1)
        ZJ = torch.cat([ZJ_base, -ZJ_base], dim=1)
    else:
        K, ZJ = K_base, ZJ_base
    # sum of K lognormal jump sizes ~ Normal(K·mJ, √K·sJ)
    Y_sum = mJ * K + sJ * torch.sqrt(K) * ZJ
    log_paths = torch.cumsum(drift + vol * Z + Y_sum, dim=0)
    return _with_s0_row(log_paths, S0)


def merton_jump_paths(S0, r, q, sigma, T, n_steps, n_paths, *, lam, mJ, sJ,
                      antithetic: bool = True, seed: Optional[int] = None,
                      dtype=None, device=None) -> torch.Tensor:
    """Merton jump-diffusion paths."""
    _validate(n_steps, n_paths)
    if lam < 0 or sJ < 0:
        raise ValueError("lam and sJ must be non-negative.")
    dt, dev = _setup(dtype, device)
    shape = (int(n_steps), int(n_paths))
    gen = _generator(seed, dev)
    Z = _normals(gen, shape, dt, dev)
    K_base = _poisson(gen, lam * (T / n_steps), shape, dt, dev)
    ZJ_base = _normals(gen, shape, dt, dev)
    return _merton_core(Z, K_base, ZJ_base,
                        *_scalars(dt, dev, S0, r, q, sigma, T, lam, mJ, sJ),
                        antithetic=bool(antithetic))


# -------------------------------
# 3) Heston (CIR variance process)
# -------------------------------
def _sv_start(S0, v0_or_sigma, n_cols, Z):
    s_init = torch.full((n_cols,), float(S0), dtype=Z.dtype, device=Z.device)
    v_init = torch.full((n_cols,), float(v0_or_sigma), dtype=Z.dtype,
                        device=Z.device)
    return s_init, v_init


def _rows(first: torch.Tensor, n_steps: int) -> torch.Tensor:
    out = torch.empty((n_steps + 1,) + tuple(first.shape), dtype=first.dtype,
                      device=first.device)
    out[0] = first
    return out


def _heston_core(Z2, Zp, S0, r, q, v0, kappa, theta, xi, rho, T, *,
                 antithetic: bool):
    n_steps = Z2.shape[0]
    dt = T / n_steps
    sqrt_dt = torch.sqrt(dt)
    Z2 = _anti(Z2, antithetic)
    Zp = _anti(Zp, antithetic)
    Z1 = rho * Z2 + torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * Zp
    s_t, v_t = _sv_start(S0, max(float(v0), 0.0), Z1.shape[1], Z1)
    S, V = _rows(s_t, n_steps), _rows(v_t, n_steps)
    for k in range(n_steps):
        v_eff = torch.clamp(v_t, min=0.0)  # full-truncation Euler
        s_t = s_t * torch.exp((r - q - 0.5 * v_eff) * dt
                              + torch.sqrt(v_eff) * sqrt_dt * Z1[k])
        v_t = torch.clamp(v_t + kappa * (theta - v_eff) * dt
                          + xi * torch.sqrt(v_eff) * sqrt_dt * Z2[k], min=0.0)
        S[k + 1], V[k + 1] = s_t, v_t
    return S, V


def qe_transition(S_t, v_t, zv, zs, *, r, q, kappa, theta, xi, rho, dt):
    """One Andersen-QE (S, v) → (S', v') transition (any shape): ``zv``
    drives the variance (its Φ supplies the exponential branch's uniform),
    ``zs`` the asset."""
    dtype = S_t.dtype
    emkt = torch.exp(-kappa * dt)
    c1 = xi * xi * emkt * (1.0 - emkt) / kappa
    c2 = theta * xi * xi * (1.0 - emkt) ** 2 / (2.0 * kappa)
    psi_c = 1.5
    # Andersen's K constants (γ1 = γ2 = ½ central weighting)
    g1 = g2 = 0.5
    K0 = -rho * kappa * theta * dt / xi
    K1 = g1 * dt * (kappa * rho / xi - 0.5) - rho / xi
    K2 = g2 * dt * (kappa * rho / xi - 0.5) + rho / xi
    K3 = g1 * dt * (1.0 - rho * rho)
    K4 = g2 * dt * (1.0 - rho * rho)
    tiny = torch.tensor(1e-12, dtype=dtype, device=S_t.device)

    m = theta + (v_t - theta) * emkt
    s2 = v_t * c1 + c2
    psi = s2 / torch.maximum(m * m, tiny)
    # quadratic branch (ψ ≤ ψ_c): v⁺ = a(b+Z)², matches (m, s²)
    psi_q = torch.clamp(psi, max=psi_c)
    two_over = 2.0 / torch.maximum(psi_q, tiny)
    b2 = (two_over - 1.0
          + torch.sqrt(two_over) * torch.sqrt(torch.clamp(two_over - 1.0,
                                                          min=0.0)))
    a = m / (1.0 + b2)
    bz = torch.sqrt(torch.clamp(b2, min=0.0)) + zv
    v_quad = a * bz * bz
    # exponential branch (ψ > ψ_c): P(v=0) = p, else Exp tail; the uniform
    # is Φ(Z_v), so both branches ride one draw
    u = torch.special.ndtr(zv)
    psi_e = torch.clamp(psi, min=psi_c)
    p = (psi_e - 1.0) / (psi_e + 1.0)
    beta = (1.0 - p) / torch.maximum(m, tiny)
    v_exp = torch.where(
        u <= p, 0.0,
        torch.log((1.0 - p) / torch.maximum(1.0 - u, tiny)) / beta)
    v_n = torch.where(psi <= psi_c, v_quad, v_exp)
    # asset: central discretisation of ∫v, ρ carried by the v-increment
    vbar_k3 = K3 * v_t + K4 * v_n
    X = (torch.log(S_t) + (r - q) * dt + K0 + K1 * v_t + K2 * v_n
         + torch.sqrt(torch.clamp(vbar_k3, min=0.0)) * zs)
    return torch.exp(X), v_n


def _heston_qe_core(Zv, Zs, S0, r, q, v0, kappa, theta, xi, rho, T, *,
                    antithetic: bool):
    """Andersen (2008) quadratic-exponential Heston scheme, branchless."""
    n_steps = Zv.shape[0]
    dt = T / n_steps
    Zv = _anti(Zv, antithetic)
    Zs = _anti(Zs, antithetic)
    s_t, v_t = _sv_start(S0, max(float(v0), 0.0), Zv.shape[1], Zv)
    S, V = _rows(s_t, n_steps), _rows(v_t, n_steps)
    for k in range(n_steps):
        s_t, v_t = qe_transition(s_t, v_t, Zv[k], Zs[k], r=r, q=q,
                                 kappa=kappa, theta=theta, xi=xi, rho=rho,
                                 dt=dt)
        S[k + 1], V[k + 1] = s_t, v_t
    return S, V


def heston_paths(S0, r, q, v0, kappa, theta, xi, rho, T, n_steps, n_paths,
                 *, antithetic: bool = True, seed: Optional[int] = None,
                 return_variance: bool = False, dtype=None,
                 scheme: str = "euler", device=None):
    """Heston paths: ``scheme="euler"`` is full-truncation Euler variance +
    log-Euler asset; ``scheme="qe"`` is Andersen's quadratic-exponential
    scheme."""
    _validate(n_steps, n_paths)
    if not (-1.0 <= rho <= 1.0):
        raise ValueError("rho must be in [-1, 1].")
    if scheme not in ("euler", "qe"):
        raise ValueError("scheme must be 'euler' or 'qe'")
    dt, dev = _setup(dtype, device)
    shape = (int(n_steps), int(n_paths))
    gen = _generator(seed, dev)
    Za = _normals(gen, shape, dt, dev)
    Zb = _normals(gen, shape, dt, dev)
    core = _heston_qe_core if scheme == "qe" else _heston_core
    S, v = core(Za, Zb, *_scalars(dt, dev, S0, r, q, v0, kappa, theta, xi,
                                  rho, T), antithetic=bool(antithetic))
    return (S, v) if return_variance else S


def _jump_factor(nj, zj, lam, mJ, sJ, T):
    """Compensated compound-Poisson log-jumps, (n_steps+1, n_paths)."""
    n_steps = nj.shape[0]
    dt = T / n_steps
    jumps = nj * mJ + torch.sqrt(nj) * sJ * zj
    kbar = torch.exp(mJ + 0.5 * sJ * sJ) - 1.0
    cum = torch.cumsum(jumps - lam * kbar * dt, dim=0)
    return torch.cat([torch.zeros_like(cum[:1]), cum], dim=0)


def bates_paths(S0, r, q, v0, kappa, theta, xi, rho, T, n_steps, n_paths,
                *, lam, mJ, sJ, antithetic: bool = True,
                seed: Optional[int] = None, return_variance: bool = False,
                dtype=None, scheme: str = "qe", device=None):
    """Bates (1996) paths: Heston stochastic vol (:func:`heston_paths`,
    Andersen QE by default) times independent compensated lognormal
    jumps, drawn from a second generator keyed by (seed, a constant)."""
    if lam < 0 or sJ < 0:
        raise ValueError("lam and sJ must be non-negative.")
    dt, dev = _setup(dtype, device)
    out = heston_paths(S0, r, q, v0, kappa, theta, xi, rho, T, n_steps,
                       n_paths, antithetic=antithetic, seed=seed,
                       return_variance=return_variance, dtype=dt,
                       scheme=scheme, device=dev)
    S, v = out if return_variance else (out, None)
    gen = _generator(seed, dev, stream=_JUMP_STREAM)
    shape = (int(n_steps), S.shape[1])
    nj = _poisson(gen, lam * (T / n_steps), shape, dt, dev)
    zj = _normals(gen, shape, dt, dev)
    J = _jump_factor(nj, zj, *_scalars(dt, dev, lam, mJ, sJ, T))
    S = S * torch.exp(J)
    return (S, v) if return_variance else S


# ---------------------------
# 4) SABR (σ lognormal case)
# ---------------------------
def _sabr_core(Z2, Zp, S0, r, q, alpha0, beta, nu, rho, T, *,
               antithetic: bool, lognormal: bool):
    n_steps = Z2.shape[0]
    dt = T / n_steps
    sqrt_dt = torch.sqrt(dt)
    Z2 = _anti(Z2, antithetic)
    Zp = _anti(Zp, antithetic)
    Z1 = rho * Z2 + torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * Zp
    s_t, sig_t = _sv_start(S0, float(alpha0), Z1.shape[1], Z1)
    S = _rows(s_t, n_steps)
    for k in range(n_steps):
        # the asset step uses the PRE-update σ_t (the reference's ordering)
        if lognormal:
            s_n = s_t * torch.exp((r - q - 0.5 * sig_t * sig_t) * dt
                                  + sig_t * sqrt_dt * Z1[k])
        else:  # Euler with a positivity clamp
            s_n = s_t + (r - q) * s_t * dt \
                + sig_t * (s_t ** beta) * sqrt_dt * Z1[k]
            s_n = torch.clamp(s_n, min=1e-12)
        sig_t = sig_t * torch.exp(nu * sqrt_dt * Z2[k] - 0.5 * nu * nu * dt)
        s_t = s_n
        S[k + 1] = s_t
    return S


def sabr_paths(S0, r, q, alpha0, beta, nu, rho, T, n_steps, n_paths, *,
               antithetic: bool = True, seed: Optional[int] = None,
               dtype=None, device=None) -> torch.Tensor:
    """SABR paths with exact lognormal σ evolution."""
    _validate(n_steps, n_paths)
    if not (0.0 <= beta <= 1.0):
        raise ValueError("beta must be in [0, 1].")
    if alpha0 <= 0.0 or nu < 0.0:
        raise ValueError("alpha0 must be >0, nu >= 0.")
    if not (-1.0 <= rho <= 1.0):
        raise ValueError("rho must be in [-1, 1].")
    dt, dev = _setup(dtype, device)
    shape = (int(n_steps), int(n_paths))
    gen = _generator(seed, dev)
    Z2 = _normals(gen, shape, dt, dev)
    Zp = _normals(gen, shape, dt, dev)
    return _sabr_core(Z2, Zp, *_scalars(dt, dev, S0, r, q, alpha0, beta, nu,
                                        rho, T),
                      antithetic=bool(antithetic),
                      lognormal=(float(beta) == 1.0))


# -----------------------------------------
# 5) Local Volatility (a Dupire σ(S, t) callable)
# -----------------------------------------
def _sigma(sigma_loc, S, t):
    return torch.as_tensor(sigma_loc(S, t), dtype=S.dtype, device=S.device)


def _local_vol_core(Z, S0, r, q, T, sigma_loc: Callable, *,
                    antithetic: bool):
    n_steps = Z.shape[0]
    dt = T / n_steps
    sqrt_dt = torch.sqrt(dt)
    Z = _anti(Z, antithetic)
    s_t = torch.full((Z.shape[1],), float(S0), dtype=Z.dtype,
                     device=Z.device)
    S = _rows(s_t, n_steps)
    t_ids = torch.arange(n_steps, dtype=Z.dtype, device=Z.device)
    for k in range(n_steps):
        t_now = t_ids[k] * dt
        sig = torch.clamp(_sigma(sigma_loc, s_t, t_now), min=0.0)
        s_t = s_t * torch.exp((r - q - 0.5 * sig * sig) * dt
                              + sig * sqrt_dt * Z[k])
        S[k + 1] = s_t
    return S


def local_vol_paths(S0, r, q, T, n_steps, n_paths, sigma_loc: Callable, *,
                    antithetic: bool = True, seed: Optional[int] = None,
                    dtype=None, device=None) -> torch.Tensor:
    """Log-Euler local-vol paths; ``sigma_loc(S, t) -> sigma`` is a torch
    callable (``t`` a 0-d tensor)."""
    _validate(n_steps, n_paths)
    dt, dev = _setup(dtype, device)
    Z = _normals(_generator(seed, dev), (int(n_steps), int(n_paths)), dt,
                 dev)
    return _local_vol_core(Z, *_scalars(dt, dev, S0, r, q, T), sigma_loc,
                           antithetic=bool(antithetic))


# ---------------------------------------------------------------------------
# 6) GBM Milstein (constant vol — demonstrates the scheme)
# ---------------------------------------------------------------------------
def _gbm_milstein_core(Z, S0, r, q, sigma, T, *, antithetic: bool):
    n_steps = Z.shape[0]
    dt = T / n_steps
    sqrt_dt = torch.sqrt(dt)
    Z = _anti(Z, antithetic)
    s_t = torch.full((Z.shape[1],), float(S0), dtype=Z.dtype,
                     device=Z.device)
    S = _rows(s_t, n_steps)
    for k in range(n_steps):
        z = Z[k]
        s_t = (s_t + (r - q) * s_t * dt + sigma * s_t * sqrt_dt * z
               + 0.5 * sigma * sigma * s_t * (z * z - 1.0) * dt)
        s_t = torch.clamp(s_t, min=1e-10)
        S[k + 1] = s_t
    return S


def gbm_milstein_paths(S0, r, q, sigma, T, n_steps, n_paths, *,
                       antithetic: bool = True, seed: Optional[int] = None,
                       dtype=None, device=None) -> torch.Tensor:
    """Explicit Milstein GBM paths (strong order 1.0 with constant σ)."""
    _validate(n_steps, n_paths)
    dt, dev = _setup(dtype, device)
    Z = _normals(_generator(seed, dev), (int(n_steps), int(n_paths)), dt,
                 dev)
    return _gbm_milstein_core(Z, *_scalars(dt, dev, S0, r, q, sigma, T),
                              antithetic=bool(antithetic))


# ---------------------------------------------------------------------------
# 7) Milstein for local vol
# ---------------------------------------------------------------------------
def _milstein_lv_core(Z, S0, r, q, T, bump, sigma_loc: Callable, *,
                      antithetic: bool):
    n_steps = Z.shape[0]
    dt = T / n_steps
    sqrt_dt = torch.sqrt(dt)
    Z = _anti(Z, antithetic)
    s_t = torch.full((Z.shape[1],), float(S0), dtype=Z.dtype,
                     device=Z.device)
    S = _rows(s_t, n_steps)
    t_ids = torch.arange(n_steps, dtype=Z.dtype, device=Z.device)
    for k in range(n_steps):
        z = Z[k]
        t_now = t_ids[k] * dt
        sig = torch.clamp(_sigma(sigma_loc, s_t, t_now), 1e-8, 10.0)
        eps = bump * s_t
        S_up = s_t + eps
        S_dn = torch.clamp(s_t - eps, min=1e-10)
        sig_up = _sigma(sigma_loc, S_up, t_now)
        sig_dn = _sigma(sigma_loc, S_dn, t_now)
        da_dS = (sig_up * S_up - sig_dn * S_dn) / (S_up - S_dn)
        a_t = sig * s_t
        s_t = (s_t + (r - q) * s_t * dt + a_t * sqrt_dt * z
               + 0.5 * a_t * da_dS * (z * z - 1.0) * dt)
        s_t = torch.clamp(s_t, min=1e-10)
        S[k + 1] = s_t
    return S


def milstein_local_vol_paths(S0, r, q, T, n_steps, n_paths,
                             sigma_loc: Callable, *, antithetic: bool = True,
                             seed: Optional[int] = None,
                             dS_bump: float = 0.01, dtype=None,
                             device=None) -> torch.Tensor:
    """Local-vol Milstein paths (strong order 1.0): σ′ of the diffusion
    coefficient a(S) = σ(S,t)·S by a central difference with bump
    ``dS_bump·S``, three ``sigma_loc`` evaluations per step."""
    _validate(n_steps, n_paths)
    dt, dev = _setup(dtype, device)
    Z = _normals(_generator(seed, dev), (int(n_steps), int(n_paths)), dt,
                 dev)
    return _milstein_lv_core(Z, *_scalars(dt, dev, S0, r, q, T, dS_bump),
                             sigma_loc, antithetic=bool(antithetic))

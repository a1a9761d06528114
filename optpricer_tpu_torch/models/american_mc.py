"""American Monte Carlo: Longstaff-Schwartz, its dual upper bounds, the
strike ladder, the multi-asset basket and the mesh route.

Counterpart of ``optpricer_tpu/models/american_mc.py``. At every exercise
date the continuation value is a polynomial regression over the
in-the-money paths; the normal equations XᵀWX, XᵀWy are (k × n)·(n × k)
matmuls and the (k, k) system is solved on the device. The reference's
``lax.scan`` over dates is a Python loop here that enqueues each date's
work with no host sync (``torch.linalg.solve_ex``, not ``solve``, which on
CUDA checks its result on the host), so the card reads one number at the
end of a pass.

* The regression products run in full float32 where the reference asks
  for ``Precision.HIGHEST``: every float32 matmul of this module runs
  under :func:`_full_f32`, which turns TF32 off for its duration whatever
  the process-wide setting.
* Every engine is a draw step and a deterministic core. The LSMC passes
  take a path matrix and draw nothing; the three Andersen-Broadie duals
  take their normals from a draw object (:class:`_DualDraws`) asking for
  one outer date k or one inner (k, j) block at a time, keyed by (seed,
  k) and (seed, k, j) through ``monte_carlo.keyed_generator``, so memory
  stays O(n_inner · n_paths) and the sample does not depend on the order
  the dates run in; the basket's path matrix is
  :func:`_ma_core` over normals from a generator seeded from ``seed``.
  torch does not reproduce ``jax.random``'s stream, so a seed gives
  another sample than the reference's; the cores fed the reference's own
  draws give its numbers.
* ``lsmc_price_sharded`` runs on the single-controller mesh
  (``parallel.mesh``): each shard draws its paths from a generator keyed
  by (seed, shard index), and every date's (XᵀWX, XᵀWy, n_itm) partials
  are summed in mesh order (``mesh_sum``, the reference's ``psum``)
  before every shard solves the same system.

Every entry point takes ``device=`` (default ``"cuda"``); float64 unless
``dtype=`` says otherwise.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Literal, Optional

import numpy as np
import torch

from ..core import CALL, OptionSpec
from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import is_call_mask
from .monte_carlo import keyed_generator, resolve_seed
from .processes import gbm_paths

__all__ = ["lsmc_price", "lsmc_price_batch", "lsmc_price_sharded",
           "lsmc_price_basket"]

_RIDGE = 1e-7
# samples per COS block in the Heston dual's control variate: a block's
# (samples, 64) complex128 temporaries stay under ~1 GB
_COS_CHUNK = 1 << 16


@contextmanager
def _full_f32():
    """Full-precision float32 matmuls (no TF32) for the block's duration,
    restoring the caller's setting after it."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device)


def _sign(is_call, dtype, device) -> torch.Tensor:
    """±1 of ``is_call`` (a bool, a bool array or tensor). A scalar is
    filled on the device, with no host-to-device copy."""
    if isinstance(is_call, torch.Tensor):
        call = is_call.to(device)
    elif np.ndim(is_call) == 0:
        return torch.full((), 1.0 if bool(is_call) else -1.0, dtype=dtype,
                          device=device)
    else:
        call = torch.as_tensor(np.array(is_call), device=device)
    return torch.where(call, 1.0, -1.0).to(dtype)


def _powers(x, k: int) -> torch.Tensor:
    """[x⁰, x¹, …, x^{k−1}] along a new last axis."""
    return torch.stack([x ** p for p in range(k)], dim=-1)


def _sv_basis(S_t, v_t, K_ref, k: int) -> torch.Tensor:
    """The stochastic-vol design matrix shared by every Heston/LSV pass:
    powers of x = S/K_ref − 1 up to k−3, then v and v·x (k ≥ 3)."""
    x = S_t / K_ref - 1.0
    return torch.stack([x ** p for p in range(k - 2)] + [v_t, v_t * x],
                       dim=-1)


def _solve(A, b) -> torch.Tensor:
    """β of the ridge-regularised normal equations, with no host check."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A + _RIDGE * eye, b)[0]


def _regress(X, ex, y):
    """(β, fitted, ITM weights) of one date: y regressed on X over the
    paths with positive intrinsic ``ex``, normalised by their count."""
    w = (ex > 0.0).to(X.dtype)
    n_itm = torch.clamp(torch.sum(w), min=1.0)
    Xw = X * w[:, None]
    beta = _solve(Xw.T @ X / n_itm, Xw.T @ y / n_itm)
    return beta, X @ beta, w


def _mean_se(value):
    n = value.shape[0]
    mean = torch.mean(value)
    se = torch.sqrt(torch.clamp(torch.sum((value - mean) ** 2) / (n - 1),
                                min=0.0) / n)
    return mean, se


def _backward(n_dates, cash, date_state, disc, ex_mask=None):
    """The backward induction over dates t = n_dates … 1. ``date_state(t)``
    gives (intrinsic, design matrix) at date t; ``cash`` starts as the
    terminal payoff. Returns (the t = 1 cashflow, β a date in date order,
    None where ``ex_mask`` grants no exercise)."""
    betas = [None] * n_dates
    with _full_f32():
        for t in range(n_dates, 0, -1):
            cont = disc * cash
            if ex_mask is not None and not ex_mask[t - 1]:
                cash = cont
                continue
            ex, X = date_state(t)
            beta, fitted, w = _regress(X, ex, cont)
            cash = torch.where((w > 0.0) & (ex > fitted), ex, cont)
            betas[t - 1] = beta
    return cash, betas


def _forward(n_dates, date_state, terminal_ex, betas, r, dt):
    """Fixed-policy forward pass: stop at the first date whose intrinsic
    exceeds the β-fitted continuation; the maturity payoff otherwise."""
    alive = torch.ones_like(terminal_ex, dtype=torch.bool)
    value = torch.zeros_like(terminal_ex)
    with _full_f32():
        for t in range(1, n_dates + 1):
            ex, X = date_state(t)
            stop = alive & (ex > 0.0) & (ex > X @ betas[t - 1])
            df = torch.exp(-r * dt * float(t))
            value = value + torch.where(stop, df * ex, 0.0)
            alive = alive & ~stop
    df_T = torch.exp(-r * dt * (n_dates + 1.0))
    return value + torch.where(alive, df_T * terminal_ex, 0.0)


def _vanilla_states(paths, v_paths, K, is_call, basis_dim: int):
    """(intrinsic, date_state) of a vanilla on a path matrix: the spot
    basis (powers of S/K − 1) when ``v_paths`` is None, else the (S, v)
    basis :func:`_sv_basis`."""
    sign = _sign(is_call, paths.dtype, paths.device)

    def intrinsic(S):
        return torch.clamp(sign * (S - K), min=0.0)

    def date_state(t):
        S_t = paths[t]
        X = _powers(S_t / K - 1.0, basis_dim) if v_paths is None \
            else _sv_basis(S_t, v_paths[t], K, basis_dim)
        return intrinsic(S_t), X

    return intrinsic, date_state


def _price_backward(paths, v_paths, K, r, dt, is_call, ex_mask, basis_dim,
                    two_pass):
    intrinsic, date_state = _vanilla_states(paths, v_paths, K, is_call,
                                            basis_dim)
    disc = torch.exp(-r * dt)
    cash, betas = _backward(paths.shape[0] - 2, intrinsic(paths[-1]),
                            date_state, disc, ex_mask)
    if two_pass:
        return torch.stack(betas)
    mean, se = _mean_se(disc * cash)
    if ex_mask is not None:
        # the Bermudan has no exercise right at t = 0: no intrinsic floor
        return mean, se
    return torch.maximum(mean, intrinsic(paths[0, 0])), se


def _price_forward(paths, v_paths, betas, K, r, dt, is_call, basis_dim):
    intrinsic, date_state = _vanilla_states(paths, v_paths, K, is_call,
                                            basis_dim)
    value = _forward(betas.shape[0], date_state, intrinsic(paths[-1]),
                     betas, r, dt)
    mean, se = _mean_se(value)
    return torch.maximum(mean, intrinsic(paths[0, 0])), se


def _lsmc_backward(paths, K, r, dt, is_call, ex_mask=None, *,
                   basis_dim: int):
    """(price, stderr) of a stored path matrix by one backward pass; basis
    powers of S/K − 1. ``ex_mask`` ((n_steps−1,) bool over the interior
    dates) restricts exercise to its True dates: the Bermudan."""
    return _price_backward(paths, None, K, r, dt, is_call, ex_mask,
                           basis_dim, False)


def _lsmc_backward_betas(paths, K, r, dt, is_call, *, basis_dim: int):
    """The backward pass's per-date coefficients, the exercise policy:
    ``betas[j]`` belongs to date t_{j+1} (j = 0 … n_steps−2)."""
    return _price_backward(paths, None, K, r, dt, is_call, None, basis_dim,
                           True)


def _lsmc_forward_fixed_policy(paths, betas, K, r, dt, is_call, *,
                               basis_dim: int):
    """Price a path set under a FIXED policy: on paths independent of the
    fit, a low-biased estimator with an honest stderr (two-pass LSMC)."""
    return _price_forward(paths, None, betas, K, r, dt, is_call, basis_dim)


def _lsmc_backward_sv(paths, v_paths, K, r, dt, is_call, ex_mask=None, *,
                      basis_dim: int, two_pass: bool = False):
    """The stochastic-vol backward pass: the regression state is (S_t,
    v_t) on :func:`_sv_basis`. ``ex_mask`` as in :func:`_lsmc_backward`;
    ``two_pass=True`` returns the per-date betas instead."""
    return _price_backward(paths, v_paths, K, r, dt, is_call, ex_mask,
                           basis_dim, two_pass)


def _lsmc_forward_fixed_policy_sv(paths, v_paths, betas, K, r, dt, is_call,
                                  *, basis_dim: int):
    """Fixed-policy forward pass on an independent (S, v) path set."""
    return _price_forward(paths, v_paths, betas, K, r, dt, is_call,
                          basis_dim)


# ---------------------------------------------------------------------------
# Andersen-Broadie dual upper bounds
# ---------------------------------------------------------------------------
class _DualDraws:
    """The normals of a dual bound: ``outer(k)`` for outer date k and
    ``inner(k, j)`` for the inner rollouts from date k at date j, each from
    its own generator keyed by (seed, *prefix, 0, k) and (seed, *prefix,
    1, k, j) — the reference's ``split`` of the key into outer and inner
    streams, then ``fold_in`` k and j."""

    def __init__(self, seed: int, prefix: tuple, n_paths: int, half: int,
                 width: int, dtype, device):
        self.seed, self.prefix = int(seed), tuple(prefix)
        lead = () if width == 1 else (width,)
        self.outer_shape = lead + (int(n_paths),)
        self.inner_shape = lead + (int(half), int(n_paths))
        self.dtype, self.device = dtype, device

    def _normal(self, index, shape):
        gen = keyed_generator(self.seed, self.prefix + index, self.device)
        return torch.randn(shape, generator=gen, dtype=self.dtype,
                           device=self.device)

    def outer(self, k: int) -> torch.Tensor:
        return self._normal((0, k), self.outer_shape)

    def inner(self, k: int, j: int) -> torch.Tensor:
        return self._normal((1, k, j), self.inner_shape)


def _anti(z):
    """Antithetic doubling along the leading (inner-path) axis."""
    return torch.cat([z, -z], dim=0)


def _cv_mean(val, cv, k: int, n_steps: int):
    """Ĉ_k: the inner rollouts' mean of val − β̂·cv, the control variate
    centred over every sample of the date and β̂ = ⟨val,c⟩/⟨c,c⟩ pooled
    (no correction at k = n_steps)."""
    cv = cv - torch.mean(cv)
    beta_cv = torch.sum(val * cv) / torch.clamp(torch.sum(cv * cv),
                                                min=1e-30)
    if k >= n_steps:
        cv = torch.zeros_like(cv)
    else:
        cv = beta_cv * cv
    return torch.mean(val - cv, dim=0)


def _outer_pass(n_steps, n_paths, state0, step, policy_stop, continuation,
                intrinsic0, r_, dt, dtype, device):
    """The outer paths of a dual: M the martingale of the policy's
    lower-bound process L, U = max_k (Z_k − M_k); returns (mean, se) of U.
    ``step(state, k)`` advances the outer state to date k."""
    C0 = continuation(0, state0)
    U = torch.full((n_paths,), 0.0, dtype=dtype, device=device) + intrinsic0
    M = torch.zeros((n_paths,), dtype=dtype, device=device)
    state, L_prev, C_prev = state0, C0, C0
    stop_prev = torch.zeros((n_paths,), dtype=torch.bool, device=device)
    for k in range(1, n_steps + 1):
        state = step(state, k)
        df = torch.exp(-r_ * dt * float(k))
        stop_k, ex = policy_stop(state, k)
        if k == n_steps:
            stop_k = torch.ones_like(stop_k)
        Z_k = df * ex
        # Ĉ at maturity is never read: L_n = Z_n
        C_k = continuation(k, state) if k < n_steps else Z_k
        L_k = torch.where(stop_k, Z_k, C_k)
        E_L = torch.where(stop_prev, C_prev, L_prev)
        M = M + L_k - E_L
        U = torch.maximum(U, Z_k - M)
        L_prev, C_prev, stop_prev = L_k, C_k, stop_k
    return _mean_se(U)


def _lsmc_dual_upper(draws, betas, S0, K, T, r, q, sigma, is_call, *,
                     basis_dim: int, n_inner: int, n_steps: int,
                     n_paths: int = 20_000):
    """Andersen-Broadie (2004) dual UPPER bound under GBM.

    V_0 ≤ E[max_k (Z_k − M_k)] for any martingale M (Z_k the time-0-
    discounted intrinsic); M compensates the fitted policy's lower-bound
    value process L_k = Z_k where the policy stops, else Ĉ_k, the
    continuation estimated by ``n_inner`` antithetic inner rollouts that
    follow the policy from (k, S_k). Increments M_k − M_{k−1} = L_k −
    (Ĉ_{k−1} if the policy stopped at k−1 else L_{k−1}), so M is a
    martingale whatever the policy, and inner noise only raises E[max].
    The inner estimate carries the optional-stopping control variate
    Y = df_τ·euro(S_τ, T−t_τ), whose conditional mean df_k·euro(S_k, T−t_k)
    is exact (the GBM step is the exact transition). ``draws`` gives the
    normals (:class:`_DualDraws`): one outer date, or one inner (k, j)
    block, at a time."""
    dtype, dev = betas.dtype, betas.device
    dt = T / n_steps
    sign = _sign(is_call, dtype, dev)
    c = (r - q - 0.5 * sigma * sigma) * dt
    sdt = sigma * torch.sqrt(dt)
    zeros_row = torch.zeros((1, basis_dim), dtype=dtype, device=dev)
    betas_pad = torch.cat([betas, zeros_row])
    half = max(n_inner // 2, 1)

    def intrinsic(S):
        return torch.clamp(sign * (S - K), min=0.0)

    def stop_at(S, beta):
        ex = intrinsic(S)
        fitted = _powers(S / K - 1.0, basis_dim) @ beta
        return (ex > 0.0) & (ex > fitted), ex

    def euro_value(S, tau):
        """Time-0-undiscounted European value at (S, τ), closed form."""
        tau_s = torch.clamp(tau, min=1e-12)
        vol = sigma * torch.sqrt(tau_s)
        d1 = (torch.log(S / K) + (r - q + 0.5 * sigma * sigma) * tau_s) / vol
        d2 = d1 - vol
        fwd = S * torch.exp(-q * tau_s)
        kd = K * torch.exp(-r * tau_s)
        call = fwd * torch.special.ndtr(d1) - kd * torch.special.ndtr(d2)
        euro = torch.where(sign > 0, call, call - fwd + kd)
        return torch.where(tau > 0, euro, intrinsic(S))

    def continuation(k, S_k):
        S = S_k[None, :].expand(2 * half, S_k.shape[0])
        alive = torch.ones(S.shape, dtype=torch.bool, device=dev)
        val = torch.zeros(S.shape, dtype=dtype, device=dev)
        S_s, j_s = S, torch.zeros_like(val)
        for j in range(k + 1, n_steps + 1):
            S = S * torch.exp(c + sdt * _anti(draws.inner(k, j)))
            stop_j, ex = stop_at(S, betas_pad[j - 1])
            stop = alive & (stop_j | (j == n_steps))
            val = val + torch.where(stop, torch.exp(-r * dt * float(j)) * ex,
                                    0.0)
            S_s = torch.where(stop, S, S_s)
            j_s = torch.where(stop, float(j), j_s)
            alive = alive & ~stop
        tau_s = dt * (float(n_steps) - j_s)
        y = torch.exp(-r * dt * j_s) * euro_value(S_s, tau_s)
        tau_k = dt * float(n_steps - k)
        df_k = torch.exp(-r * dt * float(k))
        cv = y - df_k * euro_value(S_k, tau_k)[None, :]
        return _cv_mean(val, cv, k, n_steps)

    def step(S, k):
        return S * torch.exp(c + sdt * draws.outer(k))

    def policy_stop(S, k):
        return stop_at(S, betas_pad[k - 1])

    with _full_f32():
        S0v = torch.full((n_paths,), 0.0, dtype=dtype, device=dev) + S0
        return _outer_pass(n_steps, n_paths, S0v, step, policy_stop,
                           continuation, intrinsic(S0), r, dt, dtype, dev)


_SV_INNER_CV = True   # A/B switch for the COS inner CV (tests)


def _lsmc_dual_upper_sv(draws, betas, S0, v0, kappa, theta_h, xi, rho,
                        K, T, r, q, is_call, *, basis_dim: int,
                        n_inner: int, n_steps: int, n_paths: int = 8_192):
    """Andersen-Broadie dual upper bound under HESTON dynamics: the GBM
    dual's construction over the (S, v) state, inner and outer paths on
    the same Andersen-QE transition (``processes.qe_transition``). The
    inner control variate is the European value at the policy's stopping
    time, its conditional mean the per-sample COS price
    (``analytic._heston_cos_core`` at N = 64, each sample with its own
    (S, v, τ) and truncation interval, evaluated in blocks of
    ``_COS_CHUNK`` samples); the CV is centred over the date's samples, so
    the QE scheme's weak error against the continuous-time COS mean does
    not drift the martingale."""
    from .analytic import _heston_cos_core
    from .processes import qe_transition

    dtype, dev = betas.dtype, betas.device
    dt = T / n_steps
    sign = _sign(is_call, dtype, dev)
    is_call_t = sign > 0
    qe_kw = dict(r=r, q=q, kappa=kappa, theta=theta_h, xi=xi, rho=rho,
                 dt=dt)
    zeros_row = torch.zeros((1, basis_dim), dtype=dtype, device=dev)
    betas_pad = torch.cat([betas, zeros_row])
    half = max(n_inner // 2, 1)
    L_cos = _scalar(12.0, dtype, dev)

    def intrinsic(S):
        return torch.clamp(sign * (S - K), min=0.0)

    def stop_at(S, v, beta):
        ex = intrinsic(S)
        fitted = _sv_basis(S, v, K, basis_dim) @ beta
        return (ex > 0.0) & (ex > fitted), ex

    def euro_value(S, v, tau):
        """Time-0-undiscounted per-sample European value at (S, v, τ)."""
        S_f, v_f = S.reshape(-1), torch.clamp(v.reshape(-1), min=1e-8)
        tau_f = tau.expand(S.shape).reshape(-1)
        t_s = torch.clamp(tau_f, min=0.25 * dt)
        parts = []
        for lo in range(0, S_f.shape[0], _COS_CHUNK):
            sl = slice(lo, lo + _COS_CHUNK)
            m = S_f[sl].shape[0]
            parts.append(_heston_cos_core(
                S_f[sl], K.expand(m), t_s[sl], r, q, v_f[sl], kappa,
                theta_h, xi, rho, is_call_t, L_cos, N=64))
        euro = torch.cat(parts).reshape(S.shape)
        return torch.where(tau > 0, euro, intrinsic(S))

    def continuation(k, state):
        S_k, v_k = state
        shape = (2 * half, S_k.shape[0])
        S, v = S_k[None, :].expand(shape), v_k[None, :].expand(shape)
        alive = torch.ones(shape, dtype=torch.bool, device=dev)
        val = torch.zeros(shape, dtype=dtype, device=dev)
        S_s, v_s, j_s = S, v, torch.zeros_like(val)
        for j in range(k + 1, n_steps + 1):
            zi = draws.inner(k, j)
            S, v = qe_transition(S, v, _anti(zi[0]), _anti(zi[1]), **qe_kw)
            stop_j, ex = stop_at(S, v, betas_pad[j - 1])
            stop = alive & (stop_j | (j == n_steps))
            val = val + torch.where(stop, torch.exp(-r * dt * float(j)) * ex,
                                    0.0)
            S_s = torch.where(stop, S, S_s)
            v_s = torch.where(stop, v, v_s)
            j_s = torch.where(stop, float(j), j_s)
            alive = alive & ~stop
        tau_s = dt * (float(n_steps) - j_s)
        y = torch.exp(-r * dt * j_s) * euro_value(S_s, v_s, tau_s)
        tau_k = dt * float(n_steps - k)
        df_k = torch.exp(-r * dt * float(k))
        cv = y - df_k * euro_value(S_k, v_k, tau_k)[None, :]
        if not _SV_INNER_CV:
            cv = torch.zeros_like(cv)
        return _cv_mean(val, cv, k, n_steps)

    def step(state, k):
        z = draws.outer(k)
        return qe_transition(state[0], state[1], z[0], z[1], **qe_kw)

    def policy_stop(state, k):
        return stop_at(state[0], state[1], betas_pad[k - 1])

    with _full_f32():
        zero = torch.zeros((n_paths,), dtype=dtype, device=dev)
        state0 = (zero + S0, zero + torch.clamp(v0, min=0.0))
        return _outer_pass(n_steps, n_paths, state0, step, policy_stop,
                           continuation, intrinsic(S0), r, dt, dtype, dev)


_LSV_INNER_CV = True  # A/B switch for the Black-budget CV (tests)


def _lsmc_dual_upper_lsv(draws, betas, model, K, is_call, *, basis_dim: int,
                         n_inner: int, n_steps: int, n_paths: int = 8_192):
    """Andersen-Broadie dual upper bound under CALIBRATED LSV dynamics.

    The Heston dual's construction; every transition, outer and inner, is
    the leverage-scaled step of ``lsv._advance_particles`` with the
    leverage read from the model's table at the state's log-moneyness
    (``lsv_path_matrix``'s step). ``n_steps`` is the number of leverage
    rows in use. The inner control variate is the Black-with-variance-
    budget martingale M_j = e^{−rT}·Black(F_j, w_j): F_j the carried
    forward, w_j a per-path variance budget less the variance each Euler
    log-step consumed, so E[M_τ − M_k | F_k] = 0 exactly whatever v and
    the leverage do; the budget starts at 1.75 x the expected remaining
    variance (ATM leverage x E[v_t]) + 1e-3."""
    from .lsv import _advance_particles, _interp_row, _qe_asset_coupling
    from .mc_fused import _exp_for, _log_for

    dtype, dev = betas.dtype, betas.device

    def scalar(value):
        return _scalar(value, dtype, dev)

    dt = scalar(model.T / model.n_steps)
    sign = _sign(is_call, dtype, dev)
    r_ = scalar(model.r)
    mu = scalar(model.r - model.q)
    exp_, log_ = _exp_for(dtype), _log_for(dtype)
    x_bins = torch.as_tensor(model.x_bins, device=dev)
    lev = torch.as_tensor(model.leverage, device=dev)
    n_bins = lev.shape[1]
    x0 = x_bins[0].to(dtype)
    dx = (x_bins[1] - x_bins[0]).to(dtype)
    S0 = scalar(model.S0)
    log_S0 = log_(S0)
    rho = scalar(model.rho)
    adv_kw = dict(mu=mu, kappa=scalar(model.kappa),
                  theta_v=scalar(model.theta), xi=scalar(model.xi), rho=rho,
                  rho_perp=torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)),
                  dt=dt, sqrt_dt=torch.sqrt(dt), exp_=exp_,
                  scheme=model.scheme)
    lev_rows = lev[:n_steps].to(dtype)          # row j−1 → date j
    K_ = torch.as_tensor(K, dtype=dtype, device=dev)
    n_f = float(n_steps)
    is_call_t = sign > 0

    def lsv_step(S, v, z2, zp, j):
        """One transition from date j−1 to date j, with u, the asset
        log-step's conditional variance (the budget's decrement)."""
        x = log_(S) - (log_S0 + mu * (float(j - 1) * dt))
        L = _interp_row(lev_rows[j - 1], (x - x0) / dx, n_bins)
        S_new, v_new = _advance_particles(S, v, L, z2, zp, **adv_kw)
        v_eff = torch.clamp(v, min=0.0)
        if model.scheme == "qe":
            vbar, _ = _qe_asset_coupling(v_eff, v_new, adv_kw["kappa"],
                                         adv_kw["theta_v"], adv_kw["xi"],
                                         rho, dt)
            u = L * L * vbar * dt
        else:
            u = L * L * v_eff * dt
        return S_new, v_new, u

    def black(F, w):
        """Undiscounted Black value at forward F, total variance w."""
        sq = torch.sqrt(torch.clamp(w, min=1e-10))
        d1 = log_(F / K_) / sq + 0.5 * sq
        d2 = d1 - sq
        call = F * torch.special.ndtr(d1) - K_ * torch.special.ndtr(d2)
        return torch.where(is_call_t, call, call - F + K_)

    t_i = torch.arange(n_steps, dtype=dtype, device=dev) * dt
    kap = adv_kw["kappa"]
    Ev = adv_kw["theta_v"] + (scalar(model.v0) - adv_kw["theta_v"]) \
        * torch.exp(-kap * t_i)
    u_atm = (0.0 - x0) / dx
    i_atm = int(min(max(math.floor(float(u_atm)), 0), n_bins - 2))
    fr_atm = torch.clamp(u_atm - float(i_atm), 0.0, 1.0)
    L_atm = lev_rows[:, i_atm] * (1.0 - fr_atm) \
        + lev_rows[:, i_atm + 1] * fr_atm
    ubar = L_atm * L_atm * Ev * dt
    wrem = torch.cat([torch.flip(torch.cumsum(torch.flip(ubar, [0]), 0),
                                 [0]),
                      torch.zeros((1,), dtype=dtype, device=dev)])

    def intrinsic(S):
        return torch.clamp(sign * (S - K_), min=0.0)

    def stop_at(S, v, beta):
        ex = intrinsic(S)
        fitted = _sv_basis(S, v, K_, basis_dim) @ beta
        return (ex > 0.0) & (ex > fitted), ex

    zeros_row = torch.zeros((1, basis_dim), dtype=dtype, device=dev)
    betas_pad = torch.cat([betas, zeros_row])
    half = max(n_inner // 2, 1)

    def continuation(k, state):
        S_k, v_k = state
        w_start = 1.75 * wrem[k] + 1e-3
        shape = (2 * half, S_k.shape[0])
        S, v = S_k[None, :].expand(shape), v_k[None, :].expand(shape)
        w = torch.zeros(shape, dtype=dtype, device=dev) + w_start
        alive = torch.ones(shape, dtype=torch.bool, device=dev)
        val = torch.zeros(shape, dtype=dtype, device=dev)
        m_s = torch.zeros_like(val)
        for j in range(k + 1, n_steps + 1):
            zi = draws.inner(k, j)
            S, v, u = lsv_step(S, v, _anti(zi[0]), _anti(zi[1]), j)
            w = w - u
            stop_j, ex = stop_at(S, v, betas_pad[j - 1])
            stop = alive & (stop_j | (j == n_steps))
            val = val + torch.where(stop, torch.exp(-r_ * dt * float(j)) * ex,
                                    0.0)
            F_j = S * torch.exp(mu * dt * (n_f - float(j)))
            m_s = torch.where(stop, black(F_j, w), m_s)
            alive = alive & ~stop
        F_k = S_k[None, :] * torch.exp(mu * dt * (n_f - float(k)))
        cv = torch.exp(-r_ * n_f * dt) * (m_s - black(F_k, w_start))
        if not _LSV_INNER_CV:
            cv = torch.zeros_like(cv)
        return _cv_mean(val, cv, k, n_steps)

    def step(state, k):
        z = draws.outer(k)
        S_k, v_k, _ = lsv_step(state[0], state[1], z[0], z[1], k)
        return S_k, v_k

    def policy_stop(state, k):
        return stop_at(state[0], state[1], betas_pad[k - 1])

    with _full_f32():
        zero = torch.zeros((n_paths,), dtype=dtype, device=dev)
        state0 = (zero + S0, zero + max(float(model.v0), 0.0))
        return _outer_pass(n_steps, n_paths, state0, step, policy_stop,
                           continuation, intrinsic(S0), r_, dt, dtype, dev)


def _bermudan_mask(exercise_dates, T: float, n_steps: int) -> np.ndarray:
    """(n_steps−1,) bool over interior dates: True where the Bermudan
    contract grants exercise. Dates snap to the step grid; a date that
    rounds to 0 is clamped to node 1, never dropped."""
    mask = np.zeros(n_steps - 1, bool)
    for t_e in exercise_dates:
        if not 0.0 < t_e <= T:
            raise ValueError(f"exercise date {t_e} outside (0, T={T}]")
        i = max(1, int(round(t_e / T * n_steps)))
        if i <= n_steps - 1:
            mask[i - 1] = True
    return mask


def lsmc_price(opt: OptionSpec, kind: Literal["call", "put"] = CALL, *,
               n_paths: int = 100_000, n_steps: int = 50,
               basis_dim: int = 4, antithetic: bool = True,
               seed: Optional[int] = None, dtype=None,
               return_stderr: bool = True, bound: Optional[str] = None,
               n_inner: int = 256, n_upper_paths: int = 8_192,
               heston: Optional[dict] = None, lsv=None,
               vg: Optional[dict] = None, nig: Optional[dict] = None,
               exercise_dates=None, device=None):
    """American vanilla price via Longstaff-Schwartz.

    ``bound=None``: single-pass LSMC, ``(price, stderr)`` (the stderr is
    the cashflow's; it does not count the in-sample regression bias).
    ``bound="lower"``: two-pass LSMC, the policy fitted on one path set
    and priced on an independent one (seed + 0x5EED), low-biased with an
    honest stderr. ``bound="both"``: also the Andersen-Broadie dual upper
    bound from the same policy (``n_inner`` inner rollouts per path and
    date over ``n_upper_paths`` fresh paths), returning ``{"lower":
    (price, se), "upper": (price, se), "gap": upper − lower}``: a bracket
    of the Bermudan price with exercise at the ``n_steps`` dates.

    ``heston={'v0','kappa','theta','xi','rho'}``: Heston dynamics on QE
    paths, the (S, v) basis [1, x, x², x³, v, v·x] (``opt.sigma``
    ignored); ``bound="both"`` runs the Heston dual with its COS control
    variate. ``lsv=LSVModel``: the calibrated LSV dynamics on
    ``lsv_path_matrix``, exercise at the leverage grid's dates up to
    ``opt.T`` (``n_steps`` ignored; ``opt.S0/r/q`` must match the model).
    ``vg={'sigma','theta','nu'}`` / ``nig={'alpha','beta','delta'}``: the
    Lévy path matrices, spot basis; single pass, Bermudan and
    ``bound="lower"`` (``bound="both"`` raises). ``exercise_dates=[t1,
    …]``: the Bermudan, exercise at the given dates snapped to the grid
    (maturity always, t = 0 never), single pass only.
    """
    if bound not in (None, "lower", "both"):
        raise ValueError("bound must be None, 'lower' or 'both'")
    if sum(x is not None for x in (heston, lsv, vg, nig)) > 1:
        raise ValueError("pass at most one of heston= / lsv= / vg= / "
                         "nig= (GBM when none)")
    if bound == "both" and (vg is not None or nig is not None):
        raise ValueError(
            "bound='both' under vg=/nig= is not supported (the dual's "
            "nested rollouts are not wired for the Lévy transitions) "
            "— use bound='lower' for the honest low-biased estimate")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    seed_val = resolve_seed(seed)
    is_call = is_call_mask(kind)

    def scalar(value):
        return _scalar(value, dt_, dev)

    def draws(seed_k, prefix, width):
        return _DualDraws(seed_k, prefix, n_upper_paths,
                          max(int(n_inner) // 2, 1), width, dt_, dev)

    dual_kw = dict(n_inner=int(n_inner), n_paths=int(n_upper_paths))
    path_kw = dict(n_paths=n_paths, antithetic=antithetic, dtype=dt_,
                   device=dev)
    if lsv is not None:
        for name in ("S0", "r", "q"):
            if abs(getattr(opt, name) - getattr(lsv, name)) > 1e-9:
                raise ValueError(
                    f"opt.{name}={getattr(opt, name)} disagrees with the "
                    f"calibrated model's {name}={getattr(lsv, name)}")
        from .lsv import lsv_path_matrix

        def paths_of(seed_k):
            # lsv_path_matrix checks that opt.T lands on the leverage grid
            return lsv_path_matrix(lsv, T=opt.T, seed=seed_k, **path_kw)

        def dual(betas, k, n_dates):
            return _lsmc_dual_upper_lsv(
                draws(seed_val + 0xD0A1, (), 2), betas, lsv, scalar(opt.K),
                is_call, basis_dim=k, n_steps=n_dates, **dual_kw)
    elif heston is not None:
        from .processes import heston_paths

        hp = [float(heston[k]) for k in ("v0", "kappa", "theta", "xi", "rho")]

        def paths_of(seed_k):
            # Andersen QE: full-truncation Euler's O(Δt) bias would swamp
            # the policy bias this estimator measures
            return heston_paths(opt.S0, opt.r, opt.q, *hp, opt.T, n_steps,
                                seed=seed_k, return_variance=True,
                                scheme="qe", **path_kw)

        def dual(betas, k, n_dates):
            return _lsmc_dual_upper_sv(
                draws(seed_val + 0xD0A1, (), 2), betas, scalar(opt.S0),
                *map(scalar, hp), scalar(opt.K), scalar(opt.T),
                scalar(opt.r), scalar(opt.q), is_call, basis_dim=k,
                n_steps=n_dates, **dual_kw)
    elif vg is not None or nig is not None:
        # pure-jump Lévy dynamics, Markov in the spot: the spot basis
        from .levy import nig_paths, vg_paths

        def paths_of(seed_k):
            if vg is not None:
                return vg_paths(opt.S0, opt.T, opt.r, opt.q,
                                sigma=vg["sigma"], theta=vg["theta"],
                                nu=vg["nu"], n_steps=n_steps, seed=seed_k,
                                **path_kw)
            return nig_paths(opt.S0, opt.T, opt.r, opt.q,
                             alpha=nig["alpha"], beta=nig["beta"],
                             delta=nig["delta"], n_steps=n_steps,
                             seed=seed_k, **path_kw)
    else:
        def paths_of(seed_k):
            return gbm_paths(opt.S0, opt.r, opt.q, opt.sigma, opt.T,
                             n_steps, seed=seed_k, **path_kw)

        def dual(betas, k, n_dates):
            return _lsmc_dual_upper(
                draws(seed_val, (0xAB,), 1), betas, scalar(opt.S0),
                scalar(opt.K), scalar(opt.T), scalar(opt.r), scalar(opt.q),
                scalar(opt.sigma), is_call, basis_dim=k, n_steps=n_dates,
                **dual_kw)

    sv = heston is not None or lsv is not None
    first = paths_of(seed_val)
    n_dates = (first[0] if sv else first).shape[0] - 1
    k = max(int(basis_dim), 6) if sv else int(basis_dim)
    args = (scalar(opt.K), scalar(opt.r), scalar(opt.T / n_dates), is_call)
    if sv:
        def backward(p, *mask):
            return _lsmc_backward_sv(*p, *args, *mask, basis_dim=k)

        betas_of = lambda p: _lsmc_backward_sv(  # noqa: E731
            *p, *args, basis_dim=k, two_pass=True)
        forward = lambda p, b: _lsmc_forward_fixed_policy_sv(  # noqa: E731
            *p, b, *args, basis_dim=k)
    else:
        def backward(p, *mask):
            return _lsmc_backward(p, *args, *mask, basis_dim=k)

        betas_of = lambda p: _lsmc_backward_betas(  # noqa: E731
            p, *args, basis_dim=k)
        forward = lambda p, b: _lsmc_forward_fixed_policy(  # noqa: E731
            p, b, *args, basis_dim=k)
    if exercise_dates is not None:
        if bound is not None:
            raise ValueError("exercise_dates (Bermudan) supports the "
                             "single-pass estimator only (bound=None)")
        price, se = backward(first, _bermudan_mask(exercise_dates, opt.T,
                                                   n_dates))
    elif bound is None:
        price, se = backward(first)
    else:
        betas = betas_of(first)
        # pass 2: an independent path set priced under the frozen policy
        lo, lo_se = forward(paths_of(seed_val + 0x5EED), betas)
        if bound == "lower":
            return float(lo), float(lo_se)
        up, up_se = dual(betas, k, n_dates)
        lo_f, up_f = float(lo), float(up)
        return {"lower": (lo_f, float(lo_se)),
                "upper": (up_f, float(up_se)), "gap": up_f - lo_f}
    return (float(price), float(se)) if return_stderr else float(price)


def _lsmc_backward_batch(paths, K_b, r, dt, is_call_b, *, basis_dim: int,
                         return_stderr: bool = False):
    """Backward pass for a strike/kind ladder over one path matrix.

    The basis lives in the strike-independent s = S_t/S0, so X and the
    per-path outer products X⊗X are shared by the ladder: a date's
    per-strike normal equations are two matmuls, (B, n)·(n, k²) for XᵀWX
    and (B, n)·(n, k) for XᵀWy. Nothing of size (B, n, k) is formed.
    ``return_stderr`` also returns each strike's cashflow stderr."""
    dtype, dev = paths.dtype, paths.device
    n_paths = paths.shape[1]
    k = basis_dim
    disc = torch.exp(-r * dt)
    sign = _sign(is_call_b, dtype, dev)[:, None]             # (B, 1)
    K_col = K_b[:, None]                                      # (B, 1)
    S_ref = paths[0, 0]
    eye = torch.eye(k, dtype=dtype, device=dev)

    def intrinsic(S_row):
        return torch.clamp(sign * (S_row[None, :] - K_col), min=0.0)

    cash = intrinsic(paths[-1])
    with _full_f32():
        for t in range(paths.shape[0] - 2, 0, -1):
            S_t = paths[t]
            y = disc * cash                                   # (B, n)
            ex = intrinsic(S_t)
            w = (ex > 0.0).to(dtype)
            n_itm = torch.clamp(torch.sum(w, dim=1), min=1.0)  # (B,)
            X = _powers(S_t / S_ref - 1.0, k)                  # (n, k)
            F = (X[:, :, None] * X[:, None, :]).reshape(n_paths, k * k)
            A = (w @ F).reshape(-1, k, k) / n_itm[:, None, None]
            b = ((w * y) @ X) / n_itm[:, None]                 # (B, k)
            beta = torch.linalg.solve_ex(A + _RIDGE * eye,
                                         b[..., None])[0][..., 0]
            fitted = beta @ X.T                                # (B, n)
            cash = torch.where((w > 0.0) & (ex > fitted), ex, y)
    value = disc * cash
    mean = torch.mean(value, dim=1)
    price = torch.maximum(mean, intrinsic(paths[:1, 0])[:, 0])
    if not return_stderr:
        return price
    se = torch.sqrt(torch.clamp(torch.sum((value - mean[:, None]) ** 2, dim=1)
                                / (n_paths - 1), min=0.0) / n_paths)
    return price, se


def lsmc_price_sharded(mesh, opt: OptionSpec,
                       kind: Literal["call", "put"] = CALL, *,
                       n_paths: int = 100_000, n_steps: int = 50,
                       basis_dim: int = 4, antithetic: bool = True,
                       seed: Optional[int] = None, dtype=None,
                       heston: Optional[dict] = None):
    """Mesh data-parallel Longstaff-Schwartz with ONE global policy.

    Paths shard over the mesh's devices (each shard's normals from a
    generator keyed by (seed, shard index)); at every date the shards'
    (XᵀWX, XᵀWy, n_itm) partials are summed in mesh order and every shard
    solves the same system, so the regression fits all the paths, as one
    device would. The basis is centred at S0. Returns ``(price,
    stderr)``. ``heston=`` runs Andersen-QE paths per shard and the (S, v)
    basis."""
    from .processes import _gbm_core, _heston_qe_core

    dt_ = canonical(dtype)
    seed_val = resolve_seed(seed)
    devices = mesh.device_list
    n_local = -(-int(n_paths) // len(devices))
    k_dim = max(int(basis_dim), 6) if heston is not None else int(basis_dim)
    shards = []
    for d, dev in enumerate(devices):
        gen = keyed_generator(seed_val, d, dev)
        shape = (int(n_steps), n_local)
        mkt = [_scalar(v, dt_, dev)
               for v in (opt.S0, opt.r, opt.q, opt.sigma, opt.T)]
        if heston is None:
            Z = torch.randn(shape, generator=gen, dtype=dt_, device=dev)
            shards.append((_gbm_core(Z, *mkt, antithetic=bool(antithetic)),
                           None))
        else:
            Za = torch.randn(shape, generator=gen, dtype=dt_, device=dev)
            Zb = torch.randn(shape, generator=gen, dtype=dt_, device=dev)
            hp = [_scalar(heston[k], dt_, dev)
                  for k in ("v0", "kappa", "theta", "xi", "rho")]
            shards.append(_heston_qe_core(Za, Zb, *mkt[:3], *hp, mkt[4],
                                          antithetic=bool(antithetic)))
    n, sv, sv2 = _lsmc_sharded_core(
        shards, opt.S0, opt.K, opt.r, opt.T / n_steps, is_call_mask(kind),
        basis_dim=k_dim, heston=heston is not None)
    mean = sv / n
    var = max(0.0, (sv2 - n * mean * mean) / max(n - 1.0, 1.0))
    price = max(mean, float(np.maximum(
        (1.0 if is_call_mask(kind) else -1.0) * (opt.S0 - opt.K), 0.0)))
    return float(price), float(np.sqrt(var / n))


def _lsmc_sharded_core(shards, S0, K, r, dt, is_call, *, basis_dim: int,
                       heston: bool):
    """The sharded backward pass over per-shard path matrices ``shards``
    (a list of (S paths, v paths or None), in mesh order): each date's
    normal-equation partials summed in mesh order (``mesh_sum``) on the
    first shard's device, β solved there and sent to every shard. Returns
    the host (n, Σvalue, Σvalue²) summed likewise."""
    from ..parallel.mesh import mesh_sum

    dt_ = shards[0][0].dtype
    dev0 = shards[0][0].device
    n_dates = shards[0][0].shape[0] - 2
    k = basis_dim

    def local(value, dev):
        return _scalar(value, dt_, dev)

    consts = [dict(sign=_sign(is_call, dt_, S.device),
                   K=local(K, S.device), S0=local(S0, S.device),
                   disc=torch.exp(-local(r, S.device) * local(dt, S.device)))
              for S, _ in shards]

    def intrinsic(S, c):
        return torch.clamp(c["sign"] * (S - c["K"]), min=0.0)

    def basis(S_t, v_t, c):
        if not heston:
            return _powers(S_t / c["S0"] - 1.0, k)
        return _sv_basis(S_t, v_t, c["S0"], k)

    cash = [intrinsic(S[-1], c) for (S, _), c in zip(shards, consts)]
    eye = torch.eye(k, dtype=dt_, device=dev0)
    with _full_f32():
        for t in range(n_dates, 0, -1):
            parts, locals_ = [], []
            for (S, v), c, cf in zip(shards, consts, cash):
                y = c["disc"] * cf
                ex = intrinsic(S[t], c)
                w = (ex > 0.0).to(dt_)
                X = basis(S[t], None if v is None else v[t], c)
                Xw = X * w[:, None]
                parts.append(torch.cat([(Xw.T @ X).reshape(-1), Xw.T @ y,
                                        torch.sum(w)[None]]))
                locals_.append((y, ex, w, X))
            total = mesh_sum(parts)
            A = total[:k * k].reshape(k, k)
            b = total[k * k:k * k + k]
            n_itm = torch.clamp(total[-1], min=1.0)
            beta = torch.linalg.solve_ex(A / n_itm + _RIDGE * eye,
                                         b / n_itm)[0]
            cash = []
            for (y, ex, w, X) in locals_:
                fitted = X @ beta.to(X.device)
                cash.append(torch.where((w > 0.0) & (ex > fitted), ex, y))
    stats = []
    for cf, c in zip(cash, consts):
        value = c["disc"] * cf
        stats.append(torch.stack([
            torch.as_tensor(float(value.numel()), dtype=dt_,
                            device=value.device),
            torch.sum(value), torch.sum(value * value)]))
    return np.asarray(mesh_sum(stats).cpu(), np.float64)


def lsmc_price_batch(S0, K, T, r, q, sigma, kind, *, n_paths: int = 100_000,
                     n_steps: int = 50, basis_dim: int = 4,
                     antithetic: bool = True, seed: Optional[int] = None,
                     dtype=None, device=None) -> torch.Tensor:
    """American strike/kind ladder sharing ONE path matrix: the per-date
    regressions of every strike are two matmuls
    (:func:`_lsmc_backward_batch`). Returns a tensor of ``K``'s shape."""
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    K_arr = np.atleast_1d(np.asarray(K, dtype=float))
    mask = np.broadcast_to(np.atleast_1d(is_call_mask(kind)), K_arr.shape)
    paths = gbm_paths(S0, r, q, sigma, T, n_steps, n_paths,
                      antithetic=antithetic, seed=resolve_seed(seed),
                      dtype=dt_, device=dev)
    prices = _lsmc_backward_batch(
        paths, torch.as_tensor(K_arr.reshape(-1), dtype=dt_, device=dev),
        _scalar(r, dt_, dev), _scalar(T / n_steps, dt_, dev),
        mask.reshape(-1), basis_dim=int(basis_dim))
    return prices.reshape(np.shape(K_arr))


# ---------------------------------------------------------------------------
# Multi-asset American: LSMC on correlated-GBM path matrices
# ---------------------------------------------------------------------------
def _ma_core(z, S0s, r, qs, sigmas, chol, T, *, antithetic: bool):
    """Correlated-GBM path matrix (n_steps+1, n_paths, n_assets) from the
    normals ``z`` (n_steps, half, n_assets): exact per-date transitions (a
    cumsum of exact log increments), the correlation one ``z @ Lᵀ``."""
    n_steps = z.shape[0]
    dt = T / n_steps
    if antithetic:
        z = torch.cat([z, -z], dim=1)
    with _full_f32():
        eps = z @ chol.T
    drift = (r - qs - 0.5 * sigmas * sigmas) * dt
    inc = drift[None, None, :] + sigmas[None, None, :] * torch.sqrt(dt) * eps
    S = torch.exp(torch.log(S0s)[None, None, :] + torch.cumsum(inc, dim=0))
    return torch.cat([S0s.expand(1, S.shape[1], S0s.shape[0]), S], dim=0)


def _ma_intrinsic(S_t, w, K, sign, payoff: str):
    if payoff == "basket":
        stat = S_t @ w
    elif payoff == "rainbow_max":
        stat = torch.amax(S_t, dim=-1)
    else:  # rainbow_min
        stat = torch.amin(S_t, dim=-1)
    return torch.clamp(sign * (stat - K), min=0.0)


def _ma_basis(S_t, w, K):
    """Basket moneyness and the two largest normalised prices with their
    squares, the cube of the first and the cross term (Andersen & Broadie
    2004): 9 features; one asset degenerates y2 to 0."""
    b = (S_t @ w) / K - 1.0
    ys = torch.sort(S_t / K, dim=-1, descending=True).values
    y1 = ys[..., 0] - 1.0
    y2 = ys[..., 1] - 1.0 if S_t.shape[-1] > 1 else torch.zeros_like(y1)
    one = torch.ones_like(b)
    return torch.stack([one, b, b * b, y1, y1 * y1, y1 * y1 * y1,
                        y2, y2 * y2, y1 * y2], dim=-1)


def _lsmc_backward_ma(paths, w, K, r, dt, sign, *, payoff: str,
                      two_pass: bool = False):
    """Multi-asset backward induction, the regression state the asset
    vector on :func:`_ma_basis`."""
    disc = torch.exp(-r * dt)

    def date_state(t):
        S_t = paths[t]
        return _ma_intrinsic(S_t, w, K, sign, payoff), _ma_basis(S_t, w, K)

    with _full_f32():
        cash, betas = _backward(
            paths.shape[0] - 2, _ma_intrinsic(paths[-1], w, K, sign, payoff),
            date_state, disc)
        if two_pass:
            return torch.stack(betas)
        mean, se = _mean_se(disc * cash)
        ex0 = _ma_intrinsic(paths[0, :1], w, K, sign, payoff)[0]
    return torch.maximum(mean, ex0), se


def _lsmc_forward_fixed_policy_ma(paths, betas, w, K, r, dt, sign, *,
                                  payoff: str):
    """Fixed-policy forward pass on an independent multi-asset path set."""
    def date_state(t):
        S_t = paths[t]
        return _ma_intrinsic(S_t, w, K, sign, payoff), _ma_basis(S_t, w, K)

    with _full_f32():
        value = _forward(betas.shape[0], date_state,
                         _ma_intrinsic(paths[-1], w, K, sign, payoff),
                         betas, r, dt)
        mean, se = _mean_se(value)
        ex0 = _ma_intrinsic(paths[0, :1], w, K, sign, payoff)[0]
    return torch.maximum(mean, ex0), se


def lsmc_price_basket(S0s, weights, K, T, r, qs=None, *, sigmas, corr,
                      kind: str = "call", payoff: str = "basket",
                      n_paths: int = 200_000, n_steps: int = 50,
                      antithetic: bool = True, seed: Optional[int] = None,
                      dtype=None, bound: Optional[str] = None, device=None):
    """American/Bermudan MULTI-ASSET option via Longstaff-Schwartz over
    ``n_steps`` equally spaced dates on correlated GBM. ``payoff``:
    ``"basket"`` (Σw·S vs K, weights on the simplex), ``"rainbow_max"`` or
    ``"rainbow_min"`` (the weights then shape only the basis). ``bound=
    None``: single pass; ``"lower"``: two-pass. Returns ``(price,
    stderr)``. Anchor: the Andersen-Broadie (2004) 2-asset Bermudan
    max-call (S0 100, K 100, r 5%, q 10%, σ 20%, ρ 0, T 3, 9 dates) =
    13.902."""
    if payoff not in ("basket", "rainbow_max", "rainbow_min"):
        raise ValueError("payoff must be 'basket', 'rainbow_max' or "
                         "'rainbow_min'")
    if bound not in (None, "lower"):
        raise ValueError("bound must be None or 'lower' (the dual upper "
                         "bound is single-asset only)")
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0s = np.atleast_1d(np.asarray(S0s, np.float64))
    a = S0s.size
    w = np.atleast_1d(np.asarray(weights, np.float64))
    qs_np = np.zeros(a) if qs is None else np.atleast_1d(
        np.asarray(qs, np.float64))
    sig = np.atleast_1d(np.asarray(sigmas, np.float64))
    corr = np.asarray(corr, np.float64)
    if not (w.shape == qs_np.shape == sig.shape == (a,)) \
            or corr.shape != (a, a):
        raise ValueError("S0s, weights, qs, sigmas must be length-a "
                         "vectors and corr an (a, a) matrix")
    if payoff == "basket" and (np.any(w < 0.0)
                               or abs(w.sum() - 1.0) > 1e-9):
        raise ValueError("basket weights must be non-negative and sum "
                         "to 1")
    chol = np.linalg.cholesky(corr)
    seed_val = resolve_seed(seed)

    def tensor(x):
        return torch.as_tensor(x, dtype=dt_, device=dev)

    gen_args = (tensor(S0s), tensor(r), tensor(qs_np), tensor(sig),
                tensor(chol), tensor(T))
    bw_args = (tensor(w), tensor(K), tensor(r), tensor(T / n_steps),
               tensor(1.0 if kind == "call" else -1.0))
    half = int(n_paths) // 2 if antithetic else int(n_paths)

    def paths_of(seed_k):
        gen = torch.Generator(device=dev).manual_seed(seed_k % 2**63)
        z = torch.randn((int(n_steps), half, a), generator=gen, dtype=dt_,
                        device=dev)
        return _ma_core(z, *gen_args, antithetic=bool(antithetic))

    paths = paths_of(seed_val)
    if bound is None:
        price, se = _lsmc_backward_ma(paths, *bw_args, payoff=payoff)
        return float(price), float(se)
    betas = _lsmc_backward_ma(paths, *bw_args, payoff=payoff, two_pass=True)
    lo, lo_se = _lsmc_forward_fixed_policy_ma(paths_of(seed_val + 0x5EED),
                                              betas, *bw_args,
                                              payoff=payoff)
    return float(lo), float(lo_se)

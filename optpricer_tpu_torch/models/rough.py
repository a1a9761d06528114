"""Rough volatility: rBergomi by exact joint Gaussian simulation.

Counterpart of ``optpricer_tpu/models/rough.py``. The rough Bergomi model
(Bayer, Friz & Gatheral 2016):

    v_t = ξ0(t) · exp(η·W̃_t − ½η²·t^{2H}),
    W̃_t = √(2H) ∫₀ᵗ (t−u)^{H−1/2} dW_u          (Riemann-Liouville),
    dS_t/S_t = (r−q)dt + √v_t (ρ dW_t + √(1−ρ²) dW⊥_t).

(W̃_{t_1..t_n}, ΔW_{1..n}) is a Gaussian vector with a known covariance:
its (2n × 2n) Cholesky factor is built once on the host in f64
(:func:`_joint_chol`, Gauss-Jacobi quadrature for the Volterra block),
and every path batch is one (2n × 2n)·(2n × n_paths) product on the
device. The Volterra process is exact at the grid times; the spot is
log-Euler.

As the port's other samplers, the draws are a step of their own: Z
(2n, half) from ``monte_carlo.keyed_generator(seed, 0)`` and Z′ (n, half)
from ``keyed_generator(seed, 1)``, the reference's split key pair; the
deterministic core :func:`_rbergomi_core` takes them (the tests feed it
the reference's own ``jax.random`` draws). Its float32 product runs with
TF32 off (``dtypes.full_f32``).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..dtypes import canonical, full_f32, resolve_device
from .monte_carlo import keyed_generator, resolve_seed

__all__ = ["rbergomi_paths", "rbergomi_price"]


def _volterra_cov(times: np.ndarray, H: float, n_quad: int = 64):
    """(n, n) covariance of the Riemann-Liouville Volterra process at
    ``times`` (all > 0), f64 host numpy. The diagonal is exact (t^{2H});
    off-diagonals integrate the smooth factor against the Gauss-Jacobi
    weight (1−x)^{H−1/2}, so the endpoint singularity never meets the
    quadrature."""
    from scipy.special import roots_jacobi

    # weight (1-x)^alpha on [-1, 1] with alpha = H - 1/2; map to [0, 1]
    xk, wk = roots_jacobi(n_quad, H - 0.5, 0.0)
    x01 = 0.5 * (xk + 1.0)
    # the map's jacobian: (1-x)^a on [-1,1] becomes (2(1-u))^a, dx = du/2
    w01 = wk * 0.5 ** (H + 0.5)

    tv = times[:, None]
    tu = times[None, :]
    c = np.maximum(tv, tu) / np.minimum(tv, tu)
    # I(c) = int_0^1 (c - x)^{H-1/2} (1-x)^{H-1/2} dx
    I = np.einsum("k,ijk->ij",
                  w01, (c[:, :, None] - x01[None, None, :]) ** (H - 0.5))
    cov = 2.0 * H * np.minimum(tv, tu) ** (2.0 * H) * I
    np.fill_diagonal(cov, times ** (2.0 * H))
    return cov


def _joint_chol(n_steps: int, dt: float, H: float) -> np.ndarray:
    """Cholesky factor (2n × 2n, f64) of the joint law of
    (W̃_{t_1..t_n}, ΔW_{1..n})."""
    t = dt * np.arange(1, n_steps + 1)
    C = np.zeros((2 * n_steps, 2 * n_steps))
    C[:n_steps, :n_steps] = _volterra_cov(t, H)
    # Cov(W~_{t_i}, dW_j), kernel support [t_{j-1}, t_j] within [0, t_i]
    g = H + 0.5
    ti = t[:, None]
    tj = t[None, :]
    tjm = tj - dt
    cwd = np.sqrt(2.0 * H) / g * (
        np.maximum(ti - tjm, 0.0) ** g - np.maximum(ti - tj, 0.0) ** g)
    cwd[ti < tj - 1e-15 * dt] = 0.0
    C[:n_steps, n_steps:] = cwd
    C[n_steps:, :n_steps] = cwd.T
    C[n_steps:, n_steps:] = dt * np.eye(n_steps)
    # tiny jitter: the Volterra block is near-singular for H -> 0 at
    # adjacent times; scaled to the largest variance on the diagonal
    jit = 1e-12 * max(float(t[-1] ** (2.0 * H)), dt)
    return np.linalg.cholesky(C + jit * np.eye(2 * n_steps))


def _rbergomi_core(Z, Zp, L, xi_grid, t_grid, S0, r, q, eta, H2, rho, dt,
                   *, antithetic: bool):
    """Paths (n+1, n_paths) and left-endpoint variances (n, n_paths) from
    the base draws Z (2n, half) and Z′ (n, half), antithetic columns
    appended after the base ones."""
    dtype = L.dtype
    n_steps = Zp.shape[0]
    if antithetic:
        Z = torch.cat([Z, -Z], dim=1)
        Zp = torch.cat([Zp, -Zp], dim=1)
    with full_f32():
        X = torch.matmul(L, Z)
    Wt = X[:n_steps]              # Volterra at t_1..t_n
    dW = X[n_steps:]              # increments of the driving BM
    # variance at the left endpoints t_0..t_{n-1}: W~_0 = 0
    Wt_left = torch.cat([torch.zeros_like(Wt[:1]), Wt[:-1]], dim=0)
    t_left = torch.cat([torch.zeros((1,), dtype=dtype, device=L.device),
                        t_grid[:-1]])
    v = xi_grid[:, None] * torch.exp(
        eta * Wt_left - 0.5 * eta * eta * t_left[:, None] ** H2)
    dWp = torch.sqrt(dt) * Zp
    dlogS = ((r - q) * dt - 0.5 * v * dt
             + torch.sqrt(v) * (rho * dW
                                + torch.sqrt(1.0 - rho * rho) * dWp))
    logS = torch.log(S0) + torch.cumsum(dlogS, dim=0)
    S = torch.exp(logS)
    return torch.cat([S0.expand(1, S.shape[1]), S], dim=0), v


def _draws(seed: int, n_steps: int, half: int, dtype, device):
    """The core's base normals: Z (2n, half) under key (seed, 0), Z′
    (n, half) under (seed, 1)."""
    gen = lambda i: keyed_generator(seed, i, device)
    Z = torch.randn((2 * n_steps, half), generator=gen(0), dtype=dtype,
                    device=device)
    Zp = torch.randn((n_steps, half), generator=gen(1), dtype=dtype,
                     device=device)
    return Z, Zp


def rbergomi_paths(S0, r, q, T, n_steps, n_paths, *,
                   xi0: Union[float, Callable], eta: float, H: float,
                   rho: float, antithetic: bool = True,
                   seed: Optional[int] = None, dtype=None,
                   return_variance: bool = False, device=None):
    """rBergomi path matrix ``(n_steps+1, n_paths)`` (optionally also the
    spot-variance grid ``(n_steps, n_paths)`` at the left endpoints).

    ``xi0``: flat forward variance (float) or a callable ``t -> ξ0(t)``
    evaluated on the host grid. ``H`` ∈ (0, 1/2] (½ recovers a lognormal
    model), ``eta`` the vol-of-vol, ``rho`` the spot-vol correlation.
    """
    if not (0.0 < H <= 0.5):
        raise ValueError(f"H must be in (0, 1/2], got {H}")
    if not (-1.0 <= rho <= 1.0):
        raise ValueError(f"rho must be in [-1, 1], got {rho}")
    if eta < 0.0:
        raise ValueError(f"eta must be non-negative, got {eta}")
    if n_steps < 1 or n_paths < 2:
        raise ValueError("need n_steps >= 1 and n_paths >= 2")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    n_steps = int(n_steps)
    dt = float(T) / n_steps
    L = _joint_chol(n_steps, dt, float(H))
    t_np = dt * np.arange(1, n_steps + 1)
    xi_np = (np.full(n_steps, float(xi0)) if not callable(xi0)
             else np.asarray([float(xi0(t)) for t in dt * np.arange(n_steps)]))
    if np.any(xi_np <= 0.0):
        raise ValueError("xi0 must be positive on the grid")
    half = int(n_paths) // 2 if antithetic else int(n_paths)
    Z, Zp = _draws(resolve_seed(seed), n_steps, half, dt_, dev)
    t = lambda a: torch.as_tensor(a, dtype=dt_, device=dev)
    S, v = _rbergomi_core(Z, Zp, t(L), t(xi_np), t(t_np), t(S0), t(r), t(q),
                          t(eta), t(2.0 * H), t(rho), t(dt),
                          antithetic=bool(antithetic))
    return (S, v) if return_variance else S


def rbergomi_price(S0, K, T, r, q=0.0, *, xi0, eta, H, rho,
                   kind: str = "call", n_steps: int = 128,
                   n_paths: int = 131_072, antithetic: bool = True,
                   seed: Optional[int] = None,
                   dtype=None, device=None) -> tuple[float, float]:
    """European price under rBergomi, ``(price, stderr)``; exotic payoffs
    go through the path-matrix API (``exotics.py``) on the same paths."""
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    S = rbergomi_paths(S0, r, q, T, n_steps, n_paths, xi0=xi0, eta=eta,
                       H=H, rho=rho, antithetic=antithetic, seed=seed,
                       dtype=dtype, device=device)
    sign = 1.0 if kind == "call" else -1.0
    pay = np.maximum(sign * (S[-1].cpu().numpy().astype(np.float64) - K),
                     0.0)
    disc = np.exp(-r * T)
    n = pay.size
    return (float(disc * pay.mean()),
            float(disc * pay.std(ddof=1) / np.sqrt(n)))

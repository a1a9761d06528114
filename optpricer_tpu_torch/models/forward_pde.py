"""Dupire forward PDE: the whole call surface C(K, T) from one march.

Counterpart of ``optpricer_tpu/models/forward_pde.py``. Fix S0 and march
maturity forward over a log-strike grid y = ln K:

    ∂C/∂T = ½σ²(∂²C/∂y² − ∂C/∂y) − (r − q) ∂C/∂y − q C,
    C(K, 0) = max(S0 − K, 0),

so one θ-scheme march gives European prices for every strike and every
intermediate maturity. The first ``rannacher`` steps run fully implicit
and the kink node holds its cell average (Kreiss smoothing). Calls and
puts march together as two columns, and every read-out takes the
out-of-the-money column, rebuilding the other side by put-call parity in
host f64.

* **Constant vol** (``sigma=``): each step is one (M × M)·(M × 2)
  propagator product plus the two boundary-response columns, one
  ``torch.addmm`` a step. The propagator and the state are rounded to
  the march dtype as the reference's are, but the product accumulates in
  float64: in float32 at 1 024 × 512 the ATM error on the CPU is 8.2e-5
  against 2.7e-4 with a float32-accumulated product (whose summation
  order decides its last bits), and the card and the CPU round to the
  same state. The propagator P = A⁻¹B and the columns w = A⁻¹e_{0,M−1}
  are built in f64 and cast once to the march dtype: on the CPU by
  scipy's banded LU (:func:`_prop_host`, the reference's build); on the
  card by ONE K7 launch per θ (:func:`_prop_device`), A's bands read with
  a system stride of 0 and B's M columns and the two unit columns as the
  right-hand sides. The reference rejected an f32 device build on
  accuracy (the tail entries of w need their entrywise accuracy); an f64
  build has it.
* **Local vol** (``sigma_loc=``): per step, σ at the step's midpoint and
  one tridiagonal solve of the (call, put) pair: K7 on the card through
  ``ops.tridiag.tridiag_solve_thomas``, its plain Thomas version on the
  CPU (the reference runs its log-depth scan; the two agree to
  round-off).

Every entry point takes ``device=`` (default ``"cuda"``); the grid and
the read-outs are host f64.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from ..ops.thomas import tridiag_solve_kernel
from ..ops.tridiag import tridiag_solve_thomas

__all__ = ["ForwardSurface", "dupire_forward_surface",
           "dupire_forward_price", "forward_surface_iv",
           "reprice_surface_forward"]


class ForwardSurface(NamedTuple):
    """One forward march: calls AND puts on the full (maturity × strike)
    grid, parity-stitched from the OTM columns.

    ``K`` (n_y+1,) and ``T`` (n_t+1,) are host f64; ``C[i, j]`` /
    ``P[i, j]`` are the European call / put at (K[j], T[i]) seen from S0
    (row 0 holds the payoffs).
    """
    K: np.ndarray
    T: np.ndarray
    C: np.ndarray
    S0: float
    r: float
    q: float
    P: np.ndarray

    def price(self, K, T, kind: str = "call"):
        """Bilinear read-out at (K, T) from the parity-stitched grid."""
        if kind == "call":
            V = self.C
        elif kind == "put":
            V = self.P
        else:
            raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")
        K_q = np.atleast_1d(np.asarray(K, np.float64))
        T_q = np.atleast_1d(np.asarray(T, np.float64))
        K_q, T_q = np.broadcast_arrays(K_q, T_q)
        y = np.log(self.K)
        yq = np.log(K_q)
        j = np.clip(np.searchsorted(y, yq) - 1, 0, len(y) - 2)
        wy = np.clip((yq - y[j]) / (y[j + 1] - y[j]), 0.0, 1.0)
        i = np.clip(np.searchsorted(self.T, T_q) - 1, 0, len(self.T) - 2)
        wt = np.clip((T_q - self.T[i]) / (self.T[i + 1] - self.T[i]),
                     0.0, 1.0)
        v = ((1 - wt) * ((1 - wy) * V[i, j] + wy * V[i, j + 1])
             + wt * ((1 - wy) * V[i + 1, j] + wy * V[i + 1, j + 1]))
        return v if np.ndim(K) or np.ndim(T) else float(v[0])


def _forward_operator(sig, dy, r, q):
    """Interior tridiagonals of L in log-strike: L V_j = α(V_{j−1} − 2V_j +
    V_{j+1}) + β(V_{j+1} − V_{j−1}) − qV_j with α = σ²/2dy², β = −(σ²/2 +
    r − q)/2dy."""
    alpha = 0.5 * sig**2 / dy**2
    beta = -(0.5 * sig**2 + (r - q)) / (2.0 * dy)
    return alpha - beta, -2.0 * alpha - q, alpha + beta


def _bc(t, S0, r, q, K_lo, K_hi):
    """Dirichlet values (…, 2) of (call, put) at the strike-grid edges at
    the times ``t``: K→0: C = fwd − disc·K, P = 0; K→∞ mirrored."""
    fwd = S0 * torch.exp(-q * t)
    zero = torch.zeros_like(t)
    lo = torch.stack([torch.clamp(fwd - K_lo * torch.exp(-r * t), min=0.0),
                      zero], dim=-1)
    hi = torch.stack([zero, torch.clamp(K_hi * torch.exp(-r * t) - fwd,
                                        min=0.0)], dim=-1)
    return lo, hi


def _operator_bands(y_np, dt, r, q, sigma, th):
    """Host f64 (a_L, b_L, c_L, B) of one θ step: L's interior bands and
    the explicit side B = I + (1 − θ)Δt·L, dense."""
    M = y_np.size - 2
    dy = y_np[1] - y_np[0]
    alpha = 0.5 * sigma**2 / dy**2
    beta = -(0.5 * sigma**2 + (r - q)) / (2.0 * dy)
    a_L = np.full(M, alpha - beta)
    b_L = np.full(M, -2.0 * alpha - q)
    c_L = np.full(M, alpha + beta)
    e = (1.0 - th) * dt
    B = (np.diag(1.0 + e * b_L)
         + np.diag(e * a_L[1:], -1) + np.diag(e * c_L[:-1], 1))
    return a_L, b_L, c_L, B


def _prop_host(y_np: np.ndarray, dt: float, r: float, q: float,
               sigma: float, th: float):
    """(P, w_lo, w_hi, a0, cM) for one θ, host f64: P = A⁻¹B the dense
    propagator, w = A⁻¹e_{0,M−1} the boundary-response columns, by
    LAPACK's banded solver."""
    from scipy.linalg import solve_banded

    a_L, b_L, c_L, B = _operator_bands(y_np, dt, r, q, sigma, th)
    M = B.shape[0]
    ab = np.zeros((3, M))
    ab[0, 1:] = -th * dt * c_L[:-1]
    ab[1] = 1.0 - th * dt * b_L
    ab[2, :-1] = -th * dt * a_L[1:]
    rhs = np.zeros((M, 2))
    rhs[0, 0] = 1.0
    rhs[M - 1, 1] = 1.0
    P = solve_banded((1, 1), ab, B)
    w = solve_banded((1, 1), ab, rhs)
    return P, w[:, 0], w[:, 1], float(a_L[0]), float(c_L[-1])


def _prop_device(y_np: np.ndarray, dt: float, r: float, q: float,
                 sigma: float, th: float, device):
    """:func:`_prop_host`'s (P, w_lo, w_hi, a0, cM) as f64 tensors on
    ``device``: one tridiagonal solve of A against [B | e_0 | e_{M−1}]
    (M + 2 right-hand sides, A's bands one column for every system): K7
    on the card, its plain Thomas version on the CPU."""
    a_L, b_L, c_L, B = _operator_bands(y_np, dt, r, q, sigma, th)
    M = B.shape[0]
    rhs = np.zeros((M, M + 2))
    rhs[:, :M] = B
    rhs[0, M] = 1.0
    rhs[M - 1, M + 1] = 1.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    col = lambda a: t(a)[:, None]
    # a[0] and c[M−1] are never read
    x = tridiag_solve_kernel(col(-th * dt * a_L), col(1.0 - th * dt * b_L),
                             col(-th * dt * c_L), t(rhs))
    return x[:, :M], x[:, M], x[:, M + 1], float(a_L[0]), float(c_L[-1])


def _propagator(y_np, dt, r, q, sigma, th, device):
    """The f64 propagator of one θ: the host build on the CPU, K7's on the
    card."""
    if device.type == "cpu":
        return tuple(torch.as_tensor(a, dtype=torch.float64)
                     if isinstance(a, np.ndarray) else a
                     for a in _prop_host(y_np, dt, r, q, sigma, th))
    return _prop_device(y_np, dt, r, q, sigma, th, device)


def _forward_march_prop(y_np, V0, dt, S0, r, q, sigma, theta, *,
                        n_t: int, rannacher: int):
    """Constant-vol forward march: f64 propagators (fully implicit for the
    Rannacher start, Crank-Nicolson after) rounded to V0's dtype, one
    f64-accumulated addmm a step, the state stored in V0's dtype. Returns
    V on the full (n_t+1, n_y+1, 2) grid."""
    dtype, dev = V0.dtype, V0.device
    n_y = V0.shape[0] - 1
    n_r = min(rannacher, n_t)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    K_lo, K_hi = float(np.exp(y_np[0])), float(np.exp(y_np[-1]))
    dt_j, S0_j, r_j, q_j, Klo_j, Khi_j = (
        t(v) for v in (dt, S0, r, q, K_lo, K_hi))
    V = torch.empty((n_t + 1, n_y + 1, 2), dtype=dtype, device=dev)
    V[0] = V0
    for th, lo, hin in ((1.0, 0, n_r), (theta, n_r, n_t)):
        if hin <= lo:
            continue
        P, w_lo, w_hi, a0, cM = _propagator(y_np, dt, r, q, sigma, th, dev)
        # rounded once to the march dtype; each step accumulates in f64
        P, w_lo, w_hi = (a.to(dtype).double() for a in (P, w_lo, w_hi))
        th_j, a0_j, cM_j = t(th), t(a0), t(cM)
        e = (1.0 - th_j) * dt_j
        t_now = (lo + torch.arange(hin - lo, dtype=dtype, device=dev)) * dt_j
        lo_now, hi_now = _bc(t_now, S0_j, r_j, q_j, Klo_j, Khi_j)
        lo_nxt, hi_nxt = _bc(t_now + dt_j, S0_j, r_j, q_j, Klo_j, Khi_j)
        s_lo = (e * a0_j * lo_now + th_j * dt_j * a0_j * lo_nxt).double()
        s_hi = (e * cM_j * hi_now + th_j * dt_j * cM_j * hi_nxt).double()
        resp = (w_lo[None, :, None] * s_lo[:, None, :]
                + w_hi[None, :, None] * s_hi[:, None, :])       # (n, M, 2)
        V[lo + 1:hin + 1, 0] = lo_nxt
        V[lo + 1:hin + 1, n_y] = hi_nxt
        for k in range(lo, hin):
            V[k + 1, 1:n_y] = torch.addmm(resp[k - lo], P,
                                          V[k, 1:n_y].double())
    return V


def _forward_march(y_grid, V0, dt, S0, r, q, theta, *, n_t: int,
                   sigma_func: Callable, rannacher: int):
    """θ-scheme forward march with per-step coefficients (local vol,
    σ at each step's midpoint time); the (call, put) pair rides the
    tridiagonal solve as two systems. Returns V on the full
    (n_t+1, n_y+1, 2) grid."""
    n_y = y_grid.shape[0] - 1
    M = n_y - 1
    dtype = y_grid.dtype
    dy = y_grid[1] - y_grid[0]
    K_grid = torch.exp(y_grid)
    K_int = K_grid[1:n_y]
    t_now = torch.arange(n_t, dtype=dtype, device=y_grid.device) * dt
    lo_all, hi_all = _bc(t_now + dt, S0, r, q, K_grid[0], K_grid[-1])
    V = torch.empty((n_t + 1, n_y + 1, 2), dtype=dtype, device=y_grid.device)
    V[0] = V0
    V[1:, 0] = lo_all
    V[1:, n_y] = hi_all
    for n in range(n_t):
        # Rannacher start: fully implicit for the first steps
        th = 1.0 if n < rannacher else theta
        e = (1.0 - th) * dt
        sig = sigma_func(K_int, t_now[n] + 0.5 * dt)
        sig = torch.broadcast_to(torch.as_tensor(sig).to(dtype), (M,))
        a_L, b_L, c_L = _forward_operator(sig, dy, r, q)
        V_n = V[n]
        V_int = V_n[1:n_y]
        # explicit side (I + e·L) V^n; the carried layer holds bc(t_now)
        # at nodes 0 and n_y, so the stencil reads them directly
        rhs = (V_int
               + e * (b_L[:, None] * V_int
                      + a_L[:, None] * V_n[0:n_y - 1]
                      + c_L[:, None] * V_n[2:n_y + 1]))
        # the implicit side moves its boundary couplings to the rhs
        rhs[0] += th * dt * a_L[0] * lo_all[n]
        rhs[-1] += th * dt * c_L[-1] * hi_all[n]
        V[n + 1, 1:n_y] = tridiag_solve_thomas(
            -th * dt * a_L, 1.0 - th * dt * b_L, -th * dt * c_L, rhs.T).T
    return V


def _smoothed_payoffs(y_np: np.ndarray, S0: float) -> np.ndarray:
    """(n_y+1, 2) host-f64 (call, put) payoffs with the kink node replaced
    by its cell average (Kreiss smoothing); the averages are analytic in
    y."""
    n_y = y_np.size - 1
    K_np = np.exp(y_np)
    V0 = np.stack([np.maximum(S0 - K_np, 0.0),
                   np.maximum(K_np - S0, 0.0)], axis=-1)
    dy = y_np[1] - y_np[0]
    x0 = np.log(S0)
    jk = int(np.clip(np.round((x0 - y_np[0]) / dy), 1, n_y - 1))
    a_c, b_c = y_np[jk] - 0.5 * dy, y_np[jk] + 0.5 * dy
    if a_c < x0 <= b_c:
        V0[jk, 0] = (S0 * (x0 - a_c) - (S0 - np.exp(a_c))) / dy
        V0[jk, 1] = (np.exp(b_c) - S0 - S0 * (b_c - x0)) / dy
    elif b_c <= x0:   # cell fully ITM for the call
        V0[jk, 0] = S0 - (np.exp(b_c) - np.exp(a_c)) / dy
    else:             # cell fully ITM for the put
        V0[jk, 1] = (np.exp(b_c) - np.exp(a_c)) / dy - S0
    return V0


def dupire_forward_surface(S0: float, r: float, q: float = 0.0, *,
                           T: float, sigma: float | None = None,
                           sigma_loc: Callable | None = None,
                           n_y: int = 512, n_t: int = 256,
                           y_mult: float = 6.0, theta: float = 0.5,
                           rannacher: int = 2,
                           dtype=None, device=None) -> ForwardSurface:
    """March the Dupire forward equation once; return the whole surface.

    Exactly one of ``sigma`` (constant vol, the propagator path) or
    ``sigma_loc`` (a torch ``(K, t) -> σ`` callable evaluated on the march
    device, e.g. ``calibration.dupire_local_vol_func``; the per-step
    solve) must be given. The strike grid spans ln(S0) ± ``y_mult``·σ_ref·√T
    with σ_ref ``sigma`` or the callable at (S0, T/2).
    """
    if (sigma is None) == (sigma_loc is None):
        raise ValueError("give exactly one of sigma= or sigma_loc=")
    if T <= 0.0:
        raise ValueError(f"T must be positive, got {T}")
    if n_y < 8 or n_t < 1:
        raise ValueError("need n_y >= 8 and n_t >= 1")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dt_, device=dev)

    if sigma is not None:
        sigma_ref = float(sigma)
    else:
        sigma_ref = float(torch.mean(torch.as_tensor(
            sigma_loc(t([float(S0)]), 0.5 * T)).double()))
    width = y_mult * sigma_ref * np.sqrt(T)
    y_np = np.linspace(np.log(S0) - width, np.log(S0) + width, n_y + 1)
    V0 = t(_smoothed_payoffs(y_np, S0))

    if sigma is not None:
        V = _forward_march_prop(
            y_np, V0, float(T) / n_t, float(S0), float(r), float(q),
            float(sigma), float(theta), n_t=n_t, rannacher=int(rannacher))
    else:
        V = _forward_march(t(y_np), V0, t(T / n_t), t(S0), t(r), t(q),
                           float(theta), n_t=n_t, sigma_func=sigma_loc,
                           rannacher=int(rannacher))

    V_np = V.cpu().numpy().astype(np.float64)
    T_np = np.linspace(0.0, T, n_t + 1)
    K_np = np.exp(y_np)
    # parity-stitch in host f64: the OTM column everywhere, the ITM side
    # from C − P = S0·e^{−qT} − K·e^{−rT}
    G = (S0 * np.exp(-q * T_np)[:, None]
         - K_np[None, :] * np.exp(-r * T_np)[:, None])
    otm_call = K_np[None, :] >= S0 * np.exp((r - q) * T_np)[:, None]
    C_grid = np.where(otm_call, V_np[..., 0], V_np[..., 1] + G)
    P_grid = np.where(otm_call, V_np[..., 0] - G, V_np[..., 1])
    return ForwardSurface(K=K_np, T=T_np, C=C_grid,
                          S0=float(S0), r=float(r), q=float(q),
                          P=P_grid)


def dupire_forward_price(S0: float, K, T, r: float, q: float = 0.0, *,
                         kind: str = "call", sigma: float | None = None,
                         sigma_loc: Callable | None = None,
                         n_y: int = 512, n_t: int = 256,
                         y_mult: float = 6.0, **kwargs):
    """European price(s) at (K, T) via one forward march to max(T);
    ``K`` / ``T`` broadcast, every maturity rides the same march."""
    T_max = float(np.max(np.asarray(T)))
    fs = dupire_forward_surface(S0, r, q, T=T_max, sigma=sigma,
                                sigma_loc=sigma_loc, n_y=n_y, n_t=n_t,
                                y_mult=y_mult, **kwargs)
    return fs.price(K, T, kind=kind)


def forward_surface_iv(fs: ForwardSurface, K, T, device=None):
    """Implied vols of the marched surface at (K, T) (broadcast), by the
    vectorised Newton solver; entries below intrinsic + ε come back NaN."""
    from ..ops.black_scholes import bs_implied_vol_vec

    K_b, T_b = np.broadcast_arrays(np.atleast_1d(K), np.atleast_1d(T))
    c = fs.price(K_b, T_b)
    iv = bs_implied_vol_vec(fs.S0, K_b.ravel(), T_b.ravel(), fs.r, fs.q,
                            np.ravel(c), "call", device=device)
    iv = iv.cpu().numpy().reshape(K_b.shape)
    return iv if (np.ndim(K) or np.ndim(T)) else float(iv.flat[0])


def reprice_surface_forward(surface, S0: float, r: float, q: float = 0.0,
                            *, n_y: int = 512, n_t: int = 256,
                            y_mult: float = 5.0,
                            k_lo: float = -1.0, k_hi: float = 1.0,
                            n_k: int = 41, device=None) -> dict:
    """Round-trip a calibration: SVI surface → Dupire σ_loc → forward
    march → model IVs at every surface expiry. Returns
    ``{expiry: (K, iv_model, iv_market)}`` on k ∈ [k_lo, k_hi]."""
    from .calibration import dupire_local_vol_func

    sig_fn = dupire_local_vol_func(surface, r, q)
    T_max = float(np.max(surface.expiries))
    fs = dupire_forward_surface(S0, r, q, T=T_max, sigma_loc=sig_fn,
                                n_y=n_y, n_t=n_t, y_mult=y_mult,
                                device=device)
    out = {}
    for T_i in np.asarray(surface.expiries, np.float64):
        F = S0 * np.exp((r - q) * T_i)
        K = F * np.exp(np.linspace(k_lo, k_hi, n_k))
        iv_model = forward_surface_iv(fs, K, np.full_like(K, T_i),
                                      device=device)
        iv_market = np.asarray(surface.iv(torch.as_tensor(K), float(T_i))
                               .cpu(), np.float64)
        out[float(T_i)] = (K, iv_model, iv_market)
    return out

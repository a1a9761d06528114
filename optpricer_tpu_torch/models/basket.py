"""Multi-asset pricing: correlated GBM baskets, spreads, rainbows.

Counterpart of ``optpricer_tpu/models/basket.py``:

* closed forms in float64 torch: :func:`geometric_basket_price` (the exact
  control-variate mean of the arithmetic basket), :func:`margrabe_price`
  (exchange option) and :func:`rainbow_price_stulz` (two-asset min/max
  calls and puts on ``ops/bvn.bvn_cdf``);
* terminal European payoffs by Monte Carlo, :func:`basket_price_mc` and
  the pathwise per-asset Greeks :func:`basket_greeks_mc`: one exact GBM
  terminal map, the correlation applied as one ``z @ cholᵀ`` matmul (the
  reference leaves that product to XLA too), in the working dtype
  (float64 unless ``dtype=`` says otherwise);
* path-dependent payoffs, :func:`basket_exotic_mc`: ``backend="auto"``
  and ``"pallas"`` run the basket path kernel (``ops/basket_mc``, K6) for
  books of at most 16 assets in float32 (``dtype=None`` means the
  kernel's float32 there); ``"xla"`` — and float64 or a wider book under
  ``"auto"`` — runs the torch time loop ``_basket_path_stats`` with the
  per-step ``z @ Lᵀ`` matmul.

The Monte-Carlo cores take their standard normals from a callable, so the
draws (a ``torch.Generator`` on the target device, seeded from ``seed``)
are split from the deterministic map; the JAX package draws from
``jax.random`` keys, whose stream torch does not reproduce, so a seed
gives another sample than the reference's XLA engine. The kernel route
draws the JAX kernel's own Threefry stream. ``mesh=`` (a
:class:`~optpricer_tpu_torch.parallel.mesh.Mesh`) splits the paths over
its devices: the kernel's sharded entry on the kernel route, else each
shard's scan drawing from a generator keyed by (seed, shard index), the
stats summed in mesh order. Every entry point takes ``device=`` (default
``"cuda"``), where a run without a mesh goes.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..dtypes import MC_DTYPE, canonical, resolve_device
from ..ops import stats as stats_ops
from ..ops.basket_mc import (MAX_ASSETS, basket_path_sumstats_kernel,
                             basket_path_sumstats_kernel_sharded)
from .mc_fused import _shards
from .monte_carlo import resolve_seed

__all__ = ["basket_price_mc", "basket_greeks_mc", "basket_exotic_mc",
           "geometric_basket_price", "margrabe_price",
           "rainbow_price_stulz"]

_PAYOFFS = ("basket", "spread", "rainbow_max", "rainbow_min")
_PATH_PAYOFFS = ("asian_basket", "worstof_barrier", "basket_barrier")


def _norm_cdf(x):
    return torch.special.ndtr(x)


def _f64(values, device):
    return [torch.as_tensor(np.asarray(v, np.float64), dtype=torch.float64,
                            device=device) for v in values]


def geometric_basket_price(S0s, weights, K, T, r, qs, sigmas, corr, *,
                           kind="call", device=None):
    """Exact price of a European option on the geometric basket
    ``G = Π S_i^{w_i}`` (weights on the simplex), float64.

    ln G is Gaussian with mean Σw_i(ln S0_i + (r−q_i−σ_i²/2)T) and variance
    T·wᵀΣw (Σ_ij = σ_iσ_jρ_ij), so the price is one Black-Scholes
    evaluation. Control-variate mean of :func:`basket_price_mc`.
    """
    dev = resolve_device(device)
    w, S0s, qs, sigmas, K, T, r, corr = _f64(
        (weights, S0s, qs, sigmas, K, T, r, corr), dev)
    mu = torch.sum(w * (torch.log(S0s) + (r - qs - 0.5 * sigmas ** 2) * T))
    cov = sigmas[:, None] * corr * sigmas[None, :]
    var = T * w @ cov @ w
    sig = torch.sqrt(var)
    df = torch.exp(-r * T)
    F = torch.exp(mu + 0.5 * var)
    d2 = (mu - torch.log(K)) / sig
    d1 = d2 + sig
    call = df * (F * _norm_cdf(d1) - K * _norm_cdf(d2))
    put = df * (K * _norm_cdf(-d2) - F * _norm_cdf(-d1))
    return call if kind == "call" else put


def margrabe_price(S1, S2, T, q1=0.0, q2=0.0, *, sigma1, sigma2, rho,
                   device=None):
    """Margrabe (1978) exchange option E[e^{−rT}·max(S1_T − S2_T, 0)],
    float64 — rate-free; the exact oracle of the 2-asset ``spread`` at
    K = 0."""
    dev = resolve_device(device)
    S1, S2, T, q1, q2 = _f64((S1, S2, T, q1, q2), dev)
    sig = math.sqrt(sigma1 ** 2 + sigma2 ** 2 - 2.0 * rho * sigma1 * sigma2)
    st = sig * torch.sqrt(T)
    d1 = (torch.log(S1 / S2) + (q2 - q1) * T) / st + 0.5 * st
    d2 = d1 - st
    return S1 * torch.exp(-q1 * T) * _norm_cdf(d1) \
        - S2 * torch.exp(-q2 * T) * _norm_cdf(d2)


def rainbow_price_stulz(S1, S2, K, T, r, q1=0.0, q2=0.0, *, sigma1, sigma2,
                        rho, kind: str = "call", mode: str = "min",
                        device=None):
    """Stulz (1982) closed form for two-asset rainbow options: calls and
    puts on min(S1_T, S2_T) or max(S1_T, S2_T), strike K, float64.

    Built from bivariate-normal rectangles (``ops/bvn.bvn_cdf``) with the
    identities C_max = C₁ + C₂ − C_min and the rainbow put-call parity
    P = K·e^{−rT} − C(K→0) + C(K) (K clamped to 1e-12). A float for scalar
    inputs.
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if mode not in ("min", "max"):
        raise ValueError("mode must be 'min' or 'max'")
    from ..ops.bvn import bvn_cdf

    dev = resolve_device(device)
    S1, S2, K, T, r, q1, q2, s1, s2, rho_ = _f64(
        (S1, S2, K, T, r, q1, q2, sigma1, sigma2, rho), dev)
    K = torch.clamp(K, min=1e-12)
    sqT = torch.sqrt(T)
    sig = torch.sqrt(torch.clamp(s1 * s1 + s2 * s2 - 2.0 * rho_ * s1 * s2,
                                 min=1e-30))
    b1 = r - q1
    b2 = r - q2
    d = (torch.log(S1 / S2) + (b1 - b2 + 0.5 * sig * sig) * T) / (sig * sqT)
    y1 = (torch.log(S1 / K) + (b1 + 0.5 * s1 * s1) * T) / (s1 * sqT)
    y2 = (torch.log(S2 / K) + (b2 + 0.5 * s2 * s2) * T) / (s2 * sqT)
    rho1 = (s1 - rho_ * s2) / sig
    rho2 = (s2 - rho_ * s1) / sig
    df = torch.exp(-r * T)
    f1 = S1 * torch.exp(-q1 * T)
    f2 = S2 * torch.exp(-q2 * T)

    def c_min(K_, y1_, y2_):
        return (f1 * bvn_cdf(y1_, -d, -rho1)
                + f2 * bvn_cdf(y2_, d - sig * sqT, -rho2)
                - K_ * df * bvn_cdf(y1_ - s1 * sqT, y2_ - s2 * sqT, rho_))

    cmin = c_min(K, y1, y2)
    if mode == "min" and kind == "call":
        out = cmin
    else:
        # the single-asset legs of C_max share the same primitives
        c1 = price_core_bs(S1, K, T, r, q1, s1)
        c2 = price_core_bs(S2, K, T, r, q2, s2)
        cmax = c1 + c2 - cmin
        if kind == "call":
            out = cmax
        else:
            big = torch.tensor(1e-12, dtype=torch.float64, device=dev)
            yb1 = (torch.log(S1 / big) + (b1 + 0.5 * s1 * s1) * T) \
                / (s1 * sqT)
            yb2 = (torch.log(S2 / big) + (b2 + 0.5 * s2 * s2) * T) \
                / (s2 * sqT)
            cmin0 = c_min(big, yb1, yb2)
            if mode == "min":
                out = K * df - cmin0 + cmin
            else:
                cmax0 = f1 + f2 - cmin0
                out = K * df - cmax0 + cmax
    return float(out) if out.ndim == 0 else out


def price_core_bs(S, K, T, r, q, sigma):
    """Vanilla Black-Scholes call on tensors, in their dtype."""
    st = sigma * torch.sqrt(T)
    d1 = (torch.log(S / K) + (r - q + 0.5 * sigma * sigma) * T) / st
    return S * torch.exp(-q * T) * _norm_cdf(d1) \
        - K * torch.exp(-r * T) * _norm_cdf(d1 - st)


# ---------------------------------------------------------------------------
# Monte-Carlo cores (normals injected)
# ---------------------------------------------------------------------------
def _anti(z: torch.Tensor, antithetic: bool) -> torch.Tensor:
    return torch.cat([z, -z], dim=0) if antithetic else z


def _basket_stats(z, S0s, w, K, T, r, qs, sigmas, chol, *, payoff: str,
                  is_call: bool, antithetic: bool) -> torch.Tensor:
    """(6,) control-variate sums of one scenario batch from the (n, a)
    standard normals ``z``: X = discounted payoff, Y = discounted
    geometric-basket payoff (the control; zero when the payoff has no
    geometric twin)."""
    x = _anti(z, antithetic) @ chol.T                 # correlate
    drift = (r - qs - 0.5 * sigmas ** 2) * T
    logS = torch.log(S0s)[None, :] + drift[None, :] \
        + (sigmas * torch.sqrt(T))[None, :] * x
    S = torch.exp(logS)                               # (n_eff, a)
    sign = 1.0 if is_call else -1.0
    if payoff in ("basket", "spread"):
        pay = torch.clamp(sign * (S @ w - K), min=0.0)
    elif payoff == "rainbow_max":
        pay = torch.clamp(sign * (torch.amax(S, dim=1) - K), min=0.0)
    else:                                             # rainbow_min
        pay = torch.clamp(sign * (torch.amin(S, dim=1) - K), min=0.0)
    df = torch.exp(-r * T)
    X = df * pay
    if payoff == "basket":
        G = torch.exp(logS @ w)                       # geometric basket
        Y = df * torch.clamp(sign * (G - K), min=0.0)
    else:
        Y = torch.zeros_like(X)
    n = torch.tensor(float(X.numel()), dtype=X.dtype, device=X.device)
    return torch.stack([n, torch.sum(X), torch.sum(X * X), torch.sum(Y),
                        torch.sum(Y * Y), torch.sum(X * Y)])


def _basket_path_stats(normals: Callable, S0s, w, K, T, r, qs, sigmas, chol,
                       barrier, rebate, *, payoff: str, is_call: bool,
                       n_steps: int, antithetic: bool, barrier_up: bool,
                       knock_in: bool) -> torch.Tensor:
    """(6,) control-variate sums for a path-dependent multi-asset payoff:
    a loop over the steps with the per-step correlation ``z @ Lᵀ`` and an
    O(n_paths·n_assets) state (log-spots and the payoff aggregates).
    ``normals(t)`` gives step t's (n_paths, a) standard normals.
    Y = discounted terminal basket value, the model-free control with
    E[Y] = Σw_i·S0_i·e^{−q_i T}."""
    dt = T / n_steps
    sqdt = torch.sqrt(dt)
    drift = (r - qs - 0.5 * sigmas ** 2) * dt
    voldt = sigmas * sqdt
    sign = 1.0 if is_call else -1.0

    logS = torch.log(S0s)
    B0 = S0s @ w
    lvl0 = B0 if payoff == "basket_barrier" else torch.min(S0s)
    crossed0 = (lvl0 >= barrier) if barrier_up else (lvl0 <= barrier)

    run_sum = None
    crossed = None
    for t in range(n_steps):
        x = _anti(normals(t), antithetic) @ chol.T
        logS = logS + drift[None, :] + voldt[None, :] * x
        S = torch.exp(logS)
        B = S @ w
        run_sum = B if run_sum is None else run_sum + B
        lvl = B if payoff == "basket_barrier" else torch.amin(S, dim=1)
        hit = (lvl >= barrier) if barrier_up else (lvl <= barrier)
        crossed = (crossed0 | hit) if crossed is None else (crossed | hit)
    S_T = torch.exp(logS)
    B_T = S_T @ w

    def vanilla(v):
        return torch.clamp(sign * (v - K), min=0.0)

    if payoff == "asian_basket":
        pay = vanilla(run_sum / n_steps)           # t = 0 excluded
    else:
        live = vanilla(torch.amin(S_T, dim=1)
                       if payoff == "worstof_barrier" else B_T)
        reb = rebate.expand_as(live)
        pay = torch.where(crossed, live if knock_in else reb,
                          reb if knock_in else live)
    df = torch.exp(-r * T)
    X = df * pay
    Y = df * B_T
    n = torch.tensor(float(X.numel()), dtype=X.dtype, device=X.device)
    return torch.stack([n, torch.sum(X), torch.sum(X * X), torch.sum(Y),
                        torch.sum(Y * Y), torch.sum(X * Y)])


def _basket_greek_moments(z, S0s, w, K, T, r, qs, sigmas, chol, *,
                          payoff: str, is_call: bool,
                          antithetic: bool) -> torch.Tensor:
    """Per-scenario pathwise observables from the (n, a) normals ``z``:
    X plus per-asset delta and vega. For basket/spread
    ∂pay/∂S0_i = sign·1{ITM}·w_i·S_i/S0_i and
    ∂pay/∂σ_i = sign·1{ITM}·w_i·S_i·(√T x_i − σ_i T); for rainbows the
    active asset is the arg-extremum. Returns (3 + 4a,) sums:
    [n, ΣX, ΣX², ΣD_1.., ΣD²_1.., ΣV_1.., ΣV²_1..]."""
    dt_ = z.dtype
    x = _anti(z, antithetic) @ chol.T
    drift = (r - qs - 0.5 * sigmas ** 2) * T
    logS = torch.log(S0s)[None, :] + drift[None, :] \
        + (sigmas * torch.sqrt(T))[None, :] * x
    S = torch.exp(logS)
    sign = 1.0 if is_call else -1.0
    if payoff in ("basket", "spread"):
        A = S @ w
        itm = (sign * (A - K) > 0.0).to(dt_)
        pay = torch.clamp(sign * (A - K), min=0.0)
        dpay_dS = sign * itm[:, None] * w[None, :]    # ∂pay/∂S_i
    else:
        A = torch.amax(S, dim=1) if payoff == "rainbow_max" \
            else torch.amin(S, dim=1)
        itm = (sign * (A - K) > 0.0).to(dt_)
        pay = torch.clamp(sign * (A - K), min=0.0)
        active = (S == A[:, None]).to(dt_)
        dpay_dS = sign * itm[:, None] * active
    df = torch.exp(-r * T)
    X = df * pay
    D = df * dpay_dS * S / S0s[None, :]               # (n, a) deltas
    V = df * dpay_dS * S * (torch.sqrt(T) * x
                            - (sigmas * T)[None, :])  # (n, a) vegas
    head = torch.stack([torch.tensor(float(X.numel()), dtype=dt_,
                                     device=X.device),
                        torch.sum(X), torch.sum(X * X)])
    return torch.cat([head, torch.sum(D, dim=0), torch.sum(D * D, dim=0),
                      torch.sum(V, dim=0), torch.sum(V * V, dim=0)])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _book(S0s, weights, qs, sigmas, corr):
    """Host float64 (S0s, w, qs, sig, corr) with the reference's checks."""
    S0s = np.atleast_1d(np.asarray(S0s, np.float64))
    a = S0s.size
    w = np.atleast_1d(np.asarray(weights, np.float64))
    qs = np.zeros(a) if qs is None else np.atleast_1d(
        np.asarray(qs, np.float64))
    sig = np.atleast_1d(np.asarray(sigmas, np.float64))
    corr = np.asarray(corr, np.float64)
    if not (w.shape == qs.shape == sig.shape == (a,)) \
            or corr.shape != (a, a):
        raise ValueError("S0s, weights, qs, sigmas must be length-a "
                         "vectors and corr an (a, a) matrix")
    return S0s, w, qs, sig, corr


def _generator(seed, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        resolve_seed(seed) % 2**63)


def basket_price_mc(S0s, weights, K, T, r, qs=None, *, sigmas, corr,
                    payoff: str = "basket", kind: str = "call",
                    n_paths: int = 262_144, antithetic: bool = True,
                    control_variate: bool = True, seed=None, dtype=None,
                    mesh=None, device=None):
    """European multi-asset option by correlated-GBM Monte Carlo.

    ``payoff``: ``"basket"`` (weights on the simplex, with the exact
    geometric-basket control variate unless ``control_variate=False``),
    ``"spread"`` (signed weights; (1, −1) and K = 0 is Margrabe's exchange
    option), ``"rainbow_max"`` / ``"rainbow_min"``. Returns
    ``(price, stderr)``.
    """
    if payoff not in _PAYOFFS:
        raise ValueError(f"payoff must be one of {_PAYOFFS}")
    from ..parallel.mesh import mesh_sum

    dt_ = canonical(dtype)
    dev = resolve_device(device) if mesh is None else mesh.device_list[0]
    S0s, w, qs, sig, corr = _book(S0s, weights, qs, sigmas, corr)
    a = S0s.size
    if payoff == "basket" and (np.any(w < 0.0)
                               or abs(w.sum() - 1.0) > 1e-9):
        raise ValueError("basket weights must be non-negative and sum to "
                         "1 (use payoff='spread' for signed weights)")
    chol = np.linalg.cholesky(corr)  # raises on non-PSD input
    use_cv = bool(control_variate) and payoff == "basket"
    geo_ey = None
    if use_cv:
        geo_ey = float(geometric_basket_price(S0s, w, K, T, r, qs, sig, corr,
                                              kind=kind, device=dev))
    parts = []
    for dev_d, gen, n_local in _shards(mesh, resolve_seed(seed), n_paths,
                                       dev):
        args = [torch.as_tensor(v, dtype=dt_, device=dev_d)
                for v in (S0s, w, K, T, r, qs, sig, chol)]
        z = torch.randn((n_local, a), generator=gen, dtype=dt_,
                        device=dev_d)
        parts.append(_basket_stats(z, *args, payoff=payoff,
                                   is_call=kind == "call",
                                   antithetic=bool(antithetic)))
    s = mesh_sum(parts).detach().cpu().numpy().astype(np.float64)
    if use_cv:
        mean, se = stats_ops.cv_mean_se_np(s, geo_ey)
        return mean, max(se, 2e-6 * (1.0 + abs(mean)))
    return stats_ops.mean_se(s)


def basket_exotic_mc(S0s, weights, K, T, r, qs=None, *, sigmas, corr,
                     payoff: str = "asian_basket", kind: str = "call",
                     barrier: float = 0.0,
                     barrier_type: str = "down-and-in",
                     rebate: float = 0.0, n_steps: int = 64,
                     n_paths: int = 131_072, antithetic: bool = True,
                     control_variate: bool = True, seed=None, dtype=None,
                     mesh=None, backend: str = "auto", device=None):
    """PATH-DEPENDENT multi-asset pricing: correlated-GBM time stepping.

    ``payoff``: ``"asian_basket"`` (arithmetic average of the basket over
    the ``n_steps`` dates, t = 0 excluded), ``"worstof_barrier"`` (barrier
    on min_i S_i(t), t = 0 included; vanilla on the worst terminal spot)
    or ``"basket_barrier"`` (barrier on Σw_i S_i(t); vanilla on the
    basket); ``barrier_type`` in up/down × in/out. The terminal basket
    value is the control variate (E[Y] model-free); disable with
    ``control_variate=False``. Returns ``(price, stderr)``.

    ``backend``: "auto" runs the basket kernel (K6) for float32 books of
    at most 16 assets and the torch scan otherwise; "pallas" forces the
    kernel (and raises where it cannot run); "xla" forces the scan. On the
    kernel route ``n_paths`` counts antithetic pairs and each
    pair-averaged observation is one sample; the scan pools ±z draws, so
    the two agree statistically and their stderrs differ by design.
    """
    if payoff not in _PATH_PAYOFFS:
        raise ValueError(f"payoff must be one of {_PATH_PAYOFFS}")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    from ..parallel.mesh import mesh_sum

    dev = resolve_device(device) if mesh is None else mesh.device_list[0]
    S0s, w, qs, sig, corr = _book(S0s, weights, qs, sigmas, corr)
    a = S0s.size
    chol = np.linalg.cholesky(corr)
    kernel_dtype = dtype is None or canonical(dtype) == MC_DTYPE
    kernel_ok = a <= MAX_ASSETS and kernel_dtype
    if backend == "pallas" and not kernel_ok:
        raise ValueError("backend='pallas' requires f32 and <=16 assets")
    ey = float(np.sum(w * S0s * np.exp(-qs * float(T))))
    if kernel_ok and backend != "xla":
        call = (resolve_seed(seed), int(n_paths), int(n_steps), S0s, w,
                float(K), float(T), float(r), qs, sig, chol, kind == "call")
        pk = dict(payoff=payoff, antithetic=bool(antithetic),
                  barrier=float(barrier), barrier_type=barrier_type,
                  rebate=float(rebate))
        s = basket_path_sumstats_kernel_sharded(mesh, *call, **pk) \
            if mesh is not None else \
            basket_path_sumstats_kernel(*call, device=dev, **pk)
        s = s.detach().cpu().numpy().astype(np.float64)
        if control_variate:
            mean, se = stats_ops.cv_mean_se_np(s, ey)
            return mean, max(se, 2e-6 * (1.0 + abs(mean)))
        return stats_ops.mean_se(s)

    dt_ = canonical(dtype)
    parts = []
    # the reference keys a shard's stream fold_in(key, 0x8A5E + shard)
    for dev_d, gen, n_local in _shards(mesh, resolve_seed(seed), n_paths,
                                       dev, salt=0x8A5E):
        args = [torch.as_tensor(v, dtype=dt_, device=dev_d)
                for v in (S0s, w, K, T, r, qs, sig, chol, barrier, rebate)]
        parts.append(_basket_path_stats(
            lambda t, g=gen, d=dev_d, n=n_local: torch.randn(
                (n, a), generator=g, dtype=dt_, device=d),
            *args, payoff=payoff, is_call=kind == "call",
            n_steps=int(n_steps), antithetic=bool(antithetic),
            barrier_up=barrier_type.startswith("up"),
            knock_in=barrier_type.endswith("in")))
    s = mesh_sum(parts).detach().cpu().numpy().astype(np.float64)
    # Y = e^{−rT}·B_T and E[B_T] = Σw_i·S0_i·e^{(r−q_i)T}, so
    # E[Y] = Σw_i·S0_i·e^{−q_i T} — model-free under any Q drift
    if control_variate:
        return stats_ops.cv_mean_se_np(s, ey)
    return stats_ops.mean_se(s)


def basket_greeks_mc(S0s, weights, K, T, r, qs=None, *, sigmas, corr,
                     payoff: str = "basket", kind: str = "call",
                     n_paths: int = 262_144, antithetic: bool = True,
                     seed=None, dtype=None, device=None):
    """Price plus per-asset pathwise delta and vega vectors from ONE run.

    Returns ``{"price", "stderr", "delta", "delta_stderr", "vega",
    "vega_stderr"}`` with the Greek entries length-a numpy arrays.
    """
    if payoff not in _PAYOFFS:
        raise ValueError(f"payoff must be one of {_PAYOFFS}")
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0s, w, qs, sig, corr = _book(S0s, weights, qs, sigmas, corr)
    a = S0s.size
    chol = np.linalg.cholesky(corr)
    args = [torch.as_tensor(v, dtype=dt_, device=dev)
            for v in (S0s, w, K, T, r, qs, sig, chol)]
    z = torch.randn((int(n_paths), a), generator=_generator(seed, dev),
                    dtype=dt_, device=dev)
    s = _basket_greek_moments(z, *args, payoff=payoff,
                              is_call=kind == "call",
                              antithetic=bool(antithetic))
    s = s.detach().cpu().numpy().astype(np.float64)
    n = s[0]
    mX = s[1] / n
    seX = np.sqrt(max(0.0, s[2] / n - mX * mX) / n)

    def _vec(lo):
        m = s[lo:lo + a] / n
        v = np.maximum(0.0, s[lo + a:lo + 2 * a] / n - m * m)
        return m, np.sqrt(v / n)

    delta, delta_se = _vec(3)
    vega, vega_se = _vec(3 + 2 * a)
    return {"price": float(mX), "stderr": float(seX),
            "delta": delta, "delta_stderr": delta_se,
            "vega": vega, "vega_stderr": vega_se}

"""Fused path-dependent Monte-Carlo pricing: ``exotic_price_mc``,
``exotic_price_mc_dupire`` and ``exotic_greeks_mc``.

Counterpart of ``optpricer_tpu/models/mc_fused.py``. Every price comes from
sufficient statistics reduced on the device and a float64 estimator on the
host:

* ``backend="auto"`` and ``"pallas"`` run the path kernel
  (``ops/path_mc.path_mc``, 21 stats) under GBM (``sigma=``), Heston
  (``heston=``, full-truncation Euler or Andersen QE with ``scheme="qe"``)
  or SABR (``sabr=``, β = 1 log-Euler or β < 1 clamped Euler), with the
  dual control variate under GBM, the spot control variate under
  stochastic volatility and, for the fixed-strike arithmetic Asian under
  GBM, the geometric-Asian control variate;
* ``backend="qmc"`` runs the fused path-QMC kernel (``ops/qmc_path``,
  Sobol + Brownian bridge, 8 digitally shifted replicates) under GBM;
* ``exotic_greeks_mc`` under GBM runs the path kernel with its Greek
  moments and reads price, delta, gamma, vega, rho and theta from one run;
* ``exotic_price_mc_dupire`` ships a calibrated surface's SVI slices into
  the path kernel, which evaluates the Dupire σ(S, t) in registers
  (log-Euler or Milstein), with the spot control variate.

**Seed semantics.** The path kernel is bit-reproducible given
``(seed, n_paths, n_steps, antithetic)`` and draws exactly the JAX path
kernel's ``sw_prng`` stream (Threefry keyed by seed and global program id),
so a seed prices the same sample here as JAX
``exotic_price_mc(..., backend="pallas")`` does on the CPU, where that
kernel runs in interpret mode. It is not the sample of the JAX package's
XLA scan engine (``jax.random`` keys), which is not ported. The QMC
backend randomises the reference's Sobol point set with the reference's
digital shifts, so a seed gives the JAX path-QMC kernel's replicates.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``sigma_loc=`` (a Dupire closure, which the reference prices on its
XLA scan only; ``exotic_price_mc_dupire`` is the kernel route), ``merton=``, ``vg=``, ``nig=``,
``scheme="exact"``, ``dividends=``, ``mesh=``, ``backend="xla"``, an odd
``n_steps`` (the reference sends it to the XLA scan), a ``dtype`` other
than float32 (the f64 XLA engine), and ``exotic_greeks_mc`` under non-GBM
dynamics (the reference's pathwise-AD Greeks). Nothing is routed quietly
to another engine.

Returns ``(price, stderr)`` like the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..dtypes import canonical
from ..ops import stats as stats_ops
from ..ops.fastmath import exp32, log32
from ..ops.path_mc import path_mc_sumstats_kernel
from ..ops.qmc_path import path_qmc_sumstats_kernel, qmc_path_estimate
from ..ops.terminal_mc import terminal_estimate
from .analytic import geometric_asian_price_f64
from .monte_carlo import resolve_seed

__all__ = ["exotic_price_mc", "exotic_price_mc_dupire", "exotic_greeks_mc"]

_PAYOFFS = ("vanilla", "barrier", "asian", "digital", "lookback")
# payoffs whose pathwise delta the homogeneity argument covers; barrier and
# digital payoffs are discontinuous and use likelihood-ratio estimators
_PATHWISE_OK = ("vanilla", "asian", "lookback")
_LR_OK = ("barrier", "digital")
_BACKENDS = ("auto", "pallas", "qmc")


def _exp_for(dtype):
    """exp for the engine dtype: the bias-free ``exp32`` in float32 (the
    kernels' and the reference's f32 choice), ``torch.exp`` otherwise."""
    return exp32 if dtype == torch.float32 else torch.exp


def _log_for(dtype):
    return log32 if dtype == torch.float32 else torch.log


class _Sqrt0(torch.autograd.Function):
    """sqrt with subgradient 0 at x == 0.

    Full-truncation Heston parks variance exactly at 0 with positive
    probability; there the chain rule meets sqrt'(0) = ∞ against a zero
    tangent and pathwise AD returns NaN. The one-sided derivative from the
    truncated region is 0, the reference's custom JVP. Forward mode
    (``jvp``) serves ``torch.func.jacfwd``, which vmaps it."""

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

    def vanilla(ST):
        return torch.clamp(ST - K, min=0.0) if is_call \
            else torch.clamp(K - ST, min=0.0)

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
        return (torch.clamp(S - avg, min=0.0) if is_call
                else torch.clamp(avg - S, min=0.0))
    if payoff == "lookback":
        if strike_type == "floating":
            return (S - run_min) if is_call else (run_max - S)
        return (torch.clamp(run_max - K, min=0.0) if is_call
                else torch.clamp(K - run_min, min=0.0))
    raise ValueError(f"unknown payoff {payoff!r}")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _check_dtype(dtype) -> None:
    if dtype is not None and canonical(dtype) != torch.float32:
        raise _not_ported(f"dtype={dtype!r} (the f64 XLA scan engine; the "
                          "kernels are float32)", "A.10")


def _check_kernel_route(backend: str, n_steps: int, mesh) -> None:
    if mesh is not None:
        raise _not_ported("mesh=", "A.15, parallel/")
    if backend == "xla":
        raise _not_ported("backend='xla' (the fused XLA scan engine)",
                          "A.10")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS + ('xla',)}, "
                         f"got {backend!r}")
    if backend != "qmc" and int(n_steps) % 2:
        raise _not_ported(
            "an odd n_steps (the reference prices it on the XLA scan "
            "engine; the path kernel advances two steps per draw)", "A.10")


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
    constant ``sigma`` (exact GBM step),
    ``heston={'v0','kappa','theta','xi','rho'}`` (full-truncation Euler
    variance + log-Euler asset, or Andersen QE with ``scheme="qe"``) or
    ``sabr={'alpha0','beta','nu','rho'}`` (exact lognormal σ, log-Euler
    asset for β = 1, clamped Euler for β < 1).

    ``control_variate``: dual CV under GBM, spot CV under stochastic
    volatility, the geometric-Asian CV for the fixed-strike arithmetic
    Asian under GBM. ``backend="qmc"``: ``n_paths`` points per replicate,
    8 replicates, GBM only. ``device`` (default ``"cuda"``; ``"cpu"`` runs
    the kernels' plain versions). See the module docstring for the seed
    semantics and for what is not ported.
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
    for given, what, item in (
            (sigma_loc is not None, "sigma_loc= (a Dupire closure, which "
             "the reference prices on its XLA scan engine; the kernel route "
             "of A.9 is exotic_price_mc_dupire)", "A.10"),
            (merton is not None, "merton= (jump diffusion)", "A.10"),
            (vg is not None, "vg= (variance gamma)", "A.10, A.13"),
            (nig is not None, "nig= (normal inverse Gaussian)",
             "A.10, A.13"),
            (scheme == "exact", "scheme='exact' (the exact CEV sampler)",
             "A.10"),
            (bool(dividends), "dividends=", "A.10")):
        if given:
            raise _not_ported(what, item)
    _check_kernel_route(backend, n_steps, mesh)
    _check_dtype(dtype)
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if scheme == "qe" and heston is None:
        raise ValueError("scheme='qe' is the Andersen QE Heston scheme — "
                         "it requires heston=")
    seed_val = resolve_seed(seed)

    # the fixed-strike arithmetic Asian under GBM takes the geometric-Asian
    # payoff as its control variate: corr ≈ 1 and E[Y_geo] is exact
    use_geo_cv = (bool(control_variate) and payoff == "asian"
                  and average_type == "arithmetic"
                  and strike_type == "fixed" and heston is None
                  and sabr is None)
    geo_ey = None
    if use_geo_cv:
        geo_ey = geometric_asian_price_f64(S0, K, T, r, q, sigma, kind=kind,
                                           n_steps=int(n_steps))

    if backend == "qmc":
        if sigma is None:
            raise ValueError("backend='qmc' supports GBM dynamics (sigma=)")
        stats = path_qmc_sumstats_kernel(
            seed_val, int(n_paths), int(n_steps), S0, K, T, r, q, sigma,
            kind == "call", payoff=payoff, n_replicates=8, barrier=barrier,
            barrier_type=barrier_type, rebate=rebate,
            average_type=average_type, strike_type=strike_type,
            payout=payout, device=device)
        return qmc_path_estimate(stats, S0, q, T,
                                 control_variate=bool(control_variate))

    stats_vec = path_mc_sumstats_kernel(
        seed_val, int(n_paths), int(n_steps), S0, K, T, r, q, sigma,
        kind == "call", payoff=payoff, antithetic=bool(antithetic),
        barrier=barrier, barrier_type=barrier_type, rebate=rebate,
        average_type=average_type, strike_type=strike_type, payout=payout,
        scheme=scheme, dS_bump=dS_bump, heston=heston, sabr=sabr,
        geo_cv=use_geo_cv, device=device)
    dynamics = "gbm" if (heston is None and sabr is None) else "sv"
    return _estimate_from_stats(stats_vec, S0, K, T, r, q, sigma,
                                kind == "call", dynamics, control_variate,
                                geo_ey=geo_ey)


def exotic_price_mc_dupire(payoff: str, surface, S0, K, T, r, q=0.0, *,
                           scheme: str = "milstein", backend: str = "auto",
                           control_variate: bool = False, **kwargs):
    """Path-dependent pricing under Dupire local vol from a calibrated
    :class:`~optpricer_tpu_torch.models.calibration.VolSurface`.

    The surface's SVI slices ship into the path kernel as its f32
    (6, n_slices) table and σ(S, t) is Gatheral's formula evaluated in
    registers, with the analytic forward S0·e^{(r−q)t}; ``scheme`` is
    ``"milstein"`` (σ′ by a central bump ``dS_bump``) or anything else for
    log-Euler. ``backend`` "auto" and "pallas" take the kernel; the
    reference's other routes (its XLA scan with a traced closure) raise
    ``NotImplementedError``, as does an odd ``n_steps``. Accepts
    :func:`exotic_price_mc`'s payoff kwargs and ``device=``. The control
    variate is the spot one, E[e^{−rT}S_T] = S0·e^{−qT}, which holds under
    any risk-neutral dynamics.
    """
    if payoff not in _PAYOFFS:
        raise ValueError(f"payoff must be one of {_PAYOFFS}, got {payoff!r}")
    n_steps = int(kwargs.get("n_steps", 252))
    _check_kernel_route("xla" if backend == "qmc" else backend, n_steps,
                        kwargs.get("mesh"))
    _check_dtype(kwargs.get("dtype"))
    kind = kwargs.get("kind", "call")
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    stats_vec = path_mc_sumstats_kernel(
        resolve_seed(kwargs.get("seed")), int(kwargs.get("n_paths", 100_000)),
        n_steps, S0, K, T, r, q, None, kind == "call", payoff=payoff,
        antithetic=bool(kwargs.get("antithetic", True)),
        barrier=kwargs.get("barrier", 0.0),
        barrier_type=kwargs.get("barrier_type", "up-and-out"),
        rebate=kwargs.get("rebate", 0.0),
        average_type=kwargs.get("average_type", "arithmetic"),
        strike_type=kwargs.get("strike_type", "fixed"),
        payout=kwargs.get("payout", 1.0), svi_slices=surface.svi_table(),
        scheme=scheme,
        dS_bump=kwargs.get("dS_bump", 0.01), device=kwargs.get("device"))
    return _estimate_from_stats(stats_vec, S0, K, T, r, q, 0.0,
                                kind == "call", "local_vol", control_variate)


def exotic_greeks_mc(payoff: str, S0, K, T, r, q=0.0, *, kind: str = "call",
                     strike_type: str = "fixed", **kwargs) -> dict:
    """Price + delta, gamma, vega, rho and theta from ONE path-kernel run
    (GBM, ``sigma=``).

    Continuous payoffs (vanilla, asian, lookback) take pathwise vega, rho
    and theta through each payoff's smooth inner argument; under GBM every
    running statistic is degree-1 homogeneous in S0, so
    delta = (E[X] + sign·K_eff·E[Y3])/S0 (K_eff = K fixed, 0 floating), and
    gamma is the mixed pathwise-LR estimator on that delta observable.
    Barrier and digital payoffs are discontinuous and take
    likelihood-ratio estimators from the scores of (z₁, W, Σz²) for all
    five Greeks. Theta is −dV/dT.

    Accepts ``exotic_price_mc``'s kwargs (and ``device=``). Returns
    ``{"price", "stderr", "delta", "gamma", "gamma_stderr", "vega",
    "vega_stderr", "rho", "rho_stderr", "theta", "theta_stderr",
    "exercise_prob"}`` (plus ``delta_stderr`` on the LR payoffs).
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
        raise _not_ported("exotic_greeks_mc under non-GBM dynamics (the "
                          "pathwise-AD Greeks)", "A.10")
    if kwargs.get("sigma") is None:
        raise ValueError(
            "exotic_greeks_mc needs dynamics: sigma= (GBM) or one of "
            "heston=/sabr=/merton=/sigma_loc=")
    n_steps = int(kwargs.get("n_steps", 252))
    backend = kwargs.get("backend", "auto")
    # the reference takes its XLA engine for any backend but the kernel's
    _check_kernel_route("xla" if backend == "qmc" else backend, n_steps,
                        kwargs.get("mesh"))
    _check_dtype(kwargs.get("dtype"))

    sigma = kwargs["sigma"]
    seed_val = resolve_seed(kwargs.get("seed"))
    control_variate = bool(kwargs.get("control_variate", False))
    use_lr = payoff in _LR_OK
    raw = path_mc_sumstats_kernel(
        seed_val, int(kwargs.get("n_paths", 100_000)), n_steps, S0, K, T, r,
        q, sigma, kind == "call", payoff=payoff,
        antithetic=bool(kwargs.get("antithetic", True)),
        average_type=kwargs.get("average_type", "arithmetic"),
        strike_type=strike_type,
        barrier=float(kwargs.get("barrier", 0.0)),
        barrier_type=kwargs.get("barrier_type", "up-and-out"),
        rebate=float(kwargs.get("rebate", 0.0)),
        payout=float(kwargs.get("payout", 1.0)), greek_stats=True,
        device=kwargs.get("device"))
    s = raw.detach().cpu().numpy().astype(np.float64)

    def _mom(i, n):
        m = s[i] / n
        return float(m), float(np.sqrt(max(0.0, s[i + 1] / n - m * m) / n))

    n, mY3 = s[0], s[10] / s[0]
    price, se = _estimate_from_stats(s, S0, K, T, r, q, sigma,
                                     kind == "call", "gbm", control_variate)
    vega, vega_se = _mom(11, n)
    rho, rho_se = _mom(13, n)
    theta, theta_se = _mom(15, n)
    lr_delta, lr_delta_se = _mom(17, n)
    gamma, gamma_se = _mom(19, n)
    out = {"price": float(price), "stderr": float(se),
           "gamma": gamma, "gamma_stderr": gamma_se,
           "vega": vega, "vega_stderr": vega_se,
           "rho": rho, "rho_stderr": rho_se,
           "theta": theta, "theta_stderr": theta_se,
           "exercise_prob": float(mY3 * np.exp(r * T))}
    if use_lr:
        out["delta"] = lr_delta
        out["delta_stderr"] = lr_delta_se
    else:
        sign = 1.0 if kind == "call" else -1.0
        K_eff = 0.0 if strike_type == "floating" else K
        # the CV-corrected price in the E[X] slot when asked
        out["delta"] = float((price + sign * K_eff * mY3) / S0)
    return out

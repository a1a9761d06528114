"""Multilevel Monte Carlo (Giles 2008) for path-dependent options.

Counterpart of ``optpricer_tpu/models/mlmc.py``. MLMC estimates the
continuous-monitoring / exact-transition limit at a target RMSE ``eps``
by the telescoping sum E[P_L] = E[P_0] + Σ_l E[P_l − P_{l−1}], each
correction priced on COUPLED fine/coarse paths driven by the same
Brownian increments (a coarse step consumes the scaled sum of its M fine
normals), so Var[P_l − P_{l−1}] decays with the level and most samples run
on the cheap coarse grids.

* The level estimator :func:`_level_y` is a deterministic core: fine step
  k's normals come from ``draw(k)``, called once a step in step order, so
  a chunk holds one fine step's draws at a time. A chunk's draws come from
  a generator keyed by (seed, level, chunk) (``monte_carlo.
  keyed_generator``, two nested folds: no bit-packed id that could alias
  across levels), so a result does not depend on the order chunks run in;
  torch does not reproduce ``jax.random``'s stream, so a seed gives
  another sample than the reference's.
* ``greeks=True`` differentiates each level's estimator in forward mode
  (``torch.func.jacfwd`` over the named parameters), the chunk's draws
  made before the differentiated function.
* The Giles loop runs on the host and reads each chunk's statistics back
  (the allocation needs them).
* ``mesh=`` splits a chunk's paths over the mesh's devices, each shard on
  the stream (seed, level, chunk, shard index), the stats summed in mesh
  order (``parallel.mesh.mesh_sum``).

float64 unless ``dtype=`` says otherwise; ``device=`` (default ``"cuda"``)
says where a run without a mesh goes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtypes import canonical, resolve_device
from .mc_fused import _exp_for, _log_for, _sqrt0, _terminal_payoff
from .monte_carlo import keyed_generator, resolve_seed

__all__ = ["mlmc_price"]


def _level_y(draw, fixed, *, payoff, kind, model_kind, n_coarse, M,
             n_paths, antithetic, barrier_type, average_type, strike_type,
             dtype, level0, sigma_loc=None, scheme="euler"):
    """Per-path level estimator Y of one MLMC level from one chunk.

    Level l > 0 (``level0=False``): Y = df·(P_f − P_c) on the fine grid of
    n_coarse·M steps and the coarse grid of n_coarse steps, the coarse
    normals the scaled sums of the fine ones. Level 0: Y = df·P_f on the
    n_coarse grid. ``draw(k)`` gives fine step k's (z1, z2), each
    (n_paths,) before antithetic doubling (z2 None but for Heston).
    Differentiable in every ``fixed`` entry. ``model_kind="localvol"``:
    ``sigma_loc(S, t)`` under log-Euler or explicit Milstein, the coarse
    track on the same scheme. Barriers carry the Brownian-bridge SURVIVAL
    probability of each step (Giles 2008 §5), which keeps the payoff
    smooth in the path.
    """
    dt_ = dtype
    dev = fixed["S0"].device
    n_f = n_coarse * (M if not level0 else 1)
    dt_f = fixed["T"] / n_f
    dt_c = fixed["T"] / n_coarse
    sqrt_f = torch.sqrt(dt_f)
    sqrt_c = torch.sqrt(dt_c)
    n_cols = 2 * n_paths if antithetic else n_paths
    exp_, log_ = _exp_for(dt_), _log_for(dt_)
    sub = 1 if level0 else M
    up = barrier_type.startswith("up")

    def hit(S):
        return (S >= fixed["barrier"]) if up else (S <= fixed["barrier"])

    S_init = fixed["S0"] * torch.ones(n_cols, dtype=dt_, device=dev)
    zeros = S_init * 0.0
    surv0 = torch.where(hit(S_init), 0.0, 1.0).to(dt_) \
        if payoff == "barrier" else zeros > 1.0
    v_init = zeros + torch.clamp(fixed["h_v0"], min=0.0)

    def asset_step(S, v, z1, z2, dt, sqrt_dt, t_now):
        """One transition; returns (S_new, v_new, the step's vol)."""
        r, q = fixed["r"], fixed["q"]
        if model_kind == "heston":
            v_eff = torch.clamp(v, min=0.0)  # full truncation
            rho = fixed["h_rho"]
            rho_p = torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
            zs = rho * z2 + rho_p * z1
            S_n = S * exp_((r - q - 0.5 * v_eff) * dt
                           + _sqrt0(v_eff) * sqrt_dt * zs)
            v_n = torch.clamp(
                v + fixed["h_kappa"] * (fixed["h_theta"] - v_eff) * dt
                + fixed["h_xi"] * _sqrt0(v_eff) * sqrt_dt * z2, min=0.0)
            return S_n, v_n, torch.clamp(_sqrt0(v_eff), min=1e-8)
        if model_kind == "localvol":
            mu_dt = (r - q) * dt
            if scheme == "milstein":
                # explicit Milstein, σ′ from a central dS-bump
                sig = torch.clamp(torch.as_tensor(sigma_loc(S, t_now),
                                                  dtype=dt_), 1e-8, 10.0)
                eps = fixed["bump"] * S
                S_up = S + eps
                S_dn = torch.clamp(S - eps, min=1e-10)
                sig_up = torch.as_tensor(sigma_loc(S_up, t_now), dtype=dt_)
                sig_dn = torch.as_tensor(sigma_loc(S_dn, t_now), dtype=dt_)
                da_dS = (sig_up * S_up - sig_dn * S_dn) / (S_up - S_dn)
                a_t = sig * S
                S_n = (S + mu_dt * S + a_t * sqrt_dt * z1
                       + 0.5 * a_t * da_dS * (z1 * z1 - 1.0) * dt)
                return torch.clamp(S_n, min=1e-10), v, sig
            sig = torch.clamp(torch.as_tensor(sigma_loc(S, t_now),
                                              dtype=dt_), min=0.0)
            return (S * exp_(mu_dt - 0.5 * sig * sig * dt
                             + sig * sqrt_dt * z1), v,
                    torch.clamp(sig, min=1e-8))
        mu = (r - q - 0.5 * fixed["sigma"] ** 2) * dt
        return (S * exp_(mu + fixed["sigma"] * sqrt_dt * z1), v,
                fixed["sigma"])

    def log_safe(S):
        return log_(torch.clamp(S, min=1e-30))

    def bridge_survive(S_prev, S_new, sig, dt):
        """P(the log-linear bridge from S_prev to S_new stays inside)."""
        b = log_safe(fixed["barrier"])
        xp, xn = log_safe(S_prev), log_safe(S_new)
        dp = (b - xp) if up else (xp - b)
        dn = (b - xn) if up else (xn - b)
        inside = (dp > 0.0) & (dn > 0.0)
        # clamped: exp32 holds for |x| ≲ 85, and exp(−80) is survival
        expo = torch.clamp(-2.0 * torch.clamp(dp, min=0.0)
                           * torch.clamp(dn, min=0.0) / (sig * sig * dt),
                           min=-80.0)
        p = 1.0 - exp_(expo)
        return torch.where(inside, torch.clamp(p, min=0.0), 0.0)

    def accumulate(track, S_n, v_n, sig, dt):
        S_prev, rsum, rlog, rmax, rmin, surv, _ = track
        if payoff == "asian":
            rsum = rsum + S_n
            if average_type == "geometric":
                rlog = rlog + log_safe(S_n)
        if payoff == "lookback":
            rmax = torch.maximum(rmax, S_n)
            rmin = torch.minimum(rmin, S_n)
        if payoff == "barrier":
            surv = surv * bridge_survive(S_prev, S_n, sig, dt)
        return (S_n, rsum, rlog, rmax, rmin, surv, v_n)

    def doubled(z):
        return torch.cat([z, -z]) if antithetic else z

    # (S, run_sum, run_logsum, run_max, run_min, survival, v)
    fine = coarse = (S_init, zeros, zeros, S_init, S_init, surv0, v_init)
    inv = 1.0 / np.sqrt(M)
    for t_idx in range(n_coarse):
        z1_sum = z2_sum = zeros
        for j in range(sub):
            k = t_idx * sub + j
            z1, z2 = draw(k)
            z1 = doubled(z1)
            z2 = None if z2 is None else doubled(z2)
            S_n, v_n, sig = asset_step(fine[0], fine[6], z1, z2, dt_f,
                                       sqrt_f, float(k) * dt_f)
            fine = accumulate(fine, S_n, v_n, sig, dt_f)
            z1_sum = z1_sum + z1
            if z2 is not None:
                z2_sum = z2_sum + z2
        if not level0:
            S_n, v_n, sig = asset_step(coarse[0], coarse[6], z1_sum * inv,
                                       z2_sum * inv, dt_c, sqrt_c,
                                       float(t_idx) * dt_c)
            coarse = accumulate(coarse, S_n, v_n, sig, dt_c)

    pay_kw = dict(K=fixed["K"], kind=kind, barrier_type=barrier_type,
                  rebate=fixed["rebate"], average_type=average_type,
                  strike_type=strike_type, payout=fixed["payout"])

    def payoff_of(track, n_steps_t):
        if payoff == "barrier":
            surv = track[5]
            van = _terminal_payoff("vanilla", track[:6],
                                   n_steps=n_steps_t, **pay_kw)
            if barrier_type.endswith("out"):
                return surv * van + (1.0 - surv) * fixed["rebate"]
            return (1.0 - surv) * van + surv * fixed["rebate"]
        return _terminal_payoff(payoff, track[:6], n_steps=n_steps_t,
                                **pay_kw)

    df = exp_(-fixed["r"] * fixed["T"])
    p_f = df * payoff_of(fine, n_f)
    return p_f if level0 else p_f - df * payoff_of(coarse, n_coarse)


def _step_draws(gen, n_paths: int, heston: bool, dtype, device):
    """``draw(k)`` of :func:`_level_y` from one generator, called once a
    fine step in step order: z1 and, under Heston, z2."""
    def draw(k):
        z1 = torch.randn(n_paths, generator=gen, dtype=dtype, device=device)
        z2 = torch.randn(n_paths, generator=gen, dtype=dtype,
                         device=device) if heston else None
        return z1, z2
    return draw


def _mlmc_level_stats(draw, fixed, *, greek_params=(), **static):
    """Sufficient statistics of one MLMC level from one path chunk:
    ``[n, ΣY, ΣY²]``, extended by ``[Σ∂Y/∂θ, Σ(∂Y/∂θ)²]`` for each entry
    of ``fixed`` named in ``greek_params``: one forward-mode Jacobian
    (``torch.func.jacfwd``) through :func:`_level_y`, the chunk's draws
    made first, outside the differentiated function. The level's
    corrections telescope like the price (Burgos & Giles 2012)."""
    dt_ = static["dtype"]
    if not greek_params:
        y = _level_y(draw, fixed, **static)
        n = torch.tensor(float(y.numel()), dtype=dt_, device=y.device)
        return torch.stack([n, torch.sum(y), torch.sum(y * y)])
    n_fine = static["n_coarse"] * (1 if static["level0"] else static["M"])
    draws = [draw(k) for k in range(n_fine)]
    theta0 = torch.stack([fixed[p] for p in greek_params])

    def y_of(theta):
        f = dict(fixed)
        for i, p in enumerate(greek_params):
            f[p] = theta[i]
        y = _level_y(lambda k: draws[k], f, **static)
        return y, y

    J, y = torch.func.jacfwd(y_of, has_aux=True)(theta0)
    n = torch.tensor(float(y.numel()), dtype=dt_, device=y.device)
    parts = [n, torch.sum(y), torch.sum(y * y)]
    for i in range(len(greek_params)):
        parts += [torch.sum(J[:, i]), torch.sum(J[:, i] * J[:, i])]
    return torch.stack(parts)


def _on(fixed: dict, device) -> dict:
    return {k: v.to(device) for k, v in fixed.items()}


def _mlmc_level_stats_sharded(mesh, seed: int, index: tuple, fixed, *,
                              n_paths, **static):
    """One level chunk over a mesh: each device runs ⌈n_paths / n_dev⌉
    paths on the stream (seed, *index, device index), the stat vectors
    summed in mesh order on the first device."""
    from ..parallel.mesh import mesh_sum

    devices = mesh.device_list
    n_local = -(-int(n_paths) // len(devices))
    heston = static["model_kind"] == "heston"
    parts = []
    for d, dev in enumerate(devices):
        draw = _step_draws(keyed_generator(seed, tuple(index) + (d,), dev),
                           n_local, heston, static["dtype"], dev)
        parts.append(_mlmc_level_stats(draw, _on(fixed, dev),
                                       n_paths=n_local, **static))
    return mesh_sum(parts)


def _chunk_stats(seed: int, level: int, chunk: int, fixed, *, mesh, device,
                 n_paths, **static):
    """The stats of chunk ``chunk`` of ``level``, on the stream (seed,
    level, chunk): on ``device``, or split over ``mesh``."""
    if mesh is not None:
        return _mlmc_level_stats_sharded(mesh, seed, (level, chunk), fixed,
                                         n_paths=n_paths, **static)
    draw = _step_draws(keyed_generator(seed, (level, chunk), device),
                       n_paths, static["model_kind"] == "heston",
                       static["dtype"], device)
    return _mlmc_level_stats(draw, fixed, n_paths=n_paths, **static)


def mlmc_price(payoff: str, S0: float, K: float, T: float, r: float,
               q: float = 0.0, *, sigma: Optional[float] = None,
               heston: Optional[dict] = None, sigma_loc=None,
               scheme: str = "euler", dS_bump: float = 0.01,
               kind: str = "call",
               eps: float = 0.01, n0_steps: int = 8, M: int = 2,
               L_min: int = 2, L_max: int = 7, n_init: int = 4_096,
               chunk: int = 16_384, max_paths_per_level: int = 1 << 22,
               barrier: float = 0.0, barrier_type: str = "up-and-out",
               rebate: float = 0.0, average_type: str = "arithmetic",
               strike_type: str = "fixed", payout: float = 1.0,
               antithetic: bool = True, seed: Optional[int] = None,
               dtype=None, return_info: bool = False, mesh=None,
               greeks: bool = False, device=None):
    """Adaptive MLMC price of a (path-dependent) option.

    ``payoff`` ∈ {"vanilla", "barrier", "asian", "digital", "lookback"}
    with ``exotic_price_mc``'s conventions, except that the time grid is
    not an input: level l monitors at ``n0_steps·M^l`` dates and the
    estimator targets the l → ∞ limit at root-mean-square error ``eps``.
    Dynamics: constant ``sigma`` (the exact GBM step), ``heston={'v0',
    'kappa','theta','xi','rho'}`` (full-truncation Euler) or a torch
    ``sigma_loc(S, t)`` callable under ``scheme="euler"`` or
    ``"milstein"`` (a central ``dS_bump``·S stencil for σ′).

    The Giles loop: ``n_init`` samples on levels 0..``L_min``, N_l ∝
    √(V_l/C_l) for the eps²/2 variance budget, L extended while the weak
    remainder estimated from the last corrections exceeds eps/√2, capped
    at ``L_max`` levels and ``max_paths_per_level`` paths; chunks of
    ``chunk`` paths. Returns ``(price, stderr)`` (statistical error only),
    ``(price, stderr, greeks)`` with ``greeks=True`` (GBM delta/vega/rho,
    Heston delta/rho/d_v0, local vol delta/rho, each with a ``*_stderr``;
    the digital raises), and ``info`` last with ``return_info=True`` (the
    per-level table: levels, eps, n, mean, var, cost, fine_steps,
    weak_remainder). ``mesh`` splits every chunk over its devices.
    """
    if payoff not in ("vanilla", "barrier", "asian", "digital",
                      "lookback"):
        raise ValueError(f"unknown payoff {payoff!r}")
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if barrier_type not in ("up-and-out", "up-and-in", "down-and-out",
                            "down-and-in"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    if average_type not in ("arithmetic", "geometric"):
        raise ValueError(f"unknown average_type {average_type!r}")
    if strike_type not in ("fixed", "floating"):
        raise ValueError(f"unknown strike_type {strike_type!r}")
    if sum(x is not None for x in (sigma, heston, sigma_loc)) != 1:
        raise ValueError(
            "provide exactly one of sigma / heston / sigma_loc")
    if heston is not None:
        missing = {"v0", "kappa", "theta", "xi", "rho"} - set(heston)
        if missing:
            raise ValueError(f"heston= missing keys {sorted(missing)}")
    if scheme not in ("euler", "milstein"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme == "milstein" and sigma_loc is None:
        raise ValueError("scheme='milstein' requires sigma_loc=")
    if M < 2:
        raise ValueError("M must be >= 2")
    if not 0 <= L_min <= L_max:
        raise ValueError("need 0 <= L_min <= L_max")
    dt_ = canonical(dtype)
    dev = mesh.device_list[0] if mesh is not None else resolve_device(device)
    seed_val = resolve_seed(seed)
    model_kind = ("heston" if heston is not None else
                  "localvol" if sigma_loc is not None else "gbm")
    hp = heston or {}
    fixed = {k: torch.as_tensor(float(v), dtype=dt_, device=dev)
             for k, v in (
                 ("S0", S0), ("K", K), ("T", T), ("r", r), ("q", q),
                 ("sigma", sigma if sigma is not None else 0.0),
                 ("barrier", barrier), ("rebate", rebate),
                 ("payout", payout), ("bump", dS_bump),
                 ("h_v0", hp.get("v0", 0.0)),
                 ("h_kappa", hp.get("kappa", 0.0)),
                 ("h_theta", hp.get("theta", 0.0)),
                 ("h_xi", hp.get("xi", 0.0)), ("h_rho", hp.get("rho", 0.0)))}
    greek_names: tuple = ()
    greek_params: tuple = ()
    if greeks:
        if payoff == "digital":
            raise ValueError(
                "greeks=True needs a pathwise-differentiable payoff; "
                "the digital indicator has none (use CRN bump-and-"
                "reprice around mlmc_price)")
        greek_names, greek_params = {
            "gbm": (("delta", "vega", "rho"), ("S0", "sigma", "r")),
            "heston": (("delta", "rho", "d_v0"), ("S0", "r", "h_v0")),
            "localvol": (("delta", "rho"), ("S0", "r")),
        }[model_kind]
    static = dict(payoff=payoff, kind=kind, model_kind=model_kind,
                  M=int(M), antithetic=bool(antithetic),
                  barrier_type=barrier_type, average_type=average_type,
                  strike_type=strike_type, dtype=dt_,
                  sigma_loc=sigma_loc, scheme=scheme,
                  greek_params=greek_params)
    chunk = int(chunk)
    pair_mult = 2 if antithetic else 1
    n_stats = 3 + 2 * len(greek_params)

    # per-level accumulators (host float64):
    # [n, Σy, Σy², (Σ∂y, Σ(∂y)²) per greek param]
    acc: list[np.ndarray] = []
    chunks_run: list[int] = []

    def ensure(level: int, n_target: int):
        while len(acc) <= level:
            acc.append(np.zeros(n_stats))
            chunks_run.append(0)
        n_target = min(int(n_target), int(max_paths_per_level))
        while acc[level][0] < n_target:
            s = _chunk_stats(seed_val, level, chunks_run[level], fixed,
                             mesh=mesh, device=dev,
                             n_coarse=n0_steps * M ** max(level - 1, 0),
                             n_paths=chunk, level0=(level == 0), **static)
            acc[level] += np.asarray(s.detach().cpu(), np.float64)
            chunks_run[level] += 1

    def tables():
        n = np.array([a[0] for a in acc])
        m = np.array([a[1] / a[0] for a in acc])
        v = np.maximum(np.array([a[2] / a[0] for a in acc]) - m * m, 0.0)
        return n, m, v

    L = int(L_min)
    for lev in range(L + 1):
        ensure(lev, n_init)
    while True:
        n, m, v = tables()
        # cost per pair on level l: fine + coarse step counts
        cost = np.array([n0_steps * M ** max(l - 1, 0)
                         * (1 if l == 0 else M + 1)
                         for l in range(L + 1)], np.float64)
        budget = np.sum(np.sqrt(v * cost))
        n_opt = np.ceil(2.0 * eps ** -2 * np.sqrt(v / cost) * budget)
        n_opt = np.minimum(np.maximum(n_opt, chunk * pair_mult),
                           max_paths_per_level)
        if np.any(n < n_opt):
            for lev in range(L + 1):
                ensure(lev, n_opt[lev])
            continue
        # weak-error remainder from the last correction means,
        # assuming O(M^-αl) decay with α ≥ 1 (Giles' standard test)
        if L >= 1:
            tail = max(abs(m[L]), abs(m[L - 1]) / M) / (M - 1.0)
        else:
            tail = np.inf
        if tail < eps / np.sqrt(2.0) or L >= L_max:
            break
        L += 1
        ensure(L, n_init)

    n, m, v = tables()
    price = float(np.sum(m))
    se = float(np.sqrt(np.sum(v / n)))
    out = (price, se)
    if greeks:
        gdict = {}
        for i, name in enumerate(greek_names):
            mg = np.array([a[3 + 2 * i] / a[0] for a in acc])
            vg = np.maximum(
                np.array([a[4 + 2 * i] / a[0] for a in acc]) - mg * mg,
                0.0)
            gdict[name] = float(np.sum(mg))
            gdict[name + "_stderr"] = float(np.sqrt(np.sum(vg / n)))
        out = out + (gdict,)
    if not return_info:
        return out
    info = dict(levels=L + 1, eps=eps,
                n=[int(x) for x in n], mean=list(map(float, m)),
                var=list(map(float, v)),
                cost=[n0_steps * M ** max(l - 1, 0)
                      * (1 if l == 0 else M + 1) for l in range(L + 1)],
                fine_steps=[n0_steps * M ** l for l in range(L + 1)],
                weak_remainder=float(tail if L >= 1 else np.nan))
    return out + (info,)

"""Command-line pricing tool of the PyTorch port.

Counterpart of ``optpricer_tpu/cli.py`` for the engines ported so far:
``bs``, ``binomial``, ``mc``, ``greeks``, ``fd``, ``heston``, ``american``,
``barrier``, ``lookback``, ``levy``, ``lsmc``, ``qmc``, ``lsv``, ``mlmc``
and ``basket`` (``--american`` included), with the same flags and the
same 10-decimal output, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). Routes whose engine is not ported raise
``NotImplementedError`` naming the ROADMAP item that ports it: ``heston
--engine adi`` / ``--american`` / ``--barrier`` / ``--dividends`` (the
Heston ADI PDE, A.14). ``varswap`` waits for its engine (ROADMAP A.14).

    python -m optpricer_tpu_torch.cli mc --S0 100 --K 110 --T 1 --r 0.03 \\
        --sigma 0.2 --n-paths 1000000 --seed 7
    python -m optpricer_tpu_torch.cli qmc --S0 100 --K 100 --T 1 --r 0.03 \\
        --sigma 0.2 --payoff asian --n-paths 65536 --n-steps 64
    python -m optpricer_tpu_torch.cli fd --S0 100 --K 100 --T 1 --r 0.05 \\
        --sigma 0.2 --N-S 512 --N-t 256 --american --kind put
    python -m optpricer_tpu_torch.cli heston --S0 100 --K 100 --T 1 \\
        --r 0.03 --sigma 0.2 --lam 0.3 --mJ -0.1 --sJ 0.15
    python -m optpricer_tpu_torch.cli barrier --S0 100 --K 100 --T 1 \\
        --r 0.03 --sigma 0.2 --lower 80 --upper 130 --engine fd
    python -m optpricer_tpu_torch.cli basket --S0s 100,95,105 \\
        --sigmas 0.2,0.3,0.25 --K 100 --T 1 --r 0.03 --payoff asian_basket
    python -m optpricer_tpu_torch.cli lsv --S0 100 --K 100 --T 1 --r 0.03 \\
        --sigma 0.2 --surface surface.json --payoff barrier --barrier 130
    python -m optpricer_tpu_torch.cli lsmc --S0 100 --K 110 --T 1 --r 0.05 \\
        --sigma 0.25 --kind put --n-paths 100000 --seed 0 --bound
    python -m optpricer_tpu_torch.cli mlmc --S0 100 --K 100 --T 1 --r 0.05 \\
        --sigma 0.2 --payoff barrier --barrier 130 --eps 0.005 --seed 7
"""
from __future__ import annotations

import argparse
from typing import Callable

from .core import CALL, PUT, OptionSpec

# (flag, kwargs) pairs shared by every engine
_MARKET_FLAGS = (
    ("--S0", dict(type=float, required=True)),
    ("--K", dict(type=float, required=True)),
    ("--T", dict(type=float, required=True, help="years")),
    ("--r", dict(type=float, required=True, help="cont. risk-free")),
    ("--sigma", dict(type=float, required=True)),
    ("--q", dict(type=float, default=0.0, help="cont. dividend yield")),
    ("--device", dict(default="cuda", help="cuda (default) or cpu")),
)


def _parse_kind(text: str) -> str:
    alias = {"call": CALL, "c": CALL, "put": PUT, "p": PUT}
    try:
        return alias[text.lower()]
    except KeyError:
        raise argparse.ArgumentTypeError("kind must be 'call' or 'put'")


def _spec_of(ns: argparse.Namespace) -> OptionSpec:
    return OptionSpec(S0=ns.S0, K=ns.K, T=ns.T, r=ns.r, sigma=ns.sigma,
                      q=ns.q)


def _run_bs(ns) -> str:
    from .ops.black_scholes import price

    return f"{price(_spec_of(ns), ns.kind, device=ns.device):.10f}"


def _run_binomial(ns) -> str:
    from .models.binomial import crr

    value = crr(_spec_of(ns), ns.kind, N=ns.N, american=ns.american,
                device=ns.device)
    return f"{value:.10f}"


def _run_mc(ns) -> str:
    from .models.monte_carlo import euro_price_mc

    value, stderr = euro_price_mc(
        _spec_of(ns), kind=ns.kind, n_paths=ns.n_paths, seed=ns.seed,
        antithetic=not ns.no_antithetic, control_variate=not ns.no_cv,
        device=ns.device)
    return f"{value:.10f}  (stderr {stderr:.10f})"


def _run_fd(ns) -> str:
    from .models.pde import fd_price

    value = fd_price(_spec_of(ns), ns.kind, N_S=ns.N_S, N_t=ns.N_t,
                     american=ns.american,
                     dividends=_parse_dividends(ns.dividends),
                     device=ns.device)
    return f"{value:.10f}"


def _parse_dividends(cell: str):
    if not cell:
        return None
    return [(float(t), float(d)) for t, d in
            (pair.split(":") for pair in cell.split(","))]


def _heston_pde_route(route: str):
    return NotImplementedError(
        f"heston {route} needs the Heston ADI PDE (models/heston_pde), "
        "which is not ported yet (ROADMAP A.14)")


def _run_heston(ns) -> str:
    kind = "call" if ns.kind == CALL else "put"
    hp = dict(v0=ns.v0, kappa=ns.kappa, theta=ns.theta, xi=ns.xi,
              rho=ns.rho)
    divs = _parse_dividends(getattr(ns, "dividends", ""))
    if divs is not None and ns.barrier > 0.0:
        raise SystemExit("--dividends is not supported with --barrier")
    if ns.lam > 0.0:
        if ns.barrier > 0.0 or ns.american or divs is not None:
            raise SystemExit("--lam (Bates jumps) prices European via "
                             "COS only")
        from .models.analytic import bates_price_cos

        value = float(bates_price_cos(ns.S0, ns.K, ns.T, ns.r, ns.q,
                                      **hp, lam=ns.lam, mJ=ns.mJ,
                                      sJ=ns.sJ, kind=kind,
                                      device=ns.device))
        return f"{value:.10f}"
    if ns.barrier > 0.0:
        raise _heston_pde_route("--barrier")
    if ns.engine == "adi" or ns.american or divs is not None:
        raise _heston_pde_route("--engine adi" if ns.engine == "adi" else
                                "--american" if ns.american else
                                "--dividends")
    from .models.analytic import heston_price_cos

    value = float(heston_price_cos(ns.S0, ns.K, ns.T, ns.r, ns.q, **hp,
                                   kind=kind, device=ns.device))
    return f"{value:.10f}"


def _run_american(ns) -> str:
    kind = "call" if ns.kind == CALL else "put"
    if ns.D > 0.0:
        if kind != "call":
            raise SystemExit("--D (discrete dividend) prices an American "
                             "CALL via Roll-Geske-Whaley")
        from .models.american_analytic import rgw_price

        value = float(rgw_price(ns.S0, ns.K, ns.T, ns.r, sigma=ns.sigma,
                                D=ns.D, t_div=ns.t_div, device=ns.device))
        return f"{value:.10f}"
    if ns.engine == "baw":
        from .models.american_analytic import baw_price as engine
    else:
        from .models.american_analytic import \
            bjerksund_stensland_price as engine
    value = float(engine(ns.S0, ns.K, ns.T, ns.r, ns.q, sigma=ns.sigma,
                         kind=kind, device=ns.device))
    return f"{value:.10f}"


def _run_barrier(ns) -> str:
    double = ns.lower > 0.0 or ns.upper > 0.0
    if double:
        if not 0.0 < ns.lower < ns.upper:
            raise SystemExit("double barrier needs 0 < --lower < --upper")
        if ns.engine == "fd":
            from .models.pde import fd_price_double_barrier

            value = fd_price_double_barrier(
                _spec_of(ns), ns.kind, lower=ns.lower, upper=ns.upper,
                knock=ns.knock, rebate=ns.rebate, N_S=ns.N_S, N_t=ns.N_t,
                device=ns.device)
        else:
            from .models.analytic import double_barrier_price_bs

            value = float(double_barrier_price_bs(
                ns.S0, ns.K, ns.T, ns.r, ns.q, sigma=ns.sigma,
                lower=ns.lower, upper=ns.upper, kind=ns.kind,
                knock=ns.knock, rebate=ns.rebate, device=ns.device))
        return f"{value:.10f}"
    if ns.barrier <= 0.0:
        raise SystemExit("need --barrier (single) or --lower/--upper "
                         "(double)")
    if ns.engine == "fd":
        from .models.pde import fd_price_barrier

        value = fd_price_barrier(
            _spec_of(ns), ns.kind, ns.barrier, ns.barrier_type,
            rebate=ns.rebate, N_S=ns.N_S, N_t=ns.N_t,
            barrier_mode="operator", device=ns.device)
    else:
        from .models.analytic import barrier_price_bs

        value = float(barrier_price_bs(
            ns.S0, ns.K, ns.T, ns.r, ns.q, sigma=ns.sigma,
            barrier=ns.barrier, barrier_type=ns.barrier_type,
            kind=ns.kind, rebate=ns.rebate, device=ns.device))
    return f"{value:.10f}"


def _run_lookback(ns) -> str:
    from .models.analytic import lookback_price_bs

    value = float(lookback_price_bs(
        ns.S0, ns.T, ns.r, ns.q, sigma=ns.sigma, kind=ns.kind,
        strike_type=ns.strike_type, K=ns.K,
        running_extremum=ns.running_extremum, device=ns.device))
    return f"{value:.10f}"


def _run_levy(ns) -> str:
    from .models import levy

    common = (ns.S0, ns.K, ns.T, ns.r, ns.q)
    if ns.model == "vg":
        value = levy.vg_price_cos(*common, sigma=ns.sigma, theta=ns.theta,
                                  nu=ns.nu, kind=ns.kind, N=ns.N,
                                  device=ns.device)
    elif ns.model == "nig":
        value = levy.nig_price_cos(*common, alpha=ns.alpha, beta=ns.beta,
                                   delta=ns.delta, kind=ns.kind, N=ns.N,
                                   device=ns.device)
    else:
        value = levy.cgmy_price_cos(*common, C=ns.C, G=ns.G, M=ns.M,
                                    Y=ns.Y, kind=ns.kind, N=ns.N,
                                    device=ns.device)
    return f"{float(value):.10f}"


def _run_greeks(ns) -> str:
    from .models.monte_carlo import euro_greeks_mc

    g = euro_greeks_mc(_spec_of(ns), ns.kind, n_paths=ns.n_paths,
                       seed=ns.seed, device=ns.device)
    order = ("price", "delta", "gamma", "vega", "theta", "rho")
    return "\n".join(f"{name:<6} {g[name]: .10f}" for name in order)


def _run_lsmc(ns) -> str:
    from .models.american_mc import lsmc_price

    kw = dict(n_paths=ns.n_paths, n_steps=ns.n_steps, seed=ns.seed,
              device=ns.device)
    if ns.bound:
        br = lsmc_price(_spec_of(ns), ns.kind, bound="both", **kw)
        lo, lo_se = br["lower"]
        up, up_se = br["upper"]
        return (f"lower  {lo:.10f}  (stderr {lo_se:.10f})\n"
                f"upper  {up:.10f}  (stderr {up_se:.10f})\n"
                f"gap    {br['gap']:.10f}")
    value, stderr = lsmc_price(_spec_of(ns), ns.kind, **kw)
    return f"{value:.10f}  (stderr {stderr:.10f})"


def _run_qmc(ns) -> str:
    from .models.mc_fused import exotic_price_mc

    value, stderr = exotic_price_mc(
        ns.payoff, ns.S0, ns.K, ns.T, ns.r, ns.q, sigma=ns.sigma,
        kind=ns.kind, backend="qmc", n_paths=ns.n_paths,
        n_steps=ns.n_steps, seed=ns.seed, barrier=ns.barrier,
        barrier_type=ns.barrier_type, average_type=ns.average_type,
        strike_type=ns.strike_type, payout=ns.payout, device=ns.device)
    return f"{value:.10f}  (stderr {stderr:.10f})"


def _run_lsv(ns) -> str:
    from .models.lsv import lsv_calibrate, lsv_price_mc
    from .utils import serialization as sz

    if ns.model:
        model = sz.load_lsv(ns.model, device=ns.device)
    else:
        if ns.surface:
            surface = sz.load_surface(ns.surface, device=ns.device)
        else:
            # flat surface at --sigma: LSV degenerates to pure Heston
            # leverage-corrected to the flat smile
            import numpy as np

            from .models.calibration import SVIParams, VolSurface

            expiries = sorted({ns.T * f for f in (0.25, 0.5, 1.0)})
            surface = VolSurface(
                {T: SVIParams(a=ns.sigma**2 * T, b=1e-6, rho=0.0, m=0.0,
                              sigma=0.1, expiry=T) for T in expiries},
                forward_curve={T: ns.S0 * np.exp((ns.r - ns.q) * T)
                               for T in expiries}, device=ns.device)
        heston = dict(v0=ns.v0, kappa=ns.kappa, theta=ns.theta, xi=ns.xi,
                      rho=ns.rho)
        model = lsv_calibrate(surface, heston, ns.S0, ns.r, ns.q, T=ns.T,
                              n_steps=ns.n_steps, n_paths=ns.cal_paths,
                              n_bins=ns.n_bins, seed=ns.seed,
                              scheme=ns.scheme, device=ns.device)
        if ns.save_model:
            sz.save_lsv(model, ns.save_model)
    value, stderr = lsv_price_mc(
        ns.payoff, model, ns.K, kind=ns.kind, n_paths=ns.n_paths,
        barrier=ns.barrier, barrier_type=ns.barrier_type, seed=ns.seed,
        device=ns.device)
    return f"{value:.10f}  (stderr {stderr:.10f})"


def _run_mlmc(ns) -> str:
    from .models.mlmc import mlmc_price

    value, stderr = mlmc_price(
        ns.payoff, ns.S0, ns.K, ns.T, ns.r, ns.q, sigma=ns.sigma,
        kind=ns.kind, eps=ns.eps, seed=ns.seed, barrier=ns.barrier,
        barrier_type=ns.barrier_type, average_type=ns.average_type,
        strike_type=ns.strike_type, payout=ns.payout, device=ns.device)
    return f"{value:.10f}  (stderr {stderr:.10f})"


def _csv_floats(text: str):
    return [float(x) for x in text.split(",") if x.strip()]


def _run_basket(ns) -> str:
    import numpy as np

    from .models.basket import basket_exotic_mc, basket_price_mc

    S0s = _csv_floats(ns.S0s)
    a = len(S0s)
    sigmas = _csv_floats(ns.sigmas)
    weights = _csv_floats(ns.weights) if ns.weights else [1.0 / a] * a
    corr = ns.rho * np.ones((a, a)) + (1.0 - ns.rho) * np.eye(a)
    qs = _csv_floats(ns.qs) if ns.qs else None
    common = dict(sigmas=sigmas, corr=corr, kind=ns.kind,
                  n_paths=ns.n_paths, seed=ns.seed, device=ns.device)
    if ns.american:
        if ns.payoff not in ("basket", "rainbow_max", "rainbow_min"):
            raise SystemExit("--american supports basket/rainbow_max/"
                             "rainbow_min payoffs")
        from .models.american_mc import lsmc_price_basket

        value, stderr = lsmc_price_basket(
            S0s, weights, ns.K, ns.T, ns.r, qs, payoff=ns.payoff,
            n_steps=ns.n_steps, **common)
        return f"{value:.10f}  (stderr {stderr:.10f})"
    if ns.payoff in ("asian_basket", "worstof_barrier", "basket_barrier"):
        value, stderr = basket_exotic_mc(
            S0s, weights, ns.K, ns.T, ns.r, qs, payoff=ns.payoff,
            barrier=ns.barrier, barrier_type=ns.barrier_type,
            n_steps=ns.n_steps, **common)
    else:
        value, stderr = basket_price_mc(S0s, weights, ns.K, ns.T, ns.r,
                                        qs, payoff=ns.payoff, **common)
    return f"{value:.10f}  (stderr {stderr:.10f})"


# engine name -> (help text, extra flags, runner)
_ENGINES: dict[str, tuple[str, tuple, Callable]] = {
    "bs": ("Black-Scholes price", (), _run_bs),
    "binomial": ("CRR binomial price", (
        ("--N", dict(type=int, default=500)),
        ("--american", dict(action="store_true")),
    ), _run_binomial),
    "mc": ("Monte Carlo price (GBM)", (
        ("--n-paths", dict(dest="n_paths", type=int, default=100_000)),
        ("--seed", dict(type=int, default=None)),
        ("--no-antithetic", dict(action="store_true")),
        ("--no-cv", dict(action="store_true",
                         help="disable control variate")),
    ), _run_mc),
    "fd": ("theta-scheme PDE price", (
        ("--N-S", dict(dest="N_S", type=int, default=200)),
        ("--N-t", dict(dest="N_t", type=int, default=200)),
        ("--american", dict(action="store_true")),
        ("--dividends", dict(default="",
                             help="discrete cash dividends 't:amt,t:amt' "
                                  "(piecewise-GBM jump conditions)")),
    ), _run_fd),
    "heston": ("Heston price (COS transform, or 2-D ADI PDE)", (
        ("--v0", dict(type=float, default=0.04)),
        ("--kappa", dict(type=float, default=1.5)),
        ("--theta", dict(type=float, default=0.04)),
        ("--xi", dict(type=float, default=0.4)),
        ("--rho", dict(type=float, default=-0.6)),
        ("--engine", dict(choices=("cos", "adi"), default="cos")),
        ("--american", dict(action="store_true",
                            help="American exercise (forces the ADI PDE; "
                                 "not ported: raises)")),
        ("--barrier", dict(type=float, default=0.0,
                           help="barrier level (forces the ADI PDE; "
                                "not ported: raises)")),
        ("--barrier-type", dict(dest="barrier_type",
                                default="up-and-out")),
        ("--dividends", dict(default="",
                             help="discrete cash dividends 't:amt,t:amt' "
                                  "(forces the ADI PDE; not ported: "
                                  "raises)")),
        ("--lam", dict(type=float, default=0.0,
                       help="jump intensity (> 0 prices BATES via COS)")),
        ("--mJ", dict(type=float, default=0.0, help="mean log jump")),
        ("--sJ", dict(type=float, default=0.0, help="log-jump stdev")),
    ), _run_heston),
    "american": ("analytic American approximation (O(1) per option)", (
        ("--engine", dict(choices=("bs2002", "baw"), default="bs2002",
                          help="Bjerksund-Stensland 2002 or "
                               "Barone-Adesi-Whaley")),
        ("--D", dict(type=float, default=0.0,
                     help="one cash dividend (> 0 prices the call via "
                          "Roll-Geske-Whaley, exact escrowed model)")),
        ("--t-div", dict(dest="t_div", type=float, default=0.0,
                         help="ex-dividend date (with --D)")),
    ), _run_american),
    "barrier": ("continuously-monitored barrier, closed form or PDE", (
        ("--barrier", dict(type=float, default=0.0,
                           help="single-barrier level")),
        ("--barrier-type", dict(dest="barrier_type",
                                default="up-and-out")),
        ("--lower", dict(type=float, default=0.0,
                         help="double-barrier corridor floor")),
        ("--upper", dict(type=float, default=0.0,
                         help="double-barrier corridor cap")),
        ("--knock", dict(choices=("in", "out"), default="out",
                         help="double-barrier direction")),
        ("--rebate", dict(type=float, default=0.0,
                          help="paid at expiry")),
        ("--engine", dict(choices=("analytic", "fd"), default="analytic")),
        ("--N-S", dict(dest="N_S", type=int, default=400)),
        ("--N-t", dict(dest="N_t", type=int, default=400)),
    ), _run_barrier),
    "lookback": ("continuously-monitored lookback, closed form", (
        ("--strike-type", dict(dest="strike_type",
                               choices=("floating", "fixed"),
                               default="floating")),
        ("--running-extremum", dict(dest="running_extremum", type=float,
                                    default=None,
                                    help="already-observed min/max for "
                                         "seasoned contracts")),
    ), _run_lookback),
    "levy": ("European price under a pure-jump Lévy model (COS)", (
        ("--model", dict(choices=("vg", "nig", "cgmy"), default="vg")),
        ("--theta", dict(type=float, default=-0.14,
                         help="VG drift of the subordinated BM")),
        ("--nu", dict(type=float, default=0.2,
                      help="VG variance rate of the gamma clock")),
        ("--alpha", dict(type=float, default=8.0, help="NIG tail")),
        ("--beta", dict(type=float, default=-4.0, help="NIG skew")),
        ("--delta", dict(type=float, default=0.4, help="NIG scale")),
        ("--C", dict(type=float, default=0.5, help="CGMY activity")),
        ("--G", dict(type=float, default=5.0, help="CGMY left temper")),
        ("--M", dict(type=float, default=9.0, help="CGMY right temper")),
        ("--Y", dict(type=float, default=0.8,
                     help="CGMY stability index, (0,2) \\ {1}")),
        ("--N", dict(type=int, default=256, help="COS terms")),
    ), _run_levy),
    "greeks": ("MC Greek ladder from one kernel run", (
        ("--n-paths", dict(dest="n_paths", type=int, default=1_000_000)),
        ("--seed", dict(type=int, default=None)),
    ), _run_greeks),
    "lsmc": ("American price via Longstaff-Schwartz MC", (
        ("--n-paths", dict(dest="n_paths", type=int, default=100_000)),
        ("--n-steps", dict(dest="n_steps", type=int, default=50)),
        ("--seed", dict(type=int, default=None)),
        ("--bound", dict(action="store_true",
                         help="two-pass lower + Andersen-Broadie upper "
                              "bound bracket")),
    ), _run_lsmc),
    "qmc": ("Randomised-QMC path pricer (Sobol + Brownian bridge)", (
        ("--payoff", dict(default="vanilla",
                          choices=("vanilla", "asian", "barrier",
                                   "digital", "lookback"))),
        ("--n-paths", dict(dest="n_paths", type=int, default=65_536,
                           help="points per replicate (x8 shifts)")),
        ("--n-steps", dict(dest="n_steps", type=int, default=64)),
        ("--seed", dict(type=int, default=0)),
        ("--barrier", dict(type=float, default=0.0)),
        ("--barrier-type", dict(dest="barrier_type",
                                default="up-and-out")),
        ("--average-type", dict(dest="average_type",
                                default="arithmetic")),
        ("--strike-type", dict(dest="strike_type", default="fixed")),
        ("--payout", dict(type=float, default=1.0)),
    ), _run_qmc),
    "lsv": ("LSV price (Heston x Dupire leverage, particle-calibrated)", (
        ("--surface", dict(default="",
                           help="surface JSON (save_surface); default: "
                                "flat smile at --sigma")),
        ("--model", dict(default="",
                         help="calibrated LSV JSON (save_lsv) — skips "
                              "calibration")),
        ("--save-model", dict(dest="save_model", default="",
                              help="persist the calibrated model here")),
        ("--v0", dict(type=float, default=0.04)),
        ("--kappa", dict(type=float, default=1.5)),
        ("--theta", dict(type=float, default=0.04)),
        ("--xi", dict(type=float, default=0.5)),
        ("--rho", dict(type=float, default=-0.6)),
        ("--scheme", dict(choices=("euler", "qe"), default="euler",
                          help="variance discretisation (Andersen QE "
                               "or full-truncation Euler)")),
        ("--payoff", dict(default="vanilla",
                          choices=("vanilla", "asian", "barrier",
                                   "digital", "lookback"))),
        ("--barrier", dict(type=float, default=0.0)),
        ("--barrier-type", dict(dest="barrier_type",
                                default="up-and-out")),
        ("--n-steps", dict(dest="n_steps", type=int, default=64)),
        ("--cal-paths", dict(dest="cal_paths", type=int, default=65_536)),
        ("--n-bins", dict(dest="n_bins", type=int, default=128)),
        ("--n-paths", dict(dest="n_paths", type=int, default=262_144)),
        ("--seed", dict(type=int, default=0)),
    ), _run_lsv),
    "mlmc": ("Multilevel MC: continuous-monitoring limit to RMSE eps", (
        ("--payoff", dict(default="asian",
                          choices=("vanilla", "asian", "barrier",
                                   "digital", "lookback"))),
        ("--eps", dict(type=float, default=0.01,
                       help="target root-mean-square error")),
        ("--seed", dict(type=int, default=None)),
        ("--barrier", dict(type=float, default=0.0)),
        ("--barrier-type", dict(dest="barrier_type",
                                default="up-and-out")),
        ("--average-type", dict(dest="average_type",
                                default="arithmetic")),
        ("--strike-type", dict(dest="strike_type", default="fixed")),
        ("--payout", dict(type=float, default=1.0)),
    ), _run_mlmc),
}

# multi-asset subcommand: its own market block (vector-valued flags)
_BASKET_FLAGS = (
    ("--S0s", dict(required=True, help="comma-separated spots")),
    ("--sigmas", dict(required=True, help="comma-separated vols")),
    ("--weights", dict(default="", help="comma-separated (default equal)")),
    ("--rho", dict(type=float, default=0.3,
                   help="constant pairwise correlation")),
    ("--K", dict(type=float, required=True)),
    ("--T", dict(type=float, required=True)),
    ("--r", dict(type=float, required=True)),
    ("--payoff", dict(default="basket",
                      choices=("basket", "spread", "rainbow_max",
                               "rainbow_min", "asian_basket",
                               "worstof_barrier", "basket_barrier"))),
    ("--barrier", dict(type=float, default=0.0)),
    ("--barrier-type", dict(dest="barrier_type", default="down-and-in")),
    ("--n-steps", dict(dest="n_steps", type=int, default=64)),
    ("--n-paths", dict(dest="n_paths", type=int, default=262_144)),
    ("--seed", dict(type=int, default=None)),
    ("--qs", dict(default="", help="comma-separated dividend yields "
                                   "(default zero)")),
    ("--american", dict(action="store_true",
                        help="LSMC early exercise over n-steps dates")),
    ("--device", dict(default="cuda", help="cuda (default) or cpu")),
)


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="optpricer-tpu-torch",
                                   description="options pricing CLI "
                                               "(PyTorch + CUDA)")
    subs = root.add_subparsers(dest="cmd", required=True)
    for name, (blurb, extra_flags, runner) in _ENGINES.items():
        sub = subs.add_parser(name, help=blurb)
        for flag, kw in _MARKET_FLAGS + extra_flags:
            sub.add_argument(flag, **kw)
        sub.add_argument("--kind", type=_parse_kind, default=CALL,
                         help="call|put")
        sub.set_defaults(runner=runner)
    sub = subs.add_parser("basket", help="multi-asset MC "
                          "(terminal + path-dependent payoffs)")
    for flag, kw in _BASKET_FLAGS:
        sub.add_argument(flag, **kw)
    sub.add_argument("--kind", type=_parse_kind, default=CALL,
                     help="call|put")
    sub.set_defaults(runner=_run_basket)
    return root


def main(argv=None):
    ns = build_parser().parse_args(argv)
    print(ns.runner(ns))


if __name__ == "__main__":
    main()

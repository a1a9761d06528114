"""Command-line pricing tool of the PyTorch port.

Counterpart of ``optpricer_tpu/cli.py`` for the engines ported so far:
``bs``, ``binomial``, ``mc``, ``greeks``, ``fd``, ``qmc``, ``lsv`` and
``basket``, with the same flags and the same 10-decimal output, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
``basket --american`` raises ``NotImplementedError``: its engine, the
basket LSMC, is not ported (ROADMAP A.12). The other subcommands wait for
their engines (ROADMAP).

    python -m optpricer_tpu_torch.cli mc --S0 100 --K 110 --T 1 --r 0.03 \\
        --sigma 0.2 --n-paths 1000000 --seed 7
    python -m optpricer_tpu_torch.cli qmc --S0 100 --K 100 --T 1 --r 0.03 \\
        --sigma 0.2 --payoff asian --n-paths 65536 --n-steps 64
    python -m optpricer_tpu_torch.cli fd --S0 100 --K 100 --T 1 --r 0.05 \\
        --sigma 0.2 --N-S 512 --N-t 256 --american --kind put
    python -m optpricer_tpu_torch.cli basket --S0s 100,95,105 \\
        --sigmas 0.2,0.3,0.25 --K 100 --T 1 --r 0.03 --payoff asian_basket
    python -m optpricer_tpu_torch.cli lsv --S0 100 --K 100 --T 1 --r 0.03 \\
        --sigma 0.2 --surface surface.json --payoff barrier --barrier 130
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


def _run_greeks(ns) -> str:
    from .models.monte_carlo import euro_greeks_mc

    g = euro_greeks_mc(_spec_of(ns), ns.kind, n_paths=ns.n_paths,
                       seed=ns.seed, device=ns.device)
    order = ("price", "delta", "gamma", "vega", "theta", "rho")
    return "\n".join(f"{name:<6} {g[name]: .10f}" for name in order)


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
        raise NotImplementedError(
            "basket --american (the basket LSMC, american_mc."
            "lsmc_price_basket) is not ported yet (ROADMAP A.12)")
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
    "greeks": ("MC Greek ladder from one kernel run", (
        ("--n-paths", dict(dest="n_paths", type=int, default=1_000_000)),
        ("--seed", dict(type=int, default=None)),
    ), _run_greeks),
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
                        help="LSMC early exercise over n-steps dates "
                             "(not ported: raises)")),
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

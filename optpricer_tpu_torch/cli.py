"""Command-line pricing tool of the PyTorch port.

Counterpart of ``optpricer_tpu/cli.py`` for the engines ported so far:
``bs``, ``binomial``, ``mc`` and ``greeks``, with the same flags and the
same 10-decimal output, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions). ``fd`` and the other subcommands wait for
their engines (ROADMAP).

    python -m optpricer_tpu_torch.cli mc --S0 100 --K 110 --T 1 --r 0.03 \\
        --sigma 0.2 --n-paths 1000000 --seed 7
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


def _run_greeks(ns) -> str:
    from .models.monte_carlo import euro_greeks_mc

    g = euro_greeks_mc(_spec_of(ns), ns.kind, n_paths=ns.n_paths,
                       seed=ns.seed, device=ns.device)
    order = ("price", "delta", "gamma", "vega", "theta", "rho")
    return "\n".join(f"{name:<6} {g[name]: .10f}" for name in order)


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
    "greeks": ("MC Greek ladder from one kernel run", (
        ("--n-paths", dict(dest="n_paths", type=int, default=1_000_000)),
        ("--seed", dict(type=int, default=None)),
    ), _run_greeks),
}


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
    return root


def main(argv=None):
    ns = build_parser().parse_args(argv)
    print(ns.runner(ns))


if __name__ == "__main__":
    main()

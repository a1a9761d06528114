"""Desk-style workflow: local-vol barrier pricing end to end on the card.

Counterpart of ``scripts/desk_workflow_localvol_barrier.py``: the same six
stages on the same synthetic market (3 expiries x 21 quotes) and contract,

    synthetic vol quotes → SVI calibration → Dupire local vol
    → barrier pricing (FDM + Milstein MC + fused kernel) → Greeks → report

at the same size (200 000 paths x 500 steps). The fused row runs the whole
simulation in the path kernel with the SVI surface evaluated in registers;
the path-matrix row builds the (501, 400 000) Milstein matrix with the
Dupire closure called three times a step.

``run`` returns every number of the workflow (and the host-clock time of
each stage); ``main`` prints the report. Usage::

    python -m optpricer_tpu_torch.scripts.desk_workflow_localvol_barrier \
        [--device cpu] [--n-paths N] [--n-steps M]
"""
from __future__ import annotations

import argparse
import time
from contextlib import contextmanager

import numpy as np
import torch

from ..core import CALL, OptionSpec
from ..dtypes import resolve_device
from ..models.calibration import dupire_local_vol_func, fit_svi_surface
from ..models.exotics import barrier_price
from ..models.mc_fused import exotic_price_mc_dupire
from ..models.pde import fd_greeks, fd_price, fd_price_barrier, \
    fd_price_local_vol
from ..models.processes import milstein_local_vol_paths
from ..ops.black_scholes import price as bs_price
from ..risk import numerical_greeks

RULE = "─" * 68
CONTRACT = dict(K=100.0, T=1.0, barrier=130.0, barrier_type="up-and-out")
PROBES = [(S, t) for S in (85.0, 100.0, 115.0) for t in (0.1, 0.5)]
GREEKS = ("delta", "gamma", "theta", "vega", "rho")
SEED = 42


def synth_market():
    """Three-slice synthetic smile (mild skew and convexity)."""
    S0, r, q, base_vol = 100.0, 0.05, 0.02, 0.20
    expiries = (0.25, 0.50, 1.00)
    forwards = {T: S0 * np.exp((r - q) * T) for T in expiries}
    strikes, ivs = {}, {}
    for T in expiries:
        grid = np.linspace(0.75, 1.25, 21) * forwards[T]
        k = np.log(grid / forwards[T])
        strikes[T] = grid
        ivs[T] = base_vol + 0.05 * k * k - 0.02 * k + 0.005 * np.sqrt(T)
    return S0, r, q, base_vol, forwards, strikes, ivs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_paths: int = 200_000, n_steps: int = 500, device=None) -> dict:
    """The six stages; every number they print, and ``times`` (host-clock
    seconds of each stage, each ending in a synchronize)."""
    dev = resolve_device(device)
    times = {}

    @contextmanager
    def stage(name):
        _sync(dev)
        start = time.perf_counter()
        yield
        _sync(dev)
        times[name] = time.perf_counter() - start

    S0, r, q, base_vol, forwards, strikes, ivs = synth_market()
    out = dict(S0=S0, r=r, q=q, base_vol=base_vol, n_paths=int(n_paths),
               n_steps=int(n_steps), device=str(dev),
               n_quotes=sum(map(len, strikes.values())),
               n_expiries=len(strikes))

    with stage("calibration"):
        surface = fit_svi_surface(strikes, forwards, ivs, device=dev)
    out["svi"] = {}
    for T, svi in sorted(surface.slices.items()):
        k = np.log(strikes[T] / forwards[T])
        err = svi.iv(k, device="cpu").numpy() - ivs[T]
        out["svi"][T] = dict(a=svi.a, b=svi.b, rho=svi.rho, m=svi.m,
                             sigma=svi.sigma,
                             rmse=float(np.sqrt(np.mean(err * err))))

    sigma_loc = dupire_local_vol_func(surface, r=r, q=q)
    with stage("dupire"):
        out["dupire"] = [
            (S, t, float(sigma_loc(torch.tensor([S], dtype=torch.float64,
                                                device=dev), t)[0]))
            for S, t in PROBES]

    K, T = CONTRACT["K"], CONTRACT["T"]
    barrier, btype = CONTRACT["barrier"], CONTRACT["barrier_type"]
    opt = OptionSpec(S0=S0, K=K, T=T, r=r, sigma=base_vol, q=q)
    with stage("fdm"):
        out["fdm_vanilla"] = fd_price(opt, CALL, device=dev)
        out["fdm_barrier"] = fd_price_barrier(opt, CALL, barrier, btype,
                                              device=dev)
    with stage("fdm_lv"):
        out["fdm_lv_vanilla"] = fd_price_local_vol(S0, K, T, r, q, sigma_loc,
                                                   CALL, device=dev)
    with stage("mc_paths"):
        paths = milstein_local_vol_paths(S0, r, q, T, n_steps, n_paths,
                                         sigma_loc, seed=SEED, device=dev)
        out["mc_barrier"], out["mc_se"] = barrier_price(paths, K, r, T, CALL,
                                                        barrier, btype)
    out["mc_vanilla"] = float(np.exp(-r * T)) * float(
        torch.clamp(paths[-1] - K, min=0.0).mean())
    del paths

    def fused(paths):
        return exotic_price_mc_dupire(
            "barrier", surface, S0, K, T, r, q, scheme="milstein",
            barrier=barrier, barrier_type=btype, n_steps=n_steps,
            n_paths=paths, seed=SEED, device=dev)

    fused(1)  # a one-path first call builds the kernels outside the clock
    with stage("fused"):
        out["fused_barrier"], out["fused_se"] = fused(n_paths)
    out["bs_vanilla"] = bs_price(opt, CALL, device=dev)

    with stage("greeks"):
        out["grid_greeks"] = fd_greeks(opt, CALL, device=dev)

        def fdm_engine(S, K, T, r, q, sigma, kind):
            return fd_price(OptionSpec(S0=S, K=K, T=T, r=r, sigma=sigma, q=q),
                            kind, device=dev)

        out["bump_greeks"] = numerical_greeks(fdm_engine, S0, K, T, r, q,
                                              base_vol, CALL)
    out["times"] = times
    return out


def _cell(value, width: int, decimals: int = 4) -> str:
    if value is None:
        return "—".rjust(width)
    if isinstance(value, str):
        return value.rjust(width)
    return f"{value:.{decimals}f}".rjust(width)


def _table(columns, rows) -> None:
    """columns: [(name, width, decimals)]; rows: tuples of values."""
    head = " ".join(name.rjust(w) for name, w, _ in columns)
    print("    " + head)
    print("    " + "-" * len(head))
    for row in rows:
        print("    " + " ".join(_cell(v, w, d)
                                for v, (_, w, d) in zip(row, columns)))


def _banner(step: int, title: str) -> None:
    print(f"\n{RULE}\n  Step {step} — {title}\n{RULE}")


def report(out: dict) -> None:
    t = out["times"]
    _banner(1, "Synthetic Market Data")
    print(f"Generated {out['n_quotes']} synthetic quotes across "
          f"{out['n_expiries']} expiries")
    print(f"Spot: {out['S0']}  |  Rate: {out['r']}  |  Div yield: "
          f"{out['q']}  |  Base vol: {out['base_vol']}  |  Device: "
          f"{out['device']}")

    _banner(2, "SVI Calibration")
    print(f"Calibrated SVI surface in {t['calibration']:.3f}s")
    for T, s in sorted(out["svi"].items()):
        print(f"  T={T:.2f}:  a={s['a']:.4f}  b={s['b']:.4f}  "
              f"rho={s['rho']:+.4f}  RMSE={s['rmse']:.6f}")

    _banner(3, "Dupire Local Vol Surface")
    _table([("S", 8, 1), ("t", 6, 2), ("σ_loc", 10, 4)], out["dupire"])

    _banner(4, "Barrier Option Pricing (FDM + MC)")
    c = CONTRACT
    print(f"\nContract:  S0={out['S0']}  K={c['K']}  T={c['T']}  "
          f"barrier={c['barrier']} ({c['barrier_type']})")
    _table([("Method", 25, 0), ("Vanilla", 10, 4), ("Barrier", 10, 4),
            ("Time", 9, 3)],
           [("Black-Scholes (const σ)", out["bs_vanilla"], None, None),
            ("FDM (const σ)", out["fdm_vanilla"], out["fdm_barrier"],
             f"{t['fdm']:.3f}s"),
            ("FDM (local vol)", out["fdm_lv_vanilla"], None,
             f"{t['fdm_lv']:.3f}s"),
            ("MC+Milstein (local vol)", out["mc_vanilla"], out["mc_barrier"],
             f"{t['mc_paths']:.3f}s"),
            ("Fused kernel (local vol)", None, out["fused_barrier"],
             f"{t['fused']:.3f}s")])
    print(f"\n  MC barrier stderr: {out['mc_se']:.4f} (path matrix) / "
          f"{out['fused_se']:.4f} (fused)  ({out['n_paths']:,} paths, "
          f"{out['n_steps']} steps)")

    _banner(5, "Greeks (FDM Grid vs Bump-and-Reprice)")
    print()
    _table([("Greek", 8, 0), ("FDM Grid", 12, 6), ("Bump&Reprice", 14, 6)],
           [(g, out["grid_greeks"].get(g), out["bump_greeks"][g])
            for g in GREEKS])

    _banner(6, "Summary")
    knockdown = 100.0 * (1.0 - out["fdm_barrier"] / out["fdm_vanilla"])
    lv_shift = out["fdm_lv_vanilla"] - out["fdm_vanilla"]
    for label, text in (
            ("Barrier knock-down", f"{knockdown:.1f}% (barrier "
                                   f"{c['barrier_type']} at {c['barrier']})"),
            ("Local-vol adjustment", f"{lv_shift:+.4f} "
                                     f"({100 * lv_shift / out['fdm_vanilla']:+.2f}%"
                                     " of vanilla)"),
            ("FDM vs MC barrier diff",
             f"{abs(out['fdm_barrier'] - out['mc_barrier']):.4f}"),
            ("BS vs FDM vanilla diff",
             f"{abs(out['bs_vanilla'] - out['fdm_vanilla']):.4f}")):
        print(f"  {label + ':':<26s}{text}")
    print()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--n-paths", type=int, default=200_000)
    ap.add_argument("--n-steps", type=int, default=500)
    ns = ap.parse_args(argv)
    report(run(ns.n_paths, ns.n_steps, device=ns.device))


if __name__ == "__main__":
    main()

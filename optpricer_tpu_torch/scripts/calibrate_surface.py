"""Volatility-surface calibration: market IV quotes in, fitted params out.

Counterpart of ``scripts/calibrate_surface.py``: reads a CSV with columns
``expiry,strike,forward,iv`` and writes JSON. ``--model svi`` (the
default) maps each expiry (as a string key) to ``{a, b, rho, m, sigma,
rmse}`` from per-slice raw SVI (one batched Levenberg-Marquardt call when
every expiry quotes the same number of strikes), then screens the fitted
surface for static arbitrage; ``essvi`` fits one global eSSVI surface and
exports its slices the same way; ``heston`` and ``vg`` fit one global
model through the COS pricers (``fit_heston`` / ``fit_vg``), the carry
inferred from the forward curve. ``--plot`` renders market-vs-fit smiles
when matplotlib is installed and says so when it is not.

    python -m optpricer_tpu_torch.scripts.calibrate_surface \\
        --input quotes.csv --output fit.json [--model heston --rate 0.02] \\
        [--plot smile.png] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np

from ..models.calibration import SVIParams, fit_svi, fit_svi_surface


def load_quote_grid(path):
    """Per-expiry strike arrays, forwards (the last quoted forward wins)
    and IV arrays, keyed by expiry (float, ascending)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    expiries = sorted({float(r["expiry"]) for r in rows})
    strikes, forwards, ivs = {}, {}, {}
    for T in expiries:
        mine = [r for r in rows if float(r["expiry"]) == T]
        strikes[T] = np.array([float(r["strike"]) for r in mine])
        ivs[T] = np.array([float(r["iv"]) for r in mine])
        forwards[T] = float(mine[-1]["forward"])
    return strikes, forwards, ivs


def fit_all_slices(strikes, forwards, ivs, device=None):
    """Fit every expiry; one batched LM when the strike grids are the same
    size."""
    sizes = {len(v) for v in strikes.values()}
    if len(sizes) == 1 and len(strikes) > 1:
        return fit_svi_surface(strikes, forwards, ivs, device=device).slices
    return {T: fit_svi(strikes[T], forwards[T], T, ivs[T], device=device)
            for T in strikes}


def slice_report(svi: SVIParams, strikes, forward, market_iv) -> dict:
    k = np.log(strikes / forward)
    resid = np.asarray(svi.iv(k, device="cpu")) - market_iv
    return {"a": svi.a, "b": svi.b, "rho": svi.rho, "m": svi.m,
            "sigma": svi.sigma,
            "rmse": float(np.sqrt(np.mean(resid * resid)))}


def render_smiles(path, fits, strikes, forwards, ivs, *, model_iv=None,
                  label="SVI fit"):
    """One panel per expiry: market dots and the fitted smile (``fits``'
    slices, or ``model_iv(T, F, k)`` for a global model)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not installed — skipping plot.")
        return

    expiries = sorted(strikes)
    fig, axes = plt.subplots(1, len(expiries), squeeze=False,
                             figsize=(5 * len(expiries), 4))
    for ax, T in zip(axes.ravel(), expiries):
        k_obs = np.log(strikes[T] / forwards[T])
        span = np.linspace(k_obs.min() - 0.1, k_obs.max() + 0.1, 200)
        if model_iv is not None:
            curve = model_iv(T, forwards[T], span)
        else:
            curve = np.asarray(fits[T].iv(span, device="cpu"))
        ax.plot(k_obs, ivs[T], "o", markersize=4, label="Market")
        ax.plot(span, curve, "-", label=label)
        ax.set(title=f"T = {T}", xlabel="log-moneyness k",
               ylabel="Implied Vol")
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    print(f"Plot saved to {path}")


def spot_and_carry(forwards, rate):
    """(S0, q) from the forward curve, ln F(T) = ln S0 + (r−q)·T by least
    squares; a single expiry gives S0 = F and q = r."""
    Ts = np.array(sorted(forwards))
    lnF = np.log([forwards[T] for T in Ts])
    if len(Ts) < 2:
        return float(np.exp(lnF[0])), rate
    c, ln_s0 = np.polyfit(Ts, lnF, 1)
    return float(np.exp(ln_s0)), rate - float(c)


def _quote_vectors(strikes, ivs):
    Ks = np.concatenate([strikes[T] for T in sorted(strikes)])
    Ts = np.concatenate([np.full(len(strikes[T]), T)
                         for T in sorted(strikes)])
    vols = np.concatenate([ivs[T] for T in sorted(strikes)])
    return Ks, Ts, vols


def fit_heston_surface(strikes, forwards, ivs, rate, device=None):
    """One global Heston fit across every quoted expiry."""
    from ..models.analytic import fit_heston

    S0, q = spot_and_carry(forwards, rate)
    fit = fit_heston(*_quote_vectors(strikes, ivs), S0, rate, q,
                     device=device)
    return fit, S0, q


def fit_vg_surface(strikes, forwards, ivs, rate, device=None):
    """One global Variance-Gamma fit across every quoted expiry."""
    from ..models.levy import fit_vg

    S0, q = spot_and_carry(forwards, rate)
    fit = fit_vg(*_quote_vectors(strikes, ivs), S0, rate, q, device=device)
    return fit, S0, q


def _model_iv(pricer, S0, rate, q, device):
    """Per-expiry smile k ↦ implied vol of a global model's COS prices."""
    from ..ops.black_scholes import bs_implied_vol_vec

    def iv_curve(T, forward, k):
        K = forward * np.exp(np.asarray(k))
        px = pricer(K, T).cpu().numpy()
        return bs_implied_vol_vec(S0, K, np.full_like(K, T), rate, q, px,
                                  "call", device=device).cpu().numpy()

    return iv_curve


def vg_model_iv(fit, S0, rate, q, device=None):
    """Per-expiry smile function k -> implied vol from the fitted VG."""
    from ..models.levy import vg_price_cos

    return _model_iv(lambda K, T: vg_price_cos(
        S0, K, T, rate, q, sigma=fit["sigma"], theta=fit["theta"],
        nu=fit["nu"], device=device), S0, rate, q, device)


def heston_model_iv(fit, S0, rate, q, device=None):
    """Per-expiry smile function k -> implied vol from the fitted Heston."""
    from ..models.analytic import heston_price_cos

    return _model_iv(lambda K, T: heston_price_cos(
        S0, K, T, rate, q, v0=fit["v0"], kappa=fit["kappa"],
        theta=fit["theta"], xi=fit["xi"], rho=fit["rho"], device=device),
        S0, rate, q, device)


def _global_model(ns, strikes, forwards, ivs):
    """The ``heston`` / ``vg`` routes: fit, print, write, plot."""
    if ns.model == "heston":
        fit, S0, q = fit_heston_surface(strikes, forwards, ivs, ns.rate,
                                        ns.device)
        print("  Heston: v0={v0:.4f} kappa={kappa:.4f} theta={theta:.4f} "
              "xi={xi:.4f} rho={rho:.4f} RMSE={rmse:.6f}".format(**fit))
        curve, label = heston_model_iv, "Heston fit"
    else:
        fit, S0, q = fit_vg_surface(strikes, forwards, ivs, ns.rate,
                                    ns.device)
        print("  VG: sigma={sigma:.4f} theta={theta:.4f} nu={nu:.4f} "
              "RMSE={rmse:.6f}".format(**fit))
        curve, label = vg_model_iv, "VG fit"
    report = dict(model=ns.model, S0=S0, r=ns.rate, q=q, **fit)
    Path(ns.output).write_text(json.dumps(report, indent=2))
    print(f"\nFitted params written to {ns.output}")
    if ns.plot:
        render_smiles(ns.plot, None, strikes, forwards, ivs,
                      model_iv=curve(fit, S0, ns.rate, q, ns.device),
                      label=label)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fit a volatility surface to market IV data.")
    ap.add_argument("--input", required=True, help="market data CSV")
    ap.add_argument("--output", required=True, help="output JSON")
    ap.add_argument("--plot", default=None, help="save smile plot PNG")
    ap.add_argument("--model", default="svi",
                    choices=("svi", "heston", "essvi", "vg"),
                    help="svi: per-slice raw SVI; heston / vg: one global "
                         "model via LM through the COS transform; essvi: "
                         "one global arbitrage-free-by-construction "
                         "surface (slices exported as raw SVI)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="risk-free rate for the heston and vg models (the "
                         "carry r−q is inferred from the forward curve)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)

    strikes, forwards, ivs = load_quote_grid(ns.input)
    total = sum(map(len, strikes.values()))
    print(f"Loaded {total} quotes across {len(strikes)} expiries.")

    if ns.model in ("heston", "vg"):
        _global_model(ns, strikes, forwards, ivs)
        return

    if ns.model == "essvi":
        from ..models.calibration import fit_essvi

        surface, info = fit_essvi(strikes, forwards, ivs, device=ns.device)
        fits = surface.slices
        print("  eSSVI: rho={rho:.4f} eta={eta:.4f} gamma={gamma:.4f} "
              "RMSE_w={rmse_w:.2e}".format(**info))
        print("  theta:", " ".join(f"{t:.5f}" for t in info["theta"]))
    else:
        fits = fit_all_slices(strikes, forwards, ivs, ns.device)
    report = {}
    for T in sorted(fits):
        rep = slice_report(fits[T], strikes[T], forwards[T], ivs[T])
        report[str(T)] = rep
        print("  T={:.4f}: a={a:.4f} b={b:.4f} rho={rho:.4f} m={m:.4f} "
              "sig={sigma:.4f} RMSE={rmse:.6f}".format(T, **rep))

    Path(ns.output).write_text(json.dumps(report, indent=2))
    print(f"\nFitted params written to {ns.output}")

    # static-arbitrage screen: a least-squares fit to noisy quotes can
    # embed butterfly/calendar arbitrage without any fitting-loss signal
    from ..models.calibration import VolSurface, arbitrage_report

    arb = arbitrage_report(VolSurface(fits, forward_curve=forwards,
                                      device=ns.device), device=ns.device)
    if arb["ok"]:
        print("Arbitrage screen: CLEAN (butterfly g>=0 on every slice, "
              "calendar non-crossing)")
    else:
        for T, b in sorted(arb["butterfly"].items()):
            if not b["ok"]:
                print(f"  WARNING butterfly arbitrage at T={T:.4f}: "
                      f"min g = {b['min_g']:.4g} at k={b['k_at_min']:.3f}")
        cal = arb["calendar"]
        if not cal["ok"]:
            print(f"  WARNING calendar arbitrage between T={cal['pair']}: "
                  f"min dw = {cal['min_gap']:.4g} at k={cal['k_at_min']:.3f}")

    if ns.plot:
        render_smiles(ns.plot, fits, strikes, forwards, ivs)


if __name__ == "__main__":
    main()

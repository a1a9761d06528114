"""Batch-price an options portfolio (CSV → CSV/JSON).

Counterpart of ``scripts/price_book.py``: the same CSV schema
(``id,S0,K,T,r,sigma,q,kind,method[,method columns]``), the same method
rows (``bs``, ``binomial``, ``amer_analytic``, ``mc``, ``exotic``,
``lsmc``, ``qmc``, ``fd``, ``mlmc``, ``heston``, ``levy``, ``quanto``,
``forward_start``, ``cliquet``, ``chooser``, ``compound``, ``basket``),
the same output columns and the same per-row error capture, so one bad
position never aborts the batch.

Two book routes price many rows in one call: every well-formed ``bs`` row
in one vectorised Black-Scholes call (when there are two or more), and
every well-formed ``mc`` row in one launch of the book kernel K3
(``ops/mc_batch.euro_price_mc_batch``, 100 000 paths a contract, seed 1;
its plain version on the CPU). A row is well formed when its market cells
parse and its kind is call or put; any other row is priced on its own and
its error captured. The capture takes the errors a bad row raises (a cell
that does not parse, a missing column, an argument an engine refuses) and
nothing else; the book calls run with no catch at all. So a kernel that
fails to build or launch raises.

    python -m optpricer_tpu_torch.scripts.price_book --input book.csv \\
        --output prices.csv [--greeks] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np

from ..core import OptionSpec
from ..models.binomial import crr
from ..models.exotics import (asian_price, barrier_price, digital_price,
                              lookback_price)
from ..models.monte_carlo import euro_price_mc
from ..models.processes import gbm_paths
from ..ops.black_scholes import bs_greeks_vec, bs_price_vec

GREEK_KEYS = ("delta", "gamma", "vega", "theta", "rho")
_MARKET = ("S0", "K", "T", "r", "sigma")
# what a malformed row raises; a kernel's build or launch failure is a
# RuntimeError and is not among them
_ROW_ERRORS = (ValueError, KeyError, TypeError, ArithmeticError,
               IndexError)


def _parse_div_cell(row: dict):
    """[(t, amount), ...] from a ';'-separated 't:amt' dividends cell;
    None when absent or empty."""
    cell = (row.get("dividends", "") or "").strip()
    if not cell:
        return None
    return [(float(t), float(d)) for t, d in
            (pair.split(":") for pair in cell.split(";"))]


def _cell(row: dict, name: str, default: str) -> str:
    return (row.get(name, default) or default).strip().lower()


def _greeks(S0, K, T, r, q, sigma, kind, device) -> dict:
    g = bs_greeks_vec(S0, K, T, r, q, sigma, kind, device=device)
    return {key: float(g[key]) for key in GREEK_KEYS}


def _price_row(row: dict, compute_greeks: bool, device) -> dict:
    rid = row.get("id", "")
    method = row["method"].strip().lower()
    kind = row["kind"].strip().lower()
    # K may be blank for strike-free products (cliquet, forward_start);
    # strike-based methods fail per row through the error capture
    k_cell = str(row.get("K", "") or "").strip()
    K = float(k_cell) if k_cell else None
    T, r = float(row["T"]), float(row["r"])
    q = float(row.get("q", 0.0) or 0.0)
    result = {"id": rid, "price": None, "stderr": None}
    dev = dict(device=device)
    if method != "basket":
        # basket rows carry ';'-separated per-asset values in these cells
        S0, sigma = float(row["S0"]), float(row["sigma"])

    if method == "bs":
        result["price"] = float(bs_price_vec(S0, K, T, r, q, sigma, kind,
                                             **dev))
    elif method == "binomial":
        opt = OptionSpec(S0=S0, K=K, T=T, r=r, sigma=sigma, q=q)
        american = str(row.get("american", "false")).strip().lower() == "true"
        result["price"] = crr(opt, kind, N=500, american=american, **dev)
    elif method == "amer_analytic":
        # engine cell bs2002 (default) | baw; a D cell > 0 prices the call
        # by Roll-Geske-Whaley
        from ..models.american_analytic import (baw_price,
                                                bjerksund_stensland_price,
                                                rgw_price)

        D = float(row.get("D", 0.0) or 0.0)
        if D > 0.0:
            result["price"] = float(rgw_price(
                S0, K, T, r, sigma=sigma, D=D, t_div=float(row["t_div"]),
                **dev))
        elif _cell(row, "engine", "") == "baw":
            result["price"] = float(baw_price(S0, K, T, r, q, sigma=sigma,
                                              kind=kind, **dev))
        else:
            result["price"] = float(bjerksund_stensland_price(
                S0, K, T, r, q, sigma=sigma, kind=kind, **dev))
    elif method == "mc":
        opt = OptionSpec(S0=S0, K=K, T=T, r=r, sigma=sigma, q=q)
        px, se = euro_price_mc(opt, kind, n_paths=100_000, seed=1, **dev)
        result["price"], result["stderr"] = px, se
    elif method == "exotic":
        exotic_type = row.get("exotic_type", "").strip().lower()
        n_steps = int(row.get("n_steps", 500) or 500)
        n_paths = int(row.get("n_paths", 100_000) or 100_000)
        paths = gbm_paths(S0, r, q, sigma, T, n_steps, n_paths,
                          antithetic=True, seed=1, **dev)
        if exotic_type == "barrier":
            px, se = barrier_price(
                paths, K, r, T, kind, float(row["barrier"]),
                row["barrier_type"].strip().lower(),
                float(row.get("rebate", 0.0) or 0.0))
        elif exotic_type == "asian":
            px, se = asian_price(
                paths, K, r, T, kind,
                row.get("average_type", "arithmetic").strip().lower(),
                row.get("strike_type", "fixed").strip().lower())
        elif exotic_type == "digital":
            px, se = digital_price(paths, K, r, T, kind,
                                   float(row.get("payout", 1.0) or 1.0))
        elif exotic_type == "lookback":
            px, se = lookback_price(
                paths, r, T, kind, K=K,
                strike_type=row.get("strike_type",
                                    "floating").strip().lower())
        else:
            raise ValueError(f"Unknown exotic_type: {exotic_type!r}")
        result["price"], result["stderr"] = px, se
    elif method == "lsmc":
        from ..models.american_mc import lsmc_price

        opt = OptionSpec(S0=S0, K=K, T=T, r=r, sigma=sigma, q=q)
        px, se = lsmc_price(
            opt, kind, n_paths=int(row.get("n_paths", 100_000) or 100_000),
            n_steps=int(row.get("n_steps", 50) or 50), seed=1, **dev)
        result["price"], result["stderr"] = px, se
    elif method in ("qmc", "mlmc"):
        family = dict(
            barrier=float(row.get("barrier", 0.0) or 0.0),
            barrier_type=_cell(row, "barrier_type", "up-and-out"),
            average_type=_cell(row, "average_type", "arithmetic"),
            strike_type=_cell(row, "strike_type", "fixed"),
            payout=float(row.get("payout", 1.0) or 1.0))
        payoff = row.get("exotic_type", "vanilla").strip().lower() \
            or "vanilla"
        if method == "qmc":
            from ..models.mc_fused import exotic_price_mc

            px, se = exotic_price_mc(
                payoff, S0, K, T, r, q, sigma=sigma, kind=kind,
                backend="qmc",
                n_paths=int(row.get("n_paths", 65_536) or 65_536),
                n_steps=int(row.get("n_steps", 64) or 64), seed=1,
                **family, **dev)
        else:
            # continuous-monitoring limit at target RMSE
            from ..models.mlmc import mlmc_price

            px, se = mlmc_price(
                payoff, S0, K, T, r, q, sigma=sigma, kind=kind,
                eps=float(row.get("eps", 0.01) or 0.01), seed=1, **family,
                **dev)
        result["price"], result["stderr"] = px, se
    elif method == "fd":
        # θ-scheme PDE rows: optional american / dividends columns
        from ..models.pde import fd_price

        opt = OptionSpec(S0=S0, K=K, T=T, r=r, sigma=sigma, q=q)
        result["price"] = fd_price(
            opt, kind, N_S=int(row.get("N_S", 400) or 400),
            N_t=int(row.get("N_t", 400) or 400),
            american=str(row.get("american", "false")).strip().lower()
            == "true", dividends=_parse_div_cell(row), **dev)
    elif method == "heston":
        # optional v0/kappa/theta/xi/rho columns (default σ²-flat);
        # 'american' truthy, dividends or a barrier → the 2-D ADI PDE,
        # else the COS transform
        hp = dict(
            v0=float(row.get("v0", 0.0) or sigma * sigma),
            kappa=float(row.get("kappa", 1.5) or 1.5),
            theta=float(row.get("theta", 0.0) or sigma * sigma),
            xi=float(row.get("xi", 0.4) or 0.4),
            rho=float(row.get("rho", -0.6) or -0.6))
        american = str(row.get("american", "")).strip().lower() in (
            "1", "true", "yes")
        barrier = float(row.get("barrier", 0.0) or 0.0)
        divs = _parse_div_cell(row)
        if divs is not None and barrier > 0.0:
            raise ValueError("dividends with barrier not supported on "
                             "heston rows")
        if barrier > 0.0:
            from ..models.heston_pde import heston_fd_price_barrier

            result["price"] = heston_fd_price_barrier(
                S0, K, T, r, q, **hp, kind=kind, barrier=barrier,
                barrier_type=_cell(row, "barrier_type", "up-and-out"),
                american=american, **dev)
        elif american or divs is not None:
            from ..models.heston_pde import heston_fd_price

            result["price"] = heston_fd_price(S0, K, T, r, q, **hp,
                                              kind=kind, american=american,
                                              dividends=divs, **dev)
        else:
            from ..models.analytic import heston_price_cos

            result["price"] = float(heston_price_cos(S0, K, T, r, q, **hp,
                                                     kind=kind, **dev))
    elif method == "levy":
        # 'model' column vg|nig|cgmy with the model's parameter columns,
        # priced by the COS transform
        from ..models import levy

        model = _cell(row, "model", "vg")
        if model == "vg":
            px = levy.vg_price_cos(
                S0, K, T, r, q, sigma=sigma,
                theta=float(row.get("theta_vg", -0.14) or -0.14),
                nu=float(row.get("nu", 0.2) or 0.2), kind=kind, **dev)
        elif model == "nig":
            px = levy.nig_price_cos(
                S0, K, T, r, q, alpha=float(row.get("alpha", 8.0) or 8.0),
                beta=float(row.get("beta", -4.0) or -4.0),
                delta=float(row.get("delta", 0.4) or 0.4), kind=kind, **dev)
        elif model == "cgmy":
            px = levy.cgmy_price_cos(
                S0, K, T, r, q, C=float(row.get("C", 0.5) or 0.5),
                G=float(row.get("G", 5.0) or 5.0),
                M=float(row.get("M", 9.0) or 9.0),
                Y=float(row.get("Y", 0.8) or 0.8), kind=kind, **dev)
        else:
            raise ValueError(f"Unknown levy model: {model!r}")
        result["price"] = float(px)
    elif method == "quanto":
        # sigma_fx / rho_sfx columns feed the adjusted-carry closed form
        from ..models.analytic import quanto_price

        result["price"] = float(quanto_price(
            S0, K, T, r, q, sigma_S=sigma,
            sigma_fx=float(row.get("sigma_fx", 0.0) or 0.0),
            rho_sfx=float(row.get("rho_sfx", 0.0) or 0.0), kind=kind,
            **dev))
    elif method == "forward_start":
        # strike k_ratio x S_T0 set at T0: Rubinstein under GBM
        from ..models.cliquet import forward_start_price

        result["price"] = forward_start_price(
            S0, float(row.get("k_ratio", 1.0) or 1.0), float(row["T0"]), T,
            r, q, sigma=sigma, kind=kind, method="closed", **dev)
    elif method == "cliquet":
        # a global_floor column switches the closed form to MC
        from ..models.cliquet import cliquet_price_bs, cliquet_price_mc

        kwc = dict(sigma=sigma,
                   n_periods=int(row.get("n_periods", 12) or 12),
                   local_floor=float(row.get("local_floor", 0.0) or 0.0),
                   local_cap=float(row.get("local_cap", 0.08) or 0.08))
        gf = (row.get("global_floor", "") or "").strip()
        if gf:
            px, se = cliquet_price_mc(
                S0, T, r, q, global_floor=float(gf),
                n_paths=int(row.get("n_paths", 262_144) or 262_144),
                seed=1, **kwc, **dev)
            result["price"], result["stderr"] = px, se
        else:
            result["price"] = cliquet_price_bs(S0, T, r, q, **kwc)
    elif method == "chooser":
        from ..models.analytic import chooser_price

        result["price"] = float(chooser_price(
            S0, K, T, r, q, sigma=sigma, t_choose=float(row["t_choose"]),
            **dev))
    elif method == "compound":
        # K is the outer strike at t_choose, K2 the inner strike to T;
        # 'underlying' call|put picks the inner option
        from ..models.analytic import compound_price

        result["price"] = float(compound_price(
            S0, K, float(row["K2"]), float(row["t_choose"]), T, r, q,
            sigma=sigma, kind=kind,
            underlying=_cell(row, "underlying", "call"), **dev))
    elif method == "basket":
        # S0/sigma cells hold ';'-separated per-asset values; optional
        # weights, rho, basket_payoff, american and qs columns
        from ..models.basket import basket_exotic_mc, basket_price_mc

        S0s = [float(x) for x in str(row["S0"]).split(";")]
        sigs = [float(x) for x in str(row["sigma"]).split(";")]
        a = len(S0s)
        wcell = str(row.get("weights", "") or "").strip()
        w = ([float(x) for x in wcell.split(";")] if wcell
             else [1.0 / a] * a)
        rho = float(row.get("rho", 0.3) or 0.3)
        corr = rho * np.ones((a, a)) + (1.0 - rho) * np.eye(a)
        bp = _cell(row, "basket_payoff", "basket")
        qcell = str(row.get("qs", "") or "").strip()
        qs_b = [float(x) for x in qcell.split(";")] if qcell else None
        american = str(row.get("american", "")).strip().lower() in (
            "1", "true", "yes")
        common = dict(sigmas=sigs, corr=corr, kind=kind,
                      n_paths=int(row.get("n_paths", 262_144) or 262_144),
                      seed=1, **dev)
        if american:
            if bp not in ("basket", "rainbow_max", "rainbow_min"):
                raise ValueError("american basket rows support basket/"
                                 "rainbow payoffs only")
            from ..models.american_mc import lsmc_price_basket

            px, se = lsmc_price_basket(
                S0s, w, K, T, r, qs_b, payoff=bp,
                n_steps=int(row.get("n_steps", 50) or 50), **common)
        elif bp in ("asian_basket", "worstof_barrier", "basket_barrier"):
            px, se = basket_exotic_mc(
                S0s, w, K, T, r, qs_b, payoff=bp,
                barrier=float(row.get("barrier", 0.0) or 0.0),
                barrier_type=_cell(row, "barrier_type", "down-and-in"),
                n_steps=int(row.get("n_steps", 64) or 64), **common)
        else:
            px, se = basket_price_mc(S0s, w, K, T, r, qs_b, payoff=bp,
                                     **common)
        result["price"], result["stderr"] = px, se
    else:
        raise ValueError(f"Unknown method: {method!r}")

    if compute_greeks and method in ("bs", "binomial", "mc"):
        # Black-Scholes Greeks for the vanilla rows
        result.update(_greeks(S0, K, T, r, q, sigma, kind, device))
    return result


def _book_columns(rows, idx, spec: bool = False):
    """The market columns of the rows ``idx`` as f64 arrays and their
    kinds, or None when a cell does not parse, a kind is not call/put or,
    with ``spec``, a row is not a valid
    :class:`~optpricer_tpu_torch.core.OptionSpec`."""
    try:
        cols = {c: np.array([float(rows[i][c]) for i in idx])
                for c in _MARKET}
        cols["q"] = np.array([float(rows[i].get("q", 0.0) or 0.0)
                              for i in idx])
        for j in range(len(idx) if spec else 0):
            OptionSpec(*(float(cols[c][j]) for c in _MARKET),
                       q=float(cols["q"][j]))
    except (KeyError, TypeError, ValueError):
        return None
    kinds = np.array([rows[i]["kind"].strip().lower() for i in idx])
    if not np.isin(kinds, ("call", "put")).all():
        return None
    return cols, kinds


def _book_rows(rows, method: str):
    """Indices of the well-formed rows of ``method`` and their columns: the
    rows its per-row branch would price, so that a row's result does not
    depend on how many rows of its method the book has (the mc branch
    builds an OptionSpec, the bs branch takes any parsed numbers)."""
    spec = method == "mc"
    idx = [i for i, row in enumerate(rows)
           if row["method"].strip().lower() == method
           and _book_columns(rows, [i], spec) is not None]
    return idx, (_book_columns(rows, idx, spec) if idx else None)


def price_book(rows, compute_greeks: bool = False, device=None) -> list:
    """Price every row; a failing row becomes ``{"id", "price": None,
    "error"}``. Returns the result dicts in row order."""
    book = {}
    mc_idx, mc_cols = _book_rows(rows, "mc")
    if len(mc_idx) > 1:
        # every well-formed MC row in one launch of the book kernel (K3)
        from ..ops.mc_batch import euro_price_mc_batch

        cols, kinds = mc_cols
        px, se = euro_price_mc_batch(
            cols["S0"], cols["K"], cols["T"], cols["r"], cols["q"],
            cols["sigma"], kinds, n_paths=100_000, seed=1, device=device)
        for j, i in enumerate(mc_idx):
            book[i] = {"id": rows[i].get("id", ""), "price": float(px[j]),
                       "stderr": float(se[j])}
    bs_idx, bs_cols = _book_rows(rows, "bs")
    if len(bs_idx) > 1:
        # every well-formed Black-Scholes row in one vectorised call
        cols, kinds = bs_cols
        args = (cols["S0"], cols["K"], cols["T"], cols["r"], cols["q"],
                cols["sigma"], kinds)
        px = bs_price_vec(*args, device=device).cpu().numpy()
        for j, i in enumerate(bs_idx):
            book[i] = {"id": rows[i].get("id", ""), "price": float(px[j]),
                       "stderr": None}
        if compute_greeks:
            g = {k: v.cpu().numpy() for k, v in
                 bs_greeks_vec(*args, device=device).items()}
            for j, i in enumerate(bs_idx):
                book[i].update({k: float(g[k][j]) for k in GREEK_KEYS})
    if compute_greeks:
        for i in mc_idx if len(mc_idx) > 1 else ():
            row = rows[i]
            book[i].update(_greeks(*(float(row[c]) for c in _MARKET[:4]),
                                   float(row.get("q", 0.0) or 0.0),
                                   float(row["sigma"]),
                                   row["kind"].strip().lower(), device))

    results = []
    for i, row in enumerate(rows):
        if i in book:
            results.append(book[i])
            continue
        try:
            results.append(_price_row(row, compute_greeks, device))
        except _ROW_ERRORS as e:   # one bad position never aborts the batch
            print(f"  Row {i} (id={row.get('id', '?')}): ERROR — {e}")
            results.append({"id": row.get("id", ""), "price": None,
                            "error": str(e)})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch-price an options "
                                             "portfolio.")
    ap.add_argument("--input", required=True, help="portfolio CSV")
    ap.add_argument("--output", required=True,
                    help="output path (.csv/.json)")
    ap.add_argument("--greeks", action="store_true", help="compute Greeks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with open(args.input, newline="") as f:
        rows = list(csv.DictReader(f))
    print(f"Pricing {len(rows)} positions...")
    results = price_book(rows, args.greeks, args.device)

    output_path = Path(args.output)
    if output_path.suffix == ".json":
        with open(output_path, "w") as f:
            json.dump(results, f, indent=2, default=str)
    else:
        fieldnames = list(results[0].keys())
        for r in results:
            for k in r:
                if k not in fieldnames:
                    fieldnames.append(k)
        with open(output_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames,
                                    extrasaction="ignore")
            writer.writeheader()
            writer.writerows(results)
    print(f"Results written to {args.output}")

    priced = [r for r in results if r.get("price") is not None]
    print(f"  Priced: {len(priced)}  |  Failed: {len(results) - len(priced)}")


if __name__ == "__main__":
    main()

"""Port vs reference: ``scripts/price_book.py``.

The reference script (imported from ``scripts/``, run in this process
with x64 on) and ``python -m optpricer_tpu_torch.scripts.price_book
--device cpu`` price the same book, one row of every method at small
sizes plus three malformed rows: the deterministic rows agree at rtol 1e-9,
the Monte-Carlo rows within 4·hypot(se, se), the malformed rows carry the
same error. The book routes: the bs rows in one vectorised call, the mc
rows in one ``euro_price_mc_batch`` call (K3's plain version here), a
malformed row priced on its own with its error captured, and a failure of
the book call or of an engine's kernel raised, not captured.
"""
import csv
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from optpricer_tpu_torch.scripts import price_book as tpb
from tests.torch_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
BASE = dict(S0="100", K="100", T="1", r="0.05", sigma="0.2", q="0",
            kind="call")
ROWS = [
    dict(id="bs1", method="bs"),
    dict(id="bs2", K="110", T="0.5", r="0.03", sigma="0.25", q="0.01",
         kind="put", method="bs"),
    dict(id="bin1", K="105", kind="put", method="binomial", american="true"),
    dict(id="am1", K="105", q="0.02", kind="put", method="amer_analytic",
         engine="baw"),
    dict(id="am2", K="105", method="amer_analytic"),
    dict(id="am3", K="105", method="amer_analytic", D="2", t_div="0.5"),
    dict(id="mc1", method="mc"),
    dict(id="mc2", S0="95", T="0.75", r="0.03", sigma="0.3", q="0.01",
         kind="put", method="mc"),
    dict(id="ex1", method="exotic", exotic_type="asian", n_steps="16",
         n_paths="20000"),
    dict(id="ex2", method="exotic", exotic_type="barrier", barrier="130",
         barrier_type="up-and-out", n_steps="16", n_paths="20000"),
    dict(id="lsmc1", K="110", sigma="0.25", kind="put", method="lsmc",
         n_steps="16", n_paths="20000"),
    dict(id="qmc1", method="qmc", exotic_type="asian", n_steps="16",
         n_paths="4096"),
    dict(id="fd1", kind="put", method="fd", american="true", N_S="200",
         N_t="200", dividends="0.5:2"),
    dict(id="mlmc1", method="mlmc", exotic_type="vanilla", eps="0.05"),
    dict(id="hes1", K="110", kind="put", method="heston", american="true",
         v0="0.04", xi="0.5"),
    dict(id="hes2", method="heston", v0="0.04", xi="0.5"),
    dict(id="levy1", method="levy", model="nig"),
    dict(id="levy2", kind="put", method="levy", model="vg"),
    dict(id="quanto1", q="0.01", method="quanto", sigma_fx="0.1",
         rho_sfx="-0.3"),
    dict(id="fs1", K="", T="1.5", r="0.03", sigma="0.25", q="0.01",
         kind="put", method="forward_start", k_ratio="1.05", T0="0.5"),
    dict(id="cl1", K="", r="0.03", method="cliquet", local_floor="-0.02",
         local_cap="0.05"),
    dict(id="cl2", K="", r="0.03", method="cliquet", local_floor="-0.02",
         local_cap="0.05", global_floor="0.01", n_paths="20000"),
    dict(id="ch1", method="chooser", t_choose="0.5"),
    dict(id="co1", K="5", method="compound", t_choose="0.5", K2="100",
         underlying="put"),
    dict(id="bk1", S0="100;95;105", sigma="0.2;0.3;0.25", r="0.03",
         method="basket", basket_payoff="asian_basket", n_steps="8",
         n_paths="8192"),
    dict(id="bad1", K="abc", method="mc"),
    dict(id="bad2", method="nosuch"),
    dict(id="bad3", sigma="0", method="mc"),
]


def _write(path, rows):
    rows = [dict(BASE, **r) for r in rows]
    cols = list(dict.fromkeys(c for r in rows for c in r))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols)
        writer.writeheader()
        writer.writerows(rows)
    return rows


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_price_book", REPO / "scripts" / "price_book.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("book")
    _write(tmp / "book.csv", ROWS)
    argv = sys.argv
    try:
        sys.argv = ["price_book.py", "--input", str(tmp / "book.csv"),
                    "--output", str(tmp / "ref.json")]
        _reference_script().main()
    finally:
        sys.argv = argv
    tpb.main(["--input", str(tmp / "book.csv"), "--output",
              str(tmp / "port.json"), "--device", "cpu"])
    # the CSV route with Greeks on the vanilla rows and a COS row
    _write(tmp / "vanilla.csv", [r for r in ROWS if r["id"] in (
        "bs1", "bs2", "bin1", "mc1", "mc2", "hes2")])
    tpb.main(["--input", str(tmp / "vanilla.csv"), "--output",
              str(tmp / "port.csv"), "--device", "cpu", "--greeks"])
    ref = json.loads((tmp / "ref.json").read_text())
    port = json.loads((tmp / "port.json").read_text())
    with open(tmp / "port.csv", newline="") as f:
        port_csv = list(csv.DictReader(f))
    return ref, port, port_csv


def test_deterministic_rows_match_reference(books):
    ref, port, _ = books
    assert [r["id"] for r in port] == [r["id"] for r in ref]
    n = 0
    for a, b in zip(port, ref):
        if b.get("price") is not None and b["stderr"] is None:
            assert a["stderr"] is None, a
            assert abs(a["price"] - b["price"]) <= 1e-9 * abs(b["price"]), \
                (a, b)
            n += 1
    assert n == 16


def test_monte_carlo_rows_within_reference_error(books):
    ref, port, _ = books
    n = 0
    for a, b in zip(port, ref):
        if b.get("stderr") is not None:
            assert abs(a["price"] - b["price"]) <= 4.0 * np.hypot(
                a["stderr"], b["stderr"]), (a, b)
            n += 1
    assert n == 9


def test_malformed_rows_carry_the_reference_error(books):
    ref, port, _ = books
    for a, b in zip(port, ref):
        assert a.get("error") == b.get("error")
        if b.get("error"):
            assert a["price"] is None and a.keys() == b.keys()


def test_csv_output_has_the_greek_columns(books):
    _, port, rows = books
    assert [r["id"] for r in rows] == ["bs1", "bs2", "bin1", "mc1", "mc2",
                                       "hes2"]
    by_id = {r["id"]: r for r in rows}
    for rid in ("bs1", "bs2", "bin1", "mc1", "mc2"):
        assert all(by_id[rid][k] != "" for k in tpb.GREEK_KEYS), rid
    assert by_id["hes2"]["delta"] == ""
    assert float(by_id["mc1"]["price"]) == next(
        r["price"] for r in port if r["id"] == "mc1")


def test_book_routes_price_the_rows_together(monkeypatch):
    rows = [dict(BASE, **r) for r in ROWS if r["method"] in ("bs", "mc")]
    calls = []
    real = tpb.bs_price_vec

    def counted(*args, **kw):
        calls.append(np.size(args[1]))
        return real(*args, **kw)

    monkeypatch.setattr(tpb, "bs_price_vec", counted)
    out = tpb.price_book(rows, device="cpu")
    assert calls == [2]            # one call for both bs rows
    from optpricer_tpu_torch.ops.mc_batch import euro_price_mc_batch

    px, se = euro_price_mc_batch([100.0, 95.0], [100.0, 100.0], [1.0, 0.75],
                                 [0.05, 0.03], [0.0, 0.01], [0.2, 0.3],
                                 ["call", "put"], n_paths=100_000, seed=1,
                                 device="cpu")
    got = {r["id"]: r for r in out}
    assert (got["mc1"]["price"], got["mc2"]["price"]) == tuple(px)
    assert (got["mc1"]["stderr"], got["mc2"]["stderr"]) == tuple(se)
    assert got["bad1"]["price"] is None and "abc" in got["bad1"]["error"]


@pytest.mark.parametrize("method", ["bs", "mc"])
@pytest.mark.parametrize("bad", [dict(sigma="0"), dict(T="0")])
def test_invalid_rows_are_priced_on_their_own(method, bad):
    """A row whose cells parse but whose market is out of range comes out
    as it does alone, beside two good rows of its method (the book route):
    an mc row (not a valid OptionSpec) with the per-row error, a bs row
    with bs_price_vec's value, as the per-row branches give them."""
    good = [dict(BASE, id=f"g{k}", method=method, K=str(100 + 5 * k))
            for k in range(2)]
    row = dict(BASE, id="bad", method=method, **bad)
    alone, = tpb.price_book([row], device="cpu")
    out = tpb.price_book([*good, row], device="cpu")
    if method == "mc":
        assert alone["price"] is None and "must be positive" in alone["error"]
        assert out[2] == alone
    else:
        assert out[2].keys() == alone.keys() and "error" not in alone
        np.testing.assert_allclose(out[2]["price"], alone["price"],
                                   rtol=1e-12, equal_nan=True)
    assert all(r["price"] is not None for r in out[:2])


def test_kernel_failures_are_not_captured(monkeypatch):
    import optpricer_tpu_torch.ops.mc_batch as mcb

    def broken(*args, **kw):
        raise RuntimeError("book kernel launch failed: CUDA error 700")

    rows = [dict(BASE, **r) for r in ROWS if r["method"] == "mc"]
    monkeypatch.setattr(mcb, "euro_price_mc_batch", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tpb.price_book(rows, device="cpu")
    monkeypatch.setattr(tpb, "euro_price_mc", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tpb.price_book(rows[:1], device="cpu")

"""Port vs reference: ``scripts/calibrate_surface.py``.

The reference script (imported from ``scripts/``, run in this process
with x64 on) and ``python -m optpricer_tpu_torch.scripts.calibrate_surface
--device cpu`` fit the same 3 x 21 quote grid with each model (svi,
essvi, heston, vg): the JSON files hold the same keys, the fitted
parameters within 1e-6 (relative, floored at 1e-3: the Levenberg-Marquardt
stops at its tolerance), the same printed lines up to that. ``--plot``
draws the smiles, or says that matplotlib is missing as the reference does.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest

from optpricer_tpu_torch.scripts import calibrate_surface as tcs
from tests.torch_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_calibrate_surface", REPO / "scripts" /
        "calibrate_surface.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def quotes(tmp_path_factory):
    path = tmp_path_factory.mktemp("quotes") / "quotes.csv"
    with open(path, "w") as f:
        f.write("expiry,strike,forward,iv\n")
        for T, F in ((0.25, 100.5), (0.5, 101.0), (1.0, 102.0)):
            for i in range(21):
                k = -0.3 + 0.03 * i
                w = 0.04 * T + 0.04 * math.sqrt(T) * (
                    -0.3 * k + math.sqrt(k * k + 0.01))
                f.write(f"{T},{F * math.exp(k)!r},{F},"
                        f"{math.sqrt(w / T)!r}\n")
    return path


def _flat(report: dict) -> dict:
    if "model" in report:
        return {k: v for k, v in report.items() if isinstance(v, float)}
    return {f"{T} {k}": v for T, p in report.items() for k, v in p.items()}


@pytest.mark.parametrize("model", ["svi", "essvi", "heston", "vg"])
def test_fit_matches_reference(model, quotes, tmp_path):
    argv = ["--input", str(quotes), "--model", model, "--rate", "0.02"]
    _reference_script().main(argv + ["--output", str(tmp_path / "ref.json")])
    tcs.main(argv + ["--output", str(tmp_path / "port.json"),
                     "--device", "cpu"])
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port.keys() == ref.keys()
    assert port.get("model") == ref.get("model")
    a, b = _flat(port), _flat(ref)
    assert a.keys() == b.keys()
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-6 * max(abs(b[k]), 1e-3), (k, a[k],
                                                                b[k])


def test_plot_without_matplotlib_matches_reference(quotes, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ref_mod = _reference_script()
    lines = []
    for main, extra in ((ref_mod.main, []), (tcs.main, ["--device", "cpu"])):
        main(["--input", str(quotes), "--output",
              str(tmp_path / "fit.json"), "--plot",
              str(tmp_path / "smile.png")] + extra)
        lines.append(capsys.readouterr().out.splitlines()[-1])
    assert lines[0] == lines[1] == "matplotlib not installed — skipping plot."
    assert not (tmp_path / "smile.png").exists()


def test_helpers_match_reference(quotes):
    ref = _reference_script()
    want = ref.load_quote_grid(quotes)
    got = tcs.load_quote_grid(quotes)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for T in b:
            assert (a[T] == b[T]).all() if hasattr(b[T], "all") \
                else a[T] == b[T]
    assert tcs.spot_and_carry(got[1], 0.02) == pytest.approx(
        ref.spot_and_carry(want[1], 0.02), rel=1e-14)
    assert tcs.spot_and_carry({1.0: 105.0}, 0.02) == ref.spot_and_carry(
        {1.0: 105.0}, 0.02)

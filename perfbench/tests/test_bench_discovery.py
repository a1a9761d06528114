"""Cells, configurations, mixes, entries, references and metric readers
are found by name from their files, and BENCHMARK.json keeps to its
contract's shapes."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c["config_data"]["name"] == c["config"]
    entry = c["traffic_data"]["entry"]
    assert callable(harness.entry(entry).setup)
    ref = harness.reference(entry)
    assert callable(ref.judge) and callable(ref.control)
    assert c["limits"] and c["sample"] >= 1 and c["warmup"] >= 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_is_found_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(cell, True)


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    used = {w["config"] for w in BENCH["workloads"]}
    assert set(names) == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    seen = set()
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in seen
            seen.add(m["name"])
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            if group == "end_to_end":
                assert 0.01 <= m["bound"] <= 0.25
                assert m["source"] in ("host_clock", "device_trace")
            else:
                moved = next(e for e in BENCH["end_to_end"]
                             if e["name"] == m["moves"])
                assert set(m.get("workloads", CELLS)) <= set(
                    moved.get("workloads", CELLS))
                if m["name"].endswith("_roofline"):
                    assert m["unit"] == "%"
    for name in CELLS + names:
        assert NAME.match(name)

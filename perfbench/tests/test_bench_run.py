"""A run's last line holds the contract's keys, and a run with no CUDA
device prints no result and fails."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the CPU tests' sizes: the mixes' shapes at a size a test can hold
SMALL = {"sizes": {"n_paths": 8192, "n_steps": 8}}


def test_run_without_cuda_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "gbm_mc.asian",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    r = harness.run_cell("gbm_mc.asian", 2**31 + 99, 0.5, traced,
                         device="cpu", mix=SMALL)
    assert list(r) == KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    want = {m["name"] for m in harness.cell_metrics("gbm_mc.asian", traced)}
    assert set(r["metrics"]) <= want
    if not traced:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(r["checks"]) == set(harness.load_cell("gbm_mc.asian")[
        "limits"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    json.dumps(r)
    if traced:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}

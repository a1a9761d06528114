"""The port's profiling and timing helpers (``optpricer_tpu_torch/utils/
profiling.py``, ``utils/timing.py``) against ``tests/test_profiling.py``'s
contract: benchmark keys and ordering, accumulating section timers and the
reference's report format, one memory entry per device with the
reference's keys, a trace file written into the requested directory, and
a usable region annotation. On a host without a card ``device_memory``
has the CPU's entry with ``None`` counts, as the reference's CPU backend.
"""
import json

import torch

from optpricer_tpu.utils import profiling as jprof
from optpricer_tpu_torch.utils import Timer, benchmark as median_seconds
from optpricer_tpu_torch.utils import profiling
from tests.torch_threads import torch_one_thread  # noqa: F401


def test_benchmark_syncs_and_reports():
    x = torch.arange(1024.0, dtype=torch.float64)
    r = profiling.benchmark(lambda v: (v * v).sum(), x, warmup=1, iters=3)
    assert set(r) == {"best", "mean", "times", "result"}
    assert len(r["times"]) == 3 and r["best"] > 0.0
    assert float(r["result"]) == float((x ** 2).sum())
    assert r["best"] <= r["mean"] <= max(r["times"])


def test_timed_accumulates_and_reports_in_the_reference_format():
    profiling.reset_timings()
    for _ in range(3):
        with profiling.timed("unit-test-section"):
            torch.ones(16).sum()
    report = profiling.timing_report(reset=True)
    assert "unit-test-section" in report and "    3" in report
    assert "unit-test-section" not in profiling.timing_report()
    jprof.reset_timings()
    assert report.splitlines()[0] == jprof.timing_report().splitlines()[0]


def test_device_memory_shape():
    mem = profiling.device_memory()
    keys = {"device", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert all(set(m) == keys for m in mem)
    if torch.cuda.is_available():
        assert len(mem) == torch.cuda.device_count()
        assert all(m["bytes_limit"] > 0 for m in mem)
    else:
        assert mem == [dict.fromkeys(keys) | {"device": "cpu"}]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        with profiling.annotate("unit-test-region"):
            torch.ones(8).add(1.0)
    assert d == str(tmp_path)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "unit-test-region" in names


def test_sync_walks_nested_outputs():
    a, b, c = torch.ones(2), torch.zeros(3), torch.ones(1)
    out = {"x": (a, [b, {"y": c}]), "z": 3}
    assert profiling._sync(out) is out
    assert [t.shape for t in profiling._leaves(out)] == [a.shape, b.shape,
                                                        c.shape]


def test_timer_and_median_benchmark(capsys):
    results = {}
    with Timer("block", results=results):
        torch.ones(32).cumsum(0)
    assert results["block"] > 0.0
    assert capsys.readouterr().out.startswith("[block] ")
    assert median_seconds(lambda: torch.ones(4) * 2.0, warmup=1,
                          iters=3) > 0.0

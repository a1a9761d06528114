"""Each metric reader gives the right number on a synthetic trace."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness
from perfbench.counts import k4_path_step
from perfbench.counts.peaks import bound
from perfbench.trace import CALL, INPUTS, REQUEST, Trace

MS = 1_000_000   # ns


class Ev:
    def __init__(self, name, start, end, device="CPU"):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return f"DeviceType.{self._d}"


def events():
    """Two requests of 10 ms each, 2 ms apart: inputs 1 ms, then the call
    with a host op; request 1 launches and runs kernels of 4 + 2 ms and a
    1 ms copy, request 2 one kernel of 5 ms; one launch falls between
    them."""
    ev = []
    for start in (0, 12 * MS):
        ev += [Ev(REQUEST, start, start + 10 * MS),
               Ev(INPUTS, start, start + MS),
               Ev(CALL, start + MS, start + 10 * MS),
               Ev("aten::copy_", start + MS, start + 3 * MS),
               Ev("cudaLaunchKernel", start + 2 * MS, start + 2 * MS + 10)]
    ev += [Ev("cudaLaunchKernel", 5 * MS, 5 * MS + 10),
           Ev("cudaLaunchKernel", 11 * MS, 11 * MS + 10)]
    ev += [Ev("path_mc_kernel", 2 * MS, 6 * MS, "CUDA"),
           Ev("combine", 6 * MS, 8 * MS, "CUDA"),
           Ev("Memcpy DtoH", 8 * MS, 9 * MS, "CUDA"),
           Ev("path_mc_kernel", 14 * MS, 19 * MS, "CUDA")]
    return ev


def ctx(trace=True, entry="path_mc_asian"):
    traffic = {"entry": entry,
               "sizes": {"n_paths": 1000, "n_steps": 10, "antithetic": True}}
    return SimpleNamespace(
        trace=Trace(events()) if trace else None, config={},
        traffic=traffic, requests=[{}, {}], notes={},
        latencies_s=np.array([0.001, 0.002, 0.003, 0.004]),
        contracts=np.array([1, 1, 1, 1000]), window_s=2.0, setup_s=7.5)


def read(name, c):
    return harness.metric_reader(name).read(c)


def test_trace_arrays():
    t = Trace(events())
    assert t.n_requests == 2 and t.window_ns() == 22 * MS
    assert t.busy_ns() == 12 * MS
    assert t.busy_ns(np.array([0, 12 * MS]),
                     np.array([10 * MS, 22 * MS])).tolist() == [7 * MS,
                                                                 5 * MS]
    assert t.launches().tolist() == [2, 1]
    assert t.kernel_ns() == 11 * MS
    assert t.device_ops(2) == [["path_mc_kernel", pytest.approx(0.009)],
                               ["combine", pytest.approx(0.002)]]


def test_idle_gaps_are_labelled_by_the_host():
    """Each gap counts whole under what the host was doing as it began."""
    t = Trace(events())
    assert dict(t.idle_gaps()) == pytest.approx({"make inputs": 0.002,
                                                 "call": 0.008})
    assert t._host_label(2 * MS + MS // 2) == "call: aten::copy_"
    assert t._host_label(11 * MS + MS // 2) == "between requests"


def test_host_clock_metrics():
    c = ctx(trace=False)
    assert read("prices_per_s", c) == pytest.approx(1003 / 2.0)
    assert read("latency_p95_ms", c) == pytest.approx(
        np.percentile([1, 2, 3, 4], 95))
    assert read("setup_s", c) == 7.5
    for name in ("prices_per_s", "latency_p95_ms"):
        assert read(f"{name}.host_paced", c) == read(name, c)
    for name in ("host_ms_per_req", "launches_per_req", "device_idle_pct",
                 "path_mc_asian_roofline"):
        assert read(name, c) is None


def test_trace_metrics():
    c = ctx()
    assert read("host_ms_per_req", c) == pytest.approx((3 + 5) / 2)
    assert read("launches_per_req", c) == 1.5
    assert read("device_idle_pct", c) == pytest.approx(100 * 10 / 22)
    for name in ("host_ms_per_req", "launches_per_req", "device_idle_pct"):
        assert read(f"{name}.host_paced", c) == read(name, c)


def test_roofline_share():
    c = ctx()
    one, by = bound(1000 * 10 * k4_path_step.ops_k4_path_step(True, False),
                    188)
    assert read("path_mc_asian_roofline", c) == pytest.approx(
        100 * 2 * one / 11.0)
    assert c.notes["path_mc_asian_bound_by"] == by
    # a reader finds nothing in another entry's cell
    assert read("path_mc_asian_roofline", ctx(entry="mc_batch_book")) is None
    assert read("mc_batch_roofline", c) is None

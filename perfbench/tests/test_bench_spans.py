"""The readers of the program's own spans (``metrics/_spans.py``) on a
synthetic trace with known spans, and every other reader unmoved by
them."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness
from perfbench.trace import CALL, INPUTS, REQUEST, Trace

MS = 1_000_000   # ns
IDLE = ("prepare_idle_ms", "transfer_idle_ms", "launch_idle_ms",
        "estimate_idle_ms")
NEW = IDLE + ("transfers_per_req",)
OLD = ("host_ms_per_req", "launches_per_req", "device_idle_pct",
       "path_mc_asian_roofline")


class Ev:
    def __init__(self, name, start, end, device="CPU"):
        self._n, self._s = name, int(round(start * MS))
        self._e, self._d = int(round(end * MS)), device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return f"DeviceType.{self._d}"


def base_events():
    """Two back-to-back requests of 10 ms (times in ms): inputs 1 ms, then
    the call; request 1 copies in at 2.2, runs a kernel 3.4-7 and reads at
    7.5, request 2 runs a kernel 12.6-17. The device is idle from 7.6 to
    12.6, across the boundary between them."""
    ev = []
    for start in (0, 10):
        ev += [Ev(REQUEST, start, start + 10), Ev(INPUTS, start, start + 1),
               Ev(CALL, start + 1, start + 10)]
    ev += [Ev("cudaLaunchKernel", 3.3, 3.35),
           Ev("cudaLaunchKernel", 12.55, 12.58),
           Ev("cudaMemcpyAsync", 7.45, 8.0),
           Ev("Memcpy HtoD (Pageable -> Device)", 2.2, 2.3, "CUDA"),
           Ev("path_mc_kernel", 3.4, 7.0, "CUDA"),
           Ev("Memcpy DtoH (Device -> Pageable)", 7.5, 7.6, "CUDA"),
           Ev("path_mc_kernel", 12.6, 17.0, "CUDA")]
    return ev


def program_spans():
    """Each request's call: prepare, the copies, the launch, the read and
    the estimate under one ``optpricer.call``; request 2 copies once and
    launches at once."""
    ev = []
    for start, copies, launch in ((0, ((2, 2.5), (2.5, 3)), 3),
                                  (10, ((2, 2.5),), 2.5)):
        ev += [Ev("optpricer.call", start + 1, start + 9),
               Ev("optpricer.prepare", start + 1, start + 2)]
        ev += [Ev("optpricer.copy", start + a, start + b) for a, b in copies]
        ev += [Ev("optpricer.launch.path_mc", start + launch,
                  start + launch + 0.5),
               Ev("optpricer.read", start + 3.5, start + 8),
               Ev("optpricer.estimate", start + 8, start + 9)]
    return ev


def ctx(events, entry="path_mc_asian"):
    traffic = {"entry": entry,
               "sizes": {"n_paths": 1000, "n_steps": 10, "antithetic": True}}
    return SimpleNamespace(
        trace=None if events is None else Trace(events), config={},
        traffic=traffic, requests=[{}, {}], notes={},
        latencies_s=np.array([0.009, 0.009]), contracts=np.array([1, 1]),
        window_s=0.02, setup_s=7.5)


def read(name, c):
    return harness.metric_reader(name).read(c)


def test_idle_is_split_among_the_spans_it_crosses():
    """Request 1 idles 2.2 ms (inputs 1, prepare 1, copy 0.2), 1.1 ms (copy
    0.7, launch 0.4), 0.5 ms (read) and 2.4 ms (read 0.4, estimate 1, the
    call's last 1); request 2 idles 2.6 ms (inputs 1, prepare 1, copy 0.5,
    launch 0.1) and 3 ms (read 1, estimate 1, the call's last 1)."""
    c = ctx(base_events() + program_spans())
    want = {"prepare_idle_ms": (1 + 1) / 2,
            "transfer_idle_ms": (0.2 + 0.7 + 0.5 + 0.4 + 0.5 + 1) / 2,
            "launch_idle_ms": (0.4 + 0.1) / 2,
            "estimate_idle_ms": (1 + 1) / 2}
    for name, value in want.items():
        assert read(name, c) == pytest.approx(value, abs=1e-9), name
        assert read(f"{name}.host_paced", c) == read(name, c)
    host = read("host_ms_per_req", c)
    assert host == pytest.approx((6.2 + 5.6) / 2)
    outside = host - sum(want.values())
    assert outside == pytest.approx((1 + 1 + 1 + 1) / 2)


def test_gap_from_the_read_is_not_charged_to_it():
    """``idle_gaps`` charges the 5 ms gap that starts inside request 1's
    read (in its copy to the host) whole to the copy; the span readers
    split it: 0.4 ms read, 1 ms estimate, 1 ms outside the program, then
    request 2's inputs 1 ms, prepare 1 ms, copy 0.5 ms, launch 0.1 ms."""
    c = ctx(base_events() + program_spans())
    assert dict(c.trace.idle_gaps())["call: cudaMemcpyAsync"] == \
        pytest.approx(0.005)
    # all of request 1's estimate and request 2's prepare lie in that gap
    assert read("estimate_idle_ms", c) == pytest.approx(1.0)
    assert read("prepare_idle_ms", c) == pytest.approx(1.0)


@pytest.mark.parametrize("suffix", ["", ".host_paced"])
def test_idle_readers_sum_to_at_most_the_host_time(suffix):
    c = ctx(base_events() + program_spans())
    total = sum(read(f"{name}{suffix}", c) for name in IDLE)
    assert total <= read(f"host_ms_per_req{suffix}", c) + 1e-12


def test_transfers_per_req_counts_copies_and_reads():
    c = ctx(base_events() + program_spans())
    assert read("transfers_per_req", c) == (3 + 2) / 2
    assert read("transfers_per_req.host_paced", c) == (3 + 2) / 2


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_spans(name):
    """No trace, and a trace of a program that records no span (the
    parent's), give None, as do the twins."""
    for c in (ctx(None), ctx(base_events())):
        assert read(name, c) is None
        assert read(f"{name}.host_paced", c) is None


@pytest.mark.parametrize("name", OLD)
def test_program_spans_leave_the_other_readers_as_they_were(name):
    """The program's spans are host events: the busy union, the launches,
    the kernels' time and every reader of them read the same with them and
    without them."""
    without, with_ = ctx(base_events()), ctx(base_events() + program_spans())
    assert read(name, with_) == read(name, without)
    for attr in ("busy_start", "busy_end", "dev_start", "dev_end"):
        assert np.array_equal(getattr(with_.trace, attr),
                              getattr(without.trace, attr))
    assert with_.trace.kernel_ns() == without.trace.kernel_ns()
    if name != "path_mc_asian_roofline":
        assert read(f"{name}.host_paced", with_) == read(name, without)


SMALL = {"gbm_mc.asian": {"sizes": {"n_paths": 8192, "n_steps": 8}},
         "lv_desk.barrier_mc": {"sizes": {"n_paths": 8192, "n_steps": 8}},
         "gbm_mc.euro_book": {"sizes": {"n_paths": 65536},
                              "groups": [{"n": 16, "K": {"linspace":
                                                         [95.0, 105.0]},
                                          "kind": "put"}]}}
TRANSFERS = {"gbm_mc.asian": 3, "lv_desk.barrier_mc": 4,
             "gbm_mc.euro_book": 4}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_cpu_run_reports_the_span_metrics(cell):
    """A traced run of each cell on the CPU, at sizes a test can hold,
    reports the five readers (or their twins) with the program's spans in
    its trace: the transfers a request exactly, the idle time within the
    host time."""
    r = harness.run_cell(cell, 2**31 + 7, 0.3, True, device="cpu",
                         mix=SMALL[cell])
    suffix = ".host_paced" if cell == "gbm_mc.euro_book" else ""
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW:
        assert f"{name}{suffix}" in m, name
    assert m[f"transfers_per_req{suffix}"] == TRANSFERS[cell]
    idle = sum(m[f"{name}{suffix}"] for name in IDLE)
    assert 0 < idle <= m[f"host_ms_per_req{suffix}"] + 1e-9

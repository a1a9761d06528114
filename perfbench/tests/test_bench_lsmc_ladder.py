"""The American ladder cell (``american.lsmc_ladder``) at CPU sizes: its
reference against a Bermudan lattice, the comparison that decides
``correct`` on the sound run, the control and three faults, its least-work
count and its two readers.

Sizes: 8 strikes over the mix's 70-130, its 50 dates and 2 x 131 072
paths. A fault must read past the cell's limits, which were set at the
cell's 400 000 paths; the +1% payoff reads in standard errors, which grow
as the paths shrink, and the bfloat16 control's worst error is its
discount, which rounds to 1 only at the cell's 50 dates a year.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import generator, harness
from perfbench.counts import lsmc_ladder as count
from perfbench.counts.peaks import bound
from perfbench.reference import lsmc_ladder as ref
from perfbench.reference.common import generator as ref_generator
from perfbench.trace import CALL, INPUTS, REQUEST, Trace

CELL = "american.lsmc_ladder"
SEED = 2**31 + 4242
MIX = {"sizes": {"n_paths": 131072, "n_steps": 50},
       "groups": [{"n": 8, "K": {"linspace": [70.0, 130.0]},
                   "kind": "put"}]}
MARKET = {"T": 1.0, "r": 0.03, "q": 0.0, "sigma": 0.2}


def bermudan_put(S0, K, T, r, q, sigma, dates, per_date):
    """Plain float64 CRR lattice of puts exercisable at t = 0, at the
    ``dates`` dates i·T/dates and at maturity: ``per_date`` steps a
    date."""
    N = dates * per_date
    dt = T / N
    u = math.exp(sigma * math.sqrt(dt))
    d = 1.0 / u
    p = (math.exp((r - q) * dt) - d) / (u - d)
    disc = math.exp(-r * dt)
    K = np.asarray(K, np.float64)[:, None]
    V = np.maximum(K - S0 * u ** (N - 2.0 * np.arange(N + 1)), 0.0)
    for i in range(N - 1, -1, -1):
        V = disc * (p * V[:, :-1] + (1.0 - p) * V[:, 1:])
        if i % per_date == 0:
            V = np.maximum(V, K - S0 * u ** (i - 2.0 * np.arange(i + 1)))
    return V[:, 0]


def test_reference_is_the_bermudan_lattice_s_within_its_error():
    K = np.linspace(80.0, 120.0, 9)
    lattice = bermudan_put(100.0, K, *MARKET.values(), 10, 200)
    P = ref.unit_paths(MARKET, 10, 32768, ref_generator("cpu", SEED),
                       torch.float64, "cpu")
    price, dev, pays = ref.lsmc(P, 100.0, torch.as_tensor(K), MARKET, 4)
    se = dev / math.sqrt(P.shape[1])
    assert np.all(np.abs(price - lattice) <= 4.0 * se), (price - lattice) / se
    assert np.all((pays > 0.0) & (pays <= 1.0))


def test_reference_chunks_change_nothing(monkeypatch):
    P = ref.unit_paths(MARKET, 6, 4096, ref_generator("cpu", SEED),
                       torch.float64, "cpu")
    K = torch.linspace(70.0, 130.0, 40, dtype=torch.float64)
    whole = ref.lsmc(P, 99.0, K, MARKET, 4)
    monkeypatch.setattr(ref, "CHUNK", 7)
    np.testing.assert_allclose(ref.lsmc(P, 99.0, K, MARKET, 4), whole,
                               rtol=1e-12, atol=1e-14)


def _run(seed=SEED):
    return harness.run_cell(CELL, seed, 0.5, False, device="cpu", mix=MIX)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def test_control_is_not_correct():
    cell = harness.with_mix(harness.load_cell(CELL), MIX)
    reqs = generator.Requests(cell["config_data"], cell["traffic_data"],
                              SEED, generator.WINDOW).take(2)
    outs = ref.control(cell["config_data"], cell["traffic_data"], reqs,
                       device="cpu", seed=SEED, dtype=torch.bfloat16)
    checks = harness.judge(cell, list(zip(reqs, outs)), SEED, "cpu")
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in checks.values()), checks


def _wrap(monkeypatch, module, name, fn):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: fn(orig, *a, **k))


def half_paths(monkeypatch):
    """Half of the paths left out, the rest standing for all."""
    from optpricer_tpu_torch.models import american_mc

    def half(orig, *a, **k):
        paths = orig(*a, **k)
        return paths[:, :paths.shape[1] // 2]
    _wrap(monkeypatch, american_mc, "gbm_paths", half)


def payoff_up(monkeypatch):
    """Every cashflow, and so each price, 1% higher where the backward pass
    produces it."""
    from optpricer_tpu_torch.models import american_mc

    def bump(orig, *a, **k):
        price, se = orig(*a, **k)
        return price * 1.01, se * 1.01
    _wrap(monkeypatch, american_mc, "_lsmc_backward_batch", bump)


def european(monkeypatch):
    """The regression and the exercise skipped: each path carries its
    maturity payoff back, the European price with the t = 0 floor."""
    from optpricer_tpu_torch.models import american_mc

    def hold(paths, K_b, r, dt, is_call_b, *, basis_dim, return_stderr):
        sign = torch.where(is_call_b, 1.0, -1.0).to(paths.dtype)[:, None]
        value = torch.exp(-r * dt * (paths.shape[0] - 1)) * torch.clamp(
            sign * (paths[-1][None, :] - K_b[:, None]), min=0.0)
        mean = value.mean(1)
        se = value.std(1) / math.sqrt(value.shape[1])
        floor = torch.clamp(sign[:, 0] * (paths[0, 0] - K_b), min=0.0)
        return torch.maximum(mean, floor), se
    monkeypatch.setattr(american_mc, "_lsmc_backward_batch", hold)


@pytest.mark.parametrize("fault", [half_paths, payoff_up, european])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


def test_least_work_by_hand():
    """3 strikes x 2 base draws (4 paths) x 3 steps, k = 4: 2 regression
    dates."""
    traffic = {"sizes": {"n_paths": 2, "n_steps": 3, "basis_dim": 4,
                         "antithetic": True}}
    ops, n_bytes = count.least_work({}, traffic, {"K": np.zeros(3)})
    per_strike_date = 2 + 1 + 1 + 1 + 2 * (10 + 4) + 2 * 3 + 3
    assert count.ops_strike_date(4) == per_strike_date == 42
    assert count.ops_path_date(4) == 2 + 5
    assert ops == (2 * 3 * 65 + 4 * 3 * 25 + 4 * 2 * 7
                   + 3 * 4 * (2 * 42 + 6))
    assert n_bytes == 2 * 3 * 4 * 2 + 2 * 4 * 4 * 4 + 4 * 3 + 8 * 3


def test_least_work_at_the_cell_s_size():
    cell = harness.load_cell(CELL)
    req = generator.Requests(cell["config_data"], cell["traffic_data"],
                             SEED, generator.WINDOW).next()
    ops, n_bytes = count.least_work(cell["config_data"],
                                    cell["traffic_data"], req)
    assert len(req["K"]) == 512
    # the (strike, path, date) terms carry all but a part in 100
    strike_work = 512 * 400_000 * 49 * 42
    assert strike_work <= ops <= 1.01 * strike_work
    assert 2 * 512 * 400_000 * 49 <= n_bytes <= 1.01 * 2 * 512 * 400_000 * 49
    ms, by = bound(ops, n_bytes)
    assert by == "operations" and 6.0 < ms < 6.7


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


MS = 1_000_000


def events(spans=True):
    """Two requests of 10 ms: each launches 3 kernels before its date loop,
    the first 5 inside it and the second 7, and one after it; the kernels
    take 2 + 3 ms of the first and 4 ms of the second."""
    ev = []
    for start, inside in ((0, 5), (10 * MS, 7)):
        ev += [Ev(REQUEST, start, start + 10 * MS),
               Ev(INPUTS, start, start + MS),
               Ev(CALL, start + MS, start + 10 * MS)]
        ev += [Ev("cudaLaunchKernel", start + MS + 10 * i, start + MS + 10 * i
                  + 5) for i in range(3)]
        if spans:
            ev += [Ev("optpricer.call", start + MS, start + 9 * MS),
                   Ev("optpricer.lsmc.backward", start + 2 * MS,
                      start + 8 * MS)]
        ev += [Ev("cuLaunchKernel", start + 3 * MS + 10 * i, start + 3 * MS
                  + 10 * i + 5) for i in range(inside)]
        ev.append(Ev("cudaLaunchKernel", start + 8 * MS + 100,
                     start + 8 * MS + 200))
    ev += [Ev("gemm", 2 * MS, 4 * MS, "CUDA"),
           Ev("elementwise", 4 * MS, 7 * MS, "CUDA"),
           Ev("Memcpy DtoH", 7 * MS, 8 * MS, "CUDA"),
           Ev("gemm", 13 * MS, 17 * MS, "CUDA")]
    return ev


def ctx(trace=True, spans=True, entry="lsmc_ladder", n_steps=4):
    traffic = {"entry": entry,
               "sizes": {"n_paths": 100, "n_steps": n_steps, "basis_dim": 4,
                         "antithetic": True}}
    reqs = [{"K": np.zeros(8)}, {"K": np.zeros(8)}]
    return SimpleNamespace(
        trace=Trace(events(spans)) if trace else None, config={},
        traffic=traffic, requests=reqs, notes={},
        latencies_s=np.array([0.009, 0.009]), contracts=np.array([8, 8]),
        window_s=0.02, setup_s=1.0)


def read(name, c):
    return harness.metric_reader(name).read(c)


def test_launches_per_date_counts_the_date_loop_s_launches():
    c = ctx()
    assert read("lsmc_launches_per_date", c) == pytest.approx((5 + 7)
                                                              / (2 * 3))
    assert read("launches_per_req", c) == (3 + 5 + 1 + 3 + 7 + 1) / 2
    assert read("lsmc_launches_per_date", ctx(n_steps=7)) == \
        pytest.approx(12 / (2 * 6))


def test_readers_find_nothing_without_the_loop_s_span_or_trace():
    for c in (ctx(trace=False), ctx(spans=False)):
        assert read("lsmc_launches_per_date", c) is None
    assert read("lsmc_ladder_roofline", ctx(trace=False)) is None
    assert read("lsmc_ladder_roofline", ctx(entry="mc_batch_book")) is None


def test_roofline_share_is_the_bound_over_the_kernels_time():
    c = ctx()
    ms, by = bound(*count.least_work(c.config, c.traffic, c.requests[0]))
    # the kernels: 2 + 3 + 4 ms; the copy is not a kernel
    assert read("lsmc_ladder_roofline", c) == pytest.approx(
        100.0 * 2 * ms / 9.0)
    assert c.notes["lsmc_ladder_bound_by"] == by
    # a program that records no span reads the same share
    assert read("lsmc_ladder_roofline", ctx(spans=False)) == pytest.approx(
        100.0 * 2 * ms / 9.0)


def test_the_cell_is_found_and_keeps_the_contract_s_shape():
    bench = harness.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    assert cells == ["gbm_mc.asian", "lv_desk.barrier_mc", "gbm_mc.euro_book",
                     CELL]
    cell = harness.load_cell(CELL)
    assert cell["chips"] == 1 and cell["config_data"]["precision"] == \
        "float32"
    assert cell["config_data"]["reduced"] == ["strikes"]
    assert cell["traffic_data"]["sizes"]["dtype"] == "float32"
    e2e = {m["name"] for m in harness.cell_metrics(CELL, False)}
    assert e2e == {"prices_per_s", "latency_p95_ms", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(CELL, True)}
    assert layer == {"host_ms_per_req", "launches_per_req",
                     "device_idle_pct", "prepare_idle_ms",
                     "transfer_idle_ms", "launch_idle_ms",
                     "estimate_idle_ms", "transfers_per_req",
                     "lsmc_ladder_roofline", "lsmc_launches_per_date"}


def test_traced_cpu_run_reports_the_cell_s_metrics():
    """On the CPU the trace holds no launch and no kernel: the launches a
    date read 0, the roofline nothing; the transfers a request are the two
    copies and the one read."""
    small = {"sizes": {"n_paths": 2048, "n_steps": 6},
             "groups": [{"n": 16, "K": {"linspace": [70.0, 130.0]},
                         "kind": "put"}]}
    r = harness.run_cell(CELL, SEED, 0.3, True, device="cpu", mix=small)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["transfers_per_req"] == 3
    assert m["lsmc_launches_per_date"] == 0.0
    assert "lsmc_ladder_roofline" not in m
    assert m["launch_idle_ms"] == 0.0 and m["estimate_idle_ms"] == 0.0
    assert 0 < m["prepare_idle_ms"] + m["transfer_idle_ms"] <= \
        m["host_ms_per_req"]

"""One run of one cell: set-up, warm-up, the closed-loop window, the
metrics, and the comparison with the plain reference that decides
``correct``. Everything a cell, configuration, mix or metric owns is a file
found by name:

* ``BENCHMARK.json`` names the cell's configuration, mix and chips, and
  its metrics;
* ``cells/<cell>.json``: warm-up requests, the sample the reference
  judges, the judge's settings and each compared number's limit;
* ``configs/<config>.json``; ``traffic/<mix>.json`` (``generator.py``
  reads it);
* ``entries/<entry>.py``: the program's public call the mix drives;
* ``reference/<entry>.py``: its plain reference;
* ``metrics/<metric>.py``: one reader a metric.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import re
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import generator
from .trace import CALL, INPUTS, REQUEST, Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's BENCHMARK.json entry merged with ``cells/<name>.json``,
    with its configuration and mix read in."""
    w = workload(name)
    cell = _json(HERE / "cells" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell.get(key, w[key]) != w[key]:
            raise ValueError(f"cells/{name}.json {key} {cell[key]!r} is not "
                             f"BENCHMARK.json's {w[key]!r}")
    cell.update(w)
    cell["config_data"] = _json(HERE / "configs" / f"{w['config']}.json")
    cell["traffic_data"] = _json(HERE / "traffic" / f"{w['traffic']}.json")
    return cell


def with_mix(cell: dict, mix: dict | None) -> dict:
    """The cell with keys of its mix replaced by ``mix``'s, the mix's
    ``sizes`` key by key (the CPU tests run small)."""
    traffic = cell["traffic_data"]
    for key, value in (mix or {}).items():
        traffic[key] = (dict(traffic[key], **value) if key == "sizes"
                        else value)
    return cell


def metric_reader(name: str):
    """``metrics/<name>.py`` as a module of this package; a name may hold
    dots (``host_ms_per_req.host_paced``), which a module name cannot, so
    the file is loaded by its path."""
    safe = re.sub(r"\W", "_", name)
    mod = f"{__package__}.metrics.{safe}"
    if mod not in sys.modules:
        importlib.import_module(f"{__package__}.metrics")
        spec = importlib.util.spec_from_file_location(
            mod, HERE / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod] = module
        spec.loader.exec_module(module)
    return sys.modules[mod]


def entry(name: str):
    return importlib.import_module(f"{__package__}.entries.{name}")


def reference(name: str):
    return importlib.import_module(f"{__package__}.reference.{name}")


def cell_metrics(cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    b = benchmark()
    group = b["per_layer"] if trace else b["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


class Context:
    """What the readers read: the cell, the window's requests with their
    host-clock latencies and contracts, set-up seconds and, traced, the
    profiler's arrays."""

    def __init__(self, cell, requests, latencies_s, window_s, setup_s,
                 trace):
        self.config = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.requests = requests
        self.latencies_s = np.asarray(latencies_s, np.float64)
        self.contracts = np.array([generator.contracts(r) for r in requests],
                                  np.int64)
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace
        self.notes = {}


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)


def window(call, reqs, seconds: float, traced: bool):
    """The closed loop: one client sends the next request once the last
    one's result is on the host, until ``seconds`` have passed.
    (done, latencies, attempted, failed, first_error, window_s)."""
    done, lat = [], []
    attempted = failed = 0
    error = None
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        with _span(REQUEST, traced):
            with _span(INPUTS, traced):
                req = reqs.next()
            attempted += 1
            t0 = time.perf_counter()
            try:
                with _span(CALL, traced):
                    out = call(req)
            except Exception:   # a failed request is counted, not fatal
                failed += 1
                error = error or traceback.format_exc()
                out = None
            end = time.perf_counter()
        if out is not None:
            done.append((req, out))
            lat.append(end - t0)
    return done, lat, attempted, failed, error, end - start


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start=None, mix=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``mix`` replaces keys of the mix (``with_mix``)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = with_mix(load_cell(name), mix)
    config, traffic = cell["config_data"], cell["traffic_data"]
    call = entry(traffic["entry"]).setup(config, traffic, device)
    for req in generator.Requests(config, traffic, seed,
                                  generator.WARMUP).take(cell["warmup"]):
        call(req)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    reqs = generator.Requests(config, traffic, seed, generator.WINDOW)
    trace = None
    if traced:
        with _profiler() as prof:
            done, lat, attempted, failed, error, window_s = window(
                call, reqs, seconds, True)
        trace = Trace(prof.profiler.kineto_results.events())
        del prof
    else:
        done, lat, attempted, failed, error, window_s = window(
            call, reqs, seconds, False)
    on_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    ctx = Context(cell, [r for r, _ in done], lat, window_s, setup_s, trace)
    metrics = {}
    for m in cell_metrics(name, traced):
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del call
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    checks = judge(cell, done, seed, device)
    correct = (failed == 0 and len(done) > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    if error:
        print(error, file=sys.stderr)
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = float(trace.busy_ns()) * 1e-9
        dev["window_s"] = trace.window_ns() * 1e-9
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    for key, value in ctx.notes.items():
        print(f"note {key}: {value}", file=sys.stderr)
    result["checks"] = checks
    return result


def judge(cell, done, seed, device) -> dict:
    """{number: {"value", "limit"}}: the reference's readings of a sample
    of the window's results, drawn from the seed; a number that cannot be
    read (no result, or not finite) is None."""
    traffic = cell["traffic_data"]
    if not done:
        return {k: {"value": None, "limit": float(v)}
                for k, v in cell["limits"].items()}
    rng = generator.stream(seed, generator.SAMPLE)
    pick = np.sort(rng.choice(len(done), min(cell["sample"], len(done)),
                              replace=False))
    ref_seed = int(generator.stream(seed, generator.REFERENCE)
                   .integers(0, 2**62))
    values = reference(traffic["entry"]).judge(
        cell["config_data"], traffic, [done[i] for i in pick],
        device=device, seed=ref_seed, **cell.get("judge", {}))
    return {k: {"value": float(values[k]) if np.isfinite(values[k])
                else None, "limit": float(v)}
            for k, v in cell["limits"].items()}

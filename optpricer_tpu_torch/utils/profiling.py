"""Tracing, profiling and timing of the PyTorch port.

Counterpart of ``optpricer_tpu/utils/profiling.py``:

* :func:`trace` — a ``torch.profiler`` trace of the enclosed block, CPU
  and CUDA activities, exported as a Chrome trace (Perfetto,
  ``chrome://tracing``) into ``log_dir``.
* :func:`annotate` — a named region on the profiler's timeline
  (``torch.profiler.record_function``).
* :func:`benchmark` — wall clock of any function returning tensors, with
  warm-up runs (the kernels' build and first launches) excluded and every
  output tensor's device synchronized inside the timed region.
* :func:`timed` / :func:`timing_report` — accumulating section timers for
  pipeline scripts.
* :func:`device_memory` — live, peak and total bytes of each card.

Nothing here runs work of its own: the functions time, trace and count
what the caller runs where the caller runs it.
"""
from __future__ import annotations

import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["trace", "annotate", "benchmark", "timed", "timing_report",
           "reset_timings", "device_memory"]


@contextmanager
def trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block.

    Writes ``trace.json`` (Chrome trace format) into ``log_dir``, by
    default ``optpricer_tpu_torch_trace`` under the temporary directory,
    and yields the directory. The CUDA activity is recorded where a card
    is present.
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "optpricer_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _barrier()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def _leaves(out):
    """Tensors of ``out``, through nested tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)


def _sync(out):
    """Wait until every CUDA tensor in ``out`` is computed."""
    for dev in {t.device for t in _leaves(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def _barrier() -> None:
    """Wait for all work queued on the cards this process has used."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """Wall-clock a computation on tensors correctly.

    Runs ``fn(*args, **kwargs)`` ``warmup`` times (absorbing the kernels'
    build and first launches), then ``iters`` timed runs, each ending when
    its output tensors are computed. Returns ``{"best", "mean", "times",
    "result"}`` (seconds; ``result`` is the last run's output).
    """
    out = None
    for _ in range(max(0, warmup)):
        out = _sync(fn(*args, **kwargs))
    times = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        out = _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"best": min(times), "mean": sum(times) / len(times),
            "times": times, "result": out}


_TIMINGS: dict[str, list[float]] = defaultdict(list)


@contextmanager
def timed(label: str, *, sync: bool = True):
    """Accumulating section timer: ``with timed("calibrate"): ...``.

    ``sync=True`` waits for the card's queued work before AND after the
    block, so the section is charged its own device time, not its
    predecessor's.
    """
    if sync:
        _barrier()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _barrier()
        _TIMINGS[label].append(time.perf_counter() - t0)


def timing_report(*, reset: bool = False) -> str:
    """Formatted table of every ``timed`` section recorded so far."""
    rows = ["%-32s %5s %10s %10s" % ("section", "calls", "total[s]",
                                     "mean[ms]")]
    for label, ts in _TIMINGS.items():
        rows.append("%-32s %5d %10.3f %10.1f"
                    % (label, len(ts), sum(ts), 1e3 * sum(ts) / len(ts)))
    if reset:
        reset_timings()
    return "\n".join(rows)


def reset_timings() -> None:
    _TIMINGS.clear()


def device_memory() -> list[dict]:
    """Live, peak and total bytes of each card: ``torch.cuda.memory_stats``
    (the caching allocator's view) and ``mem_get_info``'s total. A host
    without a card has one entry, the CPU's, with ``None`` counts."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current",
                                              0),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                                   0),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1]})
    return out

"""Wall-clock timing helpers that wait for the card.

Counterpart of ``optpricer_tpu/utils/timing.py``. CUDA launches return
before the device finishes, so a host clock read without a synchronize
measures the enqueue: :class:`Timer` synchronizes the card before it reads
the clock, and :func:`benchmark` synchronizes every tensor of each
result's device (``profiling._sync``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from .profiling import _barrier, _sync


@contextmanager
def Timer(label: str = "", results: dict | None = None, verbose: bool = True):
    """Context manager timing a block; waits for the card's queued work."""
    start = time.perf_counter()
    yield
    _barrier()
    elapsed = time.perf_counter() - start
    if results is not None:
        results[label] = elapsed
    if verbose and label:
        print(f"[{label}] {elapsed * 1e3:.2f} ms")


def benchmark(fn, *args, warmup: int = 2, iters: int = 10, **kwargs) -> float:
    """Median wall-clock seconds per call of ``fn``."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]

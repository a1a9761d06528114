"""The requests' share of their roofline: the least time the chip could
take for the window's work (``counts/``), over the device time of every
kernel that ran in the window."""
from __future__ import annotations

from ..counts.peaks import bound


def roofline(ctx, count, entry: str):
    """(percent, bound_by) or None: ``count.least_work`` per request, for
    a cell whose traffic drives ``entry``."""
    if ctx.trace is None or ctx.traffic["entry"] != entry:
        return None
    kernel_ns = ctx.trace.kernel_ns()
    if ctx.trace.n_requests != len(ctx.requests) or kernel_ns <= 0:
        return None
    bound_ms, by = 0.0, set()
    for req in ctx.requests:
        ms, what = bound(*count.least_work(ctx.config, ctx.traffic, req))
        bound_ms += ms
        by.add(what)
    ctx.notes[f"{entry}_bound_by"] = "/".join(sorted(by))
    return 100.0 * bound_ms / (kernel_ns * 1e-6)

"""The program's own spans (``optpricer.*``, host events on the profiler's
clock) read against the device's busy intervals: the device-idle time a
request spent inside one kind of span, measured over the whole length of
each idle gap, and the spans of a kind a request holds. A program that
records no span gives None."""
from __future__ import annotations

import numpy as np

from ..trace import _covered, _union

PREFIX = "optpricer."
# each kind of span: the prefixes of its names
PREPARE = ("optpricer.prepare",)
TRANSFER = ("optpricer.copy", "optpricer.read")
LAUNCH = ("optpricer.launch.",)
ESTIMATE = ("optpricer.estimate",)


def _spans(t, kind):
    """(starts, ends) of the host events of ``kind``, sorted by start; None
    where the program recorded no span at all."""
    if not any(name.startswith(PREFIX) for name in t.host_name):
        return None
    pick = np.array([name.startswith(kind) for name in t.host_name], bool)
    return t.host_start[pick], t.host_end[pick]


def _minus(as_, ae, bs, be):
    """The parts of the sorted, disjoint intervals (as_, ae) that lie in
    none of the sorted, disjoint intervals (bs, be)."""
    p = np.unique(np.concatenate([as_, ae, bs, be]))
    if len(p) < 2:
        return p[:0], p[:0]

    def inside(s, e):
        # whether each elementary piece [p_j, p_j+1) lies in (s, e)
        if len(s) == 0:
            return np.zeros(len(p) - 1, bool)
        i = np.searchsorted(s, p[:-1], side="right") - 1
        return (i >= 0) & (e[np.maximum(i, 0)] > p[:-1])

    keep = inside(as_, ae) & ~inside(bs, be)
    return p[:-1][keep], p[1:][keep]


def idle_ms(ctx, kind):
    """Device-idle ms inside the request's spans of ``kind``, averaged over
    the window's requests."""
    t = ctx.trace
    if t is None or t.n_requests == 0:
        return None
    spans = _spans(t, kind)
    if spans is None:
        return None
    s, e = _minus(*_union(*spans), t.busy_start, t.busy_end)
    return float(_covered(s, e, t.req_start, t.req_end).mean()) * 1e-6


def count_per_req(ctx, kind):
    """Spans of ``kind`` that start within each request's span, averaged
    over the window's requests."""
    t = ctx.trace
    if t is None or t.n_requests == 0:
        return None
    spans = _spans(t, kind)
    if spans is None:
        return None
    starts = np.sort(spans[0])
    return float((np.searchsorted(starts, t.req_end, side="right")
                  - np.searchsorted(starts, t.req_start, side="left")).mean())

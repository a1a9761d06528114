"""Reads a ``torch.profiler`` run of the window into arrays: the
benchmark's own spans (``perfbench.request``, ``perfbench.inputs``,
``perfbench.call``), every device operation, and every host operation, on
the profiler's one clock (ns)."""
from __future__ import annotations

from collections import defaultdict

import numpy as np

REQUEST, INPUTS, CALL = "perfbench.request", "perfbench.inputs", \
    "perfbench.call"
_NOT_KERNEL = ("Memcpy", "Memset")
# the CUDA runtime and driver calls that launch a kernel, as the profiler
# records them on the host
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _union(starts, ends):
    """Sorted, disjoint intervals covering the given ones."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def _covered(us, ue, lo, hi):
    """Length of the union intervals (us, ue) inside [lo, hi] for each
    pair of lo, hi."""
    if len(us) == 0:
        return np.zeros_like(np.asarray(hi) - np.asarray(lo))
    cum = np.concatenate([[0], np.cumsum(ue - us)])

    def upto(t):
        # covered length of (−inf, t]
        i = np.searchsorted(us, t, side="right")
        part = np.where(i > 0, np.minimum(t, ue[np.maximum(i - 1, 0)])
                        - us[np.maximum(i - 1, 0)], 0)
        return cum[np.maximum(i - 1, 0)] * (i > 0) + np.maximum(part, 0)

    return upto(hi) - upto(lo)


class Trace:
    def __init__(self, events):
        spans = defaultdict(list)
        dev, host = [], []
        for ev in events:
            name = ev.name()
            start, end = ev.start_ns(), ev.end_ns()
            if name.startswith("perfbench."):
                # the spans also appear on the device's timeline
                if not str(ev.device_type()).endswith("CUDA"):
                    spans[name].append((start, end))
            elif str(ev.device_type()).endswith("CUDA"):
                dev.append((name, start, end))
            else:
                host.append((name, start, end))
        req = np.array(sorted(spans[REQUEST]), np.int64).reshape(-1, 2)
        self.req_start, self.req_end = req[:, 0], req[:, 1]
        self.spans = {k: np.array(sorted(v), np.int64).reshape(-1, 2)
                      for k, v in spans.items()}
        dev.sort(key=lambda d: d[1])
        self.dev_name = [d[0] for d in dev]
        self.dev_start = np.array([d[1] for d in dev], np.int64)
        self.dev_end = np.array([d[2] for d in dev], np.int64)
        self.is_kernel = np.array([not d[0].startswith(_NOT_KERNEL)
                                   for d in dev], bool)
        host.sort(key=lambda h: h[1])
        self.host_name = [h[0] for h in host]
        self.host_start = np.array([h[1] for h in host], np.int64)
        self.host_end = np.array([h[2] for h in host], np.int64)
        self.window = ((int(self.req_start[0]), int(self.req_end[-1]))
                       if len(req) else (0, 0))
        self.busy_start, self.busy_end = _union(self.dev_start, self.dev_end)

    @property
    def n_requests(self) -> int:
        return len(self.req_start)

    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_ns(self, lo=None, hi=None):
        """Device-busy ns inside [lo, hi] (arrays or scalars); the window
        by default."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return _covered(self.busy_start, self.busy_end, np.asarray(lo),
                        np.asarray(hi))

    def launches(self):
        """Kernel launches the host made within each request's span."""
        t = np.array([s for name, s in zip(self.host_name, self.host_start)
                      if name in LAUNCHES], np.int64)
        return (np.searchsorted(t, self.req_end, side="right")
                - np.searchsorted(t, self.req_start, side="left"))

    def kernel_ns(self) -> int:
        """Device time of every kernel that started in the window."""
        lo, hi = self.window
        k = self.is_kernel & (self.dev_start >= lo) & (self.dev_start <= hi)
        return int((self.dev_end[k] - self.dev_start[k]).sum())

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations in the window that
        took most time, summed by name."""
        lo, hi = self.window
        inside = (self.dev_start >= lo) & (self.dev_end <= hi)
        total = defaultdict(int)
        for name, s, e, keep in zip(self.dev_name, self.dev_start,
                                    self.dev_end, inside):
            if keep:
                total[name[:200]] += int(e - s)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in best]

    def _host_label(self, t: int) -> str:
        """What the host was doing at ``t``: the benchmark's span and the
        innermost host operation running then."""
        span = "between requests"
        for name, label in ((CALL, "call"), (INPUTS, "make inputs")):
            iv = self.spans.get(name)
            if iv is not None and len(iv):
                i = np.searchsorted(iv[:, 0], t, side="right") - 1
                if i >= 0 and iv[i, 1] >= t:
                    span = label
                    break
        i = int(np.searchsorted(self.host_start, t, side="right")) - 1
        for j in range(i, max(i - 256, -1), -1):
            if self.host_end[j] >= t:
                return f"{span}: {self.host_name[j][:160]}"
        return span

    def idle_gaps(self, top: int = 10):
        """[[label, seconds]]: the window's device-idle time summed by what
        the host was doing as each gap began, the largest first."""
        lo, hi = self.window
        bs, be = self.busy_start, self.busy_end
        starts = np.concatenate([[lo], be])
        ends = np.concatenate([bs, [hi]])
        starts, ends = np.maximum(starts, lo), np.minimum(ends, hi)
        keep = ends > starts
        total = defaultdict(int)
        for s, e in zip(starts[keep], ends[keep]):
            total[self._host_label(int(s) + 1)] += int(e - s)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[label, ns * 1e-9] for label, ns in best]

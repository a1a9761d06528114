"""Kernel launches a regression date: the host's kernel-launch calls inside
the program's ``optpricer.lsmc.backward`` spans (the Longstaff-Schwartz
date loop), over the window's requests and their n_steps − 1 dates each.
A program that records no such span gives None."""
import numpy as np

from ..trace import LAUNCHES

SPAN = "optpricer.lsmc.backward"


def read(ctx):
    t = ctx.trace
    if t is None or t.n_requests == 0:
        return None
    spans = [(s, e) for name, s, e in zip(t.host_name, t.host_start,
                                          t.host_end) if name == SPAN]
    if not spans:
        return None
    launches = np.sort(np.array([s for name, s in zip(t.host_name,
                                                       t.host_start)
                                 if name in LAUNCHES], np.int64))
    lo, hi = np.array(spans, np.int64).T
    inside = (np.searchsorted(launches, hi, side="right")
              - np.searchsorted(launches, lo, side="left"))
    dates = int(ctx.traffic["sizes"]["n_steps"]) - 1
    return float(inside.sum()) / (t.n_requests * dates)

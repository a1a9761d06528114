"""The 95th percentile of every request's host-clock latency: from the
call until its result is on the host."""
import numpy as np


def read(ctx):
    if len(ctx.latencies_s) == 0:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3

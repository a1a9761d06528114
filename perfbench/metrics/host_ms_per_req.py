"""The host's exposed time a request: its traced span less the time the
device was busy inside it, averaged over the window's requests."""


def read(ctx):
    t = ctx.trace
    if t is None or t.n_requests == 0:
        return None
    wall = t.req_end - t.req_start
    busy = t.busy_ns(t.req_start, t.req_end)
    return float((wall - busy).mean()) * 1e-6

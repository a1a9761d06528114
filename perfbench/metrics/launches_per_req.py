"""Kernel launches a request made, by the profiler's record of the host's
launch calls inside the request's span, averaged over the window's
requests."""


def read(ctx):
    t = ctx.trace
    if t is None or t.n_requests == 0:
        return None
    return float(t.launches().mean())

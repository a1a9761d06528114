"""The share of the traced window in which no device operation ran, from
the union of the device's operation intervals."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_ns() <= 0:
        return None
    return 100.0 * (1.0 - float(t.busy_ns()) / t.window_ns())

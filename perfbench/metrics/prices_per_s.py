"""Contracts priced in the window over the window's host-clock seconds."""


def read(ctx):
    return float(ctx.contracts.sum()) / ctx.window_s if ctx.window_s else None

"""Process start to the first timed request: imports, the CUDA context,
the library load (and its build in a fresh checkout), inputs, warm-up."""


def read(ctx):
    return ctx.setup_s

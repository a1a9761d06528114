"""Device-idle ms a request spent in host preparation before the first
copy (``optpricer.prepare``): argument checks, the seed, the closed-form
control-variate mean, the grid and the book's contract tiles; averaged
over the window's requests."""
from ._spans import PREPARE, idle_ms


def read(ctx):
    return idle_ms(ctx, PREPARE)

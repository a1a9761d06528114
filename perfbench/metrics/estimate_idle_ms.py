"""Device-idle ms a request spent in the host float64 estimator after the
read (``optpricer.estimate``); averaged over the window's requests."""
from ._spans import ESTIMATE, idle_ms


def read(ctx):
    return idle_ms(ctx, ESTIMATE)

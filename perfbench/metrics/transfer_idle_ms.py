"""Device-idle ms a request spent in the program's host-card transfers
(``optpricer.copy``, ``optpricer.read``): each pageable copy of an input to
the card, and each read of the results, a host wait on the card; averaged
over the window's requests."""
from ._spans import TRANSFER, idle_ms


def read(ctx):
    return idle_ms(ctx, TRANSFER)

"""Host-card transfers a request made: the program's ``optpricer.copy``
and ``optpricer.read`` spans inside the request's span, averaged over the
window's requests."""
from ._spans import TRANSFER, count_per_req


def read(ctx):
    return count_per_req(ctx, TRANSFER)

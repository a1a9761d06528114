"""Roofline share of the American ladder by Longstaff-Schwartz: the
least-work bound of ``counts/lsmc_ladder.py`` over all kernel time of each
request (the matmuls, the batched solves and the elementwise passes of
every date, whatever kernels run them)."""
from ..counts import lsmc_ladder
from ._roofline import roofline


def read(ctx):
    return roofline(ctx, lsmc_ladder, "lsmc_ladder")

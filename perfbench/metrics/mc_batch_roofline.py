"""Roofline share of the European book (the book kernel, K3): the least-work
bound of ``counts/k3_book.py`` over all kernel time of each request."""
from ..counts import k3_book
from ._roofline import roofline


def read(ctx):
    return roofline(ctx, k3_book, "mc_batch_book")

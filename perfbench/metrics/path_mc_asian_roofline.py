"""Roofline share of the Asian under GBM (the path kernel, K4): the least-work
bound of ``counts/k4_path_step.py`` over all kernel time of each request."""
from ..counts import k4_path_step
from ._roofline import roofline


def read(ctx):
    return roofline(ctx, k4_path_step, "path_mc_asian")

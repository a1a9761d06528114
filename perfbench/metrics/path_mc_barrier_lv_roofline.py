"""Roofline share of the local-vol Milstein barrier (K4 lv_milstein):
the least-work bound of ``counts/k4_lv_path.py`` over all kernel time of
each request."""
from ..counts import k4_lv_path
from ._roofline import roofline


def read(ctx):
    return roofline(ctx, k4_lv_path, "path_mc_barrier_lv")

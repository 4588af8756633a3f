"""The relational-SpMM kernels' share of their roofline over ranking requests."""

from kgbench.lib import readers


def read(ctx):
    return readers.rspmm_roofline(ctx)

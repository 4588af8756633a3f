"""The relational-SpMM kernels' share of their roofline over training steps."""

from kgbench.lib import readers


def read(ctx):
    return readers.rspmm_roofline(ctx)

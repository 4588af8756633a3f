"""The device's idle share of a traced window of training steps."""

from kgbench.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)

"""The whole step's share of the card's peak (step_mfu), over ranking requests."""

from kgbench.lib import readers


def read(ctx):
    return readers.step_mfu_pct(ctx)

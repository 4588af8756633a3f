"""Device ms of the conv's plain-PyTorch glue a request or step, over training steps."""

from kgbench.lib import readers


def read(ctx):
    return readers.glue_ms(ctx)

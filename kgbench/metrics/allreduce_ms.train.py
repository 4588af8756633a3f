"""Device ms of NCCL's all-reduce a training step, on rank 0's chip."""

from kgbench.lib import readers


def read(ctx):
    return readers.allreduce_ms(ctx)

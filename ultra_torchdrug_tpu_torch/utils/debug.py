"""Debug helpers (counterpart of ultra_torchdrug_tpu/utils/debug.py):
setup_debug_hook, a post-mortem debugger on uncaught exceptions, on rank 0
only (other ranks idle so that a multi-process run does not tear down
mid-debug). The JAX package's detect_anomaly is torch.autograd's anomaly
mode here, the reference's own tool, which run_full enters directly.

The JAX package's WandbLogger is ROADMAP Queue 1 item 8 (build_engine
raises on ``engine.logger: wandb``).
"""

from __future__ import annotations

import sys

import torch


class DebugHook:
    instance = None

    def __init__(self, rank: int = 0):
        self.rank = rank

    def __call__(self, *args, **kwargs):
        if self.rank > 0:
            while True:  # pragma: no cover
                pass
        if DebugHook.instance is None:
            import pdb
            import traceback

            traceback.print_exception(*args)
            DebugHook.instance = pdb.post_mortem
        return DebugHook.instance(args[2])


def setup_debug_hook():
    dist = torch.distributed
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    sys.excepthook = DebugHook(rank)


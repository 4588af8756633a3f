"""Debug helpers (counterpart of ultra_torchdrug_tpu/utils/debug.py):
setup_debug_hook, a post-mortem debugger on uncaught exceptions, on rank 0
only (other ranks idle so that a multi-process run does not tear down
mid-debug), and WandbLogger, the metric sink of ``engine.logger: wandb``.
The JAX package's detect_anomaly is torch.autograd's anomaly mode here,
the reference's own tool, which run_full enters directly.
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



class WandbLogger:
    """A best-effort wandb sink for ``utils/logging.py::Meter``: inert when
    wandb is not installed or its run does not start."""

    def __init__(self, project: str = "ultra_tpu", config: dict = None):
        try:
            import wandb

            # only values wandb can serialize (the reference's engine
            # scrubs the config the same way)
            clean = {k: v for k, v in (config or {}).items()
                     if isinstance(v, (int, float, str, bool, list, dict))}
            self._run = wandb.init(project=project, config=clean)
        except Exception:
            self._run = None

    def log(self, metrics: dict, step: int = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()

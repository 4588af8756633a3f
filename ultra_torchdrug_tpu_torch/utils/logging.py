"""Run logging (counterpart of ultra_torchdrug_tpu/utils/logging.py): a
console logger with an optional log file, a windowed meter of step
metrics with an optional sink (utils/debug.py::WandbLogger), and the run's
working directory."""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict
from typing import Optional

import torch

LOGGER_NAME = "ultra_torchdrug_tpu_torch"


def get_root_logger(log_file: Optional[str] = "log.txt") -> logging.Logger:
    """The package logger: one console handler, and one file handler at
    ``log_file`` (retargeted when the path changes; none for None). Under
    a process group only rank 0 logs below a warning."""
    from ..parallel import distributed  # it imports this module

    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO if distributed.process_index() == 0
                    else logging.WARNING)
    fmt = logging.Formatter("%(asctime)-10s %(message)s", "%H:%M:%S")
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        path = os.path.abspath(log_file)
        existing = [h for h in logger.handlers
                    if isinstance(h, logging.FileHandler)]
        if not any(h.baseFilename == path for h in existing):
            for h in existing:
                logger.removeHandler(h)
                h.close()
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class Meter:
    """Accumulates step metrics and logs their window means every
    ``log_interval`` steps.

    Metric values may be device tensors: they are held as they are and
    fetched in one transfer per window, so the train loop does not wait on
    the device every step. Under a process group every rank calls
    ``log_window`` at the same step, and the window's values are the mean
    over the ranks (one all-reduce a window). ``last_window`` keeps the
    last logged window's per-step values as floats. ``sink`` (an object
    with ``log(record, step=)``) gets each window's means, rates and
    ``it_per_s``, and each ``log_dict``, at the global step, with the JAX
    package's keys."""

    def __init__(self, logger: logging.Logger, log_interval: int = 100,
                 sink=None):
        self.logger = logger
        self.log_interval = log_interval
        self.sink = sink
        self.global_step = 0
        self.last_window: list = []
        self.reset()

    def reset(self):
        self._pending = []  # per-step metric dicts; values may be lazy
        self._rates = defaultdict(float)  # summed counts -> count / window s
        self._t0 = time.time()

    def update(self, metrics: dict, rates: Optional[dict] = None):
        """``metrics`` are averaged over the window; ``rates`` are counts
        summed over the window and reported per second of its wall time."""
        self.global_step += 1
        self._pending.append(dict(metrics))
        for k, v in (rates or {}).items():
            self._rates[k] += v
        if len(self._pending) >= self.log_interval:
            self.log_window()

    def log_window(self):
        if not self._pending:
            return
        from ..parallel import distributed  # it imports this module

        keys = sorted(self._pending[0])
        values = torch.stack([
            torch.stack([torch.as_tensor(step[k], dtype=torch.float64)
                         .to(self._device()) for k in keys])
            for step in self._pending])
        values = distributed.mean_over_ranks(values).cpu()  # one transfer
        dt = time.time() - self._t0
        n = len(self._pending)
        self.last_window = [dict(zip(keys, row.tolist())) for row in values]
        means = values.mean(dim=0).tolist()
        parts = [f"{k}: {v:.6g}" for k, v in zip(keys, means)]
        parts += [f"{k}: {v / dt if dt > 0 else 0.0:.6g}"
                  for k, v in sorted(self._rates.items())]
        rate = n / dt if dt > 0 else 0.0
        self.logger.info(f"step {self.global_step} | {' | '.join(parts)} | "
                         f"{rate:.2f} it/s")
        if self.sink is not None:
            record = dict(zip(keys, means))
            record.update({k: (v / dt if dt > 0 else 0.0)
                           for k, v in self._rates.items()})
            record["it_per_s"] = rate
            self.sink.log(record, step=self.global_step)
        self.reset()

    def _device(self):
        for v in self._pending[0].values():
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def log_dict(self, metrics: dict, category: str = ""):
        prefix = f"[{category}] " if category else ""
        for k in sorted(metrics):
            self.logger.info(f"{prefix}{k}: {float(metrics[k]):.6g}")
        if self.sink is not None:
            pre = f"{category}/" if category else ""
            self.sink.log({f"{pre}{k}": float(v) for k, v in metrics.items()},
                          step=self.global_step)


def create_working_directory(output_dir: str, *names: str) -> str:
    """output_dir/<name pieces>/<timestamp>, the reference's layout (one
    process; runs started within the same second share the directory)."""
    path = os.path.join(os.path.expanduser(output_dir), *names,
                        time.strftime("%Y-%m-%d-%H-%M-%S"))
    os.makedirs(path, exist_ok=True)
    return path

"""Training engine (counterpart of ultra_torchdrug_tpu/engine/engine.py): the
optimizer, the epoch loop over batches of train triples, metric logging and
evaluation.

Batches come from ``np.random.default_rng(seed)`` permutations exactly as in
the JAX engine, so both engines see the same triples in the same order.
Negatives come from a ``torch.Generator`` seeded with the same seed. Steps
run eagerly: loss, ``torch.autograd.grad``, then the optimizer.

Checkpoints (``save``/``load``) are native: ``torch.save`` of the model's
state dict, the optimizer's state and the epoch. ``mesh`` (parallel/mesh.py)
is the run's device mesh: ``train`` and ``evaluate`` run under it, so that a
task whose graphs were prepared under an edge mesh takes the ring. Not
ported yet:
``steps_per_call``, data parallelism, fail-soft OOM demotion,
``MultiGraphPretrainTask`` and ``.pth`` import with ``fix_reasoner``
(ROADMAP Queue 1 items 7, 9, 5, 4 and 2).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import use_mesh
from ..utils.logging import Meter, get_root_logger


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ||t||²) over the tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """The counterpart of the JAX engine's ``make_optimizer``: the update
    rule of its optax chain, on a model's
    parameters, fed gradients explicitly with ``step(grads)``:

      * ``adamw``: torch.optim.AdamW with optax.adamw's constants (betas 0.9
        and 0.999, eps 1e-8 outside the square root, decay on every
        parameter); ``adam`` and ``sgd`` likewise;
      * ``clip_grad``: optax.clip_by_global_norm — g / ||g|| * max_norm when
        ||g|| >= max_norm, else g unchanged;
      * ``gradient_interval`` k > 1: optax.MultiSteps — the inner update
        runs every k-th step on the mean of the k gradients; the steps in
        between leave the parameters as they are.
    """

    def __init__(self, params, name: str = "AdamW", lr: float = 5e-4,
                 weight_decay: float = 0.01, gradient_interval: int = 1,
                 clip_grad: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        name = name.lower()
        if name == "adamw":
            self.inner = torch.optim.AdamW(
                self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=weight_decay)
        elif name == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        elif name == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=lr)
        else:
            raise ValueError(f"unknown optimizer {name!r}")
        self.gradient_interval = max(1, int(gradient_interval))
        self.clip_grad = clip_grad
        self._acc = None
        self._count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer step with ``grads`` (one per parameter, in order)."""
        grads = list(grads)
        if self.gradient_interval > 1:
            if self._acc is None:
                self._acc = [g.clone() for g in grads]
            else:
                torch._foreach_add_(self._acc, grads)
            self._count += 1
            if self._count < self.gradient_interval:
                return
            grads = [a / self.gradient_interval for a in self._acc]
            self._acc, self._count = None, 0
        if self.clip_grad:
            norm = global_norm(grads)
            grads = [torch.where(norm < self.clip_grad, g,
                                 g / norm * self.clip_grad) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.inner.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The inner optimizer's state and the gradients accumulated towards
        the next ``gradient_interval`` step."""
        return {"inner": self.inner.state_dict(), "acc": self._acc,
                "count": self._count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self._acc, self._count = state["acc"], state["count"]


class Engine:
    def __init__(self, task, batch_size: int = 64, optimizer: str = "AdamW",
                 lr: float = 5e-4, gradient_interval: int = 1,
                 clip_grad: Optional[float] = None, log_interval: int = 100,
                 seed: int = 1024, work_dir: str = ".", logger=None,
                 mesh=None):
        self.task = task
        self.mesh = mesh
        self.batch_size = batch_size
        self.work_dir = work_dir
        self.logger = logger or get_root_logger(
            os.path.join(work_dir, "log.txt"))
        self.meter = Meter(self.logger, log_interval)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=task.device).manual_seed(seed)
        self.model = task.init_params(seed)
        self.optimizer = Optimizer(
            self.model.parameters(), optimizer, lr,
            gradient_interval=gradient_interval, clip_grad=clip_grad)
        self.epoch = 0
        self.metrics = {}  # split -> the metrics of its last evaluation

    def _full_batch(self, edges: np.ndarray, idx: np.ndarray) -> np.ndarray:
        batch = edges[idx]
        if len(batch) < self.batch_size:
            reps = -(-self.batch_size // len(batch))
            batch = np.tile(batch, (reps, 1))[: self.batch_size]
        return batch

    def _edges_per_step(self) -> int:
        """Propagated edges per optimizer step (undirected entity graph x
        layers x forward and backward), the throughput counter."""
        layers = len(self.task.model_cfg.entity.hidden_dims)
        return 2 * self.task.fact_graph.num_edges * layers * 2

    def _epoch_batches(self, batch_per_epoch: Optional[int]):
        """Yield the epoch's batches [batch_size, 3] (numpy): consecutive
        slices of one permutation of the train triples; a short slice wraps
        to the start of the permutation."""
        triples = self.task.train_triples
        order = self.rng.permutation(len(triples))
        n_batches = len(order) // self.batch_size
        bpe = min(batch_per_epoch or n_batches, n_batches) or 1
        for i in range(bpe):
            lo = i * self.batch_size
            idx = order[lo: lo + self.batch_size]
            if len(idx) < self.batch_size:
                idx = np.concatenate(
                    [idx, order[: self.batch_size - len(idx)]])
            # _full_batch backstops datasets smaller than half a batch
            yield self._full_batch(triples, idx)

    def _run_step(self, batch: np.ndarray) -> dict:
        """One optimizer step; returns its metrics (device tensors)."""
        loss, metrics = self.task.loss_step(self.model, self.generator, batch)
        grads = torch.autograd.grad(loss, self.optimizer.params)
        metrics["grad_norm"] = global_norm(grads).detach()
        self.optimizer.step(grads)
        return metrics

    def _mesh_scope(self):
        """The engine's mesh, active; the caller's scope when it has none."""
        return (contextlib.nullcontext() if self.mesh is None
                else use_mesh(self.mesh))

    def train(self, num_epoch: int = 1,
              batch_per_epoch: Optional[int] = None) -> None:
        with self._mesh_scope():
            self._train(num_epoch, batch_per_epoch)

    def _train(self, num_epoch: int, batch_per_epoch: Optional[int]) -> None:
        for _ in range(num_epoch):
            self.epoch += 1
            for batch in self._epoch_batches(batch_per_epoch):
                metrics = self._run_step(batch)
                self.meter.update(
                    metrics, rates={"edges_per_s": self._edges_per_step()})
            self.meter.log_window()
            self.logger.info(f"epoch {self.epoch} done")

    def evaluate(self, split: str, fast_test: Optional[int] = None) -> dict:
        self.logger.info(f"Evaluate on {split}")
        with self._mesh_scope():
            metrics = self.task.evaluate(self.model, split, self.batch_size,
                                         fast_test=fast_test)
        self.meter.log_dict(metrics, category=f"{split}/epoch {self.epoch}")
        self.metrics[split] = metrics
        return metrics

    def save(self, path: str) -> None:
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "epoch": self.epoch}, path)
        self.logger.info(f"Save checkpoint to {path}")

    def load(self, path: str, fix_reasoner: bool = False,
             drop_optimizer: bool = True) -> None:
        """Load a checkpoint that ``save`` wrote: the model's weights, and
        with ``drop_optimizer=False`` also the optimizer's state and the
        epoch."""
        if fix_reasoner or str(path).endswith(".pth"):
            raise NotImplementedError(
                "reference .pth checkpoints and fix_reasoner are not ported "
                "yet (ROADMAP Queue 1 item 2); load a checkpoint that "
                "Engine.save wrote")
        self.logger.info(f"Load checkpoint from {path}")
        state = torch.load(path, map_location=self.task.device,
                           weights_only=True)
        self.model.load_state_dict(state["model"])
        if not drop_optimizer:
            self.optimizer.load_state_dict(state["optimizer"])
            self.epoch = state["epoch"]

"""Training engine (counterpart of ultra_torchdrug_tpu/engine/engine.py): the
optimizer, the epoch loop over batches of train triples, metric logging and
evaluation.

Batches come from ``np.random.default_rng(seed)`` permutations exactly as in
the JAX engine, so both engines see the same triples in the same order.
Negatives come from a ``torch.Generator`` seeded with the same seed. Steps
run eagerly: loss, ``torch.autograd.grad``, then the optimizer.

``steps_per_call`` K schedules the epoch in chunks of K steps as the JAX
engine does (it chains a chunk's steps in one jitted call): one graph's
epoch rounds up to whole chunks, wrapping into the start of its
permutation, and a multi-graph task draws its graph once per chunk. The K
steps of a chunk run back to back; K = 1 is the per-step schedule.

Checkpoints (``save``/``load``, utils/checkpoint.py) are native
(``torch.save`` of the model's state dict, the optimizer's state and the
epoch) or, for a path ending in ``.pth``, the reference's layout;
``fix_reasoner`` works on both. ``mesh`` (parallel/mesh.py) is the run's
device mesh: ``train`` and ``evaluate`` run under it, so that a task whose
graphs were prepared under an edge mesh takes the ring.

A ``MultiGraphPretrainTask`` trains one graph a step: each step draws its
graph from the task's edge-count mixture with the engine's numpy
generator, then a batch of that graph's train triples, in the JAX engine's
order of draws.

Data parallelism (a mesh whose ``data`` axis P > 1, one process a data
row, parallel/distributed.py): every rank draws the global batch, its
graph and its negatives exactly as one process does, and scores its rows
[r * B / P, (r + 1) * B / P) of it on the whole batch's masked graph
(``task.loss_step(..., rows=)``); the gradients are mean-all-reduced in one
flat buffer after the ``gradient_interval`` accumulation and before the
clip and the optimizer, so that every rank takes the step one process
takes, up to the order of the sums. The logged metrics are the ranks'
mean (``Meter``); with ``gradient_interval`` 1, ``grad_norm`` is the
reduced gradient's norm. Only rank 0 writes the checkpoints and the log
file; every rank loads. The parameters are broadcast from rank 0 when the
engine is built.

Fail-soft: an out-of-memory error on the first step of a graph (or in an
evaluation) demotes the task's auto memory policies one level
(``task.demote_policy``) and retries: the first step snapshots the
parameters, the optimizer's state and the negatives' generator, and a
retry restores them, so the step it completes is the one that failed. The
retry runs after the handler has ended, so that the failed step's tensors
are freed, and after ``gc.collect()`` and ``torch.cuda.empty_cache()``.
Any other error, an out-of-memory error after a graph's first step, and
one with no level left are raised. A first step runs in two phases, each
followed by one all-reduce of the ranks' "out of memory in this phase"
flags: the backward
and the update's flat gradient buffer, then the gradient all-reduce, the
clip and the optimizer. All ranks restore and demote together, or none
does (a rank that retried alone would leave the others waiting in a
collective); in one process the flag is the process's own. PyTorch's
caching allocator raises at the allocation that does not fit, so the error
is raised inside the step that caused it (the JAX engine can see an
asynchronous one late).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel import distributed
from ..parallel.mesh import use_mesh
from ..tasks.task import MultiGraphPretrainTask
from ..tasks.task import is_oom_error as _is_oom_error
from ..utils import checkpoint as ckpt_io
from ..utils.logging import Meter, get_root_logger


def _free_cached_memory(device) -> None:
    """Release the failed step's memory to the device: its tensors that
    reference cycles hold (a traceback's frames, autograd's hooks) are
    collected first, so that no segment they share with the retry's
    long-lived tensors stays pinned under a cap."""
    if torch.device(device).type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


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

    An update's gradients are one flat buffer (``accumulate``), which
    ``update`` mean-all-reduces over the data-parallel ranks
    (``distributed.all_reduce_mean``, nothing in one process) before the
    clip; ``step`` is the two in turn.
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
    def step(self, grads: Sequence[torch.Tensor]):
        """One optimizer step with ``grads`` (one per parameter, in order):
        ``update(accumulate(grads))``, or None on a step that only
        accumulates."""
        flat = self.accumulate(grads)
        return None if flat is None else self.update(flat)

    @torch.no_grad()
    def accumulate(self, grads: Sequence[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
        """Count this step's ``grads``; returns the update's gradients (the
        mean of ``gradient_interval`` steps') as one flat buffer, or None
        on a step that only accumulates."""
        grads = list(grads)
        if self.gradient_interval > 1:
            if self._acc is None:
                self._acc = [g.clone() for g in grads]
            else:
                torch._foreach_add_(self._acc, grads)
            self._count += 1
            if self._count < self.gradient_interval:
                return None
            grads, self._acc, self._count = self._acc, None, 0
            return torch.cat([g.reshape(-1) for g in grads]).div_(
                self.gradient_interval)
        return torch.cat([g.reshape(-1) for g in grads])

    @torch.no_grad()
    def update(self, flat: torch.Tensor):
        """The inner step on ``flat`` (``accumulate``'s buffer), mean-all-
        reduced over the ranks and clipped; returns the update's gradients
        (reduced, before the clip), one per parameter."""
        flat = distributed.all_reduce_mean(flat)
        grads, lo = [], 0
        for p in self.params:
            grads.append(flat[lo:lo + p.numel()].view_as(p))
            lo += p.numel()
        applied = grads
        if self.clip_grad:
            norm = global_norm(grads)
            grads = [torch.where(norm < self.clip_grad, g,
                                 g / norm * self.clip_grad) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.inner.step()
        for p in self.params:
            p.grad = None
        return applied

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
                 mesh=None, steps_per_call: int = 1, metric_logger=None):
        self.task = task
        self.mesh = mesh
        self.batch_size = batch_size
        self.steps_per_call = max(1, int(steps_per_call))
        self.work_dir = work_dir
        # the data axis: P ranks, this one scoring rows [r B / P, (r+1) B / P)
        self.data = mesh.data if mesh is not None else 1
        self.data_index = mesh.data_index if mesh is not None else 0
        if batch_size % self.data:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"the data axis of {self.data}")
        shard = batch_size // self.data
        self._rows = (slice(self.data_index * shard,
                            (self.data_index + 1) * shard)
                      if self.data > 1 else None)
        self.logger = logger or get_root_logger(
            os.path.join(work_dir, "log.txt") if self.data_index == 0
            else None)
        self.meter = Meter(self.logger, log_interval, sink=metric_logger)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=task.device).manual_seed(seed)
        self.model = task.init_params(seed)
        self.optimizer = Optimizer(
            self.model.parameters(), optimizer, lr,
            gradient_interval=gradient_interval, clip_grad=clip_grad)
        if self.data > 1:
            distributed.broadcast_tensors(list(self.model.parameters()))
        self.epoch = 0
        self.metrics = {}  # split -> the metrics of its last evaluation
        self._is_multigraph = isinstance(task, MultiGraphPretrainTask)
        self._warmed = set()  # graph ids whose first step completed

    def _full_batch(self, edges: np.ndarray, idx: np.ndarray) -> np.ndarray:
        batch = edges[idx]
        if len(batch) < self.batch_size:
            reps = -(-self.batch_size // len(batch))
            batch = np.tile(batch, (reps, 1))[: self.batch_size]
        return batch

    def _edges_per_step(self, graph_id: int = 0) -> int:
        """Propagated edges per optimizer step (undirected entity graph x
        layers x forward and backward) on the step's graph, the throughput
        counter."""
        task = self.task
        if self._is_multigraph:
            fact = task.fact_graphs[graph_id]
        elif hasattr(task, "fact_graph"):
            fact = task.fact_graph
        else:
            fact = task.dataset.train_graph
        layers = len(task.model_cfg.entity.hidden_dims)
        return 2 * fact.num_edges * layers * 2

    def _epoch_chunks(self, batch_per_epoch: Optional[int]):
        """Yield the epoch's (graph_id, batches [K, batch_size, 3]) (numpy)
        per chunk of K = ``steps_per_call`` steps, in the JAX engine's order
        of draws. One graph: graph 0, and consecutive slices of one
        permutation of the train triples, the epoch rounded up to whole
        chunks by wrapping into the start of the permutation (as a short
        slice wraps). Several graphs (``batch_per_epoch`` defaults to 1000):
        per chunk one draw from the mixture, then per step the first
        ``batch_size`` of a permutation of that graph's train triples."""
        task = self.task
        K = self.steps_per_call
        if self._is_multigraph:
            bpe = batch_per_epoch or 1000
            for _ in range(-(-bpe // K)):
                gid = task.sample_graph_id(self.rng)
                edges = task.train_triples[gid]
                yield gid, np.stack([self._full_batch(
                    edges, self.rng.permutation(len(edges))[:self.batch_size])
                    for _ in range(K)])
            return
        triples = task.train_triples
        order = self.rng.permutation(len(triples))
        n_batches = len(order) // self.batch_size
        bpe = min(batch_per_epoch or n_batches, n_batches) or 1
        for c in range(-(-bpe // K)):
            batches = []
            for i in range(c * K, c * K + K):
                lo = (i % bpe) * self.batch_size
                idx = order[lo: lo + self.batch_size]
                if len(idx) < self.batch_size:
                    idx = np.concatenate(
                        [idx, order[: self.batch_size - len(idx)]])
                # _full_batch backstops datasets smaller than half a batch
                batches.append(self._full_batch(triples, idx))
            yield 0, np.stack(batches)

    def _step(self, graph_id: int, batch: np.ndarray) -> dict:
        """One optimizer step on graph ``graph_id``'s batch; returns its
        metrics (device tensors)."""
        grads, metrics = self._grads(graph_id, batch)
        return self._apply(self.optimizer.accumulate(grads), grads, metrics)

    def _grads(self, graph_id: int, batch: np.ndarray):
        """The gradients of this rank's rows of the batch, and the step's
        metrics."""
        extra = (graph_id,) if self._is_multigraph else ()
        loss, metrics = self.task.loss_step(self.model, self.generator,
                                            batch, *extra, rows=self._rows)
        # a learned query of a shared relation tower takes part in no score
        # (the JAX package's gradient is 0 there)
        grads = torch.autograd.grad(loss, self.optimizer.params,
                                    allow_unused=True, materialize_grads=True)
        return grads, metrics

    def _apply(self, flat: Optional[torch.Tensor], grads, metrics: dict
               ) -> dict:
        """The optimizer's update on ``flat`` (``Optimizer.accumulate``'s
        buffer, None on a step that only accumulates); adds ``grad_norm``
        to the metrics: the norm of this step's gradients, as in the JAX
        engine, which under data parallelism are the ranks' mean when each
        step updates (``gradient_interval`` 1)."""
        if flat is not None:
            reduced = self.optimizer.update(flat)
            if self.optimizer.gradient_interval == 1:
                grads = reduced
        metrics["grad_norm"] = global_norm(grads).detach()
        return metrics

    def _demote(self, reason: str) -> bool:
        """Walk the task's auto policies one level down the memory ladder;
        False when the task has no level left (or no policies)."""
        if not hasattr(self.task, "demote_policy"):
            return False
        if not self.task.demote_policy(reason):
            return False
        self.logger.warning(f"device OOM -> demoted the auto policies to "
                            f"level {self.task._policy_demotion}; retrying")
        return True

    def _run_step(self, graph_id: int, batch: np.ndarray) -> dict:
        """``_step`` with fail-soft on the first step of each graph: an
        out-of-memory error there restores the snapshot taken before it,
        demotes the policies and retries (the module docstring)."""
        if graph_id in self._warmed:
            return self._step(graph_id, batch)
        while True:
            metrics = self._first_step(graph_id, batch)
            if metrics is not None:
                self._warmed.add(graph_id)
                return metrics
            # the failed attempt's tensors are free
            _free_cached_memory(self.task.device)

    def _first_step(self, graph_id: int, batch: np.ndarray
                    ) -> Optional[dict]:
        """One attempt at a graph's first step, in the module docstring's
        two phases; None when a rank ran out of memory in either, after
        every rank restored the snapshot taken here and demoted."""
        snapshot = (copy.deepcopy(self.model.state_dict()),
                    copy.deepcopy(self.optimizer.state_dict()),
                    self.generator.get_state())
        error = None
        try:
            grads, metrics = self._grads(graph_id, batch)
            flat = self.optimizer.accumulate(grads)
        except RuntimeError as e:
            if not _is_oom_error(e):
                raise
            error = e
        if self._failed_on_any_rank(error, snapshot):
            return None
        try:
            metrics = self._apply(flat, grads, metrics)
        except RuntimeError as e:
            if not _is_oom_error(e):
                raise
            error = e
        if self._failed_on_any_rank(error, snapshot):
            return None
        return metrics

    def _failed_on_any_rank(self, error: Optional[RuntimeError],
                            snapshot) -> bool:
        """One all-reduce of the ranks' out-of-memory flags (``error`` is
        this rank's); if any rank failed, restore ``snapshot`` and demote,
        or raise when no level is left."""
        if not distributed.any_rank(error is not None, self.task.device):
            return False
        self._restore(snapshot)
        reason = (str(error).splitlines()[0][:200] if error is not None
                  else "out of memory on another rank")
        if not self._demote(reason):
            if error is not None:
                raise error
            raise RuntimeError(f"{reason} with no demotion level left "
                               f"(rank {self.data_index})")
        return True

    def _restore(self, snapshot) -> None:
        state, opt_state, rng_state = snapshot
        self.model.load_state_dict(state)
        self.optimizer.load_state_dict(opt_state)
        self.generator.set_state(rng_state)

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
            for gid, batches in self._epoch_chunks(batch_per_epoch):
                for batch in batches:
                    metrics = self._run_step(gid, batch)
                    self.meter.update(metrics, rates={
                        "edges_per_s": self._edges_per_step(gid)})
            self.meter.log_window()
            self.logger.info(f"epoch {self.epoch} done")

    def evaluate(self, split: str, fast_test: Optional[int] = None) -> dict:
        """The task's metrics on ``split``; the scalar ones are logged, and
        all of them (a multi-graph task's ``per_graph`` too) kept in
        ``metrics[split]``. An out-of-memory error demotes the task's
        policies and evaluates again."""
        self.logger.info(f"Evaluate on {split}")
        while True:
            try:
                with self._mesh_scope():
                    metrics = self.task.evaluate(self.model, split,
                                                 self.batch_size,
                                                 fast_test=fast_test)
                break
            except RuntimeError as e:
                if not (_is_oom_error(e)
                        and self._demote(str(e).splitlines()[0][:200])):
                    raise
            _free_cached_memory(self.task.device)
        printable = {k: v for k, v in metrics.items()
                     if not isinstance(v, dict)}
        self.meter.log_dict(printable, category=f"{split}/epoch {self.epoch}")
        self.metrics[split] = metrics
        return metrics

    def save(self, path: str) -> None:
        """Write a checkpoint (rank 0 only; every rank waits for it)."""
        if self.data_index == 0:
            ckpt_io.save_checkpoint(path, self.model,
                                    self.optimizer.state_dict(), self.epoch)
            self.logger.info(f"Save checkpoint to {path}")
        distributed.barrier()

    def load(self, path: str, fix_reasoner: bool = False,
             drop_optimizer: bool = True) -> None:
        """Load a checkpoint: a reference ``.pth`` (its live weights; it
        holds no optimizer state or epoch) or one that ``save`` wrote (the
        weights, and with ``drop_optimizer=False`` also the optimizer's
        state and the epoch). ``fix_reasoner`` keeps the current model's
        relation projections and relation embeddings on both routes."""
        self.logger.info(f"Load checkpoint from {path}")
        sd, opt_state, epoch = ckpt_io.load_checkpoint(
            path, self.model.state_dict(), fix_reasoner=fix_reasoner,
            map_location=self.task.device)
        self.model.load_state_dict(sd)
        if not drop_optimizer and opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
            self.epoch = epoch

"""Task layer (counterpart of ultra_torchdrug_tpu/tasks/task.py): the loss
step for training and filtered-ranking evaluation, for four task classes.

  * ``TransductiveKGTask`` holds one knowledge graph: the fact graph (train
    edges) that the model propagates over, the relation graph built from
    it, and the filter graph (all splits) for filtered ranking.
  * ``InductiveKGTask`` holds a propagation graph and a relation graph per
    split (the train graph, and inference graphs with entities of their
    own), with the filter graph each split ranks against.
  * ``MultiGraphPretrainTask`` holds several graphs, each with its own
    fact, relation and filter graph; a step trains on one graph, drawn from
    an edge-count mixture, and evaluation averages the graphs' metrics.
  * ``ClassicNBFNetTask`` scores the transductive task with classic NBFNet,
    which needs no relation graph.

Each task's ``loss_step`` draws strict negatives for a batch of train
triples, masks the batch's easy edges, scores the positive and the
negatives and returns the loss (a tensor to call ``backward`` on) with its
metrics. ``evaluate`` scores each (h, r, ?) and (?, r, t) query against
every entity and turns the filtered ranks (or, with ``toy_eval``, the ranks
among 50 sampled negatives) into metrics, eagerly under
``torch.inference_mode()``. Under data parallelism (parallel/distributed.py)
``loss_step(..., rows=)`` scores one rank's rows of the batch as one
process would, and ``evaluate`` scores a round-robin shard a rank and
computes the metrics from the whole gathered ranking on every rank.

The memory policies (models/nbfnet.py) set to "auto" are resolved against
a memory budget, as the JAX package resolves them: the device's memory
(``_device_bytes``) halved once per fail-soft demotion level
(``demote_policy``, which the engine calls after an out-of-memory error).
``remat="auto"`` takes the cheapest tier whose modelled peak fits 0.7 of
the budget: keep everything, then ``save_rspmm``, then full recomputation;
``auto_micro_batch`` then halves the entity tower's batch chunk while the
saved layer inputs exceed ``_MB_BUDGET_FRACTION`` of the budget; the eval
batch (``eval_batch_size: None``) is the largest power of two whose
modelled state fits 0.75 of the budget, at most 128. The loss and eval
functions resolve the policies at every call (the JAX package resolves
them when it traces, and must re-trace after a demotion), so a demotion
takes effect at the next call and no prepared graph is rebuilt.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import default_device
from ..data.datasets import InductiveDataset, JointDataset, TransductiveDataset
from ..data.graph import Graph
from ..data.relgraph import build_relation_graph
from ..models.classic_nbfnet import classic_nbfnet_init, classic_score_all
from ..models.layers import _check_ring_aggregation, ring_active, sparse_only
from ..models.nbfnet import NBFNetConfig
from ..models.ultra import (
    UltraConfig,
    _flip_heads_to_tails,
    _mask_easy_edges,
    candidate_triples,
    ultra_eval_scores,
    ultra_init,
    ultra_train_scores,
)
from ..ops.match import head_truth_mask, tail_truth_mask
from ..ops.sampling import strict_negatives
from ..parallel import distributed
from ..parallel.mesh import current_mesh
from ..utils.logging import LOGGER_NAME
from .kg import (
    bce_self_adversarial,
    cross_entropy_positive,
    evaluate_ranking,
    filtered_ranking,
    margin_ranking,
    toy_eval_negatives,
    toy_eval_ranking,
)

DEFAULT_TRANSDUCTIVE_METRICS = (
    "mr", "mrr", "hits@1", "hits@3", "hits@10",
    "mrr-tail", "hits@1-tail", "hits@10-tail",
)
DEFAULT_INDUCTIVE_METRICS = ("mr", "mrr", "hits@1", "hits@3", "hits@10",
                             "hits@10_50")
DEFAULT_PRETRAIN_METRICS = ("mr", "mrr", "hits@1", "hits@3", "hits@10")
# the sampled protocol's candidates: 50 negatives and the positive
TOY_EVAL_SAMPLES = 50


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    num_negative: int = 128
    adversarial_temperature: float = 1.0
    strict_negative: bool = True
    filtered_ranking: bool = True
    criterion: str = "bce"
    margin: float = 6.0
    metrics: Sequence[str] = DEFAULT_TRANSDUCTIVE_METRICS
    sample_weight: bool = False
    fact_ratio: Optional[float] = None
    metric_per_rel: bool = False
    toy_eval: bool = False  # rank among 50 sampled negatives
    # pins the eval batch; None sizes it to the memory budget
    # (_TaskBase._resolve_eval_batch). Rankings do not depend on it
    eval_batch_size: Optional[int] = None


def is_oom_error(e: BaseException) -> bool:
    """A device out-of-memory error: torch's, or one whose message says so
    as XLA's do (RESOURCE_EXHAUSTED, "out of memory")."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


def _criterion_loss(cfg: TaskConfig, scores, sample_weight=None):
    if cfg.criterion == "bce":
        return bce_self_adversarial(scores, cfg.adversarial_temperature,
                                    sample_weight)
    if cfg.criterion == "ce":
        return cross_entropy_positive(scores)
    if cfg.criterion == "ranking":
        return margin_ranking(scores, cfg.margin)
    raise ValueError(f"unknown criterion {cfg.criterion!r}")


def _degree_weights(train: np.ndarray, num_entities: int, num_relations: int):
    """The sample_weight degree tables: (h, r) and (t, r) counts of the
    train triples."""
    deg_hr = np.zeros((num_entities, num_relations), np.int64)
    deg_tr = np.zeros((num_entities, num_relations), np.int64)
    np.add.at(deg_hr, (train[:, 0], train[:, 2]), 1)
    np.add.at(deg_tr, (train[:, 1], train[:, 2]), 1)
    return deg_hr, deg_tr


# the memory budget on the CPU, where no device reports one: the JAX
# package's fallback figure (tests set it with monkeypatch)
CPU_BUDGET_BYTES = 16 << 30


def _device_bytes(device) -> int:
    """The memory the auto policies size against: the card's total memory,
    or CPU_BUDGET_BYTES for the CPU (a budget, not a measurement)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return CPU_BUDGET_BYTES


# The peak models below are in units of one flat [V, B*D] fp32 state of the
# propagation graph (V nodes, batch B, width D), fitted to
# torch.cuda.max_memory_allocated above the resident graphs and weights, on
# an NVIDIA H100 80GB HBM3 at 700 W (diagnostics/policy_memory.py: ULTRA
# 6x64, one train step at batch 64 with 128 negatives, eval batches of 16
# and 64, on generated graphs with FB15k-237's, WN18RR's and ATOMIC's
# counts). Each constant takes the largest of the graphs' readings.
# keep-everything training peak, units a layer: FB15k-237 28.51 / 6 = 4.752
# (WN18RR 4.375; ATOMIC out of memory)
_FULL_SAVE_PEAK_FACTOR = 4.752
# save_rspmm training peak: 2 units a layer (each layer keeps its input and
# its aggregation's output) plus a working set: FB15k-237 19.35 - 12 = 7.35
# (WN18RR 5.09; ATOMIC out of memory)
_SAVE_RSPMM_UNITS_PER_LAYER = 2.0
_SAVE_RSPMM_UNITS_BASE = 7.35
# full recomputation's training peak, units a layer: FB15k-237 13.83 / 6 =
# 2.305 (WN18RR 2.011, ATOMIC 2.006: 55.9 GiB). auto_micro_batch lets the
# saved layer inputs (L units) take 0.7 / 2.305 of the budget, so that the
# peak they stand for stays within 0.7 of it, as for the other tiers
_MB_BUDGET_FRACTION = 0.3036
# eval: the peak's growth a query, in [V, D] fp32 units: FB15k-237 11.10
# (WN18RR 11.02, ATOMIC 11.01) from batches of 16 and 64
_EVAL_STATE_COPIES = 11.10
_EVAL_BATCH_RAISE_CAP = 128  # the auto eval batch never exceeds this


def _save_rspmm_units(num_layers: int) -> float:
    return (_SAVE_RSPMM_UNITS_PER_LAYER * num_layers
            + _SAVE_RSPMM_UNITS_BASE)


def auto_micro_batch(model_cfg: UltraConfig, num_nodes: int, batch: int,
                     budget_bytes: int) -> UltraConfig:
    """The entity tower's micro-batch for ``batch`` queries on a graph of
    ``num_nodes`` nodes: with full recomputation the backward still keeps
    one flat [V, B*D] fp32 input a layer; while those exceed
    _MB_BUDGET_FRACTION of ``budget_bytes``, halve the chunk (while it
    divides the batch). An explicit micro_batch, a batch of one, and a
    batch whose inputs fit keep the config as it is."""
    ent = model_cfg.entity
    if ent.micro_batch or batch <= 1:
        return model_cfg
    layers, dim = len(ent.hidden_dims), ent.input_dim
    budget = _MB_BUDGET_FRACTION * budget_bytes

    def carry_bytes(b):
        return layers * num_nodes * b * dim * 4

    if carry_bytes(batch) <= budget:
        return model_cfg
    mb = batch
    while mb > 1 and carry_bytes(mb) > budget and batch % (mb // 2) == 0:
        mb //= 2
    if mb == batch:
        return model_cfg  # an odd batch: no chunk divides it
    return dataclasses.replace(
        model_cfg, entity=dataclasses.replace(ent, micro_batch=mb))


class _TaskBase:
    model_cfg: UltraConfig
    cfg: TaskConfig
    device: torch.device

    # fail-soft: each demotion level halves the budget that every auto
    # policy sizes against, which walks the training policy one tier down
    # (keep everything -> save_rspmm -> full recomputation -> halved
    # micro-batches) and shrinks the auto eval batch; pinned values stay
    _policy_demotion = 0
    _MAX_POLICY_DEMOTION = 6

    def init_params(self, seed: int = 0):
        """A freshly initialized model on the task's device."""
        return ultra_init(self.model_cfg, seed, self.device)

    def _budget_bytes(self) -> int:
        return _device_bytes(self.device) >> self._policy_demotion

    def demote_policy(self, reason: str = "") -> bool:
        """Halve the budget of the auto policies; the next loss or eval call
        resolves them against it. False when the ladder is exhausted."""
        if self._policy_demotion >= self._MAX_POLICY_DEMOTION:
            return False
        self._policy_demotion += 1
        logging.getLogger(LOGGER_NAME).warning(
            "policy demotion -> level %d (budget %.1f GiB)%s",
            self._policy_demotion, self._budget_bytes() / 2**30,
            f": {reason}" if reason else "")
        return True

    def _resolve_model_cfg(self, fact_graph, batch: int = 64) -> UltraConfig:
        """The model config with ``remat="auto"`` and ``stack="auto"``
        resolved for ``batch`` queries on ``fact_graph`` (its node count):
        per tower the first tier whose modelled peak fits 0.7 of the budget,
        keep everything (False), then "save_rspmm", else full recomputation
        (True); the relation tower sizes against the relation graph's 2R
        nodes. ``stack`` resolves to "scan", as the JAX package does off the
        TPU (it changes nothing in the port)."""
        cfg = self.model_cfg
        budget = 0.7 * self._budget_bytes()

        def resolve(tower, num_nodes):
            layers = len(tower.hidden_dims)
            unit = num_nodes * batch * tower.input_dim * 4
            if _FULL_SAVE_PEAK_FACTOR * layers * unit <= budget:
                return False
            if _save_rspmm_units(layers) * unit <= budget:
                return "save_rspmm"
            return True

        towers = {}
        for name, num_nodes in (("entity", fact_graph.num_nodes),
                                ("relation", cfg.entity.num_relations)):
            tower = getattr(cfg, name)
            changes = {}
            if tower.remat == "auto":
                changes["remat"] = resolve(tower, num_nodes)
            if tower.stack == "auto":
                changes["stack"] = "scan"
            towers[name] = (dataclasses.replace(tower, **changes) if changes
                            else tower)
        if all(towers[n] is getattr(cfg, n) for n in towers):
            return cfg
        return dataclasses.replace(cfg, **towers)

    def _train_model_cfg(self, fact_graph, batch: int) -> UltraConfig:
        """The policies a loss step of ``batch`` queries on ``fact_graph``
        runs: the resolved remat, then the auto micro-batch."""
        return auto_micro_batch(self._resolve_model_cfg(fact_graph, batch),
                                fact_graph.num_nodes, batch,
                                self._budget_bytes())

    def _resolve_eval_batch(self, requested: int, num_nodes: int) -> int:
        """The eval batch: ``eval_batch_size`` when the config pins it, else
        the largest power of two whose modelled forward state
        (_EVAL_STATE_COPIES [V, D] fp32 units a query) fits 0.75 of the
        budget, at most max(``requested``, _EVAL_BATCH_RAISE_CAP)."""
        if self.cfg.eval_batch_size:
            return int(self.cfg.eval_batch_size)
        per_query = (_EVAL_STATE_COPIES * num_nodes
                     * self.model_cfg.entity.input_dim * 4)
        fit = max(1, int(0.75 * self._budget_bytes() / per_query))
        cap = min(fit, max(requested, _EVAL_BATCH_RAISE_CAP))
        b = 1
        while b * 2 <= cap:
            b *= 2
        return b

    # scoring hooks: ULTRA here; ClassicNBFNetTask overrides them
    def _train_scores(self, model, fact_graph, rel_graph, h, t, r, neg,
                      fact_und, model_cfg=None, rows=None):
        """[B, 1 + N] scores of each query's positive and negatives, under
        the memory policies of ``model_cfg`` (the task's by default); only
        ``rows`` of them, on the whole batch's masked graph, when given."""
        return ultra_train_scores(model, fact_graph, rel_graph, h, t, r, neg,
                                  fact_graph_und=fact_und,
                                  model_cfg=model_cfg or self.model_cfg,
                                  rows=rows)

    def _eval_scores(self, model, fact_graph, rel_graph, h, t, r, fact_und,
                     model_cfg=None):
        """All-entity (tail [B, V], head [B, V]) scores."""
        return ultra_eval_scores(model, fact_graph, rel_graph, h, t, r,
                                 fact_graph_und=fact_und,
                                 model_cfg=model_cfg or self.model_cfg)

    def _prepare_graphs(self, fact_graph: Graph, rel_graph: Graph,
                        backward: bool = False):
        """The undirected propagation graph with its CSR (the rspmm kernels'
        layouts, the backward's too when ``backward``), and the relation
        graph with its dense adjacency when it is small and dense enough,
        and its CSR when it has none or when the relation tower's conv
        reaches the sparse ops on every graph (max, pna, rotate), on the
        task's device. Under an active edge mesh with ``rspmm_impl="ring"``
        the propagation graph also gets the ring's buckets
        (``Graph.prepare_ring``): per-bucket CSRs for distmult,
        degree-balanced when the contiguous split is not, permuted IO. It
        keeps its CSR for the single-device route off the mesh."""
        und = fact_graph.undirected_with_inverse().prepare_csr(backward)
        n_shards = self._ring_shards()
        if n_shards:
            und = und.prepare_ring(
                n_shards, pallas=self.model_cfg.entity.message_func
                == "distmult", balance="auto", permuted_io=True,
                backward=backward)
        rel_graph = rel_graph.prepare_dense()
        relation = self.model_cfg.relation
        if (rel_graph.dense_adj is None
                or sparse_only(relation.aggregate_func,
                               relation.message_func)):
            rel_graph = rel_graph.prepare_csr(backward)
        return und.to(self.device), rel_graph.to(self.device)

    def _ring_shards(self) -> int:
        """The edge shards of the active mesh when the entity tower rides
        the ring (``rspmm_impl="ring"`` with an ``edge_axis`` the mesh has),
        else 0. The relation tower stays replicated and dense; an edge axis
        on it (``parallel.relation_edge``) raises."""
        entity = self.model_cfg.entity
        layer_cfg = entity.layer_configs()[0]
        if not ring_active(layer_cfg):
            return 0
        if self.model_cfg.relation.edge_axis:
            raise NotImplementedError(
                "an edge-sharded relation tower (parallel.relation_edge) is "
                "not ported yet (ROADMAP Queue 1 item 9)")
        _check_ring_aggregation(layer_cfg)
        return current_mesh().shape[entity.edge_axis]

    def _build_loss_fn(self, fact_graph: Graph, rel_graph: Graph,
                       num_nodes: int):
        """Returns fn(model, generator, batch [B, 3] on the device,
        sample_weight=None, neg=None, rows=None) -> (loss, metrics).
        Negatives are strict (or uniform) draws from ``generator`` unless
        ``neg`` [B, N] is given. ``rows`` (a data-parallel rank's slice of
        the batch, one of P equal ones): the negatives and the easy-edge
        mask are the whole batch's, as in one process, only those rows are
        scored, and the loss is scaled so that its mean over the P ranks is
        the whole batch's loss (and so are the metrics')."""
        cfg = self.cfg
        # pre-sorted edges: the per-step easy-edge mask joins by binary
        # search instead of sorting the edges and the batch every step
        fact_graph = fact_graph.prepare_join(
            one_hop=self.model_cfg.remove_one_hop).to(self.device)
        fact_und, rel_graph = self._prepare_graphs(fact_graph, rel_graph,
                                                   backward=True)
        fact_edges = fact_graph.edge_list

        def loss_fn(model, generator, batch, sample_weight=None, neg=None,
                    rows=None):
            h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
            if neg is None and cfg.strict_negative:
                neg = strict_negatives(generator, fact_edges, h, t, r,
                                       num_nodes, cfg.num_negative)
            elif neg is None:
                neg = torch.randint(0, num_nodes,
                                    (batch.shape[0], cfg.num_negative),
                                    generator=generator, device=batch.device)
            n_rows = batch.shape[0]
            if rows is not None:
                n_rows = len(range(*rows.indices(batch.shape[0])))
            scores = self._train_scores(
                model, fact_graph, rel_graph, h, t, r, neg, fact_und,
                model_cfg=self._train_model_cfg(fact_graph, n_rows),
                rows=rows)
            scale = 1.0
            if rows is not None and sample_weight is not None:
                if cfg.criterion == "bce":  # the one that weighs rows
                    # P * (this rank's weighted sum) / (the batch's weight)
                    scale = (batch.shape[0] / n_rows
                             * sample_weight[rows].sum()
                             / sample_weight.sum())
                sample_weight = sample_weight[rows]
            loss = _criterion_loss(cfg, scores, sample_weight) * scale
            metrics = {"loss": loss.detach(),
                       "pos_score": scores[:, 0].detach().mean(),
                       "neg_score": scores[:, 1:].detach().mean()}
            return loss, metrics

        return loss_fn

    def _build_eval_fn(self, fact_graph: Graph, rel_graph: Graph,
                       filter_graph: Graph):
        """Returns fn(model, batch [B, 3] on the device, generator) ->
        (ranking [B, 2], num_candidates [B, 2] float32), tail direction in
        column 0, head in column 1. The ranking is the filtered rank
        (int64) among the num_candidates allowed entities, or with
        ``toy_eval`` the float rank among TOY_EVAL_SAMPLES allowed entities
        drawn from ``generator`` (num_candidates the samples and the
        positive)."""
        cfg = self.cfg
        V = fact_graph.num_nodes
        fact_und, rel_graph = self._prepare_graphs(fact_graph, rel_graph)
        filter_edges = filter_graph.edge_list.to(self.device)

        def eval_fn(model, batch, generator=None):
            h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
            t_scores, h_scores = self._eval_scores(
                model, fact_graph, rel_graph, h, t, r, fact_und,
                model_cfg=self._resolve_model_cfg(fact_graph))
            t_truth = tail_truth_mask(filter_edges, h, r, V)
            h_truth = head_truth_mask(filter_edges, t, r, V)
            if cfg.toy_eval:
                ranks = [toy_eval_ranking(
                    scores.gather(1, target[:, None]), scores,
                    toy_eval_negatives(generator, ~truth, TOY_EVAL_SAMPLES))
                    for scores, target, truth in ((t_scores, t, t_truth),
                                                  (h_scores, h, h_truth))]
                ranking = torch.stack(ranks, dim=1)
                num_cand = torch.full(ranking.shape, TOY_EVAL_SAMPLES + 1.0,
                                      device=ranking.device)
                return ranking, num_cand
            t_rank = filtered_ranking(t_scores, t, t_truth,
                                      cfg.filtered_ranking)
            h_rank = filtered_ranking(h_scores, h, h_truth,
                                      cfg.filtered_ranking)
            num_cand = torch.stack([(~t_truth).sum(-1), (~h_truth).sum(-1)],
                                   dim=1).to(torch.float32)
            return torch.stack([t_rank, h_rank], dim=1), num_cand

        return eval_fn

    def _run_eval(self, eval_fn, model, triples: np.ndarray,
                  batch_size: int):
        """The numpy ranking [N, 2] and num_candidates [N, 2] of
        ``triples``. Under a process group each rank scores a round-robin
        shard (``distributed.shard_eval_triples``) and every rank gets the
        whole split's results in order (``gather_rankings``). An
        out-of-memory error on any rank raises one on every rank (a flag
        all-reduced before the gather), so that all ranks demote and retry
        together."""
        total = len(triples)
        triples = distributed.shard_eval_triples(triples)
        error = None
        try:
            ranking, cand = self._score_triples(eval_fn, model, triples,
                                                batch_size)
        except RuntimeError as e:
            if not is_oom_error(e):
                raise
            error = e
        if distributed.any_rank(error is not None, self.device):
            raise error or RuntimeError(
                "out of memory on another rank during evaluation")
        return (distributed.gather_rankings(ranking, total),
                distributed.gather_rankings(cand, total))

    def _score_triples(self, eval_fn, model, triples: np.ndarray,
                       batch_size: int):
        """Pad-to-batch eval loop (the last chunk repeats its row 0); returns
        the numpy ranking [N, 2] and num_candidates [N, 2]. The toy
        protocol's draws come from a generator seeded per batch by its
        first row's index in ``triples`` (a rank's shard under a process
        group, as in the JAX package). Results stay on the device until the
        split is done."""
        rankings, cands, keeps = [], [], []
        with torch.inference_mode():
            for start in range(0, len(triples), batch_size):
                chunk = triples[start:start + batch_size]
                pad = batch_size - len(chunk)
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[:1], pad, 0)], 0)
                batch = torch.from_numpy(chunk.astype(np.int64)).to(
                    self.device)
                generator = None
                if self.cfg.toy_eval:
                    generator = torch.Generator(
                        device=self.device).manual_seed(1024 + start)
                ranking, num_cand = eval_fn(model, batch, generator)
                rankings.append(ranking)
                cands.append(num_cand)
                keeps.append(batch_size - pad)
        if not rankings:
            dtype = np.float32 if self.cfg.toy_eval else np.int64
            return np.zeros((0, 2), dtype), np.zeros((0, 2), np.float32)
        return tuple(torch.cat([x[:k] for x, k in zip(xs, keeps)]).cpu().numpy()
                     for xs in (rankings, cands))

    def _metrics_from_rankings(self, ranking: np.ndarray,
                               num_cand: np.ndarray,
                               rel: Optional[np.ndarray]) -> Dict[str, float]:
        """The config's metrics of a split's ranking; with
        ``metric_per_rel`` and ``rel`` (the relation id of each ranking
        entry) also each metric's mean per relation."""
        kwargs = {}
        if self.cfg.metric_per_rel and rel is not None:
            kwargs = dict(rel_index=torch.from_numpy(rel.astype(np.int64)),
                          num_relations=self.num_relations * 2)
        m = evaluate_ranking(torch.from_numpy(ranking), self.cfg.metrics,
                             num_candidates=torch.from_numpy(num_cand),
                             **kwargs)
        return {k: float(v) for k, v in m.items()}

    def sample_weight_for(self, batch: np.ndarray):
        """Per-triple loss weights 1 / sqrt(deg(h, r) * deg(t, r)) over the
        train triples when ``sample_weight`` is on, else None."""
        if not self.cfg.sample_weight:
            return None
        w = (self.deg_hr[batch[:, 0], batch[:, 2]]
             * self.deg_tr[batch[:, 1], batch[:, 2]])
        return torch.as_tensor(1.0 / np.sqrt(np.maximum(w, 1)),
                               dtype=torch.float32, device=self.device)

    def loss_step(self, model, generator: torch.Generator, batch: np.ndarray,
                  neg: Optional[torch.Tensor] = None,
                  rows: Optional[slice] = None):
        """(loss, metrics) of one batch of train triples [B, 3]; ``neg``
        [B, N] replaces the drawn negatives (to hold a step against
        another implementation); ``rows`` scores a data-parallel rank's
        rows (``_build_loss_fn``)."""
        b = torch.from_numpy(np.asarray(batch, np.int64)).to(self.device)
        return self._loss_fn(model, generator, b,
                             self.sample_weight_for(batch), neg, rows)

    def _fast_subset(self, triples: np.ndarray, fast_test) -> np.ndarray:
        """``fast_test`` triples of ``triples``: a seeded random subset."""
        if not fast_test:
            return triples
        g = np.random.default_rng(1024)
        return triples[g.permutation(len(triples))[:fast_test]]


class TransductiveKGTask(_TaskBase):
    def __init__(self, dataset: TransductiveDataset, model_cfg: UltraConfig,
                 cfg: TaskConfig = TaskConfig(), seed: int = 0, device=None):
        self.dataset = dataset
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = default_device(device)
        self.num_relations = dataset.num_relations
        self.fact_graph, self.train_triples = dataset.fact_graph(
            cfg.fact_ratio, seed=seed)
        self.rel_graph = build_relation_graph(self.fact_graph)
        self.graph = dataset.graph  # filter graph
        if cfg.sample_weight:
            self.deg_hr, self.deg_tr = _degree_weights(
                self.train_triples, dataset.num_entities,
                dataset.num_relations)
        self._loss_fn = self._build_loss_fn(self.fact_graph, self.rel_graph,
                                            dataset.num_entities)
        self._eval_fn = self._build_eval_fn(self.fact_graph, self.rel_graph,
                                            self.graph)

    def eval_triples(self, split: str) -> np.ndarray:
        return {"valid": self.dataset.valid, "test": self.dataset.test}[split]

    def evaluate(self, model, split: str, batch_size: int, fast_test=None):
        """Filtered-ranking metrics of ``model`` on a split; ``fast_test``
        keeps a seeded random subset of that many triples."""
        triples = self._fast_subset(self.eval_triples(split), fast_test)
        ranking, cand = self._run_eval(
            self._eval_fn, model, triples,
            self._resolve_eval_batch(batch_size, self.fact_graph.num_nodes))
        rel = np.stack([triples[:, 2], triples[:, 2] + self.num_relations], 1)
        return self._metrics_from_rankings(ranking, cand, rel)


def _same_graph(a: Graph, b: Graph) -> bool:
    """The same object, or equal edge lists and edge types."""
    return a is b or (a.num_edges == b.num_edges
                      and torch.equal(a.edge_index, b.edge_index)
                      and torch.equal(a.edge_type, b.edge_type))


class InductiveKGTask(_TaskBase):
    """Inductive KG completion: the model trains over the train graph and
    evaluates each split over that split's propagation graph, whose
    entities may be new, with a relation graph built from it. Valid ranks
    against the transductive filter graph (``dataset.graph``) when the
    valid graph is the train graph, else against the inductive one, as
    test always does. Each distinct propagation graph is prepared once:
    where valid and test share one, they share its layouts and relation
    graph."""

    def __init__(self, dataset: InductiveDataset, model_cfg: UltraConfig,
                 cfg: TaskConfig = TaskConfig(
                     metrics=DEFAULT_INDUCTIVE_METRICS),
                 device=None):
        self.dataset = dataset
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = default_device(device)
        self.num_relations = dataset.num_relations
        self.train_triples = dataset.train
        self.graphs = {"train": dataset.train_graph,
                       "valid": dataset.valid_graph,
                       "test": dataset.test_graph}
        rel_graphs = {}
        for g in self.graphs.values():
            if id(g) not in rel_graphs:
                rel_graphs[id(g)] = build_relation_graph(g)
        self.rel_graphs = {split: rel_graphs[id(g)]
                           for split, g in self.graphs.items()}
        valid_is_train = _same_graph(dataset.valid_graph,
                                     dataset.train_graph)
        self.filter_graphs = {
            "train": dataset.graph,
            "valid": dataset.graph if valid_is_train
            else dataset.inductive_graph,
            "test": dataset.inductive_graph,
        }
        if cfg.sample_weight:
            self.deg_hr, self.deg_tr = _degree_weights(
                dataset.train, dataset.train_graph.num_nodes,
                dataset.num_relations)
        self._eval_fns = {}

    @functools.cached_property
    def _loss_fn(self):
        """The loss over the train graph, prepared at the first step."""
        return self._build_loss_fn(self.dataset.train_graph,
                                   self.rel_graphs["train"],
                                   self.dataset.train_graph.num_nodes)

    def eval_fn(self, split: str):
        """The eval function of ``split``, built at its first use, one per
        distinct (propagation graph, filter graph)."""
        key = (id(self.graphs[split]), id(self.filter_graphs[split]))
        if key not in self._eval_fns:
            self._eval_fns[key] = self._build_eval_fn(
                self.graphs[split], self.rel_graphs[split],
                self.filter_graphs[split])
        return self._eval_fns[key]

    def eval_triples(self, split: str) -> np.ndarray:
        return {"valid": self.dataset.valid, "test": self.dataset.test}[split]

    def evaluate(self, model, split: str, batch_size: int, fast_test=None):
        """Filtered-ranking metrics of ``model`` on a split, over the
        split's graph; per relation (``metric_per_rel``) both directions
        count under the base relation."""
        triples = self._fast_subset(self.eval_triples(split), fast_test)
        ranking, cand = self._run_eval(
            self.eval_fn(split), model, triples,
            self._resolve_eval_batch(batch_size,
                                     self.graphs[split].num_nodes))
        rel = np.stack([triples[:, 2], triples[:, 2]], 1)
        return self._metrics_from_rankings(ranking, cand, rel)


class MultiGraphPretrainTask(_TaskBase):
    """Pre-training on several graphs: per graph the full graph (the
    filter), the fact graph of its train edges that the model propagates
    over, its relation graph and its train triples. A step trains on one
    graph (``sample_graph_id`` draws it, weighted by the graphs' fact edge
    counts); each graph's loss and eval functions, with its layouts on the
    device, are built at first use and kept. ``evaluate`` returns each
    metric's mean over the graphs, and every graph's metrics under
    ``per_graph``."""

    def __init__(self, dataset: JointDataset, model_cfg: UltraConfig,
                 cfg: TaskConfig = TaskConfig(
                     metrics=DEFAULT_PRETRAIN_METRICS),
                 device=None):
        self.dataset = dataset
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = default_device(device)
        self.graphs: List[Graph] = []  # full graphs (filtering)
        self.fact_graphs: List[Graph] = []  # train-edge graphs (propagation)
        self.rel_graphs: List[Graph] = []
        self.train_triples: List[np.ndarray] = []
        for ds in dataset.datasets:
            fact, train = ds.fact_graph(None)
            self.graphs.append(ds.graph)
            self.fact_graphs.append(fact)
            self.rel_graphs.append(build_relation_graph(fact))
            self.train_triples.append(train)
        self.num_graphs = len(self.graphs)
        self.num_relations = max(g.num_relations for g in self.graphs)
        probs = np.array([g.num_edges for g in self.fact_graphs], np.float64)
        self._graph_probs = probs / probs.sum()
        self._loss_fns = {}
        self._eval_fns = {}

    def sample_graph_id(self, rng: np.random.Generator) -> int:
        """One draw of the edge-count mixture."""
        return int(rng.choice(self.num_graphs, p=self._graph_probs))

    def ensure_loss_fn(self, graph_id: int):
        """Graph ``graph_id``'s loss function, built at its first use."""
        if graph_id not in self._loss_fns:
            fact = self.fact_graphs[graph_id]
            self._loss_fns[graph_id] = self._build_loss_fn(
                fact, self.rel_graphs[graph_id], fact.num_nodes)
        return self._loss_fns[graph_id]

    def loss_step(self, model, generator: torch.Generator, batch: np.ndarray,
                  graph_id: int, neg: Optional[torch.Tensor] = None,
                  rows: Optional[slice] = None):
        """(loss, metrics) of one batch of graph ``graph_id``'s train
        triples; ``neg`` and ``rows`` as in ``_TaskBase.loss_step``."""
        b = torch.from_numpy(np.asarray(batch, np.int64)).to(self.device)
        return self.ensure_loss_fn(graph_id)(model, generator, b, None, neg,
                                             rows)

    def eval_sets(self, split: str):
        """[(graph name, graph id, triples)] of ``split``."""
        return [(ds.name, gid, {"valid": ds.valid, "test": ds.test}[split])
                for gid, ds in enumerate(self.dataset.datasets)]

    def evaluate(self, model, split: str, batch_size: int, fast_test=None):
        """Each metric's mean over the graphs, and ``per_graph``: graph
        name -> its metrics; ``fast_test`` applies per graph."""
        per_graph = {}
        for name, gid, triples in self.eval_sets(split):
            triples = self._fast_subset(triples, fast_test)
            if gid not in self._eval_fns:
                self._eval_fns[gid] = self._build_eval_fn(
                    self.fact_graphs[gid], self.rel_graphs[gid],
                    self.graphs[gid])
            ranking, cand = self._run_eval(
                self._eval_fns[gid], model, triples,
                self._resolve_eval_batch(batch_size,
                                         self.fact_graphs[gid].num_nodes))
            per_graph[name] = self._metrics_from_rankings(ranking, cand, None)
        metrics = list(per_graph.values())
        avg = {k: float(np.mean([m[k] for m in metrics]))
               for k in metrics[0]}
        avg["per_graph"] = per_graph
        return avg


class ClassicNBFNetTask(TransductiveKGTask):
    """Transductive KG completion with classic NBFNet (learned query
    embeddings, no relation tower; models/classic_nbfnet.py). ``nbf_cfg`` is
    an NBFNetConfig from ``classic_nbfnet_config``; ``model_cfg`` wraps it
    as both towers of an UltraConfig, as in the JAX package, so the task's
    machinery (the easy-edge mask with ``remove_one_hop`` off, the engine's
    counters) applies unchanged. The relation graph is built and unused."""

    def __init__(self, dataset: TransductiveDataset, nbf_cfg: NBFNetConfig,
                 cfg: TaskConfig = TaskConfig(), seed: int = 0, device=None):
        self.nbf_cfg = nbf_cfg
        super().__init__(dataset, UltraConfig(entity=nbf_cfg,
                                              relation=nbf_cfg),
                         cfg, seed=seed, device=device)

    def init_params(self, seed: int = 0):
        return classic_nbfnet_init(self.nbf_cfg, seed, self.device)

    def _prepare_graphs(self, fact_graph: Graph, rel_graph: Graph,
                        backward: bool = False):
        und = fact_graph.undirected_with_inverse().prepare_csr(backward)
        return und.to(self.device), rel_graph

    # as in the JAX package, classic NBFNet runs the config's own policies:
    # the resolved ones (model_cfg) are not read
    def _train_scores(self, model, fact_graph, rel_graph, h, t, r, neg,
                      fact_und, model_cfg=None, rows=None):
        h_index, t_index, r_index = candidate_triples(h, t, r, neg)
        graph = _mask_easy_edges(self.model_cfg, fact_graph, h_index,
                                 t_index, r_index)
        # the weighted degree of pna follows the masked weights
        graph_und = fact_und.with_edge_weight(
            torch.cat([graph.edge_weight, graph.edge_weight]))
        h_index, t_index, r_index = _flip_heads_to_tails(
            h_index, t_index, r_index, fact_graph.num_relations)
        if rows is not None:
            h_index, t_index, r_index = (h_index[rows], t_index[rows],
                                         r_index[rows])
        return classic_score_all(model, graph_und, h_index[:, 0],
                                 r_index[:, 0], targets=t_index)

    def _eval_scores(self, model, fact_graph, rel_graph, h, t, r, fact_und,
                     model_cfg=None):
        t_scores = classic_score_all(model, fact_und, h, r)
        h_scores = classic_score_all(model, fact_und, t,
                                     r + fact_graph.num_relations)
        return t_scores, h_scores

"""Task layer (counterpart of ultra_torchdrug_tpu/tasks/task.py): the loss
step for training and filtered-ranking evaluation.

``TransductiveKGTask`` holds one knowledge graph: the fact graph (train
edges) that the model propagates over, the relation graph built from it, and
the filter graph (all splits) for filtered ranking. ``ClassicNBFNetTask``
scores the same task with classic NBFNet, which needs no relation graph.

  * ``loss_step`` draws strict negatives for a batch of train triples,
    masks the batch's easy edges, scores the positive and the negatives and
    returns the loss (a tensor to call ``backward`` on) with its metrics.
  * ``evaluate`` scores each (h, r, ?) and (?, r, t) query against every
    entity and turns the filtered ranks into metrics, eagerly under
    ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import default_device
from ..data.datasets import TransductiveDataset
from ..data.graph import Graph
from ..data.relgraph import build_relation_graph
from ..models.classic_nbfnet import classic_nbfnet_init, classic_score_all
from ..models.layers import sparse_only
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
from .kg import (
    bce_self_adversarial,
    cross_entropy_positive,
    evaluate_ranking,
    filtered_ranking,
    margin_ranking,
)

DEFAULT_TRANSDUCTIVE_METRICS = (
    "mr", "mrr", "hits@1", "hits@3", "hits@10",
    "mrr-tail", "hits@1-tail", "hits@10-tail",
)


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


class _TaskBase:
    model_cfg: UltraConfig
    cfg: TaskConfig
    device: torch.device

    def init_params(self, seed: int = 0):
        """A freshly initialized model on the task's device."""
        return ultra_init(self.model_cfg, seed, self.device)

    # scoring hooks: ULTRA here; ClassicNBFNetTask overrides them
    def _train_scores(self, model, fact_graph, rel_graph, h, t, r, neg,
                      fact_und):
        """[B, 1 + N] scores of each query's positive and negatives."""
        return ultra_train_scores(model, fact_graph, rel_graph, h, t, r, neg,
                                  fact_graph_und=fact_und)

    def _eval_scores(self, model, fact_graph, rel_graph, h, t, r, fact_und):
        """All-entity (tail [B, V], head [B, V]) scores."""
        return ultra_eval_scores(model, fact_graph, rel_graph, h, t, r,
                                 fact_graph_und=fact_und)

    def _prepare_graphs(self, fact_graph: Graph, rel_graph: Graph,
                        backward: bool = False):
        """The undirected propagation graph with its CSR (the rspmm kernels'
        layouts, the backward's too when ``backward``), and the relation
        graph with its dense adjacency when it is small and dense enough,
        and its CSR when it has none or when the relation tower's conv
        reaches the sparse ops on every graph (max, pna, rotate), on the
        task's device."""
        und = fact_graph.undirected_with_inverse().prepare_csr(backward)
        rel_graph = rel_graph.prepare_dense()
        relation = self.model_cfg.relation
        if (rel_graph.dense_adj is None
                or sparse_only(relation.aggregate_func,
                               relation.message_func)):
            rel_graph = rel_graph.prepare_csr(backward)
        return und.to(self.device), rel_graph.to(self.device)

    def _build_loss_fn(self, fact_graph: Graph, rel_graph: Graph,
                       num_nodes: int):
        """Returns fn(model, generator, batch [B, 3] on the device,
        sample_weight=None, neg=None) -> (loss, metrics). Negatives are
        strict (or uniform) draws from ``generator`` unless ``neg`` [B, N]
        is given."""
        cfg = self.cfg
        # pre-sorted edges: the per-step easy-edge mask joins by binary
        # search instead of sorting the edges and the batch every step
        fact_graph = fact_graph.prepare_join(
            one_hop=self.model_cfg.remove_one_hop).to(self.device)
        fact_und, rel_graph = self._prepare_graphs(fact_graph, rel_graph,
                                                   backward=True)
        fact_edges = fact_graph.edge_list

        def loss_fn(model, generator, batch, sample_weight=None, neg=None):
            h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
            if neg is None and cfg.strict_negative:
                neg = strict_negatives(generator, fact_edges, h, t, r,
                                       num_nodes, cfg.num_negative)
            elif neg is None:
                neg = torch.randint(0, num_nodes,
                                    (batch.shape[0], cfg.num_negative),
                                    generator=generator, device=batch.device)
            scores = self._train_scores(model, fact_graph, rel_graph, h, t, r,
                                        neg, fact_und)
            loss = _criterion_loss(cfg, scores, sample_weight)
            metrics = {"loss": loss.detach(),
                       "pos_score": scores[:, 0].detach().mean(),
                       "neg_score": scores[:, 1:].detach().mean()}
            return loss, metrics

        return loss_fn

    def _build_eval_fn(self, fact_graph: Graph, rel_graph: Graph,
                       filter_graph: Graph):
        """Returns fn(model, batch [B, 3] on the device) -> ranking [B, 2]
        (int64; tail direction in column 0, head in column 1)."""
        cfg = self.cfg
        V = fact_graph.num_nodes
        fact_und, rel_graph = self._prepare_graphs(fact_graph, rel_graph)
        filter_edges = filter_graph.edge_list.to(self.device)

        def eval_fn(model, batch):
            h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
            t_scores, h_scores = self._eval_scores(
                model, fact_graph, rel_graph, h, t, r, fact_und)
            t_truth = tail_truth_mask(filter_edges, h, r, V)
            h_truth = head_truth_mask(filter_edges, t, r, V)
            t_rank = filtered_ranking(t_scores, t, t_truth,
                                      cfg.filtered_ranking)
            h_rank = filtered_ranking(h_scores, h, h_truth,
                                      cfg.filtered_ranking)
            return torch.stack([t_rank, h_rank], dim=1)

        return eval_fn

    def _run_eval(self, eval_fn, model, triples: np.ndarray,
                  batch_size: int):
        """Pad-to-batch eval loop (the last chunk repeats its row 0); returns
        the numpy ranking [N, 2]. Results stay on the device until the split
        is done."""
        rankings, keeps = [], []
        with torch.inference_mode():
            for start in range(0, len(triples), batch_size):
                chunk = triples[start:start + batch_size]
                pad = batch_size - len(chunk)
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[:1], pad, 0)], 0)
                batch = torch.from_numpy(chunk.astype(np.int64)).to(
                    self.device)
                rankings.append(eval_fn(model, batch))
                keeps.append(batch_size - pad)
        if not rankings:
            return np.zeros((0, 2), np.int64)
        return torch.cat([r[:k] for r, k in zip(rankings, keeps)]).cpu().numpy()

    def _metrics_from_rankings(self, ranking: np.ndarray) -> Dict[str, float]:
        m = evaluate_ranking(torch.from_numpy(ranking), self.cfg.metrics)
        return {k: float(v) for k, v in m.items()}


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

    def sample_weight_for(self, batch: np.ndarray):
        """Per-triple loss weights 1 / sqrt(deg(h, r) * deg(t, r)) when
        ``sample_weight`` is on, else None."""
        if not self.cfg.sample_weight:
            return None
        w = (self.deg_hr[batch[:, 0], batch[:, 2]]
             * self.deg_tr[batch[:, 1], batch[:, 2]])
        return torch.as_tensor(1.0 / np.sqrt(np.maximum(w, 1)),
                               dtype=torch.float32, device=self.device)

    def loss_step(self, model, generator: torch.Generator, batch: np.ndarray,
                  neg: Optional[torch.Tensor] = None):
        """(loss, metrics) of one batch of train triples [B, 3]; ``neg``
        [B, N] replaces the drawn negatives (to hold a step against
        another implementation)."""
        b = torch.from_numpy(np.asarray(batch, np.int64)).to(self.device)
        return self._loss_fn(model, generator, b,
                             self.sample_weight_for(batch), neg)

    def eval_triples(self, split: str) -> np.ndarray:
        return {"valid": self.dataset.valid, "test": self.dataset.test}[split]

    def evaluate(self, model, split: str, batch_size: int, fast_test=None):
        """Filtered-ranking metrics of ``model`` on a split; ``fast_test``
        keeps a seeded random subset of that many triples."""
        triples = self.eval_triples(split)
        if fast_test:
            g = np.random.default_rng(1024)
            triples = triples[g.permutation(len(triples))[:fast_test]]
        ranking = self._run_eval(self._eval_fn, model, triples,
                                 int(batch_size))
        return self._metrics_from_rankings(ranking)


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

    def _train_scores(self, model, fact_graph, rel_graph, h, t, r, neg,
                      fact_und):
        h_index, t_index, r_index = candidate_triples(h, t, r, neg)
        graph = _mask_easy_edges(self.model_cfg, fact_graph, h_index,
                                 t_index, r_index)
        # the weighted degree of pna follows the masked weights
        graph_und = fact_und.with_edge_weight(
            torch.cat([graph.edge_weight, graph.edge_weight]))
        h_index, t_index, r_index = _flip_heads_to_tails(
            h_index, t_index, r_index, fact_graph.num_relations)
        return classic_score_all(model, graph_und, h_index[:, 0],
                                 r_index[:, 0], targets=t_index)

    def _eval_scores(self, model, fact_graph, rel_graph, h, t, r, fact_und):
        t_scores = classic_score_all(model, fact_und, h, r)
        h_scores = classic_score_all(model, fact_und, t,
                                     r + fact_graph.num_relations)
        return t_scores, h_scores

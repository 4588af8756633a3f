"""Task layer, evaluation half (counterpart of ultra_torchdrug_tpu/tasks/task.py).

``TransductiveKGTask`` holds one knowledge graph: the fact graph (train
edges) that the model propagates over, the relation graph built from it, and
the filter graph (all splits) for filtered ranking. ``evaluate`` scores each
(h, r, ?) and (?, r, t) query against every entity and turns the filtered
ranks into metrics. It runs eagerly under ``torch.inference_mode()``.
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
from ..models.ultra import UltraConfig, ultra_eval_scores, ultra_init
from ..ops.match import head_truth_mask, tail_truth_mask
from .kg import evaluate_ranking, filtered_ranking

DEFAULT_TRANSDUCTIVE_METRICS = (
    "mr", "mrr", "hits@1", "hits@3", "hits@10",
    "mrr-tail", "hits@1-tail", "hits@10-tail",
)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    filtered_ranking: bool = True
    metrics: Sequence[str] = DEFAULT_TRANSDUCTIVE_METRICS
    fact_ratio: Optional[float] = None


class _TaskBase:
    model_cfg: UltraConfig
    cfg: TaskConfig
    device: torch.device

    def init_params(self, seed: int = 0):
        """A freshly initialized model on the task's device."""
        return ultra_init(self.model_cfg, seed, self.device)

    def _prepare_graphs(self, fact_graph: Graph, rel_graph: Graph):
        """The undirected propagation graph with its CSR (the rspmm kernel's
        layout), and the relation graph with its dense adjacency when it is
        small and dense enough (else its CSR), on the task's device."""
        und = fact_graph.undirected_with_inverse().prepare_csr()
        rel_graph = rel_graph.prepare_dense()
        if rel_graph.dense_adj is None:
            rel_graph = rel_graph.prepare_csr()
        return und.to(self.device), rel_graph.to(self.device)

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
            t_scores, h_scores = ultra_eval_scores(
                model, fact_graph, rel_graph, h, t, r,
                fact_graph_und=fact_und)
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
        self._eval_fn = self._build_eval_fn(self.fact_graph, self.rel_graph,
                                            self.graph)

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

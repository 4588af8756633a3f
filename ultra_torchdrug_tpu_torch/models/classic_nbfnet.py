"""Classic NBFNet (counterpart of ultra_torchdrug_tpu/models/classic_nbfnet.py):
the standalone Bellman-Ford reasoner with learned query embeddings, the
NeuralBellmanFordNetwork of Zhu et al. (NeurIPS 2021).

Query vectors come from an ``Embedding(2R, D)`` table instead of a relation
tower; the layers run in "dependent" mode (per-query relation projections)
by default, with PNA aggregation and distmult messages. Every message
(distmult, transe, rotate) with every aggregation (sum, mean, max, pna, each
also ``*_nobound``) builds, evaluates and trains; on the card sum and mean
run kernel K1 (backward K2 or K3), max K4 (backward K5), pna K6/K7 (backward
K6b/K7b) or, for transe, K6 and two K1 sums (backward K6b and K3). Rotate's
sums run K8f (backward K8b); its max, min and PNA's second moment take the
O(E) route of ops/rspmm.py::rotate_aggregate, as in the JAX package. The
module tree follows the reference's NBFNet state dict: ``layers.{i}``,
``query`` and ``mlp``.

Not ported yet (ROADMAP Queue 1): ``edge_gradients``, ``beam_search_paths``
and ``visualize``, which need gradients to the edge weights; and
``concat_hidden``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.core import init_parameters_
from .nbfnet import NBFNet, NBFNetConfig, _flat_boundary, _propagate, score_heads


def classic_nbfnet_config(input_dim: int = 32,
                          hidden_dims: Sequence[int] = (32,) * 6,
                          num_relations: int = 1,
                          message_func: str = "distmult",
                          aggregate_func: str = "pna",
                          dependent: bool = True, short_cut: bool = True,
                          layer_norm: bool = False,
                          num_mlp_layer: int = 2) -> NBFNetConfig:
    """The classic NBFNet architecture over a graph with ``num_relations``
    base relations (doubled by the inverse edges)."""
    return NBFNetConfig(
        input_dim=input_dim,
        hidden_dims=tuple(hidden_dims),
        num_relations=num_relations * 2,
        message_func=message_func,
        aggregate_func=aggregate_func,
        short_cut=short_cut,
        layer_norm=layer_norm,
        num_mlp_layer=num_mlp_layer,
        rel_mode="dependent" if dependent else "embedding",
        project=False,
    )


class ClassicNBFNet(NBFNet):
    """The conv stack and scoring MLP of ``NBFNet`` plus the query table."""

    def __init__(self, cfg: NBFNetConfig):
        super().__init__(cfg, scoring=True)
        self.query = nn.Embedding(cfg.num_relations, cfg.input_dim)


def classic_nbfnet_init(cfg: NBFNetConfig, seed: int = 0,
                        device=None) -> ClassicNBFNet:
    """A ClassicNBFNet on ``device`` with weights drawn from a generator
    seeded with ``seed`` (torch's default initializers)."""
    from .. import default_device

    device = default_device(device)
    model = ClassicNBFNet(cfg).to(device)
    init_parameters_(model, torch.Generator(device=device).manual_seed(seed))
    return model


def _bellmanford(model: ClassicNBFNet, graph, source, query_rel):
    """Propagate from ``source`` [B] conditioned on ``query_rel`` [B]:
    (final flat state [V, B*D], query vectors [B, D])."""
    B = source.shape[0]
    query = model.query.weight[query_rel]  # [B, D]
    boundary = _flat_boundary(graph.num_nodes, B, model.cfg.input_dim, source,
                              query)
    return _propagate(model, graph, boundary, query=query), query


def classic_score_all(model: ClassicNBFNet, graph_und, source, query_rel,
                      targets=None) -> torch.Tensor:
    """Scores of (source[b], query_rel[b], ?) on the undirected+inverse
    graph: [B, V] over all entities, or [B, T] over the candidates
    ``targets`` [B, T] (the head then runs on those rows alone)."""
    final, query = _bellmanford(model, graph_und, source, query_rel)
    return score_heads(model.mlp, final, query, targets)

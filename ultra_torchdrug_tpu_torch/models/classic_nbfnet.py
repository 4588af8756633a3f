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
O(E) route of ops/rspmm.py::aggregate_edges, as in the JAX package. The
module tree follows the reference's NBFNet state dict: ``layers.{i}``,
``query`` and ``mlp``. ``concat_hidden`` feeds the head every layer's
state side by side.

Path interpretability (the reference's ``visualize`` and ``beam_search``):
``edge_gradients`` differentiates one score with respect to each layer's
copy of the edge weights (the convs then take the O(E) route of
``aggregate_edges``, as the JAX package's edge_grad takes its XLA route),
and ``beam_search_paths`` keeps each node's ``num_beam`` best paths by
summed edge gradient, layer by layer, as a tensor program on the graph's
device.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.core import init_parameters_
from ..ops.variadic import variadic_topk
from .nbfnet import (
    NBFNet,
    NBFNetConfig,
    _check_options,
    _flat_boundary,
    _propagate,
    score_heads,
)


def classic_nbfnet_config(input_dim: int = 32,
                          hidden_dims: Sequence[int] = (32,) * 6,
                          num_relations: int = 1,
                          message_func: str = "distmult",
                          aggregate_func: str = "pna",
                          dependent: bool = True, short_cut: bool = True,
                          layer_norm: bool = False, concat_hidden: bool = False,
                          num_mlp_layer: int = 2,
                          rspmm_impl: str = "auto") -> NBFNetConfig:
    """The classic NBFNet architecture over a graph with ``num_relations``
    base relations (doubled by the inverse edges); ``rspmm_impl`` "auto"
    (or "pallas") takes the kernels, "xla" the O(E) route."""
    impl = _check_options("classic_nbfnet_config", rspmm_impl, {})
    return NBFNetConfig(
        input_dim=input_dim,
        hidden_dims=tuple(hidden_dims),
        num_relations=num_relations * 2,
        message_func=message_func,
        aggregate_func=aggregate_func,
        short_cut=short_cut,
        layer_norm=layer_norm,
        concat_hidden=concat_hidden,
        num_mlp_layer=num_mlp_layer,
        rel_mode="dependent" if dependent else "embedding",
        project=False,
        rspmm_impl=impl["rspmm_impl"],
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


def _bellmanford(model: ClassicNBFNet, graph, source, query_rel,
                 edge_weights=None):
    """Propagate from ``source`` [B] conditioned on ``query_rel`` [B]:
    (final flat state [V, B*D], or [V, B*L*D] with ``concat_hidden``;
    query vectors [B, D]). With ``edge_weights`` (one [E] tensor per layer)
    each layer runs over its own copy of the weights on the O(E) route, so
    that each layer's edge gradient can be taken (the reference's
    separate_grad)."""
    B = source.shape[0]
    query = model.query.weight[query_rel]  # [B, D]
    boundary = _flat_boundary(graph.num_nodes, B, model.cfg.input_dim, source,
                              query)
    if edge_weights is None:
        return _propagate(model, graph, boundary, query=query), query
    graphs = [graph.with_edge_weight(w) for w in edge_weights]
    return _propagate(model, graphs, boundary, query=query,
                      edge_grad=True), query


def classic_score_all(model: ClassicNBFNet, graph_und, source, query_rel,
                      targets=None) -> torch.Tensor:
    """Scores of (source[b], query_rel[b], ?) on the undirected+inverse
    graph: [B, V] over all entities, or [B, T] over the candidates
    ``targets`` [B, T] (the head then runs on those rows alone)."""
    final, query = _bellmanford(model, graph_und, source, query_rel)
    return score_heads(model.mlp, final, query, targets)


def edge_gradients(model: ClassicNBFNet, graph_und, h_index: int,
                   t_index: int, r_index: int) -> List[torch.Tensor]:
    """Per layer, d score(h_index, r_index, t_index) / d edge_weight: a
    list of [E] tensors over the undirected+inverse graph's edges."""
    device = graph_und.device
    weights = [graph_und.edge_weight.detach().clone().requires_grad_()
               for _ in model.layers]
    with torch.enable_grad():
        final, query = _bellmanford(
            model, graph_und, torch.tensor([h_index], device=device),
            torch.tensor([r_index], device=device), edge_weights=weights)
        score = score_heads(model.mlp, final, query)[0, t_index]
        return list(torch.autograd.grad(score, weights))


def beam_search_paths(graph_und, edge_grads: Sequence[torch.Tensor],
                      h_index: int, t_index: int, num_beam: int = 10,
                      path_topk: int = 10
                      ) -> Tuple[List[List[Tuple[int, int, int]]], List[float]]:
    """The ``path_topk`` paths from h_index to t_index with the largest mean
    edge gradient, with their means: a beam of ``num_beam`` per node, the
    reference's semantics (model.py:416-470 of the NBFNet reference). Per
    layer every edge extends its source's beam by its own gradient; equal
    distances in one beam keep their first slot; each node keeps its
    ``num_beam`` best candidates (variadic_topk); no path leaves the
    target. O(E * num_beam) tensor work a layer on the graph's device; the
    paths are traced back on the host."""
    device = graph_und.device
    num_nodes = graph_und.num_nodes
    neg = -math.inf
    # edges sorted by destination: each node's candidates are contiguous
    el = graph_und.edge_list
    order = torch.argsort(el[:, 1], stable=True)
    el_s = el[order]
    src_s = el_s[:, 0]
    sizes = torch.bincount(el_s[:, 1], minlength=num_nodes) * num_beam
    leaves_target = (src_s == t_index)[:, None]
    first_slot = torch.ones((el_s.shape[0], 1), dtype=torch.bool,
                            device=device)
    dist = torch.full((num_nodes, num_beam), neg, device=device)
    dist[h_index, 0] = 0.0
    distances, back_edges = [], []
    for grad in edge_grads:
        grad = torch.as_tensor(grad, device=device)[order]
        cand = (dist[src_s] + grad[:, None]).masked_fill(leaves_target, neg)
        # a beam is sorted descending, so equal distances are adjacent
        first = torch.cat([first_slot, cand[:, 1:] != cand[:, :-1]], dim=1)
        cand = torch.where(first, cand, neg)
        dist, idx = variadic_topk(cand.reshape(-1), sizes, num_beam)
        dist = torch.where(sizes[:, None] > 0, dist, neg)  # isolated nodes
        e, b = idx // num_beam, idx % num_beam
        back = torch.cat([el_s[e], b[..., None]], dim=-1)  # (h, t, r, slot)
        back = torch.where(torch.isfinite(dist)[..., None], back, -1)
        distances.append(dist.cpu().numpy())
        back_edges.append(back.cpu().numpy())

    paths, mean_grads = [], []
    for i in range(len(edge_grads)):
        for b in np.argsort(-distances[i][t_index])[:path_topk]:
            d = distances[i][t_index, b]
            if d == neg:
                break
            u, v, r, prev = back_edges[i][t_index, b]
            path = [(int(u), int(v), int(r))]
            for j in range(i - 1, -1, -1):
                u, v, r, prev = back_edges[j][u, prev]
                path.append((int(u), int(v), int(r)))
            paths.append(path[::-1])
            mean_grads.append(float(d) / len(path))
    if paths:
        pairs = sorted(zip(mean_grads, paths), key=lambda p: -p[0])[:path_topk]
        mean_grads, paths = [p[0] for p in pairs], [p[1] for p in pairs]
    return paths, mean_grads


def visualize(model: ClassicNBFNet, graph, h_index: int, t_index: int,
              r_index: int, num_beam: int = 10, path_topk: int = 10):
    """The top paths of the query (h, r, t) over ``graph`` (directed; its
    undirected+inverse graph is built here): ``edge_gradients``, then
    ``beam_search_paths``."""
    graph_und = graph.undirected_with_inverse()
    grads = edge_gradients(model, graph_und, h_index, t_index, r_index)
    return beam_search_paths(graph_und, grads, h_index, t_index, num_beam,
                             path_topk)

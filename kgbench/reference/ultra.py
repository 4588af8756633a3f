"""ULTRA (Galkin et al., arXiv 2310.04562) as its equations state it, in
plain PyTorch: a relation tower (NBFNet over the relation graph, learned
embeddings of its four edge types, an all-ones query at the query relation)
whose output is injected, through a per-layer 2-layer projection, into the
entity tower (NBFNet over the fact graph with inverse edges, the query
relation's representation at the source entity), then an MLP over
[state ; query] for every candidate. Every conv: distmult messages, sum
aggregation with the boundary as one more message, a linear layer over
[state ; aggregate], layer norm, ReLU and a short-cut.

Parameters carry the names of the published model's state dict.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import common
from .common import Edges, Precision


def param_specs(cfg: dict, num_relations: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter: init "uniform" (±1/√fan_in
    with the fan-in of the layer's weight), "normal", "ones" or "zeros"."""
    D = cfg["input_dim"]
    specs = []

    def linear(name, out_dim, in_dim):
        specs.append((f"{name}.weight", (out_dim, in_dim), "uniform"))
        specs.append((f"{name}.bias", (out_dim,), "uniform"))

    def norm(name, dim):
        specs.append((f"{name}.weight", (dim,), "ones"))
        specs.append((f"{name}.bias", (dim,), "zeros"))

    for i in range(len(cfg["hidden_dims"])):
        p = f"model.layers.{i}"
        linear(f"{p}.linear", D, 2 * D)
        norm(f"{p}.layer_norm", D)
        linear(f"{p}.relation_projection.layers.0", D, D)
        linear(f"{p}.relation_projection.layers.1", D, D)
    linear("model.mlp.layers.0", 2 * D, 2 * D)
    linear("model.mlp.layers.1", 1, 2 * D)
    for i in range(cfg["rel_model"]["num_layers"]):
        p = f"rel_models.0.model.layers.{i}"
        linear(f"{p}.linear", D, 2 * D)
        norm(f"{p}.layer_norm", D)
        specs.append((f"{p}.relation.weight", (4, D), "normal"))
    return specs


class Ultra:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 num_relations: int, prec: Precision):
        self.p, self.cfg, self.prec = prec.cast(params), cfg, prec
        self.R = num_relations
        self.layers = len(cfg["hidden_dims"])
        self.rel_layers = cfg["rel_model"]["num_layers"]

    def _conv_update(self, prefix, x, agg):
        p, prec = self.p, self.prec
        h = prec.linear(torch.cat([x, agg], -1), p[f"{prefix}.linear.weight"],
                        p[f"{prefix}.linear.bias"])
        h = common.layer_norm(h, p[f"{prefix}.layer_norm.weight"],
                              p[f"{prefix}.layer_norm.bias"])
        return torch.relu(h) + x

    def relation_tower(self, adjacency, query_rels):
        """[B, 2R, D] relation representations conditioned on each query
        relation, over the dense relation graph ``adjacency`` [4, 2R, 2R]."""
        B, D = query_rels.shape[0], self.cfg["input_dim"]
        N = adjacency.shape[1]
        ones = torch.ones((B, D), dtype=self.prec.dtype,
                          device=query_rels.device)
        bnd = common.boundary(N, query_rels, ones)
        x = bnd
        for i in range(self.rel_layers):
            prefix = f"rel_models.0.model.layers.{i}"
            rel = self.p[f"{prefix}.relation.weight"]  # [4, D]
            agg = bnd
            for k in range(adjacency.shape[0]):
                spread = self.prec.mm(adjacency[k].to(x.dtype),
                                      x.reshape(N, -1))
                agg = agg + spread.reshape(N, B, D) * rel[k]
            x = self._conv_update(prefix, x, agg)
        return x.transpose(0, 1)

    def entity_states(self, edges: Edges, rel_q, source, query_rel):
        """(final states [V, B, D], queries [B, D]) from ``source`` [B] under
        ``query_rel`` [B], with the relation tower's ``rel_q`` [B, 2R, D]."""
        edges = self.prec.edges(edges)
        B = source.shape[0]
        query = rel_q[torch.arange(B, device=source.device), query_rel]
        bnd = common.boundary(edges.num_nodes, source, query)
        x = bnd
        for i in range(self.layers):
            prefix = f"model.layers.{i}"
            rel = self.prec.mlp(rel_q, self.p,
                                f"{prefix}.relation_projection.layers.", 2)
            agg = common.edge_sum(edges, x, rel.transpose(0, 1)) + bnd
            x = self._conv_update(prefix, x, agg)
        return x, query

    def head(self, final, query, targets=None):
        """The MLP over [state ; query]: [B, V], or [B, T] at ``targets``."""
        if targets is None:
            V = final.shape[0]
            feat = torch.cat([final, query[None].expand(V, -1, -1)], -1)
            return self.prec.mlp(feat, self.p, "model.mlp.layers.", 2)[..., 0].t()
        B = query.shape[0]
        rows = final[targets, torch.arange(B, device=targets.device)[:, None]]
        feat = torch.cat([rows, query[:, None].expand_as(rows)], -1)
        return self.prec.mlp(feat, self.p, "model.mlp.layers.", 2)[..., 0]

    def train_scores(self, edges: Edges, adjacency, pos_r, h, t, r):
        """[b, 1 + N] scores of tail-form candidate rows (h, t, r); the
        relation tower is conditioned on the rows' own query relations
        ``pos_r``."""
        rel_q = self.relation_tower(adjacency, pos_r)
        final, query = self.entity_states(edges, rel_q, h[:, 0], r[:, 0])
        return self.head(final, query, t)

    def eval_scores(self, edges: Edges, adjacency, batch):
        """(tail scores [B, V], head scores [B, V]) of test triples."""
        h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
        rel_q = self.relation_tower(adjacency, r)
        return (self.head(*self.entity_states(edges, rel_q, h, r)),
                self.head(*self.entity_states(edges, rel_q, t, r + self.R)))

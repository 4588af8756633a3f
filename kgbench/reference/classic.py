"""Classic NBFNet (Zhu et al., arXiv 2106.06935) as its equations state it,
in plain PyTorch: a learned query embedding of each relation and its
inverse at the source entity; per layer, relation vectors projected from
the query ("dependent"), distmult messages over the fact edges and their
inverses, PNA's aggregation (mean, max, min and standard deviation of the
messages with the boundary as one more message, each times the degree
scalers 1, s and 1/s, s = log(degree + 1) over its mean over the graph),
a linear layer over [state ; aggregate], layer norm, ReLU and a short-cut;
then an MLP over [state ; query] for every candidate.

Parameters carry the names of the published model's state dict.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import common
from .common import Edges, Precision


def param_specs(cfg: dict, num_relations: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, as ``ultra.param_specs``."""
    D = cfg["input_dim"]
    R2 = 2 * num_relations
    specs = []

    def linear(name, out_dim, in_dim):
        specs.append((f"{name}.weight", (out_dim, in_dim), "uniform"))
        specs.append((f"{name}.bias", (out_dim,), "uniform"))

    for i in range(len(cfg["hidden_dims"])):
        linear(f"layers.{i}.linear", D, 13 * D)
        specs.append((f"layers.{i}.layer_norm.weight", (D,), "ones"))
        specs.append((f"layers.{i}.layer_norm.bias", (D,), "zeros"))
        linear(f"layers.{i}.relation_linear", R2 * D, D)
    linear("mlp.layers.0", 2 * D, 2 * D)
    linear("mlp.layers.1", 1, 2 * D)
    specs.append(("query.weight", (R2, D), "normal"))
    return specs


def pna_scalers(degree):
    """[V, 3]: 1, s and 1/s with s = log(degree) over its mean over the
    graph (1/s with s clipped at 0.01)."""
    s = torch.log(degree)
    s = s / s.mean()
    return torch.stack([torch.ones_like(s), s, 1.0 / s.clamp(min=1e-2)], -1)


class ClassicNBFNet:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 num_relations: int, prec: Precision):
        self.p, self.cfg, self.prec = prec.cast(params), cfg, prec
        self.R = num_relations
        self.layers = len(cfg["hidden_dims"])

    def states(self, edges: Edges, source, query_rel):
        """(final states [V, B, D], queries [B, D])."""
        p, prec = self.p, self.prec
        edges = prec.edges(edges)
        B, D = source.shape[0], self.cfg["input_dim"]
        query = p["query.weight"][query_rel]
        bnd = common.boundary(edges.num_nodes, source, query)
        degree = edges.in_degree() + 1.0
        scalers = pna_scalers(degree)[:, None, None, None, :]
        degree = degree[:, None, None]
        x = bnd
        for i in range(self.layers):
            rel = prec.linear(query, p[f"layers.{i}.relation_linear.weight"],
                              p[f"layers.{i}.relation_linear.bias"])
            rel = rel.reshape(B, 2 * self.R, D).transpose(0, 1)
            s, sq, mx, mn = common.edge_stats(edges, x, rel)
            mean = (s + bnd) / degree
            sq_mean = (sq + bnd * bnd) / degree
            std = torch.sqrt(torch.clamp(sq_mean - mean * mean,
                                         min=common.PNA_STD_EPS))
            stats = torch.stack([mean, torch.maximum(mx, bnd),
                                 torch.minimum(mn, bnd), std], -1)
            agg = (stats[..., None] * scalers).reshape(*x.shape[:2], 12 * D)
            h = prec.linear(torch.cat([x, agg], -1),
                            p[f"layers.{i}.linear.weight"],
                            p[f"layers.{i}.linear.bias"])
            h = common.layer_norm(h, p[f"layers.{i}.layer_norm.weight"],
                                  p[f"layers.{i}.layer_norm.bias"])
            x = torch.relu(h) + x
        return x, query

    def head(self, final, query, targets=None):
        if targets is None:
            V = final.shape[0]
            feat = torch.cat([final, query[None].expand(V, -1, -1)], -1)
            return self.prec.mlp(feat, self.p, "mlp.layers.", 2)[..., 0].t()
        B = query.shape[0]
        rows = final[targets, torch.arange(B, device=targets.device)[:, None]]
        feat = torch.cat([rows, query[:, None].expand_as(rows)], -1)
        return self.prec.mlp(feat, self.p, "mlp.layers.", 2)[..., 0]

    def train_scores(self, edges: Edges, adjacency, pos_r, h, t, r):
        """[b, 1 + N] scores of tail-form candidate rows (the relation graph
        and the rows' own relations play no part)."""
        return self.head(*self.states(edges, h[:, 0], r[:, 0]), t)

    def eval_scores(self, edges: Edges, adjacency, batch):
        h, t, r = batch[:, 0], batch[:, 1], batch[:, 2]
        return (self.head(*self.states(edges, h, r)),
                self.head(*self.states(edges, t, r + self.R)))

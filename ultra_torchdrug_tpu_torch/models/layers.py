"""Generalized relational message-passing layer (counterpart of
ultra_torchdrug_tpu/models/layers.py), the NBFNet conv.

One layer covers the three relation-parameterization modes:

  * "embedding":  learned per-relation vectors (``relation``)
  * "dependent":  relations projected from the query (``relation_linear``)
  * "injected":   relation vectors supplied by the caller, optionally passed
                  through a per-layer 2-layer MLP (``relation_projection``)

Messages: distmult, transe and rotate. Aggregations: sum (the architecture
of every shipped ULTRA config), mean, max and pna (classic NBFNet's
default), each also as ``*_nobound``; the boundary condition is folded into
the aggregation as in the JAX package. Sum and mean take the sum rspmm
(kernel K1, its backward K2 or K3), or the dense per-relation matmuls on a
graph that carries a dense adjacency; max takes the sparse extremum (K4, its
backward K5) on every graph, as the JAX package does. PNA takes the fused
pairs of ops/rspmm.py (max+min for both messages, sum+sum of squares for
distmult; transe's second moment sums rel² + x², which does not factor
through the message, so it keeps two sum calls). Rotate routes as the JAX
package's ``_spmm_raw`` does and never takes the dense route: its sums run
K8f (backward K8b); its max, min and PNA's second moment take the O(E)
route of ``rotate_aggregate``. ``compute_dtype="bfloat16"`` routes as
the JAX package's ``_spmm_raw`` and ``spmm_addsq`` do: the sparse distmult
and transe sums take K1h (backward K2h, transe K3); the dense route, max,
min and rotate stay fp32; distmult PNA leaves the fused moments pair (fp32
only) for two K1h sums, (rel, x) and (rel², x²), and keeps K6 for max and
min. Node states are carried flat, [V, B*D] with b-major features, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import MLP, layer_norm
from ..ops.dense import dense_rspmm
from ..ops.rspmm import (
    broadcast_rel_flat,
    generalized_rspmm,
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
    rotate_aggregate,
)

_MESSAGES = {"distmult": "mul", "transe": "add", "rotate": "rotate"}
_AGGREGATIONS = tuple(f"{base}{bound}" for base in ("sum", "mean", "max", "pna")
                      for bound in ("", "_nobound"))
EPS = 1e-6


def sparse_only(aggregate_func: str, message_func: str = "distmult") -> bool:
    """Whether the conv takes the sparse ops on every graph (max and pna,
    ± ``_nobound``, and every rotate aggregation): its graph needs a CSR
    even where it carries a dense adjacency, which only distmult and transe
    sum and mean use."""
    return (aggregate_func.replace("_nobound", "") in ("max", "pna")
            or message_func == "rotate")


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    input_dim: int
    output_dim: int
    num_relations: int
    query_input_dim: int
    message_func: str = "distmult"  # distmult | transe | rotate
    aggregate_func: str = "sum"  # sum | mean | max | pna, each + _nobound
    layer_norm: bool = False
    rel_mode: str = "injected"  # embedding | dependent | injected
    project: bool = True  # injected mode: per-layer MLP on relation vectors
    compute_dtype: str = "float32"  # bfloat16: bf16 operands, fp32 sums


class GeneralizedRelationalConv(nn.Module):
    def __init__(self, cfg: ConvConfig):
        super().__init__()
        if cfg.message_func not in _MESSAGES:
            raise ValueError(
                f"message_func={cfg.message_func!r}: one of "
                f"{', '.join(_MESSAGES)}")
        if cfg.aggregate_func not in _AGGREGATIONS:
            raise ValueError(
                f"aggregate_func={cfg.aggregate_func!r}: one of "
                f"{', '.join(_AGGREGATIONS)}")
        self.cfg = cfg
        # [x; update] -> output: the pna update is 4 statistics x 3 degree
        # scalers wide
        in_mult = 13 if cfg.aggregate_func.startswith("pna") else 2
        self.linear = nn.Linear(cfg.input_dim * in_mult, cfg.output_dim)
        if cfg.layer_norm:
            self.layer_norm = nn.LayerNorm(cfg.output_dim)
        if cfg.rel_mode == "embedding":
            self.relation = nn.Embedding(cfg.num_relations, cfg.input_dim)
        elif cfg.rel_mode == "dependent":
            self.relation_linear = nn.Linear(
                cfg.query_input_dim, cfg.num_relations * cfg.input_dim)
        elif cfg.rel_mode == "injected":
            if cfg.project:
                self.relation_projection = MLP(
                    cfg.query_input_dim, [cfg.input_dim, cfg.input_dim])
        else:
            raise ValueError(f"unknown rel_mode {cfg.rel_mode!r}")

    def forward(self, graph, x, boundary, query=None, rel_injected=None):
        return conv_apply(self, graph, x, boundary, query, rel_injected)


def _relation_input(layer: GeneralizedRelationalConv, query, rel_injected):
    """Per-relation vectors: [R, D] (shared) or [R, B, D] (per batch)."""
    cfg = layer.cfg
    if cfg.rel_mode == "embedding":
        return layer.relation.weight  # [R, D]
    if cfg.rel_mode == "dependent":
        # query: [B, Q] -> [B, R, D] -> [R, B, D]
        rel = layer.relation_linear(query)
        rel = rel.reshape(query.shape[0], cfg.num_relations, cfg.input_dim)
        return rel.transpose(0, 1)
    rel = rel_injected  # [R, D] or [B, R, D]
    if cfg.project:
        rel = layer.relation_projection(rel)
    if rel.dim() == 3:  # [B, R, D] -> [R, B, D]
        rel = rel.transpose(0, 1)
    return rel


def conv_apply(layer: GeneralizedRelationalConv, graph, x: torch.Tensor,
               boundary: torch.Tensor, query: Optional[torch.Tensor] = None,
               rel_injected: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One message-passing step.

    graph: data.Graph (undirected+inverse where applicable), carrying a CSR
      for the sparse route on the card (and for max, pna and rotate on both
      devices) or a dense adjacency for the dense one
    x, boundary: flat [V, B*D] node states (or [V, B, D]; the output then
      comes back [V, B, output_dim])
    query: [B, Q] ("dependent" mode); rel_injected: [R, D] or [B, R, D]
      ("injected" mode)
    Returns flat [V, B*output_dim] (or [V, B, output_dim] for 3-D input).
    """
    cfg = layer.cfg
    rel = _relation_input(layer, query, rel_injected)
    D = cfg.input_dim
    flat_in = x.dim() == 2
    V = x.shape[0]
    B = x.shape[1] // D if flat_in else x.shape[1]
    x = x if flat_in else x.reshape(V, B * D)
    boundary = boundary if boundary.dim() == 2 else boundary.reshape(V, -1)

    msg = _MESSAGES[cfg.message_func]
    rel_flat = broadcast_rel_flat(rel, B)
    base = cfg.aggregate_func.replace("_nobound", "")
    bounded = not cfg.aggregate_func.endswith("_nobound")
    if base == "pna":
        update = _pna_update(cfg, graph, rel_flat, x, boundary, msg)
    elif base == "max":
        # never the dense route: a max does not decompose into matmuls
        update = _spmm(graph, rel_flat, x, msg, "max", D, cfg.compute_dtype)
        if bounded:
            # torch.maximum splits the gradient at ties, as jnp.maximum does
            update = torch.maximum(update, boundary)
    else:  # sum, mean
        if graph.dense_adj is not None and msg != "rotate":
            # small dense graph (the ULTRA relation graph): per-etype matmuls
            update = dense_rspmm(graph.dense_adj, rel_flat, x, msg=msg)
        else:
            update = _spmm(graph, rel_flat, x, msg, "add", D,
                           cfg.compute_dtype)
        if bounded:
            update = update + boundary
        if base == "mean":
            update = update / (graph.degree_out() + 1.0)[:, None]

    # cat([x, update]) @ W^T split into x @ W[:, :D]^T + update @ W[:, D:]^T:
    # the same math without materializing the [V, B, 2D] concat
    w = layer.linear.weight  # [out, 2D]
    out = (torch.matmul(x.reshape(V, B, D), w[:, :D].T)
           + torch.matmul(update.reshape(V, B, -1), w[:, D:].T)
           + layer.linear.bias)
    if cfg.layer_norm:
        out = layer_norm(layer.layer_norm, out)
    out = F.relu(out)
    return out.reshape(V, -1) if flat_in else out


def _spmm(graph, rel_flat, x, msg, agg, dim, compute_dtype="float32"):
    """The sparse rspmm over flat [V, B*dim] states (``compute_dtype``
    reaches generalized_rspmm, which applies it to the distmult and transe
    sums only). Rotate, as the JAX package's ``_spmm_raw`` routes it, works
    on the [V, B, dim] form in fp32: its sum through generalized_rspmm (K8f
    forward, K8b backward on CUDA tensors), max, min and sq_add (Σ w·m²,
    PNA's second moment) the O(E) route."""
    edges = (graph.edge_index, graph.edge_type, graph.edge_weight)
    if msg != "rotate":
        return generalized_rspmm(*edges, rel_flat, x, msg=msg, agg=agg,
                                 num_nodes=graph.num_nodes, csr=graph.csr,
                                 compute_dtype=compute_dtype)
    B = x.shape[1] // dim
    rel, x = rel_flat.reshape(-1, B, dim), x.reshape(x.shape[0], B, dim)
    if agg == "sq_add":
        out = rotate_aggregate(*edges, rel, x, agg, graph.num_nodes)
    else:
        out = generalized_rspmm(*edges, rel, x, msg=msg, agg=agg,
                                num_nodes=graph.num_nodes, csr=graph.csr)
    return out.reshape(graph.num_nodes, -1)


def pna_moments(cfg: ConvConfig, graph, rel_flat, x, boundary, msg):
    """(mean, sq_mean, degree [V, 1]) of each node's in-edge messages, the
    boundary counting as one more message unless ``pna_nobound``; degree is
    the weighted in-degree plus one."""
    D, dtype = cfg.input_dim, cfg.compute_dtype
    if msg == "mul" and dtype == "float32":
        s, sq = generalized_rspmm_addsq(
            graph.edge_index, graph.edge_type, graph.edge_weight, rel_flat, x,
            num_nodes=graph.num_nodes, csr=graph.csr)
    else:
        # the fused moments pair is fp32 only: bf16 distmult takes two sums
        s = _spmm(graph, rel_flat, x, msg, "add", D, dtype)
        # rotate sums the squared message; distmult and transe sum rel² and
        # x² (transe's convention, which does not factor through the
        # message; for distmult the same sum as the squared message)
        sq = (_spmm(graph, rel_flat, x, msg, "sq_add", D) if msg == "rotate"
              else _spmm(graph, rel_flat ** 2, x ** 2, msg, "add", D, dtype))
    degree = (graph.degree_out() + 1.0)[:, None]
    if cfg.aggregate_func == "pna":
        return (s + boundary) / degree, (sq + boundary ** 2) / degree, degree
    return s / degree, sq / degree, degree


def _pna_update(cfg: ConvConfig, graph, rel_flat, x, boundary, msg):
    """PNA's update [V, B*12D]: per (b, d) the interleaved [mean, max, min,
    std] of the in-edge messages (with the boundary as one more message
    unless ``pna_nobound``), each times the degree scalers [1, s, 1/s],
    s = log(degree) normalised by its mean over the nodes."""
    V = x.shape[0]
    mean, sq_mean, degree = pna_moments(cfg, graph, rel_flat, x, boundary,
                                        msg)
    if msg == "rotate":  # no fused pair: two O(E) calls, as in JAX
        mx = _spmm(graph, rel_flat, x, msg, "max", cfg.input_dim)
        mn = _spmm(graph, rel_flat, x, msg, "min", cfg.input_dim)
    else:
        mx, mn = generalized_rspmm_maxmin(
            graph.edge_index, graph.edge_type, graph.edge_weight, rel_flat,
            x, msg=msg, num_nodes=graph.num_nodes, csr=graph.csr)
    if cfg.aggregate_func == "pna":
        # torch.maximum/minimum split the gradient at ties, as jnp's do
        mx = torch.maximum(mx, boundary)
        mn = torch.minimum(mn, boundary)
    std = torch.sqrt(torch.clamp(sq_mean - mean ** 2, min=EPS))
    features = torch.stack([mean, mx, mn, std], dim=-1)  # [V, B*D, 4]
    scale = torch.log(degree)
    scale = scale / (scale.sum() / graph.num_nodes)
    inv = 1.0 / torch.clamp(scale, min=1e-2)
    scales = torch.cat([torch.ones_like(scale), scale, inv], dim=-1)  # [V, 3]
    return (features[:, :, :, None] * scales[:, None, None, :]).reshape(V, -1)

"""Bellman-Ford style NBFNet towers (counterpart of
ultra_torchdrug_tpu/models/nbfnet.py).

  * relation tower (RelNBFNet): query-conditioned GNN over the relation
    graph; boundary = one-hot at the query relation with an all-ones query,
    learned 4-type relation embeddings, sum aggregation, layer norm,
    short-cut. Output [B, 2R, D].
  * entity tower (TransferNBFNet): GNN over the entity graph with injected
    relation representations; boundary = query vector at the source entity;
    final [state ; query] -> MLP -> one score per entity.

Propagation state is carried flat, [V, B*D] with b-major features.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.core import MLP
from ..ops.rspmm import COMPUTE_DTYPES
from ..utils.logging import LOGGER_NAME
from .layers import ConvConfig, GeneralizedRelationalConv


@dataclasses.dataclass(frozen=True)
class NBFNetConfig:
    input_dim: int
    hidden_dims: Sequence[int]
    num_relations: int  # relation vocabulary of the propagation graph
    message_func: str = "distmult"
    aggregate_func: str = "sum"
    short_cut: bool = True
    layer_norm: bool = True
    num_mlp_layer: int = 2
    rel_mode: str = "injected"
    project: bool = True
    compute_dtype: str = "float32"  # bfloat16: K1h/K2h on the sparse sums

    def layer_configs(self):
        dims = [self.input_dim] + list(self.hidden_dims)
        return [
            ConvConfig(
                input_dim=dims[i],
                output_dim=dims[i + 1],
                num_relations=self.num_relations,
                query_input_dim=self.input_dim,
                message_func=self.message_func,
                aggregate_func=self.aggregate_func,
                layer_norm=self.layer_norm,
                rel_mode=self.rel_mode,
                project=self.project,
                compute_dtype=self.compute_dtype,
            )
            for i in range(len(dims) - 1)
        ]


# the JAX package's config options that change no result: the port runs
# every layer stack eagerly with all activations kept (recomputation,
# batch and scoring chunks are ROADMAP item 5)
_MEMORY_ONLY = {"remat": (False, None, "none"), "stack": ("auto",),
                "micro_batch": (0,), "score_chunk": (0,)}
# options the port reproduces only at the value given, by the ROADMAP item
# that ports the others
_FIXED = {"concat_hidden": (False, "item 6"), "edge_axis": ("", "item 9"),
          "ring_exchange": ("ppermute", "item 9"),
          "learn_query": (False, "item 7")}


def _check_options(where: str, rspmm_impl: str, options: dict):
    """Apply the JAX package's config options that the port does not carry:
    the memory-only ones are logged as not applied, the fixed ones must
    have the value the port reproduces, and anything else raises."""
    if rspmm_impl not in ("auto", "pallas"):
        item = "item 9" if rspmm_impl == "ring" else "item 7"
        raise NotImplementedError(
            f"{where}: rspmm_impl={rspmm_impl!r} is not ported (ROADMAP Queue "
            f"1 {item}); 'auto' and 'pallas' take the port's kernels")
    for key, value in options.items():
        if key in _MEMORY_ONLY:
            if value not in _MEMORY_ONLY[key]:
                logging.getLogger(LOGGER_NAME).warning(
                    "%s: %s=%r changes memory use, not results, and is not "
                    "applied (ROADMAP Queue 1 item 5)", where, key, value)
        elif key in _FIXED:
            want, item = _FIXED[key]
            if value != want:
                raise NotImplementedError(
                    f"{where}: {key}={value!r} is not ported (ROADMAP Queue 1 "
                    f"{item}); the port runs {key}={want!r}")
        else:
            raise TypeError(f"{where}: unknown option {key!r}")


def _check_dtype(where: str, compute_dtype: str):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{where}: compute_dtype must be one of "
                         f"{COMPUTE_DTYPES}, got {compute_dtype!r}")


def rel_nbfnet_config(input_dim: int = 64, hidden: int = 64,
                      num_layers: int = 6, rspmm_impl: str = "auto",
                      compute_dtype: str = "float32",
                      **options) -> NBFNetConfig:
    """The fixed architecture RelNBFNet instantiates: distmult, sum
    aggregation, layer norm, short-cut, 4 relation types, learned relation
    embeddings. ``options`` are the JAX function's others (``edge_axis``,
    ``learn_query``, ``remat``, ``stack``, ``ring_exchange``), applied as
    ``_check_options`` says."""
    _check_options("rel_nbfnet_config", rspmm_impl, options)
    _check_dtype("rel_nbfnet_config", compute_dtype)
    return NBFNetConfig(
        input_dim=input_dim,
        hidden_dims=(hidden,) * num_layers,
        num_relations=4,
        message_func="distmult",
        aggregate_func="sum",
        short_cut=True,
        layer_norm=True,
        rel_mode="embedding",
        project=False,
        compute_dtype=compute_dtype,
    )


def entity_nbfnet_config(input_dim: int = 64,
                         hidden_dims: Sequence[int] = (64,) * 6,
                         num_relations: int = 1,
                         message_func: str = "distmult",
                         aggregate_func: str = "sum",
                         rspmm_impl: str = "auto", short_cut: bool = True,
                         layer_norm: bool = True, num_mlp_layer: int = 2,
                         project: bool = True, compute_dtype: str = "float32",
                         **options) -> NBFNetConfig:
    """The entity tower (TransferNBFNet) with injected relations. The JAX
    function's other options (``concat_hidden``, ``edge_axis``,
    ``ring_exchange``, ``remat``, ``stack``, ``micro_batch``,
    ``score_chunk``) are applied as ``_check_options`` says: the port
    raises on every option or value it does not honour."""
    _check_options("entity_nbfnet_config", rspmm_impl, options)
    _check_dtype("entity_nbfnet_config", compute_dtype)
    return NBFNetConfig(
        input_dim=input_dim,
        hidden_dims=tuple(hidden_dims),
        num_relations=num_relations,
        message_func=message_func,
        aggregate_func=aggregate_func,
        short_cut=short_cut,
        layer_norm=layer_norm,
        num_mlp_layer=num_mlp_layer,
        rel_mode="injected",
        project=project,
        compute_dtype=compute_dtype,
    )


class NBFNet(nn.Module):
    """A stack of conv layers; with ``scoring`` also the entity tower's
    scoring MLP over [state ; query]."""

    def __init__(self, cfg: NBFNetConfig, scoring: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            GeneralizedRelationalConv(c) for c in cfg.layer_configs())
        if scoring:
            feature_dim = cfg.hidden_dims[-1] + cfg.input_dim
            self.mlp = MLP(feature_dim,
                           [feature_dim] * (cfg.num_mlp_layer - 1) + [1])


class RelNBFNet(nn.Module):
    """The relation-graph model; its tower sits under ``model`` as in the
    reference's state dict (``rel_models.{t}.model.layers.{i}...``)."""

    def __init__(self, cfg: NBFNetConfig):
        super().__init__()
        self.model = NBFNet(cfg)

    def forward(self, rel_graph, query_rels):
        return rel_nbfnet_apply(self.model, rel_graph, query_rels)


def _propagate(tower: NBFNet, graph, boundary, query=None,
               rel_injected=None):
    """Run the conv stack from the boundary condition; returns the final flat
    [V, B*D] hidden state."""
    x = boundary
    for layer in tower.layers:
        h = layer(graph, x, boundary, query=query, rel_injected=rel_injected)
        if tower.cfg.short_cut and h.shape == x.shape:
            h = h + x
        x = h
    return x


def _flat_boundary(V, B, D, rows, query):
    """Flat [V, B*D] boundary with query[b] at (rows[b], b): row rows*B + b
    of a [V*B, D] view."""
    flat = torch.zeros((V * B, D), dtype=query.dtype, device=query.device)
    idx = rows * B + torch.arange(B, device=rows.device)
    return flat.index_add_(0, idx, query).reshape(V, B * D)


def rel_nbfnet_apply(tower: NBFNet, rel_graph, query_rels) -> torch.Tensor:
    """query_rels: int [B]. Returns [B, num_rel_nodes, D] conditional
    relation representations."""
    B = query_rels.shape[0]
    D = tower.cfg.input_dim
    V = rel_graph.num_nodes
    query = torch.ones((B, D), dtype=torch.float32, device=query_rels.device)
    boundary = _flat_boundary(V, B, D, query_rels, query)
    out = _propagate(tower, rel_graph, boundary)
    return out.reshape(V, B, -1).transpose(0, 1)  # [B, V(=2R), D]


def entity_nbfnet_score_all(tower: NBFNet, graph, rel_queries,
                            source: torch.Tensor, query_rel: torch.Tensor,
                            targets: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Score entities as the target of (source[b], query_rel[b], ?).

    graph: undirected+inverse entity graph (2R relation types)
    rel_queries: [B, 2R, D] per-query relation representations
    source: int [B]; query_rel: int [B] in [0, 2R)
    targets: optional int [B, T] candidates; the head then runs on those
      rows only
    Returns [B, V] scores, or [B, T] with targets.
    """
    B = source.shape[0]
    query = rel_queries[torch.arange(B, device=source.device), query_rel]
    V = graph.num_nodes
    boundary = _flat_boundary(V, B, tower.cfg.input_dim, source, query)
    final = _propagate(tower, graph, boundary, rel_injected=rel_queries)
    return score_heads(tower.mlp, final, query, targets)


def score_heads(mlp: MLP, final, query, targets=None):
    """The [state ; query] MLP head over a flat final state [V, B*feat]
    with query [B, D]: [B, V] scores, or [B, T] for the candidates
    ``targets`` [B, T] only (the head then runs on those rows alone)."""
    B, V = query.shape[0], final.shape[0]
    if targets is not None:
        # flat [V, B*feat] viewed [V*B, feat]: row v*B + b is state(v, b),
        # so the (b, t) rows are targets*B + b
        feat = final.shape[1] // B
        rows = targets * B + torch.arange(B, device=targets.device)[:, None]
        feats = final.reshape(V * B, feat)[rows]  # [B, T, feat]
        return _mlp_head_targets(mlp, feats, query)
    return _mlp_head_split(mlp, final.reshape(V, B, -1), query)[..., 0].T


def _mlp_head_split(mlp: MLP, final, query):
    """mlp(cat([final, broadcast(query)], -1)) without materializing the
    concat: the first layer's weight is split into its state columns
    ``w0[:, :-dq]`` and its query columns ``w0[:, -dq:]`` (the MLP input is
    ordered [state; query])."""
    first = mlp.layers[0]
    w0 = first.weight  # [H, feat + dq]
    dq = query.shape[-1]
    h = (torch.matmul(final, w0[:, :-dq].T)
         + torch.matmul(query, w0[:, -dq:].T)[None]
         + first.bias)
    for layer in mlp.layers[1:]:
        h = layer(torch.relu(h))
    return h


def _mlp_head_targets(mlp: MLP, feats, query):
    """The target-gathered head: feats [B, T, feat], query [B, D] -> [B, T].
    The split-weight formulation of _mlp_head_split, with the query term
    broadcast over T."""
    first = mlp.layers[0]
    w0 = first.weight
    dq = query.shape[-1]
    h = (torch.matmul(feats, w0[:, :-dq].T)
         + torch.matmul(query, w0[:, -dq:].T)[:, None, :]
         + first.bias)
    for layer in mlp.layers[1:]:
        h = layer(torch.relu(h))
    return h[..., 0]

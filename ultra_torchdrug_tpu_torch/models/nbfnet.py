"""Bellman-Ford style NBFNet towers (counterpart of
ultra_torchdrug_tpu/models/nbfnet.py).

  * relation tower (RelNBFNet): query-conditioned GNN over the relation
    graph; boundary = one-hot at the query relation with an all-ones query
    (or, with ``learn_query``, a learned vector), learned 4-type relation
    embeddings, sum aggregation, layer norm, short-cut. Output [B, 2R, D];
    the shared variant (the reference's CustomNBFNet,
    ``rel_nbfnet_apply_shared``) marks every query relation of the batch
    in one channel and gives one [2R, D] for the batch.
  * entity tower (TransferNBFNet): GNN over the entity graph with injected
    relation representations, one for every layer or one per layer (several
    relation towers); boundary = query vector at the source entity; final
    [state ; query] -> MLP -> one score per entity.

Propagation state is carried flat, [V, B*D] with b-major features. Under
an active edge mesh with ring buckets on the entity graph
(``layers.ring_block_domain``), the entity tower carries it in the ring's
padded block domain, [n * v_block, B*D] rows relabelled when degree-
balanced: only the boundary scatter and the readout map indices.

Memory policies, applied while gradients are taken (none of them changes a
result; a task resolves their "auto" values, tasks/task.py):

  * ``remat``: False / "none" keeps every activation; True / "full"
    checkpoints each layer (torch.utils.checkpoint, non-reentrant: the
    backward re-runs the layer's aggregation kernel); "save_rspmm" keeps
    each aggregation's output and checkpoints only the layer's update
    (layers.conv_update), so the backward re-runs no kernel. An unresolved
    "auto" acts as "full", as in the JAX package. Skipped under
    ``edge_grad`` and for distinct per-layer injections (the JAX package
    runs those in a loop without remat).
  * ``micro_batch``: the entity tower scores the batch in chunks of that
    many queries, each chunk under one checkpoint, so that one chunk's
    propagation is alive at a time.
  * ``score_chunk``: the all-entity scoring head runs over that many entity
    rows at a time.
  * ``stack``: the JAX package's choice between lax.scan and an unrolled
    layer loop; the port runs its layers in a Python loop whatever it says.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.core import MLP
from ..ops.rspmm import COMPUTE_DTYPES
from .layers import (
    ConvConfig,
    GeneralizedRelationalConv,
    conv_aggregate,
    conv_update,
    ring_block_domain,
)


@dataclasses.dataclass(frozen=True)
class NBFNetConfig:
    input_dim: int
    hidden_dims: Sequence[int]
    num_relations: int  # relation vocabulary of the propagation graph
    message_func: str = "distmult"
    aggregate_func: str = "sum"
    short_cut: bool = True
    layer_norm: bool = True
    activation: Optional[str] = "relu"  # layers.ACTIVATIONS, or none
    num_mlp_layer: int = 2
    rel_mode: str = "injected"
    project: bool = True
    compute_dtype: str = "float32"  # bfloat16: K1h/K2h on the sparse sums
    # auto (the kernels) | xla (the O(E) route) | ring (edge mesh only)
    rspmm_impl: str = "auto"
    edge_axis: str = ""  # the mesh axis of the edge partition ("" = off)
    ring_exchange: str = "ppermute"  # ppermute | rdma (kernel K9)
    learn_query: bool = False  # relation tower: a learned query vector
    # the final state is every layer's output side by side (the MLP head
    # widens to match)
    concat_hidden: bool = False
    # the memory policies of the module docstring
    remat: object = False  # False | "none" | True | "full" | "save_rspmm"
    stack: str = "auto"  # auto | scan | unroll: no effect in the port
    micro_batch: int = 0  # 0 = the whole batch at once
    score_chunk: int = 0  # 0 = every entity row at once

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
                activation=self.activation,
                rel_mode=self.rel_mode,
                project=self.project,
                compute_dtype=self.compute_dtype,
                rspmm_impl=self.rspmm_impl,
                edge_axis=self.edge_axis,
                ring_exchange=self.ring_exchange,
            )
            for i in range(len(dims) - 1)
        ]


RSPMM_IMPLS = ("auto", "pallas", "xla", "ring")
_EXCHANGES = ("ppermute", "rdma")
REMAT_VALUES = (False, True, None, "none", "full", "save_rspmm", "auto")
STACK_VALUES = ("auto", "scan", "unroll")


def remat_mode(remat) -> str:
    """How the layer stack applies a ``remat`` value: "none" (False, None,
    "none"), "save_rspmm", or "full" (True, "full", and an "auto" that no
    task resolved, as the JAX package's ``_maybe_remat`` reads it)."""
    if not remat or remat == "none":
        return "none"
    return "save_rspmm" if remat == "save_rspmm" else "full"


def _check_memory(where: str, remat, stack: str, micro_batch: int,
                  score_chunk: int):
    if remat not in REMAT_VALUES:
        raise ValueError(f"{where}: remat must be one of {REMAT_VALUES}, got "
                         f"{remat!r}")
    if stack not in STACK_VALUES:
        raise ValueError(f"{where}: stack must be one of {STACK_VALUES}, got "
                         f"{stack!r}")
    if micro_batch < 0 or score_chunk < 0:
        raise ValueError(f"{where}: micro_batch and score_chunk must be >= 0, "
                         f"got {micro_batch} and {score_chunk}")


def _check_options(where: str, rspmm_impl: str, options: dict) -> dict:
    """Apply the JAX package's edge-mesh options (``edge_axis``,
    ``ring_exchange``): checked and returned with ``rspmm_impl`` ("auto"
    for 'auto' and 'pallas', which both take the port's kernels, "xla" for
    the O(E) route, or "ring"); any other option raises."""
    if rspmm_impl not in RSPMM_IMPLS:
        raise ValueError(
            f"{where}: rspmm_impl must be one of {RSPMM_IMPLS}, got "
            f"{rspmm_impl!r}: 'auto' and 'pallas' take the port's kernels, "
            "'xla' the O(E) route, 'ring' the edge-partitioned ring under an "
            "edge mesh")
    edge_axis = options.pop("edge_axis", "")
    ring_exchange = options.pop("ring_exchange", "ppermute")
    if edge_axis not in ("", "edge"):
        raise ValueError(f"{where}: edge_axis must be '' or 'edge', got "
                         f"{edge_axis!r}")
    if ring_exchange not in _EXCHANGES:
        raise ValueError(f"{where}: ring_exchange must be one of "
                         f"{_EXCHANGES}, got {ring_exchange!r}")
    if edge_axis and rspmm_impl != "ring":
        raise NotImplementedError(
            f"{where}: edge_axis={edge_axis!r} with rspmm_impl="
            f"{rspmm_impl!r} selects the partitioned path "
            "(parallel/sharded_rspmm.py), which is not ported yet (ROADMAP "
            "Queue 1 item 9); rspmm_impl='ring' takes the ring")
    for key in options:
        raise TypeError(f"{where}: unknown option {key!r}")
    return dict(rspmm_impl="auto" if rspmm_impl == "pallas" else rspmm_impl,
                edge_axis=edge_axis, ring_exchange=ring_exchange)


def _check_dtype(where: str, compute_dtype: str):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{where}: compute_dtype must be one of "
                         f"{COMPUTE_DTYPES}, got {compute_dtype!r}")


def rel_nbfnet_config(input_dim: int = 64, hidden: int = 64,
                      num_layers: int = 6, rspmm_impl: str = "auto",
                      compute_dtype: str = "float32", remat=False,
                      stack: str = "auto", learn_query: bool = False,
                      **options) -> NBFNetConfig:
    """The fixed architecture RelNBFNet instantiates: distmult, sum
    aggregation, layer norm, short-cut, 4 relation types, learned relation
    embeddings; ``learn_query`` gives the tower a learned query vector.
    ``options`` are the JAX function's others (``edge_axis``,
    ``ring_exchange``), applied as ``_check_options`` says."""
    mesh_opts = _check_options("rel_nbfnet_config", rspmm_impl, options)
    _check_dtype("rel_nbfnet_config", compute_dtype)
    _check_memory("rel_nbfnet_config", remat, stack, 0, 0)
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
        remat=remat,
        stack=stack,
        learn_query=bool(learn_query),
        **mesh_opts,
    )


def entity_nbfnet_config(input_dim: int = 64,
                         hidden_dims: Sequence[int] = (64,) * 6,
                         num_relations: int = 1,
                         message_func: str = "distmult",
                         aggregate_func: str = "sum",
                         rspmm_impl: str = "auto", short_cut: bool = True,
                         layer_norm: bool = True, num_mlp_layer: int = 2,
                         project: bool = True, compute_dtype: str = "float32",
                         concat_hidden: bool = False, remat=False,
                         stack: str = "auto", micro_batch: int = 0,
                         score_chunk: int = 0, **options) -> NBFNetConfig:
    """The entity tower (TransferNBFNet) with injected relations. The JAX
    function's other options (``edge_axis``, ``ring_exchange``) are
    applied as ``_check_options`` says: the port raises on every option or
    value it does not honour."""
    mesh_opts = _check_options("entity_nbfnet_config", rspmm_impl, options)
    _check_dtype("entity_nbfnet_config", compute_dtype)
    _check_memory("entity_nbfnet_config", remat, stack, micro_batch,
                  score_chunk)
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
        concat_hidden=concat_hidden,
        remat=remat,
        stack=stack,
        micro_batch=int(micro_batch),
        score_chunk=int(score_chunk),
        **mesh_opts,
    )


class NBFNet(nn.Module):
    """A stack of conv layers; with ``scoring`` also the entity tower's
    scoring MLP over [state ; query]; with ``learn_query`` the relation
    tower's query vector (``learnable_q``, [1, D])."""

    def __init__(self, cfg: NBFNetConfig, scoring: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            GeneralizedRelationalConv(c) for c in cfg.layer_configs())
        if cfg.learn_query:
            self.learnable_q = nn.Embedding(1, cfg.input_dim)
        if scoring:
            layers = len(cfg.hidden_dims) if cfg.concat_hidden else 1
            feature_dim = cfg.hidden_dims[-1] * layers + cfg.input_dim
            self.mlp = MLP(feature_dim,
                           [feature_dim] * (cfg.num_mlp_layer - 1) + [1])


class RelNBFNet(nn.Module):
    """The relation-graph model; its tower sits under ``model`` as in the
    reference's state dict (``rel_models.{t}.model.layers.{i}...``)."""

    def __init__(self, cfg: NBFNetConfig):
        super().__init__()
        self.model = NBFNet(cfg)


def _propagate(tower: NBFNet, graph, boundary, query=None,
               rel_injected=None, block_domain=False, cfg=None,
               edge_grad=False):
    """Run the conv stack from the boundary condition; returns the final flat
    [V, B*D] hidden state (block-domain rows with ``block_domain``), or with
    ``concat_hidden`` every layer's state side by side per query,
    [V, B*(L*D)]. ``graph`` and ``rel_injected`` are each one for every
    layer, or a list of one per layer. ``cfg`` (the tower's own by default)
    gives the short-cut, the concat and the remat policy, which applies
    while gradients are taken, not under ``edge_grad`` and not for a list
    of distinct injections."""
    cfg = cfg or tower.cfg
    L = len(tower.layers)
    graphs = graph if isinstance(graph, (list, tuple)) else [graph] * L
    rels = (list(rel_injected) if isinstance(rel_injected, (list, tuple))
            else [rel_injected] * L)
    distinct = any(r is not rels[0] for r in rels[1:])
    mode = (remat_mode(cfg.remat)
            if torch.is_grad_enabled() and not edge_grad and not distinct
            else "none")
    hiddens = []
    x = boundary
    for layer, g, rel_injected in zip(tower.layers, graphs, rels):
        step = functools.partial(_layer_step, layer, cfg, g, boundary=boundary,
                                 query=query, rel_injected=rel_injected,
                                 block_domain=block_domain)
        if mode == "full":
            h = checkpoint(step, x, use_reentrant=False,
                           preserve_rng_state=False)
        elif mode == "save_rspmm":
            aggregates = conv_aggregate(layer, g, x, query, rel_injected,
                                        block_domain)
            h = checkpoint(step, x, *aggregates, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = step(x)
        hiddens.append(h)
        x = h
    if cfg.concat_hidden:
        # per query b the layers' features side by side: concat the
        # [V, B, *] views, then flatten back
        V, B = boundary.shape[0], boundary.shape[1] // cfg.input_dim
        return torch.cat([h.reshape(V, B, -1) for h in hiddens],
                         dim=-1).reshape(V, -1)
    return x


def _layer_step(layer, cfg, graph, x, *aggregates, boundary, query,
                rel_injected, block_domain):
    """One layer (a call of the module) and its short-cut; with
    ``aggregates`` (conv_aggregate's, computed outside a checkpoint) only
    the update."""
    if aggregates:
        h = conv_update(layer, graph, x, boundary, aggregates, block_domain)
    else:
        h = layer(graph, x, boundary, query=query, rel_injected=rel_injected,
                  block_domain=block_domain)
    if cfg.short_cut and h.shape == x.shape:
        h = h + x
    return h


def _flat_boundary(V, B, D, rows, query):
    """Flat [V, B*D] boundary with query[b] at (rows[b], b): row rows*B + b
    of a [V*B, D] view."""
    flat = torch.zeros((V * B, D), dtype=query.dtype, device=query.device)
    idx = rows * B + torch.arange(B, device=rows.device)
    return flat.index_add_(0, idx, query).reshape(V, B * D)


def rel_nbfnet_apply(tower: NBFNet, rel_graph, query_rels,
                     cfg=None) -> torch.Tensor:
    """query_rels: int [B]. Returns [B, num_rel_nodes, D] conditional
    relation representations: the query (all ones, or ``learnable_q``
    broadcast) at each query relation; ``cfg`` as for ``_propagate``."""
    B = query_rels.shape[0]
    D = tower.cfg.input_dim
    V = rel_graph.num_nodes
    if tower.cfg.learn_query:
        query = tower.learnable_q.weight.expand(B, D)
    else:
        query = torch.ones((B, D), dtype=torch.float32,
                           device=query_rels.device)
    boundary = _flat_boundary(V, B, D, query_rels, query)
    out = _propagate(tower, rel_graph, boundary, cfg=cfg)
    return out.reshape(V, B, -1).transpose(0, 1)  # [B, V(=2R), D]


def rel_nbfnet_apply_shared(tower: NBFNet, rel_graph, query_rels,
                            cfg=None) -> torch.Tensor:
    """The shared variant (the reference's CustomNBFNet): every query
    relation of the batch is set to 1 in one channel, so a relation that
    the batch repeats is still 1, and the output [num_rel_nodes, D] serves
    the whole batch; ``cfg`` as for ``_propagate``."""
    boundary = torch.zeros((rel_graph.num_nodes, tower.cfg.input_dim),
                           dtype=torch.float32, device=query_rels.device)
    boundary[query_rels] = 1.0
    return _propagate(tower, rel_graph, boundary, cfg=cfg)  # [V(=2R), D]


def entity_nbfnet_score_all(tower: NBFNet, graph, rel_queries,
                            source: torch.Tensor, query_rel: torch.Tensor,
                            targets: Optional[torch.Tensor] = None,
                            cfg: Optional[NBFNetConfig] = None
                            ) -> torch.Tensor:
    """Score entities as the target of (source[b], query_rel[b], ?).

    graph: undirected+inverse entity graph (2R relation types)
    rel_queries: [B, 2R, D] per-query relation representations, or [2R, D]
      shared by the batch, or a list of such tensors: one, injected into
      every layer, or num_layers + 1, element 0 giving the query and
      element i + 1 feeding layer i
    source: int [B]; query_rel: int [B] in [0, 2R)
    targets: optional int [B, T] candidates; the head then runs on those
      rows only
    cfg: the tower's config with the memory policies to apply (the tower's
      own by default): ``micro_batch``, ``score_chunk`` and, through
      ``_propagate``, ``remat``
    Returns [B, V] scores, or [B, T] with targets.
    """
    cfg = cfg or tower.cfg
    B = source.shape[0]
    listed = isinstance(rel_queries, (list, tuple))
    mb = cfg.micro_batch
    if mb and B > mb:
        if B % mb:
            raise ValueError(f"batch {B} is not divisible by micro_batch "
                             f"{mb}")
        chunk = functools.partial(entity_nbfnet_score_all, tower, graph,
                                  cfg=dataclasses.replace(cfg, micro_batch=0))
        grad = torch.is_grad_enabled()
        outs = []
        for lo in range(0, B, mb):
            part = slice(lo, lo + mb)
            # per-query relation representations are split with the batch,
            # shared [2R, D] ones are not (their gradients still flow
            # through the chunk's checkpoint)

            def split(r):
                return r[part] if r.dim() == 3 else r

            args = ([split(r) for r in rel_queries] if listed
                    else split(rel_queries), source[part], query_rel[part],
                    None if targets is None else targets[part])
            # checkpointed: the backward re-runs one chunk at a time, so
            # one chunk's propagation is alive at a time
            outs.append(checkpoint(chunk, *args, use_reentrant=False,
                                   preserve_rng_state=False)
                        if grad else chunk(*args))
        return torch.cat(outs)
    L = len(tower.layers)
    query_src, injected = rel_queries, rel_queries
    if listed:
        if len(rel_queries) not in (1, L + 1):
            raise ValueError(f"{len(rel_queries)} relation representations "
                             f"for {L} layers: give 1 or {L + 1}")
        query_src = rel_queries[0]
        injected = (list(rel_queries[1:]) if len(rel_queries) > 1
                    else rel_queries[0])
    if query_src.dim() == 3:
        query = query_src[torch.arange(B, device=source.device), query_rel]
    else:
        query = query_src[query_rel]
    V = graph.num_nodes
    # the ring's permuted IO: the propagation runs in the padded block
    # domain; the boundary goes to the relabelled source rows, and the
    # readout reads the relabelled target rows (or maps the score columns
    # back to entity order), never a pad row
    ring = ring_block_domain(tower.cfg.layer_configs()[0], graph)
    if ring is None:
        rows, to_new = V, None
    else:
        rows, to_new = ring.v_pad, ring.to_new
    boundary = _flat_boundary(rows, B, tower.cfg.input_dim,
                              source if to_new is None else to_new[source],
                              query)
    final = _propagate(tower, graph, boundary, rel_injected=injected,
                       block_domain=ring is not None, cfg=cfg)
    if targets is not None:
        return score_heads(tower.mlp, final, query,
                           targets if to_new is None else to_new[targets])
    scores = score_heads(tower.mlp, final, query,
                         chunk=cfg.score_chunk)  # [B, rows]
    if ring is None:
        return scores
    return scores[:, :V] if to_new is None else scores[:, to_new]


def score_heads(mlp: MLP, final, query, targets=None, chunk: int = 0):
    """The [state ; query] MLP head over a flat final state [V, B*feat]
    with query [B, D]: [B, V] scores, or [B, T] for the candidates
    ``targets`` [B, T] only (the head then runs on those rows alone). With
    ``chunk`` > 0 the all-entity head runs over that many rows at a time,
    so only [chunk, B, *] intermediates are alive at once."""
    B, V = query.shape[0], final.shape[0]
    if targets is not None:
        # flat [V, B*feat] viewed [V*B, feat]: row v*B + b is state(v, b),
        # so the (b, t) rows are targets*B + b
        feat = final.shape[1] // B
        rows = targets * B + torch.arange(B, device=targets.device)[:, None]
        feats = final.reshape(V * B, feat)[rows]  # [B, T, feat]
        return _mlp_head_targets(mlp, feats, query)
    step = chunk if 0 < chunk < V else V
    scores = [_mlp_head_split(mlp, final[lo:lo + step].reshape(
        -1, B, final.shape[1] // B), query)[..., 0]
        for lo in range(0, V, step)]  # [rows, B] each
    return torch.cat(scores).T


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

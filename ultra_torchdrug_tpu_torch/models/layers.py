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
route of ``aggregate_edges``. ``compute_dtype="bfloat16"`` routes as
the JAX package's ``_spmm_raw`` and ``spmm_addsq`` do: the sparse distmult
and transe sums take K1h (backward K2h, transe K3); the dense route, max,
min and rotate stay fp32; distmult PNA leaves the fused moments pair (fp32
only) for two K1h sums, (rel, x) and (rel², x²), and keeps K6 for max and
min. Node states are carried flat, [V, B*D] with b-major features, as in
the JAX package.

A step is ``conv_aggregate`` (the aggregation kernels' outputs, which
``remat="save_rspmm"`` keeps: models/nbfnet.py) followed by
``conv_update`` (the boundary, PNA's statistics, the split linear, layer
norm and the activation, which it recomputes). The activation is
``ConvConfig.activation``: any name of ``ACTIVATIONS`` (the ``jax.nn``
functions that keep the shape of a [V, B, out] tensor, with their default
arguments), or None, "" or "none" for the identity. An edge weight that
requires grad (classic NBFNet's path tools) sends every aggregation to
the O(E) route of ``aggregate_edges``, each op deciding it for itself
(ops/rspmm.py), and keeps the sums off the ring, so that gradients reach
the edge weights, as the JAX package's edge_grad takes its XLA route: no
kernel runs there.

Under an active mesh with an edge axis (parallel/mesh.py; ``edge_axis``
set), the distmult and transe aggregations route as the JAX package's
``_spmm_raw`` does. With ``rspmm_impl="ring"`` and the graph's ring
buckets (``Graph.prepare_ring``) every aggregation rides the ring
(parallel/ring_rspmm.py): sums, max and min, PNA's extremum pair and, for
distmult, its moments in one rotation each; buckets built with
``permuted_io`` need the caller to pass block-domain states
(``block_domain``; ``ring_block_domain`` says when the entity tower can),
which the entity tower keeps on the shards' cards (``CardRows``,
parallel/card_rows.py): the ring ops take and return them, and
``conv_update`` runs once a card.
With "auto" the sums take the partitioned kernels with the graph's
``part_layouts`` (``Graph.prepare_csr_sharded``; a graph without them
raises: no plain route stands in for the kernels) and max and min the
single-device kernels; with "xla" the sums take its sharded body
(parallel/sharded_rspmm.py). "ring" without buckets that the states may
meet takes the single-device kernels. PNA's pairs are not fused under an
edge axis.
Rotate takes the O(E) route for every aggregation under an edge axis, and
the dense route is skipped there. Off the mesh, ``ring`` runs the
single-device kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import LAYER_NORM_EPS, MLP
from ..ops.dense import dense_rspmm
from ..ops.rspmm import (
    aggregate_edges,
    broadcast_rel_flat,
    generalized_rspmm,
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
    needs_edge_grad,
)
from ..parallel.card_rows import CardRows
from ..parallel.mesh import current_mesh
from ..parallel.ring_rspmm import (
    ring_rspmm,
    ring_rspmm_addsq,
    ring_rspmm_maxmin,
)
from ..parallel.sharded_rspmm import partitioned_rspmm, sharded_rspmm

_MESSAGES = {"distmult": "mul", "transe": "add", "rotate": "rotate"}
_AGGREGATIONS = tuple(f"{base}{bound}" for base in ("sum", "mean", "max", "pna")
                      for bound in ("", "_nobound"))
EPS = 1e-6


def _standardize(x, eps: float = 1e-5):
    """jax.nn.standardize over the last axis: the variance as E[x²] - E[x]²
    clipped at 0."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0)
    return (x - mean) * torch.rsqrt(var + eps)


# jax.nn's shape-keeping activations under their default arguments, each as
# the torch call with the same defaults; softmax, log_softmax and
# standardize act over the feature axis
ACTIVATIONS = {
    "celu": F.celu,
    "elu": F.elu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "hard_sigmoid": F.hardsigmoid,
    "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh,
    "identity": lambda x: x,
    "leaky_relu": F.leaky_relu,
    "log1mexp": lambda x: torch.where(x < math.log(2.0),
                                      torch.log(-torch.expm1(-x)),
                                      torch.log1p(-torch.exp(-x))),
    "log_sigmoid": F.logsigmoid,
    "log_softmax": functools.partial(F.log_softmax, dim=-1),
    "mish": F.mish,
    "relu": F.relu,
    "relu6": F.relu6,
    "selu": F.selu,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "soft_sign": F.softsign,
    "softmax": functools.partial(F.softmax, dim=-1),
    "softplus": F.softplus,
    "sparse_plus": lambda x: torch.where(
        x <= -1.0, torch.zeros_like(x),
        torch.where(x >= 1.0, x, (x + 1.0) ** 2 / 4)),
    "sparse_sigmoid": lambda x: 0.5 * torch.clamp(x + 1.0, 0.0, 2.0),
    "squareplus": lambda x: (x + torch.sqrt(x * x + 4.0)) / 2,
    "standardize": _standardize,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def activation_fn(name):
    """The function of an activation name (None, "" and "none": the
    identity); any name outside ``ACTIVATIONS`` raises."""
    if not name or name == "none":
        return ACTIVATIONS["identity"]
    if name not in ACTIVATIONS:
        raise ValueError(f"activation={name!r}: one of None, 'none' or "
                         f"{', '.join(sorted(ACTIVATIONS))}")
    return ACTIVATIONS[name]


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
    activation: Optional[str] = "relu"  # a name of ACTIVATIONS, or none
    rel_mode: str = "injected"  # embedding | dependent | injected
    project: bool = True  # injected mode: per-layer MLP on relation vectors
    compute_dtype: str = "float32"  # bfloat16: bf16 operands, fp32 sums
    # auto (the kernels) | xla (the O(E) route) | ring (edge mesh only)
    rspmm_impl: str = "auto"
    edge_axis: str = ""  # the mesh axis of the edge partition ("" = off)
    ring_exchange: str = "ppermute"  # ppermute | rdma (kernel K9)


def edge_active(cfg: ConvConfig) -> bool:
    """Whether the conv runs under an edge mesh: an ``edge_axis`` that the
    active mesh has."""
    if not cfg.edge_axis:
        return False
    mesh = current_mesh()
    return mesh is not None and cfg.edge_axis in mesh.axis_names


def ring_active(cfg: ConvConfig) -> bool:
    """Whether the conv rides the ring: ``rspmm_impl="ring"`` under an edge
    mesh."""
    return cfg.rspmm_impl == "ring" and edge_active(cfg)


def ring_block_domain(cfg: ConvConfig, graph):
    """The graph's ``RingRspmmInputs`` when every spmm of a propagation over
    ``graph`` rides the ring with ``permuted_io`` (the model then carries
    node states as padded block-domain rows for the whole stack), else None.
    Mirrors conv_aggregate's routing: off the mesh, for rotate messages or
    without permuted-IO buckets the states stay in original order."""
    ri = getattr(graph, "ring_inputs", None)
    if ri is None or not ri.permuted_io or not ring_active(cfg):
        return None
    if cfg.message_func not in ("distmult", "transe"):
        return None
    return ri


def _ring_route(cfg: ConvConfig, graph, block_domain: bool):
    """The ring inputs that this conv's distmult and transe aggregations
    take, or None: buckets built with ``permuted_io`` must never meet
    original-order states, and an edge weight that requires grad takes the
    O(E) route instead."""
    if (not ring_active(cfg) or cfg.message_func == "rotate"
            or needs_edge_grad(graph.edge_weight)):
        return None
    ri = getattr(graph, "ring_inputs", None)
    if ri is None or (ri.permuted_io and not block_domain):
        return None
    return ri


def block_degree(graph, ring) -> torch.Tensor:
    """The weighted in-degree plus one, [V]; with ``ring`` in its block
    domain, [n * v_block]: pad rows get 1 and relabelled rows move."""
    degree = graph.degree_out() + 1.0
    if ring is None:
        return degree
    degree = torch.cat([degree, degree.new_ones(ring.v_pad - degree.shape[0])])
    return degree if ring.to_old is None else degree[ring.to_old]


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
        activation_fn(cfg.activation)
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

    def forward(self, graph, x, boundary, query=None, rel_injected=None,
                block_domain=False):
        return conv_apply(self, graph, x, boundary, query, rel_injected,
                          block_domain)


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
               rel_injected: Optional[torch.Tensor] = None,
               block_domain: bool = False) -> torch.Tensor:
    """One message-passing step: ``conv_aggregate``, then ``conv_update``.

    graph: data.Graph (undirected+inverse where applicable), carrying a CSR
      for the sparse route on the card (and for max, pna and rotate on both
      devices) or a dense adjacency for the dense one
    x, boundary: flat [V, B*D] node states (or [V, B, D]; the output then
      comes back [V, B, output_dim])
    query: [B, Q] ("dependent" mode); rel_injected: [R, D] or [B, R, D]
      ("injected" mode)
    block_domain: x and boundary are rows of the graph's ring block domain
      (``ring_block_domain``); required for permuted-IO ring buckets. They
      may then be ``CardRows`` (the rows kept on the shards' cards), and
      the output is too
    Returns flat [V, B*output_dim] (or [V, B, output_dim] for 3-D input).
    """
    if isinstance(x, CardRows):
        aggregates = conv_aggregate(layer, graph, x, query, rel_injected,
                                    block_domain)
        return conv_update(layer, graph, x, boundary, aggregates,
                           block_domain)
    flat_in = x.dim() == 2
    V = x.shape[0]
    x = x if flat_in else x.reshape(V, -1)
    boundary = boundary if boundary.dim() == 2 else boundary.reshape(V, -1)
    aggregates = conv_aggregate(layer, graph, x, query, rel_injected,
                                block_domain)
    out = conv_update(layer, graph, x, boundary, aggregates, block_domain)
    return out if flat_in else out.reshape(V, -1, layer.cfg.output_dim)


def conv_aggregate(layer: GeneralizedRelationalConv, graph, x: torch.Tensor,
                   query: Optional[torch.Tensor] = None,
                   rel_injected: Optional[torch.Tensor] = None,
                   block_domain: bool = False) -> tuple:
    """The aggregation kernels' outputs of one step over flat [V, B*D]
    states, the ones that ``remat="save_rspmm"`` keeps (the JAX package's
    ``checkpoint_name(..., "rspmm_out")``): (s,) for sum and mean, (mx,)
    for max, (s, sq, mx, mn) for pna; the boundary is not folded in yet.
    ``CardRows`` states take the ring and give ``CardRows``."""
    cfg = layer.cfg
    rel = _relation_input(layer, query, rel_injected)
    msg = _MESSAGES[cfg.message_func]
    base = cfg.aggregate_func.replace("_nobound", "")
    ring = _ring_route(cfg, graph, block_domain)
    if isinstance(x, CardRows) and ring is None:
        raise ValueError("states kept on the cards take the ring: "
                         "rspmm_impl='ring' under the edge mesh, permuted-IO "
                         "buckets, distmult or transe messages")
    if base == "pna":
        return (pna_sums(cfg, graph, rel, x, msg, ring)
                + _pna_extrema(cfg, graph, rel, x, msg, ring))
    if base == "max":
        return (_extremum(cfg, graph, rel, x, msg, "max", ring),)
    # sum, mean
    return (_sum(cfg, graph, rel, x, msg, ring),)


def conv_update(layer: GeneralizedRelationalConv, graph, x: torch.Tensor,
                boundary: torch.Tensor, aggregates: tuple,
                block_domain: bool = False) -> torch.Tensor:
    """The rest of the step from ``conv_aggregate``'s outputs, the cheap
    elementwise and dense work that ``remat="save_rspmm"`` recomputes: the
    boundary folded in, mean's divide, PNA's statistics and scalers, the
    split linear, layer norm and the activation. Flat [V, B*D] in,
    [V, B*out] out. States kept on the cards (``CardRows``) are updated
    once a card: the layer's parameters are copied to each card (their
    gradients come home through the copies and add up there), and the
    per-row constants (mean's degree, PNA's degree and scalers) are
    computed on the home from the whole graph, then cut a card."""
    cfg = layer.cfg
    consts = _row_constants(cfg, graph,
                            graph.ring_inputs if block_domain else None)
    params = (layer.linear.weight, layer.linear.bias,
              *((layer.layer_norm.weight, layer.layer_norm.bias)
                if cfg.layer_norm else ()))
    if not isinstance(x, CardRows):
        return _update(cfg, x, boundary, aggregates, consts, params)
    layout, k = x.layout, len(aggregates)
    cut = [layout.cut(t) for t in consts]
    copies = [layout.replicate(p) for p in params]
    per_card = [(tuple(t[c] for t in cut), tuple(p[c] for p in copies))
                for c in range(len(layout.groups))]
    return x.map(lambda xt, bt, *rest: _update(cfg, xt, bt, rest[:k],
                                               *rest[k]),
                 boundary, *aggregates, consts=(per_card,))


def _row_constants(cfg: ConvConfig, graph, ring) -> tuple:
    """The update's per-row constants over the graph's rows (``ring``'s
    block domain with ``ring``): (degree [rows],) for mean, (degree
    [rows, 1], scalers [rows, 3]) for pna (``pna_scales``), () else."""
    base = cfg.aggregate_func.replace("_nobound", "")
    if base == "mean":
        return (block_degree(graph, ring),)
    if base == "pna":
        degree = block_degree(graph, ring)[:, None]
        return degree, pna_scales(degree, graph.num_nodes)
    return ()


def _update(cfg: ConvConfig, x, boundary, aggregates, consts, params):
    """``conv_update`` over flat rows with their per-row ``consts``
    (``_row_constants``') and the layer's ``params`` (linear weight and
    bias, then layer norm's when ``cfg.layer_norm``)."""
    D = cfg.input_dim
    V = x.shape[0]
    B = x.shape[1] // D
    base = cfg.aggregate_func.replace("_nobound", "")
    bounded = not cfg.aggregate_func.endswith("_nobound")
    if base == "pna":
        update = _pna_update(cfg, boundary, *aggregates, *consts)
    elif base == "max":
        (update,) = aggregates
        if bounded:
            # torch.maximum splits the gradient at ties, as jnp.maximum does
            update = torch.maximum(update, boundary)
    else:  # sum, mean
        (update,) = aggregates
        if bounded:
            update = update + boundary
        if base == "mean":
            (degree,) = consts
            update = update / degree[:, None]

    # cat([x, update]) @ W^T split into x @ W[:, :D]^T + update @ W[:, D:]^T:
    # the same math without materializing the [V, B, 2D] concat
    w, bias = params[:2]  # [out, 2D], [out]
    out = (torch.matmul(x.reshape(V, B, D), w[:, :D].T)
           + torch.matmul(update.reshape(V, B, -1), w[:, D:].T)
           + bias)
    if cfg.layer_norm:
        out = F.layer_norm(out, (cfg.output_dim,), *params[2:],
                           LAYER_NORM_EPS)
    return activation_fn(cfg.activation)(out).reshape(V, -1)


def _oe(graph, rel, x, msg, agg, dim):
    """``aggregate_edges`` (the O(E) route) over a [V, B, dim] view of flat
    x with ``rel`` as given ([R, dim] or [R, B, dim]); flat out."""
    B = x.shape[1] // dim
    out = aggregate_edges(graph.edge_index, graph.edge_type,
                          graph.edge_weight, rel, x.reshape(-1, B, dim),
                          msg=msg, agg=agg, num_nodes=graph.num_nodes)
    return out.reshape(graph.num_nodes, -1)


def _sum(cfg: ConvConfig, graph, rel, x, msg, ring):
    """The sum of each node's weighted in-edge messages, flat [V, B*D] in
    and out, ``rel`` [R, D] or [R, B, D], routed as the JAX package's
    ``_spmm_raw``:

      * under an edge mesh (distmult, transe; no edge-weight gradient): the
        ring with ``ring``'s buckets; ``sharded_rspmm`` for
        ``rspmm_impl="xla"``; the partitioned kernels with the graph's
        ``part_layouts`` for "auto" (a graph without them raises: no plain
        route stands in for the kernels); "ring" without buckets that
        these states may meet takes the single-device kernels;
      * the dense per-relation matmuls where the graph carries a dense
        adjacency, off an edge axis;
      * ``rspmm_impl="xla"``, or rotate with an ``edge_axis``: the O(E)
        route;
      * else the single-device op (K1 / K1h / K8f)."""
    D = cfg.input_dim
    B = x.shape[1] // D
    edge_grad = needs_edge_grad(graph.edge_weight)
    if msg != "rotate" and edge_active(cfg) and not edge_grad:
        if ring is not None:
            return ring_rspmm(graph.edge_weight, ring,
                              broadcast_rel_flat(rel, B), x, msg=msg,
                              compute_dtype=cfg.compute_dtype,
                              exchange=cfg.ring_exchange)
        if cfg.rspmm_impl == "xla":
            mesh = current_mesh()
            out = sharded_rspmm(graph.edge_index, graph.edge_type,
                                graph.edge_weight, rel, x.reshape(-1, B, D),
                                msg=msg, num_nodes=graph.num_nodes,
                                n_shards=mesh.shape[cfg.edge_axis],
                                devices=mesh.devices)
            return out.reshape(graph.num_nodes, -1)
        if cfg.rspmm_impl == "auto":
            if graph.part_layouts is None:
                raise ValueError(
                    "rspmm_impl='auto' under an edge mesh takes the "
                    "partitioned kernels, which need the graph's per-shard "
                    "CSRs (Graph.prepare_csr_sharded)")
            return partitioned_rspmm(graph.edge_weight, graph.part_layouts,
                                     broadcast_rel_flat(rel, B), x, msg=msg,
                                     compute_dtype=cfg.compute_dtype)
    if (msg != "rotate" and graph.dense_adj is not None
            and not cfg.edge_axis and not edge_grad):
        # small dense graph (the ULTRA relation graph): per-etype matmuls
        return dense_rspmm(graph.dense_adj, broadcast_rel_flat(rel, B), x,
                           msg=msg)
    if cfg.rspmm_impl == "xla" or (msg == "rotate" and cfg.edge_axis):
        return _oe(graph, rel, x, msg, "add", D)
    return _spmm(graph, broadcast_rel_flat(rel, B), x, msg, "add", D,
                 cfg.compute_dtype)


def _extremum(cfg: ConvConfig, graph, rel, x, msg, agg, ring):
    """The max or min of each node's weighted in-edge messages, flat: the
    ring's schedule with ``ring``; the O(E) route under ``xla`` or for
    rotate; else K4, on an edge mesh too, as the JAX package's partitioned
    paths leave extrema to the single-device kernels (never the dense
    route: an extremum does not decompose into matmuls)."""
    D = cfg.input_dim
    if cfg.rspmm_impl == "xla" or msg == "rotate":
        return _oe(graph, rel, x, msg, agg, D)
    rel_flat = broadcast_rel_flat(rel, x.shape[1] // D)
    if ring is not None:
        return ring_rspmm(graph.edge_weight, ring, rel_flat, x, msg=msg,
                          agg=agg, exchange=cfg.ring_exchange)
    return _spmm(graph, rel_flat, x, msg, agg, D)


def _spmm(graph, rel_flat, x, msg, agg, dim, compute_dtype="float32"):
    """The sparse rspmm over flat [V, B*dim] states (``compute_dtype``
    reaches generalized_rspmm, which applies it to the distmult and transe
    sums only; an edge weight that requires grad takes the O(E) route
    there). Rotate, as the JAX
    package's ``_spmm_raw`` routes it, works on the [V, B, dim] form in
    fp32: its sum through generalized_rspmm (K8f forward, K8b backward on
    CUDA tensors), max, min and sq_add (Σ w·m², PNA's second moment) the
    O(E) route."""
    edges = (graph.edge_index, graph.edge_type, graph.edge_weight)
    if msg != "rotate":
        return generalized_rspmm(*edges, rel_flat, x, msg=msg, agg=agg,
                                 num_nodes=graph.num_nodes, csr=graph.csr,
                                 compute_dtype=compute_dtype)
    B = x.shape[1] // dim
    rel, x = rel_flat.reshape(-1, B, dim), x.reshape(x.shape[0], B, dim)
    if agg == "sq_add":
        out = aggregate_edges(*edges, rel, x, msg=msg, agg=agg,
                              num_nodes=graph.num_nodes)
    else:
        out = generalized_rspmm(*edges, rel, x, msg=msg, agg=agg,
                                num_nodes=graph.num_nodes, csr=graph.csr)
    return out.reshape(graph.num_nodes, -1)


def pna_sums(cfg: ConvConfig, graph, rel, x, msg, ring=None):
    """(s, sq): the sums of each node's in-edge messages and of their
    squares, ``rel`` [R, D] or [R, B, D]. Distmult takes one ring rotation
    for both with ``ring`` (``ring_rspmm_addsq``), else in fp32 off an edge
    axis and off ``xla`` the fused moments pair (K7); rotate sums its
    squared message on the O(E) route; otherwise two sums (``_sum``'s
    routes) of (rel, x) and (rel², x²), transe's convention, which does not
    factor through the message, and for distmult the same sum as the
    squared message."""
    D, B = cfg.input_dim, x.shape[1] // cfg.input_dim
    if msg == "mul" and ring is not None:
        return ring_rspmm_addsq(graph.edge_weight, ring,
                                broadcast_rel_flat(rel, B), x,
                                exchange=cfg.ring_exchange)
    if (msg == "mul" and cfg.compute_dtype == "float32"
            and not cfg.edge_axis and cfg.rspmm_impl != "xla"):
        return generalized_rspmm_addsq(
            graph.edge_index, graph.edge_type, graph.edge_weight,
            broadcast_rel_flat(rel, B), x, num_nodes=graph.num_nodes,
            csr=graph.csr)
    s = _sum(cfg, graph, rel, x, msg, ring)
    if msg == "rotate":
        return s, _oe(graph, rel, x, msg, "sq_add", D)
    x2 = x.map(lambda t: t ** 2) if isinstance(x, CardRows) else x ** 2
    return s, _sum(cfg, graph, rel ** 2, x2, msg, ring)


def _pna_extrema(cfg: ConvConfig, graph, rel, x, msg, ring=None):
    """(mx, mn): one ring rotation for both with ``ring``
    (``ring_rspmm_maxmin``); the fused pair (K6) off an edge axis and off
    ``xla``; otherwise two ``_extremum`` calls (K4 twice, or the O(E)
    route for rotate and ``xla``), as the JAX package's unfused pair."""
    B = x.shape[1] // cfg.input_dim
    if ring is not None:
        return ring_rspmm_maxmin(graph.edge_weight, ring,
                                 broadcast_rel_flat(rel, B), x, msg=msg,
                                 exchange=cfg.ring_exchange)
    if msg == "rotate" or cfg.edge_axis or cfg.rspmm_impl == "xla":
        return tuple(_extremum(cfg, graph, rel, x, msg, agg, None)
                     for agg in ("max", "min"))
    return generalized_rspmm_maxmin(
        graph.edge_index, graph.edge_type, graph.edge_weight,
        broadcast_rel_flat(rel, B), x, msg=msg, num_nodes=graph.num_nodes,
        csr=graph.csr)


def pna_moments(cfg: ConvConfig, graph, s, sq, boundary, ring=None):
    """(mean, sq_mean, degree [rows, 1]) of each node's in-edge messages
    from ``pna_sums``' (s, sq), the boundary counting as one more message
    unless ``pna_nobound``; degree is the weighted in-degree plus one, in
    ``ring``'s block domain when the states are (``block_degree``)."""
    degree = block_degree(graph, ring)[:, None]
    return (*_moments(cfg, s, sq, boundary, degree), degree)


def _moments(cfg: ConvConfig, s, sq, boundary, degree):
    if cfg.aggregate_func == "pna":
        return (s + boundary) / degree, (sq + boundary ** 2) / degree
    return s / degree, sq / degree


def pna_scales(degree: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """PNA's degree scalers [rows, 3] from degree [rows, 1]: [1, s, 1/s],
    s = log(degree) normalised by its mean over the graph's ``num_nodes``
    nodes (the block domain's pad rows have degree 1 and add nothing). The
    mean is over the whole graph: states kept on the cards take their rows
    of these scalers, never a mean of their own rows."""
    scale = torch.log(degree)
    scale = scale / (scale.sum() / num_nodes)
    inv = 1.0 / torch.clamp(scale, min=1e-2)
    return torch.cat([torch.ones_like(scale), scale, inv], dim=-1)


def _pna_update(cfg: ConvConfig, boundary, s, sq, mx, mn, degree, scales):
    """PNA's update [V, B*12D]: per (b, d) the interleaved [mean, max, min,
    std] of the in-edge messages (with the boundary as one more message
    unless ``pna_nobound``), each times the rows' degree ``scales``
    (``pna_scales``)."""
    V = boundary.shape[0]
    mean, sq_mean = _moments(cfg, s, sq, boundary, degree)
    if cfg.aggregate_func == "pna":
        # torch.maximum/minimum split the gradient at ties, as jnp's do
        mx = torch.maximum(mx, boundary)
        mn = torch.minimum(mn, boundary)
    std = torch.sqrt(torch.clamp(sq_mean - mean ** 2, min=EPS))
    features = torch.stack([mean, mx, mn, std], dim=-1)  # [V, B*D, 4]
    return (features[:, :, :, None] * scales[:, None, None, :]).reshape(V, -1)

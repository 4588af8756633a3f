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

Under an active mesh with an edge axis (parallel/mesh.py), a conv with
``rspmm_impl="ring"`` and ``edge_axis`` set sends its distmult and transe
sums through the ring (parallel/ring_rspmm.py) when the graph carries ring
buckets (``Graph.prepare_ring``), with the JAX package's rules: buckets
built with ``permuted_io`` need the caller to pass block-domain states
(``block_domain``; ``ring_block_domain`` says when the entity tower can),
and otherwise the sums take the single-device route. Max and pna under an
active edge mesh raise: their ring schedules are not ported yet (ROADMAP
Queue 1 item 9). Off the mesh, ``ring`` runs the single-device kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import MLP, layer_norm
from ..ops.dense import dense_rspmm
from ..ops.rspmm import (
    aggregate_edges,
    broadcast_rel_flat,
    generalized_rspmm,
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
    needs_edge_grad,
)
from ..parallel.mesh import current_mesh
from ..parallel.ring_rspmm import ring_rspmm

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


def ring_active(cfg: ConvConfig) -> bool:
    """Whether the conv's sums ride the ring: ``rspmm_impl="ring"`` with an
    ``edge_axis`` that the active mesh has."""
    if cfg.rspmm_impl != "ring" or not cfg.edge_axis:
        return False
    mesh = current_mesh()
    return mesh is not None and cfg.edge_axis in mesh.axis_names


def _check_ring_aggregation(cfg: ConvConfig):
    base = cfg.aggregate_func.replace("_nobound", "")
    if base not in ("sum", "mean") and cfg.message_func != "rotate":
        raise NotImplementedError(
            f"aggregate_func={cfg.aggregate_func!r} on the ring (the max/min "
            "and moments ring schedules) is not ported yet (ROADMAP Queue 1 "
            "item 9); under an active edge mesh the ring takes sum and mean")


def ring_block_domain(cfg: ConvConfig, graph):
    """The graph's ``RingRspmmInputs`` when every spmm of a propagation over
    ``graph`` rides the ring with ``permuted_io`` (the model then carries
    node states as padded block-domain rows for the whole stack), else None.
    Mirrors conv_apply's routing: off the mesh, for rotate messages or
    without permuted-IO buckets the states stay in original order. Raises
    for the aggregations whose ring schedules are not ported."""
    ri = getattr(graph, "ring_inputs", None)
    if ri is None or not ri.permuted_io or not ring_active(cfg):
        return None
    if cfg.message_func not in ("distmult", "transe"):
        return None
    _check_ring_aggregation(cfg)
    return ri


def _ring_route(cfg: ConvConfig, graph, block_domain: bool):
    """The ring inputs that this conv's sums take, or None: buckets built
    with ``permuted_io`` must never meet original-order states, and an edge
    weight that requires grad takes the O(E) route instead."""
    if not ring_active(cfg) or needs_edge_grad(graph.edge_weight):
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
      (``ring_block_domain``); required for permuted-IO ring buckets
    Returns flat [V, B*output_dim] (or [V, B, output_dim] for 3-D input).
    """
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
    for max, (s, sq, mx, mn) for pna; the boundary is not folded in yet."""
    cfg = layer.cfg
    rel = _relation_input(layer, query, rel_injected)
    D = cfg.input_dim
    B = x.shape[1] // D
    msg = _MESSAGES[cfg.message_func]
    rel_flat = broadcast_rel_flat(rel, B)
    base = cfg.aggregate_func.replace("_nobound", "")
    if cfg.rspmm_impl == "xla":
        return _xla_aggregates(cfg, graph, rel, x, msg, base)
    if ring_active(cfg) and not needs_edge_grad(graph.edge_weight):
        _check_ring_aggregation(cfg)
    ring = _ring_route(cfg, graph, block_domain)
    if base == "pna":
        return (pna_sums(cfg, graph, rel_flat, x, msg)
                + _pna_extrema(cfg, graph, rel_flat, x, msg))
    if base == "max":
        # never the dense route: a max does not decompose into matmuls
        return (_spmm(graph, rel_flat, x, msg, "max", D, cfg.compute_dtype),)
    # sum, mean
    if ring is not None and msg != "rotate":
        return (ring_rspmm(graph.edge_weight, ring, rel_flat, x, msg=msg,
                           compute_dtype=cfg.compute_dtype,
                           exchange=cfg.ring_exchange),)
    if (graph.dense_adj is not None and msg != "rotate"
            and not cfg.edge_axis):
        # small dense graph (the ULTRA relation graph): per-etype matmuls
        return (dense_rspmm(graph.dense_adj, rel_flat, x, msg=msg),)
    return (_spmm(graph, rel_flat, x, msg, "add", D, cfg.compute_dtype),)


def conv_update(layer: GeneralizedRelationalConv, graph, x: torch.Tensor,
                boundary: torch.Tensor, aggregates: tuple,
                block_domain: bool = False) -> torch.Tensor:
    """The rest of the step from ``conv_aggregate``'s outputs, the cheap
    elementwise and dense work that ``remat="save_rspmm"`` recomputes: the
    boundary folded in, mean's divide, PNA's statistics and scalers, the
    split linear, layer norm and the activation. Flat [V, B*D] in,
    [V, B*out] out."""
    cfg = layer.cfg
    D = cfg.input_dim
    V = x.shape[0]
    B = x.shape[1] // D
    base = cfg.aggregate_func.replace("_nobound", "")
    bounded = not cfg.aggregate_func.endswith("_nobound")
    if base == "pna":
        update = _pna_update(cfg, graph, boundary, *aggregates)
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
            ring = _ring_route(cfg, graph, block_domain)
            degree = block_degree(graph, ring if block_domain else None)
            update = update / degree[:, None]

    # cat([x, update]) @ W^T split into x @ W[:, :D]^T + update @ W[:, D:]^T:
    # the same math without materializing the [V, B, 2D] concat
    w = layer.linear.weight  # [out, 2D]
    out = (torch.matmul(x.reshape(V, B, D), w[:, :D].T)
           + torch.matmul(update.reshape(V, B, -1), w[:, D:].T)
           + layer.linear.bias)
    if cfg.layer_norm:
        out = layer_norm(layer.layer_norm, out)
    return activation_fn(cfg.activation)(out).reshape(V, -1)


def _xla_aggregates(cfg: ConvConfig, graph, rel, x, msg, base) -> tuple:
    """``conv_aggregate``'s outputs on the ``xla`` route: every sparse
    aggregation by ``aggregate_edges`` over a [V, B, D] view with ``rel``
    as given ([R, D] or [R, B, D]), fp32; PNA as the JAX package's unfused
    pairs (rotate's second moment over its squared messages, the others'
    over rel² and x²). Sums over a dense relation graph keep its matmuls."""
    D = cfg.input_dim
    B = x.shape[1] // D

    def spmm(r, xx, agg):
        if agg == "add" and msg != "rotate" and graph.dense_adj is not None:
            return dense_rspmm(graph.dense_adj, broadcast_rel_flat(r, B), xx,
                               msg=msg)
        out = aggregate_edges(graph.edge_index, graph.edge_type,
                              graph.edge_weight, r, xx.reshape(-1, B, D),
                              msg=msg, agg=agg, num_nodes=graph.num_nodes)
        return out.reshape(graph.num_nodes, -1)

    if base == "pna":
        sq = (spmm(rel, x, "sq_add") if msg == "rotate"
              else spmm(rel ** 2, x ** 2, "add"))
        return (spmm(rel, x, "add"), sq, spmm(rel, x, "max"),
                spmm(rel, x, "min"))
    return (spmm(rel, x, "max" if base == "max" else "add"),)


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


def pna_sums(cfg: ConvConfig, graph, rel_flat, x, msg):
    """(s, sq): the sums of each node's in-edge messages and of their
    squares. Distmult in fp32 takes the fused moments pair (K7); rotate
    sums the squared message; distmult and
    transe otherwise sum rel² and x² (transe's convention, which does not
    factor through the message; for distmult the same sum as the squared
    message)."""
    D, dtype = cfg.input_dim, cfg.compute_dtype
    if msg == "mul" and dtype == "float32":
        return generalized_rspmm_addsq(
            graph.edge_index, graph.edge_type, graph.edge_weight, rel_flat, x,
            num_nodes=graph.num_nodes, csr=graph.csr)
    # the fused moments pair is fp32 only: bf16 distmult takes two sums
    s = _spmm(graph, rel_flat, x, msg, "add", D, dtype)
    sq = (_spmm(graph, rel_flat, x, msg, "sq_add", D) if msg == "rotate"
          else _spmm(graph, rel_flat ** 2, x ** 2, msg, "add", D, dtype))
    return s, sq


def _pna_extrema(cfg: ConvConfig, graph, rel_flat, x, msg):
    """(mx, mn): the fused max/min pair (K6), or two O(E) calls for rotate
    (as in JAX: no fused pair)."""
    if msg == "rotate":
        return tuple(_spmm(graph, rel_flat, x, msg, agg, cfg.input_dim)
                     for agg in ("max", "min"))
    return generalized_rspmm_maxmin(
        graph.edge_index, graph.edge_type, graph.edge_weight, rel_flat, x,
        msg=msg, num_nodes=graph.num_nodes, csr=graph.csr)


def pna_moments(cfg: ConvConfig, graph, s, sq, boundary):
    """(mean, sq_mean, degree [V, 1]) of each node's in-edge messages from
    ``pna_sums``' (s, sq), the boundary counting as one more message unless
    ``pna_nobound``; degree is the weighted in-degree plus one."""
    degree = (graph.degree_out() + 1.0)[:, None]
    if cfg.aggregate_func == "pna":
        return (s + boundary) / degree, (sq + boundary ** 2) / degree, degree
    return s / degree, sq / degree, degree


def _pna_update(cfg: ConvConfig, graph, boundary, s, sq, mx, mn):
    """PNA's update [V, B*12D]: per (b, d) the interleaved [mean, max, min,
    std] of the in-edge messages (with the boundary as one more message
    unless ``pna_nobound``), each times the degree scalers [1, s, 1/s],
    s = log(degree) normalised by its mean over the nodes."""
    V = boundary.shape[0]
    mean, sq_mean, degree = pna_moments(cfg, graph, s, sq, boundary)
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

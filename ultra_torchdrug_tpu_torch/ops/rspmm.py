"""Generalized relational sparse-dense matrix multiply (counterpart of
ultra_torchdrug_tpu/ops/rspmm.py), the hot op of NBFNet propagation:

    out[t] = AGG_{e=(h,t,r)} edge_weight[e] * (relation[r] MSG x[h])

``generalized_rspmm`` covers MSG in {mul (distmult), add (transe), rotate}
with AGG in {add, max, min}, in the flat form (x [V, F], relation [R, F]) and
the [V, B, D] form (relation [R, D] shared across the batch, or [R, B, D]);
rotate takes only the [V, B, D] form with even D, each D block holding the
real parts in [:D/2] and the imaginary parts in [D/2:].

  * AGG add: on CUDA tensors an autograd node over the graph's layouts
    (``Graph.prepare_csr``): its forward launches kernel K1
    (ops/rspmm_cuda.py), its backward K2 for distmult and K3 for transe
    messages (ops/rspmm_bwd_cuda.py); rotate has its own node, K8f forward
    and K8b backward. On CPU tensors it runs the plain index_select +
    index_add_ version, whose gradients come from autograd. With
    ``compute_dtype="bfloat16"`` distmult and transe sums take one node on
    both devices (it needs the CSR on both): K1h forward, K2h backward for
    distmult and K3 (fp32, as the JAX package's transe backward) for
    transe, their plain versions on CPU tensors; rotate ignores the mode,
    as the JAX package does.
  * AGG max / min: fp32 whatever ``compute_dtype`` says (the backward's
    equality gates need the forward replayed exactly), one autograd node
    on both devices, kernel K4 forward and
    K5 backward on CUDA tensors (ops/rspmm_pna_cuda.py), their plain
    versions on CPU tensors. Rows without edges give 0; weight-0 edges send
    the message 0, which takes part. Rotate takes the O(E) route
    (``rotate_aggregate``) on both devices, as the JAX package does: no TPU
    kernel exists for it.

PNA's fused pairs, ``generalized_rspmm_maxmin`` (the max and min of the same
messages, mul or add) and ``generalized_rspmm_addsq`` (their sum and sum of
squares, distmult), are autograd nodes on both devices in the same way:
kernels K6/K7 forward and K6b/K7b backward on CUDA tensors, the plain
versions on CPU tensors. The max/min nodes give the full gradient to every
tied edge on both devices, and need the graph's ``Csr`` on both, with
``prepare_csr(backward=True)`` for gradients; rotate's O(E) route shares
the gradient among tied edges, as XLA's segment_max does. Gradients to the
edge weights (classic NBFNet's edge-gradient path) are not ported yet: an
edge weight that requires grad raises on CUDA tensors, and for the max/min
and pair nodes on both devices.
"""

from __future__ import annotations

import math

import torch

from .rspmm_bwd_cuda import (
    rotate_bwd_cuda,
    rspmm_bwd_bf16_cuda,
    rspmm_bwd_cuda,
)
from .rspmm_cuda import (
    rotate_fwd_cuda,
    rotate_product,
    rspmm_fwd_bf16_cuda,
    rspmm_fwd_cuda,
    rspmm_plain_edges,
)
from .rspmm_pna_cuda import pna_bwd_cuda, pna_fwd_cuda

__all__ = ["generalized_rspmm", "generalized_rspmm_maxmin",
           "generalized_rspmm_addsq", "broadcast_rel_flat",
           "rotate_aggregate"]

_MODES = {"mul": "mul_rel", "add": "add_rel", "rotate": "rot_rel"}
_AGGS = ("add", "max", "min")
_REDUCE = {"max": "amax", "min": "amin"}
COMPUTE_DTYPES = ("float32", "bfloat16")


def broadcast_rel_flat(relation: torch.Tensor, B: int) -> torch.Tensor:
    """[R, D] or [R, B, D] -> flat [R, B*D], b-major like the flat x layout."""
    if relation.dim() == 2:
        R, D = relation.shape
        return relation[:, None, :].expand(R, B, D).reshape(R, B * D)
    return relation.reshape(relation.shape[0], -1)


class _RspmmK1K2(torch.autograd.Function):
    """K1 forward, K2 (mul_rel) or K3 (add_rel) backward over a graph's
    ``Csr``; with ``bf16`` K1h forward and K2h (mul_rel) backward, K3
    staying fp32 as the JAX package's transe backward does. The wrappers
    launch the kernels on CUDA tensors and run their plain versions on CPU
    tensors, so on the CPU the bf16 node's gradients are the plain K2h's
    fp32 products of bf16 operands and not autograd's bf16 arithmetic. Flat
    fp32 operands: edge_weight [E], relation [R, F], x [V, F]."""

    @staticmethod
    def forward(ctx, csr, edge_weight, relation, x, mode, bf16=False):
        ctx.csr, ctx.mode, ctx.bf16 = csr, mode, bf16
        # K3 reads no x: the transe backward keeps none alive
        ctx.save_for_backward(edge_weight, relation,
                              x if mode == "mul_rel" else None)
        fwd = rspmm_fwd_bf16_cuda if bf16 else rspmm_fwd_cuda
        return fwd(csr.rowptr, csr.src, csr.etype, csr.eid, edge_weight,
                   relation, x, mode)

    @staticmethod
    def backward(ctx, grad_out):
        edge_weight, relation, x = ctx.saved_tensors
        need_dr, need_dx = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        grad_out = grad_out.contiguous()
        if ctx.bf16 and ctx.mode == "mul_rel":
            dx, dr = rspmm_bwd_bf16_cuda(ctx.csr, edge_weight, relation, x,
                                         grad_out, need_dx, need_dr)
        else:
            dx, dr = rspmm_bwd_cuda(ctx.csr, edge_weight, relation, x,
                                    grad_out, need_dx=need_dx,
                                    need_dr=need_dr, mode=ctx.mode)
        return None, None, dr, dx, None, None


class _RspmmRotate(torch.autograd.Function):
    """K8f forward, K8b backward over a graph's ``Csr``, rotate messages.
    Flat operands: edge_weight [E], relation [R, F], x [V, F] with F a
    multiple of ``dim``, the width of one re/im block."""

    @staticmethod
    def forward(ctx, csr, edge_weight, relation, x, dim):
        ctx.csr, ctx.dim = csr, dim
        ctx.save_for_backward(edge_weight, relation, x)
        return rotate_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                               edge_weight, relation, x, dim)

    @staticmethod
    def backward(ctx, grad_out):
        edge_weight, relation, x = ctx.saved_tensors
        dx, dr = rotate_bwd_cuda(ctx.csr, edge_weight, relation, x,
                                 grad_out.contiguous(), ctx.dim,
                                 need_dx=ctx.needs_input_grad[3],
                                 need_dr=ctx.needs_input_grad[2])
        return None, None, dr, dx, None


def generalized_rspmm(edge_index, edge_type, edge_weight, relation, x, *,
                      msg: str = "mul", agg: str = "add", num_nodes: int,
                      csr=None, compute_dtype: str = "float32") -> torch.Tensor:
    """Relational SpMM with sum, max or min aggregation.

    edge_index [E, 2], edge_type [E], edge_weight [E] in original edge order;
    csr: the graph's ``Csr`` (data/graph.py), required on CUDA and, for max
    and min and for bf16 sums, on both devices (``prepare_csr(backward=True)``
    for gradients). compute_dtype: "float32", or "bfloat16" for the distmult
    and transe sums (K1h, K2h): operands rounded to bf16, fp32 sums and
    output. Returns the layout of x with num_nodes rows. On CUDA, gradients
    flow to relation and x; an edge_weight that requires grad raises (the
    edge-gradient path of classic NBFNet is not ported yet). Rotate max and
    min take the O(E) route on both devices and need no CSR.
    """
    if msg not in _MODES:
        raise ValueError(f"msg must be one of {tuple(_MODES)}, got {msg!r}")
    if agg not in _AGGS:
        raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    mode = _MODES[msg]
    dim = 0
    if msg == "rotate":
        if x.dim() != 3 or x.shape[-1] % 2:
            raise ValueError("rotate needs [V, B, D] inputs with even D "
                             "(D blocks store re in [:D/2], im in [D/2:])")
        if agg != "add":
            return rotate_aggregate(edge_index, edge_type, edge_weight,
                                    relation, x, agg, num_nodes)
        dim = x.shape[-1]
    elif agg != "add":
        (out,) = _gated(agg, edge_weight, relation, x, mode, num_nodes, csr)
        return out
    xf, rel, unflat = _flat_operands(relation, x, num_nodes)
    bf16 = compute_dtype == "bfloat16" and msg != "rotate"
    if x.device.type == "cpu" and not bf16:
        out = rspmm_plain_edges(edge_index[:, 0], edge_index[:, 1], edge_type,
                                edge_weight, rel, xf, mode, num_nodes, dim)
    else:
        _check_graph(csr, edge_weight, num_nodes)
        args = (csr, edge_weight.contiguous(), rel.contiguous(),
                xf.contiguous())
        out = (_RspmmRotate.apply(*args, dim) if msg == "rotate"
               else _RspmmK1K2.apply(*args, mode, bf16))
    return unflat(out)


def rotate_aggregate(edge_index, edge_type, edge_weight, relation, x,
                     agg: str, num_nodes: int) -> torch.Tensor:
    """Rotate messages materialized per edge and reduced by destination, on
    both devices: the O(E) route of the JAX package
    (models/layers.py::_rotate_messages_aggregate, ops/rspmm.py::_rspmm_xla),
    which runs no TPU kernel, so none is ported for it. x [V, B, D] with
    even D; relation [R, D] or [R, B, D]. agg "add", "max" or "min" reduces
    m · w (rows without edges 0; tied edges share the gradient, as XLA's
    segment_max does); "sq_add" reduces
    m · m · w over the unweighted message m, PNA's second moment."""
    rel_e = relation.index_select(0, edge_type)
    if rel_e.dim() == 2:
        rel_e = rel_e[:, None, :]
    m = rotate_product(rel_e, x.index_select(0, edge_index[:, 0]))
    w = edge_weight[:, None, None]
    m = m * m * w if agg == "sq_add" else m * w
    shape, dst = (num_nodes,) + tuple(m.shape[1:]), edge_index[:, 1]
    if agg in ("add", "sq_add"):
        return m.new_zeros(shape).index_add_(0, dst, m)
    # scatter_reduce's backward counts the initial value among the ties even
    # with include_self=False: start at ∓inf, never a message, then give
    # rows without edges 0 as segment_max's caller does
    out = m.new_full(shape, -math.inf if agg == "max" else math.inf)
    out = out.scatter_reduce(0, dst[:, None, None].expand_as(m), m,
                             _REDUCE[agg], include_self=False)
    return torch.where(torch.isfinite(out), out, 0.0)


def _flat_operands(relation, x, num_nodes):
    """(x [V, F], relation [R, F], a function that gives an output [N, F]
    the layout of x) for the flat or the [V, B, D] form."""
    if x.dim() == 2:
        return x, relation, lambda out: out
    xf = x.reshape(x.shape[0], -1)
    rel = broadcast_rel_flat(relation, x.shape[1])
    return xf, rel, lambda out: out.reshape(num_nodes, *x.shape[1:])


def _check_graph(csr, edge_weight, num_nodes):
    if csr is None:
        raise ValueError("the kernels and their plain versions need the "
                         "graph's CSR (Graph.prepare_csr)")
    if csr.rowptr.numel() != num_nodes + 1:
        raise ValueError(f"CSR has {csr.rowptr.numel() - 1} rows, "
                         f"expected {num_nodes}")
    if edge_weight.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "gradients to edge weights (classic NBFNet's edge-gradient "
            "path, ROADMAP item 12) are not ported yet")


class _RspmmGated(torch.autograd.Function):
    """The aggregations of ops/rspmm_pna_cuda.py over one set of messages,
    on both devices: kind ``max`` / ``min`` (K4 forward, K5 backward),
    ``maxmin`` (K6, K6b), modes mul_rel/add_rel, or ``addsq`` (K7, K7b),
    mul_rel, over a graph's ``Csr``. The wrappers launch the kernels on
    CUDA tensors and run their plain versions on CPU tensors. The extrema
    are saved for the backward's gates as the forward returns them, rows
    without edges masked to 0. Flat operands: edge_weight [E], relation
    [R, F], x [V, F]; returns the kind's outputs as a tuple."""

    @staticmethod
    def forward(ctx, kind, csr, edge_weight, relation, x, mode):
        outs = pna_fwd_cuda(kind, csr, edge_weight, relation, x, mode)
        ctx.kind, ctx.csr, ctx.mode = kind, csr, mode
        extrema = outs if kind != "addsq" else ()
        ctx.save_for_backward(edge_weight, relation, x, *extrema)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        edge_weight, relation, x, *extrema = ctx.saved_tensors
        grads = [g.contiguous() for g in grads]
        if ctx.kind == "addsq":
            kind, planes = "moments", tuple(grads)
        else:  # each extremum's gradient beside it
            kind = "argext_pair" if ctx.kind == "maxmin" else "argext"
            planes = tuple(p for pair in zip(grads, extrema) for p in pair)
        need_dr, need_dx = ctx.needs_input_grad[3], ctx.needs_input_grad[4]
        dx, dr = pna_bwd_cuda(kind, ctx.csr, edge_weight, relation, x, planes,
                              ctx.mode, need_dx, need_dr)
        return None, None, None, dr, dx, None


def _gated(kind, edge_weight, relation, x, mode, num_nodes, csr):
    xf, rel, unflat = _flat_operands(relation, x, num_nodes)
    _check_graph(csr, edge_weight, num_nodes)
    outs = _RspmmGated.apply(kind, csr, edge_weight.contiguous(),
                             rel.contiguous(), xf.contiguous(), mode)
    return tuple(unflat(o) for o in outs)


def generalized_rspmm_maxmin(edge_index, edge_type, edge_weight, relation,
                             x, *, msg: str = "mul", num_nodes: int,
                             csr=None):
    """PNA's extremum pair: (max, min) over each node's in-edges of
    w · (relation MSG x), rows without edges 0, in one fused pass (K6 on
    CUDA). Shapes as for generalized_rspmm; ``csr`` is required on both
    devices (edge_index and edge_type, the JAX signature's, are carried by
    it), and the backward (K6b) needs ``prepare_csr(backward=True)``.
    Gradients flow to relation and x; every edge whose message ties with the
    extremum gets the full gradient. Returns (out_max, out_min)."""
    if msg not in ("mul", "add"):
        raise ValueError(
            f"msg={msg!r}: the fused max/min pair has mul and add (rotate "
            "takes generalized_rspmm's O(E) route twice, as in the JAX "
            "package)")
    return _gated("maxmin", edge_weight, relation, x, _MODES[msg], num_nodes,
                  csr)


def generalized_rspmm_addsq(edge_index, edge_type, edge_weight, relation, x,
                            *, num_nodes: int, csr=None):
    """PNA's moments of the same distmult messages: (Σ w·(rel ⊙ x),
    Σ w·(rel ⊙ x)²) in one fused pass (K7 on CUDA, K7b for the backward).
    Shapes and ``csr`` as for generalized_rspmm_maxmin. Returns (s, sq)."""
    return _gated("addsq", edge_weight, relation, x, "mul_rel", num_nodes, csr)

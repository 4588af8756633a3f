"""Generalized relational sparse-dense matrix multiply (counterpart of
ultra_torchdrug_tpu/ops/rspmm.py), the hot op of NBFNet propagation:

    out[t] = AGG_{e=(h,t,r)} edge_weight[e] * (relation[r] MSG x[h])

This slice covers MSG in {mul (distmult), add (transe)} with AGG add, in the
flat form (x [V, F], relation [R, F]) and the [V, B, D] form (relation
[R, D] shared across the batch, or [R, B, D]).

On CUDA tensors the op is an autograd node over the graph's layouts
(``Graph.prepare_csr``): its forward launches kernel K1
(ops/rspmm_cuda.py) and, for distmult messages, its backward launches
kernel K2 (ops/rspmm_bwd_cuda.py). The transe backward (kernel K3) and
gradients to the edge weights are not ported yet and raise. On CPU tensors
the op runs the plain index_select + index_add_ version, whose gradients
come from autograd.
"""

from __future__ import annotations

import torch

from .rspmm_bwd_cuda import rspmm_bwd_cuda
from .rspmm_cuda import rspmm_fwd_cuda, rspmm_plain_edges

__all__ = ["generalized_rspmm", "broadcast_rel_flat"]

_MODES = {"mul": "mul_rel", "add": "add_rel"}


def broadcast_rel_flat(relation: torch.Tensor, B: int) -> torch.Tensor:
    """[R, D] or [R, B, D] -> flat [R, B*D], b-major like the flat x layout."""
    if relation.dim() == 2:
        R, D = relation.shape
        return relation[:, None, :].expand(R, B, D).reshape(R, B * D)
    return relation.reshape(relation.shape[0], -1)


class _RspmmK1K2(torch.autograd.Function):
    """K1 forward, K2 backward (mul_rel) over a graph's ``Csr``. Flat
    operands: edge_weight [E], relation [R, F], x [V, F]."""

    @staticmethod
    def forward(ctx, csr, edge_weight, relation, x, mode):
        ctx.csr, ctx.mode = csr, mode
        ctx.save_for_backward(edge_weight, relation, x)
        return rspmm_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                              edge_weight, relation, x, mode)

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.mode != "mul_rel":
            raise NotImplementedError(
                "the transe (add_rel) rspmm backward is kernel K3, not "
                "ported yet")
        edge_weight, relation, x = ctx.saved_tensors
        need_dr, need_dx = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        dx, dr = rspmm_bwd_cuda(ctx.csr, edge_weight, relation, x,
                                grad_out.contiguous(), need_dx=need_dx,
                                need_dr=need_dr)
        return None, None, dr, dx, None


def generalized_rspmm(edge_index, edge_type, edge_weight, relation, x, *,
                      msg: str = "mul", agg: str = "add", num_nodes: int,
                      csr=None) -> torch.Tensor:
    """Relational SpMM with sum aggregation.

    edge_index [E, 2], edge_type [E], edge_weight [E] in original edge order;
    csr: the graph's ``Csr`` (data/graph.py), required on CUDA.
    Returns the layout of x with num_nodes rows. On CUDA, gradients flow to
    relation and x; an edge_weight that requires grad raises (the
    edge-gradient path of classic NBFNet is not ported yet).
    """
    if msg not in _MODES:
        raise NotImplementedError(
            f"msg={msg!r}: this slice ports mul and add; rotate comes with "
            "the other-aggregations slice (K8)")
    if agg != "add":
        raise NotImplementedError(
            f"agg={agg!r}: this slice ports sum aggregation; max/min come "
            "with the other-aggregations slice (K4-K7)")
    flat = x.dim() == 2
    xf = x if flat else x.reshape(x.shape[0], -1)
    rel = relation if flat else broadcast_rel_flat(relation, x.shape[1])
    mode = _MODES[msg]
    if x.device.type == "cpu":
        out = rspmm_plain_edges(edge_index[:, 0], edge_index[:, 1], edge_type,
                                edge_weight, rel, xf, mode, num_nodes)
    else:
        if csr is None:
            raise ValueError("the CUDA path needs the graph's CSR "
                             "(Graph.prepare_csr)")
        if csr.rowptr.numel() != num_nodes + 1:
            raise ValueError(f"CSR has {csr.rowptr.numel() - 1} rows, "
                             f"expected {num_nodes}")
        if edge_weight.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "gradients to edge weights (classic NBFNet's edge-gradient "
                "path) are not ported yet")
        out = _RspmmK1K2.apply(csr, edge_weight.contiguous(),
                               rel.contiguous(), xf.contiguous(), mode)
    return out if flat else out.reshape(num_nodes, *x.shape[1:])

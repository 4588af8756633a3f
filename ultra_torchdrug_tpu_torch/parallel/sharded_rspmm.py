"""The edge-partitioned sum rspmm with replicated node states (counterpart
of ultra_torchdrug_tpu/parallel/sharded_rspmm.py): the JAX package's
default path under an edge mesh, ``rspmm_impl`` auto/pallas, and its
``xla`` body.

Two bodies, as in the JAX package:

  * ``sharded_rspmm``, the ``xla`` body: the edges are padded to a
    multiple of n with weight-0 edges and cut into n contiguous ranges;
    each range is aggregated into a full [V, ...] partial by plain segment
    sums (the O(E) route of ops/rspmm.py, no kernel), and the partials are
    summed (the JAX package's psum). Its backward is the transposed
    partials: dx summed over shards, dr the per-shard segment sums summed.
  * ``partitioned_rspmm``, the kernel body: shard s owns the output rows
    [s * v_block, (s + 1) * v_block) (relabelled by a degree-balanced
    permutation when the contiguous split is hub-imbalanced) and runs
    kernel K1 (K1h with ``compute_dtype="bfloat16"``) over the CSR of the
    edges whose destination lies in its block, gathering from the
    replicated x; its backward runs K2 (K2h; K3 for transe) over the CSR
    of the edges whose source lies in its block, for its own dx rows and a
    d_relation partial, gathering from the replicated upstream gradient.
    The dr partials are summed over shards.

Each shard works on its own device (parallel/mesh.py; parallel/
placement.py) inside one autograd node whose operands and results live on
the home device (shard 0's): x (the upstream gradient in the backward),
the edge weight and the relation operand are copied to every shard device
(a tree of copies from the home), each shard's kernels run there on its
layouts, the output (dx) blocks come home to be concatenated, and the
d_relation partials are summed at home (the JAX package's psum); the
``xla`` body copies each shard's edge range to its device and sums the
[V, ...] partials at home. With every shard on one device the shards'
calls run one after another on it, each writing its own block of rows,
and nothing is copied. A shard without edges launches nothing and gives
zero rows. The
layouts are the port's ``Csr`` (data/graph.py), one per shard and family;
the TPU's chunk padding to a common count is not needed. A shard's
reverse CSR spans the v_block source rows of its block and every
destination row (``build_csr(..., num_src_nodes=v_block)``), so its
backward reads two row spaces: x and dx of v_block rows, the upstream
gradient of V rows, which the backward kernels index apart
(ops/rspmm_bwd_cuda.py::check_bwd_operands). K3's relation layout (the
JAX package's optional ``rel`` family) is the reverse CSR's (destination
tile, relation) chunks, which every backward CSR carries, so no third
family is built. No gradient flows to the edge weights, as in the JAX
package. Reference analogue: none (the reference replicates the graph on
every GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.graph import build_csr
from ..ops.rspmm import COMPUTE_DTYPES, aggregate_edges, broadcast_rel_flat
from ..ops.rspmm_bwd_cuda import rspmm_bwd_bf16_cuda, rspmm_bwd_cuda
from ..ops.rspmm_cuda import rspmm_fwd_bf16_cuda, rspmm_fwd_cuda
from .balance import degree_balanced_permutation, resolve_balance
from .placement import (
    add_partial,
    indexed,
    replicate,
    shard_devices,
    sum_home,
    zero_partial,
)

_MODES = {"mul": "mul_rel", "add": "add_rel"}


def _to(t, device):
    return None if t is None else t.to(device)


def _check_msg(msg: str):
    if msg not in _MODES:
        raise ValueError(f"msg must be one of {tuple(_MODES)}, got {msg!r}")


class _ShardedRspmm(torch.autograd.Function):
    """The ``xla`` body over n contiguous edge ranges: edge_index [E, 2],
    edge_type [E], edge_weight [E] (E a multiple of n), relation [R, D] or
    [R, B, D] with x [V, B, D], or flat [R, F] with x [V, F]; range s on
    ``devices[s]``."""

    @staticmethod
    def forward(ctx, edge_index, edge_type, edge_weight, relation, x, msg,
                num_nodes, n, devices):
        devs = shard_devices(devices, x.device)
        ctx.msg, ctx.n, ctx.devs = msg, n, devs
        ctx.save_for_backward(edge_index, edge_type, edge_weight, relation, x)
        rels, xs = replicate(relation, devs), replicate(x, devs)
        parts = {}
        for d, (lo, hi) in zip(devs, _ranges(edge_index.shape[0], n)):
            add_partial(parts, d, aggregate_edges(
                edge_index[lo:hi].to(d), edge_type[lo:hi].to(d),
                edge_weight[lo:hi].to(d), rels[d], xs[d], msg=msg, agg="add",
                num_nodes=num_nodes))
        return sum_home(parts, x.device)

    @staticmethod
    def backward(ctx, g):
        edge_index, edge_type, edge_weight, relation, x = ctx.saved_tensors
        need_dr, need_dx = ctx.needs_input_grad[3], ctx.needs_input_grad[4]
        devs = ctx.devs
        gs, rels = replicate(g, devs), replicate(relation, devs)
        xs = replicate(x, devs) if need_dr and ctx.msg == "mul" else None
        dx_parts, dr_parts = {}, {}
        for d, (lo, hi) in zip(devs, _ranges(edge_index.shape[0], ctx.n)):
            src, dst = (edge_index[lo:hi, i].to(d) for i in (0, 1))
            etype = edge_type[lo:hi].to(d)
            w = edge_weight[lo:hi].to(d).reshape((-1,) + (1,) * (g.dim() - 1))
            gw = gs[d].index_select(0, dst) * w
            if ctx.msg == "mul":
                rel_e = rels[d].index_select(0, etype)
                if rel_e.dim() < gw.dim():
                    rel_e = rel_e[:, None, :]
                dx_e = rel_e * gw if need_dx else None
                dr_e = xs[d].index_select(0, src) * gw if need_dr else None
            else:  # transe: the message's derivative is 1 in x and in rel
                dx_e = dr_e = gw
            if need_dx:
                zero_partial(dx_parts, gs[d], x.shape).index_add_(0, src,
                                                                  dx_e)
            if need_dr:
                zero_partial(dr_parts, rels[d], (relation.shape[0],)
                             + tuple(g.shape[1:])).index_add_(0, etype, dr_e)
        home = x.device
        dx = sum_home(dx_parts, home) if need_dx else None
        dr = sum_home(dr_parts, home) if need_dr else None
        if need_dr and relation.dim() < dr.dim():
            dr = dr.sum(dim=tuple(range(1, dr.dim() - relation.dim() + 1)))
        return None, None, None, dr, dx, None, None, None, None


def _ranges(num_edges: int, n: int):
    size = num_edges // n
    return [(s * size, (s + 1) * size) for s in range(n)]


def sharded_rspmm(edge_index, edge_type, edge_weight, relation, x, *,
                  msg: str, num_nodes: int, n_shards: int,
                  devices=None) -> torch.Tensor:
    """The sum rspmm over ``n_shards`` contiguous edge ranges, the JAX
    package's ``xla`` body (module docstring). edge_index [E, 2],
    edge_type [E], edge_weight [E] for any E (padded here with weight-0
    edges); relation [R, D] or [R, B, D] with x [V, B, D], or relation
    [R, F] with x [V, F]. ``devices``: each range's device (the mesh's;
    shard 0's is the operands'), x's for every range by default. Returns
    x's layout with num_nodes rows; gradients flow to relation and x."""
    _check_msg(msg)
    devices = (x.device,) * n_shards if devices is None else tuple(devices)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards, {len(devices)} devices")
    pad = (-edge_index.shape[0]) % n_shards
    if pad:
        edge_index = torch.cat([edge_index,
                                edge_index.new_zeros((pad, 2))])
        edge_type = torch.cat([edge_type, edge_type.new_zeros((pad,))])
        edge_weight = torch.cat([edge_weight,
                                 edge_weight.new_zeros((pad,))])
    return _ShardedRspmm.apply(
        edge_index, edge_type, edge_weight, relation, x, msg, int(num_nodes),
        int(n_shards), devices)


@dataclasses.dataclass(frozen=True)
class PartitionedRspmmLayouts:
    """The kernel body's per-shard layouts (the JAX package's stacked
    ``CsrLayout``s, here one ``Csr`` a shard):

      fwd[s]: the edges whose destination lies in block s; rows block-local
        over v_block rows, sources global (gathers from the replicated x)
      rev[s]: None unless built with ``backward``: the edges whose source
        lies in block s, with the backward's layouts; source rows
        block-local over v_block rows, destinations global (gathers from
        the replicated upstream gradient)
      fwd_counts, rev_counts: int [n], each shard's edges
      to_old: int64 [n * v_block] new row -> original node (empty slots ->
        the zero pad row ``num_nodes``), to_new: int64 [V] original -> new,
        relabelling the output row space only; None when blocks are
        contiguous original ids
      devices: each shard's device (``to_mesh``; built on the CPU):
        fwd[s] and rev[s] on devices[s], to_old and to_new on the home
        (devices[0])
    Every eid is global: per-batch edge weights stay one [E] tensor."""

    fwd: tuple
    rev: Optional[tuple]
    fwd_counts: np.ndarray
    rev_counts: np.ndarray
    to_old: Optional[torch.Tensor] = None
    to_new: Optional[torch.Tensor] = None
    v_block: int = 0
    n_shards: int = 1
    num_nodes: int = 0
    devices: tuple = ()

    @property
    def v_pad(self) -> int:
        return self.v_block * self.n_shards

    def to(self, device) -> "PartitionedRspmmLayouts":
        """Layouts whose shards share one device go to ``device`` whole;
        layouts spread over several devices keep their shards' devices and
        move only the home's index maps."""
        if len(set(self.devices)) == 1:
            return self.to_mesh((device,) * self.n_shards)
        return dataclasses.replace(self, to_old=_to(self.to_old, device),
                                   to_new=_to(self.to_new, device))

    def to_mesh(self, devices) -> "PartitionedRspmmLayouts":
        """Each shard's CSRs on its device ``devices[s]``, the index maps
        on the home (``devices[0]``); nothing is copied where a layout
        lies on its device already."""
        devices = tuple(indexed(d) for d in devices)
        if len(devices) != self.n_shards:
            raise ValueError(f"{self.n_shards} shards, {len(devices)} "
                             "devices")

        def move(family):
            return None if family is None else tuple(
                c.to(d) for c, d in zip(family, devices))

        return dataclasses.replace(self, fwd=move(self.fwd),
                                   rev=move(self.rev),
                                   to_old=_to(self.to_old, devices[0]),
                                   to_new=_to(self.to_new, devices[0]),
                                   devices=devices)


def build_partitioned_rspmm_inputs(edge_index, edge_type, num_nodes: int,
                                   num_relations: int, n_shards: int,
                                   backward: bool = True,
                                   balance="auto") -> PartitionedRspmmLayouts:
    """Host-side build of the per-shard layouts (numpy; every shard's on
    the CPU).
    Shard s owns output rows [s * v_block, (s + 1) * v_block), v_block =
    ceil(V / n): its forward CSR holds the edges whose destination lands
    in the block, its reverse CSR (with ``backward``) those whose source
    does, each in edge order within a row. ``balance``: True, False or
    "auto" (relabel the output row space with a degree-balanced
    permutation, parallel/balance.py, when contiguous blocks are
    hub-imbalanced); gathers keep reading x and the gradient in original
    order."""
    ei = np.asarray(edge_index)
    et = np.asarray(edge_type, np.int64)
    src, dst = ei[:, 0].astype(np.int64), ei[:, 1].astype(np.int64)
    n = int(n_shards)
    vb = -(-num_nodes // n)
    to_new = to_old = None
    row_src, row_dst = src, dst  # the output-row keys, relabelled or not
    if resolve_balance(balance, src, dst, num_nodes, n):
        to_new, to_old = degree_balanced_permutation(src, dst, num_nodes, n)
        row_src = to_new[src].astype(np.int64)
        row_dst = to_new[dst].astype(np.int64)

    def shard_edges(row_key):
        return [np.flatnonzero(row_key // vb == s) for s in range(n)]

    fwd_ids = shard_edges(row_dst)
    fwd = tuple(build_csr(src[ids], row_dst[ids] - s * vb, et[ids], vb,
                          num_relations, edge_ids=ids)
                for s, ids in enumerate(fwd_ids))
    rev, rev_ids = None, [np.zeros(0, np.int64)] * n
    if backward:
        rev_ids = shard_edges(row_src)
        rev = tuple(build_csr(row_src[ids] - s * vb, dst[ids], et[ids],
                              num_nodes, num_relations, backward=True,
                              edge_ids=ids, num_src_nodes=vb)
                    for s, ids in enumerate(rev_ids))

    def long(a):
        return None if a is None else torch.from_numpy(a.astype(np.int64))

    return PartitionedRspmmLayouts(
        fwd=fwd, rev=rev,
        fwd_counts=np.array([len(i) for i in fwd_ids], np.int64),
        rev_counts=np.array([len(i) for i in rev_ids], np.int64),
        to_old=long(to_old), to_new=long(to_new), v_block=vb, n_shards=n,
        num_nodes=int(num_nodes), devices=(torch.device("cpu"),) * n)


def _from_blocks(layouts: PartitionedRspmmLayouts, rows: torch.Tensor):
    """Block-domain rows [v_pad, F] -> original order [V, F]."""
    if layouts.to_new is None:
        return rows[:layouts.num_nodes]
    return rows[layouts.to_new]


class _PartitionedRspmm(torch.autograd.Function):
    """The kernel body over flat operands: edge_weight [E], relation
    [R, F], x [V, F]; returns [V, F]. K1 (K1h) a shard forward, K2 (K2h,
    or K3 for ``add_rel``) a shard backward, each on its shard's device,
    both skipping shards without edges; no gradient to edge_weight."""

    @staticmethod
    def forward(ctx, layouts, edge_weight, relation, x, mode, bf16):
        ctx.layouts, ctx.mode, ctx.bf16 = layouts, mode, bf16
        ctx.save_for_backward(edge_weight, relation,
                              x if mode == "mul_rel" else None)
        fwd = rspmm_fwd_bf16_cuda if bf16 else rspmm_fwd_cuda
        vb, home = layouts.v_block, x.device
        devs = shard_devices(layouts.devices, home)
        xs, ws, rels = (replicate(t, devs) for t in (x, edge_weight,
                                                     relation))
        blocks = []
        for s, (c, d) in enumerate(zip(layouts.fwd, devs)):
            if not layouts.fwd_counts[s]:
                blocks.append(x.new_zeros((vb, x.shape[1])))
                continue
            blocks.append(fwd(c.rowptr, c.src, c.etype, c.eid, ws[d],
                              rels[d], xs[d], mode,
                              segments=c.segments).to(home))
        return _from_blocks(layouts, torch.cat(blocks))

    @staticmethod
    def backward(ctx, grad_out):
        edge_weight, relation, x = ctx.saved_tensors
        layouts = ctx.layouts
        if layouts.rev is None:
            raise ValueError("the partitioned layouts have no reverse CSRs: "
                             "build them with backward=True "
                             "(Graph.prepare_csr_sharded)")
        need_dr, need_dx = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        g = grad_out.contiguous()
        vb, F, home = layouts.v_block, g.shape[1], g.device
        devs = shard_devices(layouts.devices, home)
        gs, ws, rels = (replicate(t, devs) for t in (g, edge_weight,
                                                     relation))
        x_blocks = None
        if x is not None:  # K3 (transe) reads no x
            x_blocks = torch.cat([x, x.new_zeros((layouts.v_pad - x.shape[0],
                                                  F))])
            if layouts.to_old is not None:
                x_blocks = x_blocks[layouts.to_old]
        dx_blocks, dr_parts = [], {}
        for s, (c, d) in enumerate(zip(layouts.rev, devs)):
            if not layouts.rev_counts[s]:
                dx_blocks.append(g.new_zeros((vb, F)))
                continue
            x_s = (None if x_blocks is None
                   else x_blocks[s * vb:(s + 1) * vb].to(d))
            if ctx.bf16 and ctx.mode == "mul_rel":
                dx_s, dr_s = rspmm_bwd_bf16_cuda(c, ws[d], rels[d], x_s,
                                                 gs[d], need_dx, need_dr)
            else:
                dx_s, dr_s = rspmm_bwd_cuda(c, ws[d], rels[d], x_s, gs[d],
                                            need_dx=need_dx, need_dr=need_dr,
                                            mode=ctx.mode)
            dx_blocks.append(None if dx_s is None else dx_s.to(home))
            if need_dr:
                add_partial(dr_parts, d, dr_s)
        dr = sum_home(dr_parts, home) if need_dr else None
        if need_dr and dr is None:  # no shard has an edge
            dr = torch.zeros_like(relation)
        dx = _from_blocks(layouts, torch.cat(dx_blocks)) if need_dx else None
        return None, None, dr, dx, None, None


def partitioned_rspmm(edge_weight, layouts: PartitionedRspmmLayouts,
                      relation, x, *, msg: str,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """The sum rspmm through the kernels with destination/source row-block
    partitioning (module docstring). edge_weight [E] in original edge
    order; relation [R, F], [R, D] shared or [R, B, D] per batch; x flat
    [V, F] or [V, B, D]. Returns the layout of x. ``compute_dtype=
    "bfloat16"`` runs K1h and K2h (transe's backward K3 stays fp32), as
    the single-device op does."""
    _check_msg(msg)
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    shape = x.shape
    if shape[0] != layouts.num_nodes:
        raise ValueError(f"x has {shape[0]} rows, the graph "
                         f"{layouts.num_nodes} nodes")
    xf = x.reshape(shape[0], -1)
    rel = (relation if x.dim() == 2 and relation.dim() == 2
           else broadcast_rel_flat(relation, shape[1]))
    out = _PartitionedRspmm.apply(layouts, edge_weight.contiguous(),
                                  rel.contiguous(), xf.contiguous(),
                                  _MODES[msg], compute_dtype == "bfloat16")
    return out.reshape(shape)

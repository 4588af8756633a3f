"""The ring-pipelined edge-partitioned rspmm (counterpart of
ultra_torchdrug_tpu/parallel/ring_rspmm.py): sums, extrema, PNA's extremum
pair and its moments.

Node rows are split into n contiguous blocks of v_block = ceil(V/n) rows,
one per edge shard of the mesh (parallel/mesh.py). Shard s owns output block
s and the edges whose destination lies in it, bucketed host-side by the
block of their source. The op runs n ring steps: at step k shard s holds x
block (s - k) mod n, adds its bucket for that block into its own output
block, and passes the held block to its right neighbour (the ring shift:
``ppermute``, or kernel K9 with ``exchange="rdma"``, parallel/rdma.py). No
shard ever needs more than its own block and the one it holds.

The backward is the transposed ring: shard s owns dx block s (the edges whose
source lies in it) and rotates the upstream gradient's blocks with the
mirrored bucket family; each step's d_relation partial uses the shard's own x
block, and the partials are summed over shards (the JAX package's psum).

In this port every shard lives on the mesh's one device: the n blocks are
row blocks of one [n * v_block, F] tensor, and each shard's work is one
call per bucket. With per-bucket CSRs (``build_ring_rspmm_inputs(pallas=
True)``) and distmult messages each step runs kernel K1 per bucket forward
and K2 per bucket backward (K1h and K2h with ``compute_dtype="bfloat16"``),
skipping buckets without edges, as the JAX package runs its Pallas kernels
per bucket. Otherwise (transe, or no CSRs) a step gathers and scatters the
bucket arrays in plain PyTorch, as the JAX package runs XLA segment ops.

The other schedules are the JAX package's XLA segment ops, in plain
PyTorch here (``scatter_reduce``, ``index_add_``) over the same buckets,
each an autograd node over block-domain operands with the same exchanges:

  * ``ring_rspmm(agg="max"|"min")``: each step folds its bucket's
    extrema into the owner's rows; padding edges are neutral, a real
    weight-0 edge sends the message 0, a row without edges gives 0. The
    backward rotates the upstream gradient and the saved extremum together
    through the transposed ring, and every edge whose recomputed message
    equals the extremum takes all of the gradient (the kernels'
    convention, not XLA's sharing among ties).
  * ``ring_rspmm_maxmin``: both extrema of one rotation; the backward
    rotates the four planes (g_max, max, g_min, min) through one
    transposed ring.
  * ``ring_rspmm_addsq`` (distmult): Σ w·m and Σ w·m² of one rotation; the
    backward rotates (g_s, g_sq) and both gradients factor through
    w·g_s + 2m·w·g_sq.

The planes that rotate together are packed side by side into one
[n * v_block, k * F] tensor once, so that each step shifts them in one
exchange (one K9 launch with ``rdma``). Not ported yet (ROADMAP Queue 1
item 9): shards on several cards. Reference analogue: none (the reference
replicates the graph on every GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.graph import build_csr
from ..ops.rspmm import COMPUTE_DTYPES, broadcast_rel_flat
from ..ops.rspmm_bwd_cuda import rspmm_bwd_bf16_cuda, rspmm_bwd_cuda
from ..ops.rspmm_cuda import rspmm_fwd_bf16_cuda, rspmm_fwd_cuda
from .balance import degree_balanced_permutation, resolve_balance
from .rdma import ring_shift, ring_shift_plain

EXCHANGES = ("ppermute", "rdma")
_MODES = {"mul": "mul_rel", "add": "add_rel"}


def _to(t, device):
    return None if t is None else t.to(device)


@dataclasses.dataclass(frozen=True)
class RingBuckets:
    """One direction's edge buckets, int64 arrays [n, n, Emax] indexed
    [owner block, held block, edge]: ``gather_local`` indexes the held
    block, ``out_local`` the owner's block, ``edge_id`` is global (the
    weight's index); ``valid`` (float32) is 0 on padding."""

    gather_local: torch.Tensor
    out_local: torch.Tensor
    etype: torch.Tensor
    edge_id: torch.Tensor
    valid: torch.Tensor

    def to(self, device) -> "RingBuckets":
        return RingBuckets(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class RingRspmmInputs:
    """The ring path's host-built inputs.

      fwd: owner = destination block, held = source block (the x ring)
      rev: owner = source block, held = destination block (the g ring)
      csr: None, or csr[i][j] — the ``Csr`` (data/graph.py) of the edges
        whose destination lies in block i and source in block j, over
        block-local rows and gather indices, global eid, with the backward
        layouts when built with ``backward``. The forward's bucket (s, b) is
        csr[s][b], the backward's bucket (s, b) csr[b][s].
      edge_counts: int [n, n], the edges of csr[i][j]
      to_old: int64 [n * v_block] new row -> original node (empty slots ->
        the zero pad row ``num_nodes``), to_new: int64 [V] original -> new;
        None when blocks are contiguous original ids
      permuted_io: the caller keeps node states in the padded block domain
        ([n * v_block] rows, relabelled when balanced) for the whole
        propagation; the op then takes and returns block-domain rows
    """

    fwd: RingBuckets
    rev: RingBuckets
    csr: Optional[tuple] = None
    edge_counts: Optional[np.ndarray] = None
    to_old: Optional[torch.Tensor] = None
    to_new: Optional[torch.Tensor] = None
    v_block: int = 0
    n_shards: int = 1
    num_nodes: int = 0
    permuted_io: bool = False

    @property
    def v_pad(self) -> int:
        return self.v_block * self.n_shards

    @property
    def nonempty_buckets(self) -> int:
        """Buckets with edges: the kernel calls of one ring pass."""
        return int(np.count_nonzero(self.edge_counts))

    def to(self, device) -> "RingRspmmInputs":
        csr = None if self.csr is None else tuple(
            tuple(c.to(device) for c in row) for row in self.csr)
        return dataclasses.replace(
            self, fwd=self.fwd.to(device), rev=self.rev.to(device), csr=csr,
            to_old=_to(self.to_old, device), to_new=_to(self.to_new, device))


def build_ring_rspmm_inputs(edge_index, edge_type, num_nodes: int,
                            n_shards: int, num_relations: Optional[int] = None,
                            pallas: bool = False, balance=False,
                            permuted_io: bool = False,
                            backward: bool = True) -> RingRspmmInputs:
    """Host-side bucket build (numpy; CPU tensors out).

    Buckets are padded to the largest (owner, held) pair, rounded up to a
    multiple of 8, as in the JAX package. ``balance`` (True, False or
    "auto") relabels node ids with a degree-balanced permutation
    (parallel/balance.py); with ``permuted_io`` the caller owns the block
    domain, so the relabelling costs no gathers inside the op. ``pallas``
    also builds the per-bucket CSRs (``RingRspmmInputs.csr``) over
    ``num_relations`` relations (default: the largest type + 1), with the
    backward's layouts when ``backward``."""
    ei = np.asarray(edge_index)
    et = np.asarray(edge_type, np.int64)
    src, dst = ei[:, 0].astype(np.int64), ei[:, 1].astype(np.int64)
    n = int(n_shards)
    vb = -(-num_nodes // n)
    if num_relations is None:
        num_relations = int(et.max()) + 1 if len(et) else 1

    to_new = to_old = None
    if resolve_balance(balance, src, dst, num_nodes, n):
        to_new, to_old = degree_balanced_permutation(src, dst, num_nodes, n)
        src, dst = to_new[src].astype(np.int64), to_new[dst].astype(np.int64)

    # the edges of each (destination block i, source block j) pair, in edge
    # order: the forward's bucket (i, j) and the backward's bucket (j, i)
    dst_blk, src_blk = dst // vb, src // vb
    pair = [[np.nonzero((dst_blk == i) & (src_blk == j))[0] for j in range(n)]
            for i in range(n)]
    counts = np.array([[len(ids) for ids in row] for row in pair], np.int64)
    emax = -(-max(1, int(counts.max(initial=0))) // 8) * 8

    def family(owner_dst: bool) -> RingBuckets:
        arrays = {k: np.zeros((n, n, emax), np.int64)
                  for k in ("gather_local", "out_local", "etype", "edge_id")}
        valid = np.zeros((n, n, emax), np.float32)
        for s in range(n):
            for b in range(n):
                ids = pair[s][b] if owner_dst else pair[b][s]
                gather, out = (src, dst) if owner_dst else (dst, src)
                m = len(ids)
                arrays["gather_local"][s, b, :m] = gather[ids] - b * vb
                arrays["out_local"][s, b, :m] = out[ids] - s * vb
                arrays["etype"][s, b, :m] = et[ids]
                arrays["edge_id"][s, b, :m] = ids
                valid[s, b, :m] = 1.0
        return RingBuckets(
            **{k: torch.from_numpy(a) for k, a in arrays.items()},
            valid=torch.from_numpy(valid))

    csr = None
    if pallas:
        csr = tuple(
            tuple(build_csr(src[ids] - j * vb, dst[ids] - i * vb, et[ids], vb,
                            num_relations, backward, edge_ids=ids)
                  for j, ids in enumerate(row))
            for i, row in enumerate(pair))

    def long(a):
        return None if a is None else torch.from_numpy(a.astype(np.int64))

    return RingRspmmInputs(
        fwd=family(owner_dst=True), rev=family(owner_dst=False), csr=csr,
        edge_counts=counts, to_old=long(to_old), to_new=long(to_new),
        v_block=vb, n_shards=n, num_nodes=int(num_nodes),
        permuted_io=permuted_io)


def _rotate(exchange: str, n: int):
    """The boundary transport of one ring step, shard s -> s + 1 (mod n):
    ``ppermute`` the plain shift, ``rdma`` kernel K9 (its plain version on
    CPU tensors)."""
    if exchange == "rdma":
        return lambda t: ring_shift(t, n)
    if exchange == "ppermute":
        return lambda t: ring_shift_plain(t, n)
    raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")


def _step_buckets(buckets: RingBuckets, k: int, n: int, vb: int):
    """Step k's bucket of every shard s (held block (s - k) mod n), as flat
    rows of the block-stacked [n * v_block] domain: (gather rows, out rows,
    etype, edge_id, valid), each [n * Emax]."""
    shards = torch.arange(n, device=buckets.valid.device)
    held = (shards - k) % n
    offset = (shards * vb)[:, None]
    return ((buckets.gather_local[shards, held] + offset).reshape(-1),
            (buckets.out_local[shards, held] + offset).reshape(-1),
            buckets.etype[shards, held].reshape(-1),
            buckets.edge_id[shards, held].reshape(-1),
            buckets.valid[shards, held].reshape(-1))


def _ring_forward(inputs: RingRspmmInputs, edge_weight, relation, x, msg,
                  exchange, bf16):
    n, vb = inputs.n_shards, inputs.v_block
    rotate = _rotate(exchange, n)
    kernels = inputs.csr is not None and msg == "mul"
    out = x.new_zeros((inputs.v_pad, x.shape[1]), dtype=torch.float32)
    held = x
    for k in range(n):
        if kernels:
            for s in range(n):
                b = (s - k) % n
                if not inputs.edge_counts[s, b]:
                    continue  # no edges: the bucket adds nothing
                c = inputs.csr[s][b]
                rows = slice(s * vb, (s + 1) * vb)
                args = (c.rowptr, c.src, c.etype, c.eid, edge_weight,
                        relation, held[rows], "mul_rel")
                fwd = rspmm_fwd_bf16_cuda if bf16 else rspmm_fwd_cuda
                out[rows] += fwd(*args, segments=c.segments)
        else:
            g_rows, o_rows, etype, eid, valid = _step_buckets(inputs.fwd, k,
                                                              n, vb)
            w = edge_weight[eid] * valid
            rel_e, x_e = relation[etype], held[g_rows]
            m = rel_e * x_e if msg == "mul" else rel_e + x_e
            out.index_add_(0, o_rows, m * w[:, None])
        if k + 1 < n:
            # consumed only at the next step
            held = rotate(held)
    return out


def _ring_backward(inputs: RingRspmmInputs, edge_weight, relation, x, g, msg,
                   exchange, bf16, need_dx, need_dr):
    n, vb = inputs.n_shards, inputs.v_block
    rotate = _rotate(exchange, n)
    kernels = inputs.csr is not None and msg == "mul"
    dx = g.new_zeros((inputs.v_pad, g.shape[1])) if need_dx else None
    dr = relation.new_zeros(relation.shape) if need_dr else None
    held = g
    for k in range(n):
        if kernels:
            for s in range(n):
                b = (s - k) % n
                # the backward's bucket (s, b): source block s, destination
                # block b, i.e. the forward's pair csr[b][s]
                if not inputs.edge_counts[b, s]:
                    continue
                rows = slice(s * vb, (s + 1) * vb)
                args = (inputs.csr[b][s], edge_weight, relation, x[rows],
                        held[rows], need_dx, need_dr)
                dx_p, dr_p = (rspmm_bwd_bf16_cuda(*args) if bf16
                              else rspmm_bwd_cuda(*args, mode="mul_rel"))
                if need_dx:
                    dx[rows] += dx_p
                if need_dr:
                    dr += dr_p
        else:
            g_rows, o_rows, etype, eid, valid = _step_buckets(inputs.rev, k,
                                                              n, vb)
            gw = held[g_rows] * (edge_weight[eid] * valid)[:, None]
            if msg == "mul":
                dx_e = relation[etype] * gw if need_dx else None
                dr_e = x[o_rows] * gw if need_dr else None
            else:  # transe: the message's derivative is 1 in x and in rel
                dx_e = dr_e = gw
            if need_dx:
                dx.index_add_(0, o_rows, dx_e)
            if need_dr:
                dr.index_add_(0, etype, dr_e)
        if k + 1 < n:
            held = rotate(held)
    return dx, dr


class _RingRspmm(torch.autograd.Function):
    """The ring over block-domain operands: edge_weight [E], relation
    [R, F], x [n * v_block, F]; returns [n * v_block, F]. No gradient flows
    to edge_weight (the JAX package's ring returns zeros there)."""

    @staticmethod
    def forward(ctx, inputs, edge_weight, relation, x, msg, exchange, bf16):
        ctx.inputs, ctx.msg, ctx.exchange, ctx.bf16 = (inputs, msg, exchange,
                                                       bf16)
        ctx.save_for_backward(edge_weight, relation, x)
        return _ring_forward(inputs, edge_weight, relation, x, msg, exchange,
                             bf16)

    @staticmethod
    def backward(ctx, grad_out):
        edge_weight, relation, x = ctx.saved_tensors
        dx, dr = _ring_backward(
            ctx.inputs, edge_weight, relation, x, grad_out.contiguous(),
            ctx.msg, ctx.exchange, ctx.bf16,
            need_dx=ctx.needs_input_grad[3], need_dr=ctx.needs_input_grad[2])
        return None, None, dr, dx, None, None, None


_BIG = 1e30  # the JAX package's neutral value of an extremum
_REDUCE = {"max": "amax", "min": "amin"}


def _messages(relation, etype, rows, msg):
    rel_e = relation[etype]
    return rel_e * rows if msg == "mul" else rel_e + rows


def _fold_extremum(out, o_rows, mw, valid, agg):
    """Fold one step's weighted messages mw [k, F] into out [v_pad, F] by
    their owner rows, padding edges neutral."""
    neutral = -_BIG if agg == "max" else _BIG
    mw = torch.where(valid[:, None] > 0, mw, neutral)
    index = o_rows[:, None].expand_as(mw)
    return out.scatter_reduce_(0, index, mw, _REDUCE[agg], include_self=True)


def _empty_to_zero(out, agg):
    """Rows that no edge reached keep the neutral value: they give 0."""
    empty = out <= -_BIG / 2 if agg == "max" else out >= _BIG / 2
    return out.masked_fill_(empty, 0.0)


def _ring_pass(inputs, planes, exchange, step):
    """Run ``step(g_rows, o_rows, etype, eid, valid, held)`` for the n
    steps of the transposed ring, ``held`` the packed ``planes`` that
    shard s holds at step k (block (s - k) mod n), shifted between steps
    by one exchange."""
    n, vb = inputs.n_shards, inputs.v_block
    rotate = _rotate(exchange, n)
    held = planes[0] if len(planes) == 1 else torch.cat(planes, dim=1)
    for k in range(n):
        step(*_step_buckets(inputs.rev, k, n, vb), held)
        if k + 1 < n:
            held = rotate(held)


def _ring_messages_pass(inputs, edge_weight, relation, x, msg, exchange,
                        step):
    """The forward ring: ``step(o_rows, m, w, valid)`` for each step's
    messages m (unweighted) of every shard's bucket, x rotating."""
    n, vb = inputs.n_shards, inputs.v_block
    rotate = _rotate(exchange, n)
    held = x
    for k in range(n):
        g_rows, o_rows, etype, eid, valid = _step_buckets(inputs.fwd, k, n,
                                                          vb)
        m = _messages(relation, etype, held[g_rows], msg)
        step(o_rows, m, (edge_weight[eid] * valid)[:, None], valid)
        if k + 1 < n:
            held = rotate(held)


def _gated_backward(inputs, edge_weight, relation, x, planes, msg, exchange,
                    need_dx, need_dr):
    """The extrema's transposed ring: planes (g, out) per extremum, each
    edge's coefficient the sum of w·g over the extrema that its recomputed
    weighted message equals. Returns (dx, dr)."""
    F = x.shape[1]
    dx = x.new_zeros(x.shape) if need_dx else None
    dr = relation.new_zeros(relation.shape) if need_dr else None

    def step(g_rows, o_rows, etype, eid, valid, held):
        w = (edge_weight[eid] * valid)[:, None]
        rel_e, x_e = relation[etype], x[o_rows]
        mw = (rel_e * x_e if msg == "mul" else rel_e + x_e) * w
        rows = held[g_rows]
        c = None
        for i in range(0, len(planes), 2):
            g_e = rows[:, i * F:(i + 1) * F]
            gate = (mw == rows[:, (i + 1) * F:(i + 2) * F]).to(g_e.dtype)
            c = g_e * gate if c is None else c + g_e * gate
        c = c * w
        if need_dx:
            dx.index_add_(0, o_rows, rel_e * c if msg == "mul" else c)
        if need_dr:
            dr.index_add_(0, etype, x_e * c if msg == "mul" else c)

    _ring_pass(inputs, planes, exchange, step)
    return dx, dr


class _RingExtremum(torch.autograd.Function):
    """The ring's max or min over block-domain operands: edge_weight [E],
    relation [R, F], x [n * v_block, F]; returns [n * v_block, F]. No
    gradient flows to edge_weight."""

    @staticmethod
    def forward(ctx, inputs, edge_weight, relation, x, msg, agg, exchange):
        out = x.new_full((inputs.v_pad, x.shape[1]),
                         -_BIG if agg == "max" else _BIG)
        _ring_messages_pass(
            inputs, edge_weight, relation, x, msg, exchange,
            lambda o_rows, m, w, valid: _fold_extremum(out, o_rows, m * w,
                                                       valid, agg))
        out = _empty_to_zero(out, agg)
        ctx.inputs, ctx.msg, ctx.exchange = inputs, msg, exchange
        ctx.save_for_backward(edge_weight, relation, x, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        edge_weight, relation, x, out = ctx.saved_tensors
        dx, dr = _gated_backward(ctx.inputs, edge_weight, relation, x,
                                 (grad_out, out), ctx.msg, ctx.exchange,
                                 ctx.needs_input_grad[3],
                                 ctx.needs_input_grad[2])
        return None, None, dr, dx, None, None, None


class _RingMaxMin(torch.autograd.Function):
    """Both extrema of one rotation over block-domain operands; returns
    (max, min), each [n * v_block, F]."""

    @staticmethod
    def forward(ctx, inputs, edge_weight, relation, x, msg, exchange):
        shape = (inputs.v_pad, x.shape[1])
        mx, mn = x.new_full(shape, -_BIG), x.new_full(shape, _BIG)

        def step(o_rows, m, w, valid):
            mw = m * w
            _fold_extremum(mx, o_rows, mw, valid, "max")
            _fold_extremum(mn, o_rows, mw, valid, "min")

        _ring_messages_pass(inputs, edge_weight, relation, x, msg, exchange,
                            step)
        mx, mn = _empty_to_zero(mx, "max"), _empty_to_zero(mn, "min")
        ctx.inputs, ctx.msg, ctx.exchange = inputs, msg, exchange
        ctx.save_for_backward(edge_weight, relation, x, mx, mn)
        return mx, mn

    @staticmethod
    def backward(ctx, g_mx, g_mn):
        edge_weight, relation, x, mx, mn = ctx.saved_tensors
        planes = (g_mx.contiguous(), mx, g_mn.contiguous(), mn)
        dx, dr = _gated_backward(ctx.inputs, edge_weight, relation, x, planes,
                                 ctx.msg, ctx.exchange,
                                 ctx.needs_input_grad[3],
                                 ctx.needs_input_grad[2])
        return None, None, dr, dx, None, None


class _RingAddSq(torch.autograd.Function):
    """Σ w·m and Σ w·m² of one rotation, distmult, over block-domain
    operands; returns (s, sq), each [n * v_block, F]."""

    @staticmethod
    def forward(ctx, inputs, edge_weight, relation, x, exchange):
        s = x.new_zeros((inputs.v_pad, x.shape[1]))
        sq = torch.zeros_like(s)

        def step(o_rows, m, w, valid):
            mw = m * w
            s.index_add_(0, o_rows, mw)
            sq.index_add_(0, o_rows, m * mw)

        _ring_messages_pass(inputs, edge_weight, relation, x, "mul", exchange,
                            step)
        ctx.inputs, ctx.exchange = inputs, exchange
        ctx.save_for_backward(edge_weight, relation, x)
        return s, sq

    @staticmethod
    def backward(ctx, g_s, g_sq):
        edge_weight, relation, x = ctx.saved_tensors
        need_dr, need_dx = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        F = x.shape[1]
        dx = x.new_zeros(x.shape) if need_dx else None
        dr = relation.new_zeros(relation.shape) if need_dr else None

        def step(g_rows, o_rows, etype, eid, valid, held):
            w = (edge_weight[eid] * valid)[:, None]
            rel_e, x_e = relation[etype], x[o_rows]
            rows = held[g_rows]
            inner = rows[:, :F] * w + (2.0 * (rel_e * x_e)) * (rows[:, F:]
                                                              * w)
            if need_dx:
                dx.index_add_(0, o_rows, rel_e * inner)
            if need_dr:
                dr.index_add_(0, etype, x_e * inner)

        _ring_pass(ctx.inputs, (g_s.contiguous(), g_sq.contiguous()),
                   ctx.exchange, step)
        return None, None, dr, dx, None


def _check_ring_args(msg, exchange, compute_dtype="float32"):
    if msg not in _MODES:
        raise ValueError(f"msg must be one of {tuple(_MODES)}, got {msg!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, got "
                         f"{exchange!r}")


def _to_blocks(inputs: RingRspmmInputs, relation, x):
    """(relation [R, F], x as block-domain rows [n * v_block, F]) from the
    caller's operands: x flat [rows, F] or [rows, B, D], with rows = n *
    v_block when ``inputs.permuted_io``, else V original rows (padded and
    relabelled here)."""
    shape = x.shape
    xf = x.reshape(shape[0], -1)
    rel = (relation if x.dim() == 2 and relation.dim() == 2
           else broadcast_rel_flat(relation, shape[1]))
    if inputs.permuted_io:
        if shape[0] != inputs.v_pad:
            raise ValueError(f"permuted_io: x has {shape[0]} rows, the block "
                             f"domain {inputs.v_pad}")
        return rel.contiguous(), xf.contiguous()
    if shape[0] != inputs.num_nodes:
        raise ValueError(f"x has {shape[0]} rows, the graph "
                         f"{inputs.num_nodes} nodes")
    blocks = torch.cat([xf, xf.new_zeros((inputs.v_pad - shape[0],
                                          xf.shape[1]))])
    if inputs.to_old is not None:
        blocks = blocks[inputs.to_old]
    return rel.contiguous(), blocks.contiguous()


def _from_blocks(inputs: RingRspmmInputs, out, shape):
    """Block-domain rows back to the caller's layout ``shape`` (and to
    original order unless ``inputs.permuted_io``)."""
    if not inputs.permuted_io:
        out = (out[:inputs.num_nodes] if inputs.to_new is None
               else out[inputs.to_new])
    return out.reshape(out.shape[0], *shape[1:])


def ring_rspmm(edge_weight, inputs: RingRspmmInputs, relation, x, *,
               msg: str, agg: str = "add", compute_dtype: str = "float32",
               exchange: str = "ppermute") -> torch.Tensor:
    """The ring rspmm (module docstring), sum, max or min aggregation.

    edge_weight [E] in original edge order; relation [R, F], [R, D] shared
    or [R, B, D] per batch; x flat [rows, F] or [rows, B, D], with rows = n *
    v_block block-domain rows when ``inputs.permuted_io``, else V original
    rows (padded and relabelled on entry, mapped back on exit). Returns the
    layout of x. ``compute_dtype="bfloat16"`` runs K1h/K2h on the sums'
    kernel route (distmult with per-bucket CSRs) and changes nothing on the
    plain one or for max and min, as in the JAX package. ``exchange``:
    "ppermute" (the plain shift) or "rdma" (K9 on CUDA tensors)."""
    _check_ring_args(msg, exchange, compute_dtype)
    if agg not in ("add", "max", "min"):
        raise ValueError(f"agg must be one of ('add', 'max', 'min'), got "
                         f"{agg!r}")
    rel, blocks = _to_blocks(inputs, relation, x)
    if agg == "add":
        out = _RingRspmm.apply(inputs, edge_weight, rel, blocks, msg,
                               exchange, compute_dtype == "bfloat16")
    else:
        out = _RingExtremum.apply(inputs, edge_weight, rel, blocks, msg, agg,
                                  exchange)
    return _from_blocks(inputs, out, x.shape)


def ring_rspmm_maxmin(edge_weight, inputs: RingRspmmInputs, relation, x, *,
                      msg: str, exchange: str = "ppermute") -> tuple:
    """PNA's extremum pair over one ring rotation: (max, min) of each row's
    weighted messages, shapes and layouts as ``ring_rspmm``'s."""
    _check_ring_args(msg, exchange)
    rel, blocks = _to_blocks(inputs, relation, x)
    pair = _RingMaxMin.apply(inputs, edge_weight, rel, blocks, msg, exchange)
    return tuple(_from_blocks(inputs, o, x.shape) for o in pair)


def ring_rspmm_addsq(edge_weight, inputs: RingRspmmInputs, relation, x, *,
                     exchange: str = "ppermute") -> tuple:
    """PNA's moments of distmult messages over one ring rotation: (Σ w·m,
    Σ w·m²), m = rel ⊙ x, shapes and layouts as ``ring_rspmm``'s."""
    _check_ring_args("mul", exchange)
    rel, blocks = _to_blocks(inputs, relation, x)
    pair = _RingAddSq.apply(inputs, edge_weight, rel, blocks, exchange)
    return tuple(_from_blocks(inputs, o, x.shape) for o in pair)

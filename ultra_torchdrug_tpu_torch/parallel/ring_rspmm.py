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

Each shard works on its own device (parallel/mesh.py). Each op is one
autograd node over the node states as one tensor a card
(parallel/card_rows.py: the rows of the card's shards), its separate
inputs and outputs, so that x, the output and their gradients stay on
the shards' cards: the held blocks start as views of x's, the owner's
output block is a view of its card's output, both stay there for all n
steps, and the exchange moves the held blocks device to device. The
backward takes the upstream gradient a card and returns dx a card. The
edge weight and the relation operand stay on the home (shard 0's
device) and are copied to each shard device once an op; the d_relation
partials are summed there (parallel/placement.py). The entity tower
keeps its block-domain states on the cards (``CardRows``) for the whole
propagation; a caller that passes a home tensor has it cut to the cards
at entry and the results brought home at exit, outside the node. With
per-bucket CSRs (``build_ring_rspmm_inputs(pallas=True)``) and distmult
messages each step runs kernel K1 per bucket forward and K2 per bucket
backward (K1h and K2h with ``compute_dtype="bfloat16"``) on the shard's
device, skipping buckets without edges, as the JAX package runs its
Pallas kernels per bucket. Otherwise (transe, or no CSRs) a step gathers
and scatters the bucket's arrays in plain PyTorch, as the JAX package runs
XLA segment ops. The layouts keep each shard's buckets and CSRs on its
device (``RingRspmmInputs.to_mesh``; built on the CPU). With every shard
on one device the blocks are views of one tensor, one K9 launch shifts
all of them, and the schedule is the single-device one.

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
exchange (one K9 launch a source device with ``rdma``). Reference
analogue: none (the reference replicates the graph on every GPU).
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
from .card_rows import CardLayout, CardRows
from .placement import (
    add_partial,
    indexed,
    replicate,
    sum_home,
    zero_partial,
)
from .rdma import shift_blocks, shift_blocks_plain

EXCHANGES = ("ppermute", "rdma")
_MODES = {"mul": "mul_rel", "add": "add_rel"}


def _to(t, device):
    return None if t is None else t.to(device)


@dataclasses.dataclass(frozen=True)
class RingBuckets:
    """One direction's edge buckets, each field a tuple of the n owner
    blocks' int64 rows [n, Emax] indexed [held block, edge], row s on
    shard s's device: ``gather_local`` indexes the held block,
    ``out_local`` the owner's block, ``edge_id`` is global (the weight's
    index); ``valid`` (float32) is 0 on padding."""

    gather_local: tuple
    out_local: tuple
    etype: tuple
    edge_id: tuple
    valid: tuple

    def to_mesh(self, devices) -> "RingBuckets":
        """Owner s's row on ``devices[s]``."""
        return RingBuckets(**{f.name: tuple(getattr(self, f.name)[s].to(d)
                                            for s, d in enumerate(devices))
                              for f in dataclasses.fields(self)})

    def bucket(self, s: int, b: int) -> tuple:
        """Bucket (owner s, held b): (gather_local, out_local, etype,
        edge_id, valid), each [Emax]."""
        return tuple(getattr(self, f.name)[s][b]
                     for f in dataclasses.fields(self))


@dataclasses.dataclass(frozen=True)
class RingRspmmInputs:
    """The ring path's host-built inputs.

      fwd: owner = destination block, held = source block (the x ring)
      rev: owner = source block, held = destination block (the g ring)
      csr: None, or csr[i][j] — the ``Csr`` (data/graph.py) of the edges
        whose destination lies in block i and source in block j, over
        block-local rows and gather indices, global eid, with the backward
        layouts when built with ``backward``: the forward's bucket (s, b),
        on shard s's device
      csr_rev: None, or csr_rev[s][b] — the backward's bucket (s, b), the
        forward's pair csr[b][s], on shard s's device: an off-diagonal CSR
        is kept on both of its shards' devices (one object where they
        share a device)
      edge_counts: int [n, n], the edges of csr[i][j]
      to_old: int64 [n * v_block] new row -> original node (empty slots ->
        the zero pad row ``num_nodes``), to_new: int64 [V] original -> new;
        None when blocks are contiguous original ids
      permuted_io: the caller keeps node states in the padded block domain
        ([n * v_block] rows, relabelled when balanced) for the whole
        propagation; the op then takes and returns block-domain rows
      devices: each shard's device (``to_mesh``): the buckets' row s and
        csr[s], csr_rev[s] on devices[s]; to_old and to_new on the home
        (devices[0])
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
    csr_rev: Optional[tuple] = None
    devices: tuple = ()

    @property
    def v_pad(self) -> int:
        return self.v_block * self.n_shards

    @property
    def nonempty_buckets(self) -> int:
        """Buckets with edges: the kernel calls of one ring pass."""
        return int(np.count_nonzero(self.edge_counts))

    def to(self, device) -> "RingRspmmInputs":
        """Layouts whose shards share one device go to ``device`` whole;
        layouts spread over several devices keep their shards' devices and
        move only the home's index maps."""
        if len(set(self.devices)) == 1:
            return self.to_mesh((device,) * self.n_shards)
        return dataclasses.replace(self, to_old=_to(self.to_old, device),
                                   to_new=_to(self.to_new, device))

    def to_mesh(self, devices) -> "RingRspmmInputs":
        """Each shard's buckets and CSRs on its device ``devices[s]``, the
        index maps on the home (``devices[0]``). Nothing is copied where a
        layout lies on its device already."""
        devices = tuple(indexed(d) for d in devices)
        if len(devices) != self.n_shards:
            raise ValueError(f"{self.n_shards} shards, {len(devices)} "
                             "devices")
        csr = csr_rev = None
        if self.csr is not None:
            n = self.n_shards
            csr = tuple(tuple(self.csr[s][b].to(d) for b in range(n))
                        for s, d in enumerate(devices))
            # where both shards of a pair share a device, one CSR serves
            csr_rev = tuple(tuple(csr[b][s] if devices[b] == d
                                  else self.csr_rev[s][b].to(d)
                                  for b in range(n))
                            for s, d in enumerate(devices))
        return dataclasses.replace(
            self, fwd=self.fwd.to_mesh(devices),
            rev=self.rev.to_mesh(devices), csr=csr, csr_rev=csr_rev,
            to_old=_to(self.to_old, devices[0]),
            to_new=_to(self.to_new, devices[0]), devices=devices)


def build_ring_rspmm_inputs(edge_index, edge_type, num_nodes: int,
                            n_shards: int, num_relations: Optional[int] = None,
                            pallas: bool = False, balance=False,
                            permuted_io: bool = False,
                            backward: bool = True) -> RingRspmmInputs:
    """Host-side bucket build (numpy; every shard's layouts on the CPU).

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
        arrays["valid"] = valid
        return RingBuckets(**{k: tuple(torch.from_numpy(a[s])
                                       for s in range(n))
                              for k, a in arrays.items()})

    csr = csr_rev = None
    if pallas:
        csr = tuple(
            tuple(build_csr(src[ids] - j * vb, dst[ids] - i * vb, et[ids], vb,
                            num_relations, backward, edge_ids=ids)
                  for j, ids in enumerate(row))
            for i, row in enumerate(pair))
        csr_rev = tuple(tuple(csr[b][s] for b in range(n)) for s in range(n))

    def long(a):
        return None if a is None else torch.from_numpy(a.astype(np.int64))

    return RingRspmmInputs(
        fwd=family(owner_dst=True), rev=family(owner_dst=False), csr=csr,
        edge_counts=counts, to_old=long(to_old), to_new=long(to_new),
        v_block=vb, n_shards=n, num_nodes=int(num_nodes),
        permuted_io=permuted_io, csr_rev=csr_rev,
        devices=(torch.device("cpu"),) * n)


def _exchange(exchange: str):
    """The boundary transport of one ring step, shard s -> s + 1 (mod n),
    over per-shard blocks: ``ppermute`` the plain shift (PyTorch's copies
    between devices), ``rdma`` kernel K9 (its plain version on CPU
    tensors)."""
    if exchange == "rdma":
        return shift_blocks
    if exchange == "ppermute":
        return shift_blocks_plain
    raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")




def _check_cards(inputs: RingRspmmInputs, layout: CardLayout):
    if layout.devices != inputs.devices or layout.v_block != inputs.v_block:
        raise ValueError(
            f"states on {[str(d) for d in layout.devices]} in blocks of "
            f"{layout.v_block} rows, but the ring's shards lie on "
            f"{[str(d) for d in inputs.devices]} in blocks of "
            f"{inputs.v_block}")


def _ring_pass(inputs, layout, planes, exchange, step):
    """Run ``step(s, b, held)`` for shard s at each of the n ring steps:
    ``held`` the block b = (s - k) mod n of the packed ``planes`` (each a
    list of the cards' tensors, packed side by side a card) that shard s
    holds at step k, on its device; the blocks shift between steps by one
    exchange."""
    n = inputs.n_shards
    packed = [cards[0] if len(cards) == 1 else torch.cat(cards, dim=1)
              for cards in zip(*planes)]
    held = [layout.block(packed, s) for s in range(n)]
    shift = _exchange(exchange)
    for k in range(n):
        for s in range(n):
            step(s, (s - k) % n, held[s])
        if k + 1 < n:
            # consumed only at the next step
            held = shift(held, inputs.devices)


def _card_buffers(layout, like, fill: float = 0.0, dtype=None) -> tuple:
    """(buffers, blocks): a [rows(c), F] buffer on each card filled with
    ``fill`` (``like``'s cards' tensors give F, dtype and device) and each
    shard's block of its card's buffer to accumulate into."""
    bufs = [t.new_full(t.shape, fill, dtype=dtype) for t in like]
    return bufs, [layout.block(bufs, s) for s in range(len(layout.devices))]


def _ring_messages_pass(inputs, layout, edge_weight, relation, xs, msg,
                        exchange, step):
    """The forward ring: ``step(s, o_local, m, w, valid)`` for each step's
    messages m (unweighted) of shard s's bucket, on its device, x's blocks
    rotating."""
    devs = inputs.devices
    w, rel = replicate(edge_weight, devs), replicate(relation, devs)

    def messages(s, b, held):
        d = devs[s]
        g_loc, o_loc, etype, eid, valid = inputs.fwd.bucket(s, b)
        step(s, o_loc, _messages(rel[d], etype, held[g_loc], msg),
             (w[d][eid] * valid)[:, None], valid)

    _ring_pass(inputs, layout, (xs,), exchange, messages)


def _ring_forward(inputs, layout, edge_weight, relation, xs, msg, exchange,
                  bf16) -> list:
    """The sums, a tensor a card: K1 (K1h) per bucket with edges with
    per-bucket CSRs and distmult messages, else the plain gathers and
    scatters."""
    out, blocks = _card_buffers(layout, xs, dtype=torch.float32)
    if inputs.csr is not None and msg == "mul":
        devs = inputs.devices
        w, rel = replicate(edge_weight, devs), replicate(relation, devs)
        fwd = rspmm_fwd_bf16_cuda if bf16 else rspmm_fwd_cuda

        def step(s, b, held):
            if inputs.edge_counts[s, b]:  # a bucket without edges adds 0
                c, d = inputs.csr[s][b], devs[s]
                blocks[s] += fwd(c.rowptr, c.src, c.etype, c.eid, w[d],
                                 rel[d], held, "mul_rel", segments=c.segments)

        _ring_pass(inputs, layout, (xs,), exchange, step)
    else:
        _ring_messages_pass(
            inputs, layout, edge_weight, relation, xs, msg, exchange,
            lambda s, o_loc, m, w, valid: blocks[s].index_add_(0, o_loc,
                                                                m * w))
    return out


class _BackwardShards:
    """A transposed ring's per-shard operands and results: the edge
    weight and relation on every shard device, x's blocks, dx a buffer a
    card (each shard's block a view of it) and the d_relation partials a
    device."""

    def __init__(self, inputs, layout, edge_weight, relation, xs, need_dx,
                 need_dr):
        self.devs = inputs.devices
        self.w = replicate(edge_weight, self.devs)
        self.rel = replicate(relation, self.devs)
        self.x = CardRows(layout, tuple(xs))
        self.dx, self.dx_blocks = (_card_buffers(layout, xs) if need_dx
                                   else (None, None))
        self.dr_parts = {}
        self.relation, self.need_dx, self.need_dr = relation, need_dx, need_dr

    def operands(self, s, etype, eid, valid, o_loc):
        """(w [k, 1], rel_e, x_e) of shard s's bucket edges."""
        d = self.devs[s]
        return ((self.w[d][eid] * valid)[:, None], self.rel[d][etype],
                self.x.block(s)[o_loc])

    def add(self, s, o_loc, etype, dx_e, dr_e):
        """Scatter shard s's edge terms into its dx block and its device's
        d_relation partial."""
        if self.need_dx:
            self.dx_blocks[s].index_add_(0, o_loc, dx_e)
        if self.need_dr:
            zero_partial(self.dr_parts,
                         self.rel[self.devs[s]]).index_add_(0, etype, dr_e)

    def results(self):
        """(dx a tensor a card, or None; dr on the relation's device, the
        home)."""
        dr = None
        if self.need_dr:
            dr = sum_home(self.dr_parts, self.relation.device)
            if dr is None:  # no bucket has an edge
                dr = torch.zeros_like(self.relation)
        return self.dx, dr


def _ring_backward(inputs, layout, edge_weight, relation, xs, gs, msg,
                   exchange, bf16, need_dx, need_dr):
    """The sums' transposed ring: K2 (K2h) per bucket with edges with
    per-bucket CSRs and distmult messages, else the plain gathers and
    scatters. Returns (dx a tensor a card, dr)."""
    sh = _BackwardShards(inputs, layout, edge_weight, relation, xs, need_dx,
                         need_dr)
    kernels = inputs.csr is not None and msg == "mul"

    def step(s, b, held):
        d = sh.devs[s]
        if kernels:
            # the backward's bucket (s, b): source block s, destination
            # block b, i.e. the forward's pair csr[b][s]
            if not inputs.edge_counts[b, s]:
                return
            args = (inputs.csr_rev[s][b], sh.w[d], sh.rel[d], sh.x.block(s),
                    held, need_dx, need_dr)
            dx_p, dr_p = (rspmm_bwd_bf16_cuda(*args) if bf16
                          else rspmm_bwd_cuda(*args, mode="mul_rel"))
            if need_dx:
                sh.dx_blocks[s] += dx_p
            if need_dr:
                add_partial(sh.dr_parts, d, dr_p)
            return
        g_loc, o_loc, etype, eid, valid = inputs.rev.bucket(s, b)
        if msg == "mul":
            w, rel_e, x_e = sh.operands(s, etype, eid, valid, o_loc)
            gw = held[g_loc] * w
            sh.add(s, o_loc, etype, rel_e * gw if need_dx else None,
                   x_e * gw if need_dr else None)
        else:  # transe: the message's derivative is 1 in x and in rel
            gw = held[g_loc] * (sh.w[d][eid] * valid)[:, None]
            sh.add(s, o_loc, etype, gw, gw)

    _ring_pass(inputs, layout, (gs,), exchange, step)
    return sh.results()


def _grads(xs, dx, dr, before: int) -> tuple:
    """An op's backward result: None for its ``before`` leading inputs but
    the relation (the fourth, ``dr``), then dx a card (None where not
    needed)."""
    head = [None] * before
    head[3] = dr
    return tuple(head) + (tuple(dx) if dx is not None
                          else (None,) * len(xs))


class _RingRspmm(torch.autograd.Function):
    """The ring over block-domain operands: edge_weight [E], relation
    [R, F], x as a tensor a card of ``layout`` (``CardRows.tensors``);
    returns a tensor a card. No gradient flows to edge_weight (the JAX
    package's ring returns zeros there)."""

    @staticmethod
    def forward(ctx, inputs, layout, edge_weight, relation, msg, exchange,
                bf16, *xs):
        ctx.inputs, ctx.layout, ctx.msg = inputs, layout, msg
        ctx.exchange, ctx.bf16 = exchange, bf16
        ctx.save_for_backward(edge_weight, relation, *xs)
        return tuple(_ring_forward(inputs, layout, edge_weight, relation, xs,
                                   msg, exchange, bf16))

    @staticmethod
    def backward(ctx, *grads):
        edge_weight, relation, *xs = ctx.saved_tensors
        dx, dr = _ring_backward(
            ctx.inputs, ctx.layout, edge_weight, relation, xs,
            [g.contiguous() for g in grads], ctx.msg, ctx.exchange, ctx.bf16,
            need_dx=any(ctx.needs_input_grad[7:]),
            need_dr=ctx.needs_input_grad[3])
        return _grads(xs, dx, dr, 7)


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


def _gated_backward(inputs, layout, edge_weight, relation, xs, planes, msg,
                    exchange, need_dx, need_dr):
    """The extrema's transposed ring: planes (g, out) per extremum, each a
    list of the cards' tensors, each edge's coefficient the sum of w·g
    over the extrema that its recomputed weighted message equals. Returns
    (dx a tensor a card, dr)."""
    F = xs[0].shape[1]
    sh = _BackwardShards(inputs, layout, edge_weight, relation, xs, need_dx,
                         need_dr)

    def step(s, b, held):
        g_loc, o_loc, etype, eid, valid = inputs.rev.bucket(s, b)
        w, rel_e, x_e = sh.operands(s, etype, eid, valid, o_loc)
        mw = (rel_e * x_e if msg == "mul" else rel_e + x_e) * w
        rows = held[g_loc]
        c = None
        for i in range(0, len(planes), 2):
            g_e = rows[:, i * F:(i + 1) * F]
            gate = (mw == rows[:, (i + 1) * F:(i + 2) * F]).to(g_e.dtype)
            c = g_e * gate if c is None else c + g_e * gate
        c = c * w
        sh.add(s, o_loc, etype,
               (rel_e * c if msg == "mul" else c) if need_dx else None,
               (x_e * c if msg == "mul" else c) if need_dr else None)

    _ring_pass(inputs, layout, planes, exchange, step)
    return sh.results()


def _extremum_pass(inputs, layout, edge_weight, relation, xs, msg, exchange,
                   aggs) -> list:
    """The forward ring folding each step's weighted messages into one
    buffer a card for each of ``aggs`` ("max", "min"); rows that no edge
    reached give 0. Returns the buffers, a list a card for each of
    ``aggs``."""
    folds = [_card_buffers(layout, xs, -_BIG if agg == "max" else _BIG)
             for agg in aggs]

    def step(s, o_loc, m, w, valid):
        mw = m * w
        for agg, (_, blocks) in zip(aggs, folds):
            _fold_extremum(blocks[s], o_loc, mw, valid, agg)

    _ring_messages_pass(inputs, layout, edge_weight, relation, xs, msg,
                        exchange, step)
    return [[_empty_to_zero(t, agg) for t in bufs]
            for agg, (bufs, _) in zip(aggs, folds)]


class _RingExtremum(torch.autograd.Function):
    """The ring's max or min over block-domain operands: edge_weight [E],
    relation [R, F], x a tensor a card of ``layout``; returns a tensor a
    card. No gradient flows to edge_weight."""

    @staticmethod
    def forward(ctx, inputs, layout, edge_weight, relation, msg, agg,
                exchange, *xs):
        (out,) = _extremum_pass(inputs, layout, edge_weight, relation, xs,
                                msg, exchange, (agg,))
        ctx.inputs, ctx.layout, ctx.msg, ctx.exchange = (inputs, layout, msg,
                                                         exchange)
        ctx.cards = len(xs)
        ctx.save_for_backward(edge_weight, relation, *xs, *out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        edge_weight, relation, *saved = ctx.saved_tensors
        xs, out = saved[:ctx.cards], saved[ctx.cards:]
        dx, dr = _gated_backward(
            ctx.inputs, ctx.layout, edge_weight, relation, xs,
            ([g.contiguous() for g in grads], out), ctx.msg, ctx.exchange,
            any(ctx.needs_input_grad[7:]), ctx.needs_input_grad[3])
        return _grads(xs, dx, dr, 7)


class _RingMaxMin(torch.autograd.Function):
    """Both extrema of one rotation over block-domain operands; returns
    the max's tensors a card, then the min's."""

    @staticmethod
    def forward(ctx, inputs, layout, edge_weight, relation, msg, exchange,
                *xs):
        mx, mn = _extremum_pass(inputs, layout, edge_weight, relation, xs,
                                msg, exchange, ("max", "min"))
        ctx.inputs, ctx.layout, ctx.msg, ctx.exchange = (inputs, layout, msg,
                                                         exchange)
        ctx.cards = len(xs)
        ctx.save_for_backward(edge_weight, relation, *xs, *mx, *mn)
        return tuple(mx) + tuple(mn)

    @staticmethod
    def backward(ctx, *grads):
        edge_weight, relation, *saved = ctx.saved_tensors
        k = ctx.cards
        xs, mx, mn = saved[:k], saved[k:2 * k], saved[2 * k:]
        g = [t.contiguous() for t in grads]
        dx, dr = _gated_backward(ctx.inputs, ctx.layout, edge_weight,
                                 relation, xs, (g[:k], mx, g[k:], mn),
                                 ctx.msg, ctx.exchange,
                                 any(ctx.needs_input_grad[6:]),
                                 ctx.needs_input_grad[3])
        return _grads(xs, dx, dr, 6)


class _RingAddSq(torch.autograd.Function):
    """Σ w·m and Σ w·m² of one rotation, distmult, over block-domain
    operands; returns the sum's tensors a card, then the squares'."""

    @staticmethod
    def forward(ctx, inputs, layout, edge_weight, relation, exchange, *xs):
        (s, s_blocks), (sq, sq_blocks) = (_card_buffers(layout, xs)
                                          for _ in range(2))

        def step(i, o_loc, m, w, valid):
            mw = m * w
            s_blocks[i].index_add_(0, o_loc, mw)
            sq_blocks[i].index_add_(0, o_loc, m * mw)

        _ring_messages_pass(inputs, layout, edge_weight, relation, xs, "mul",
                            exchange, step)
        ctx.inputs, ctx.layout, ctx.exchange = inputs, layout, exchange
        ctx.save_for_backward(edge_weight, relation, *xs)
        return tuple(s) + tuple(sq)

    @staticmethod
    def backward(ctx, *grads):
        edge_weight, relation, *xs = ctx.saved_tensors
        need_dr = ctx.needs_input_grad[3]
        need_dx = any(ctx.needs_input_grad[5:])
        F, k = xs[0].shape[1], len(xs)
        sh = _BackwardShards(ctx.inputs, ctx.layout, edge_weight, relation,
                             xs, need_dx, need_dr)

        def step(s, b, held):
            g_loc, o_loc, etype, eid, valid = ctx.inputs.rev.bucket(s, b)
            w, rel_e, x_e = sh.operands(s, etype, eid, valid, o_loc)
            rows = held[g_loc]
            inner = rows[:, :F] * w + (2.0 * (rel_e * x_e)) * (rows[:, F:]
                                                              * w)
            sh.add(s, o_loc, etype, rel_e * inner if need_dx else None,
                   x_e * inner if need_dr else None)

        g = [t.contiguous() for t in grads]
        _ring_pass(ctx.inputs, ctx.layout, (g[:k], g[k:]), ctx.exchange,
                   step)
        dx, dr = sh.results()
        return _grads(xs, dx, dr, 5)


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


def _card_operands(inputs: RingRspmmInputs, relation, x, outputs: int):
    """(relation [R, F], layout, x's tensors a card, back): a ``CardRows``
    x (the block domain, ``inputs.permuted_io``) passes as it is, and
    ``back`` wraps an op's tensors a card (``outputs`` results side by
    side) as ``CardRows``; a home tensor is cut into block-domain rows
    (``_to_blocks``) and each card's share (``CardRows.from_home``), and
    ``back`` brings the results home in x's layout."""
    if isinstance(x, CardRows):
        if not inputs.permuted_io:
            raise ValueError("states kept on the cards are block-domain "
                             "rows: the ring's buckets need permuted_io")
        _check_cards(inputs, x.layout)
        if relation.dim() != 2:
            raise ValueError(f"states on the cards are flat [rows, F]: the "
                             f"relation must be [R, F], got "
                             f"{tuple(relation.shape)}")
        layout, rows = x.layout, x
    else:
        relation, full = _to_blocks(inputs, relation, x)
        layout = CardLayout.of(inputs.devices, inputs.v_block)
        rows = CardRows.from_home(full, layout)
    k = len(layout.groups)

    def back(outs):
        parts = [CardRows(layout, tuple(outs[i * k:(i + 1) * k]))
                 for i in range(outputs)]
        if not isinstance(x, CardRows):
            parts = [_from_blocks(inputs, p.to_home(), x.shape)
                     for p in parts]
        return parts[0] if outputs == 1 else tuple(parts)

    return (relation.contiguous(), layout,
            [t.contiguous() for t in rows.tensors], back)


def ring_rspmm(edge_weight, inputs: RingRspmmInputs, relation, x, *,
               msg: str, agg: str = "add", compute_dtype: str = "float32",
               exchange: str = "ppermute"):
    """The ring rspmm (module docstring), sum, max or min aggregation.

    edge_weight [E] in original edge order; relation [R, F], [R, D] shared
    or [R, B, D] per batch; x flat [rows, F] or [rows, B, D] on the home,
    with rows = n * v_block block-domain rows when ``inputs.permuted_io``,
    else V original rows (padded and relabelled on entry, mapped back on
    exit), or a ``CardRows`` (block-domain rows kept on the shards' cards,
    relation [R, F]). Returns the layout of x. ``compute_dtype="bfloat16"``
    runs K1h/K2h on the sums' kernel route (distmult with per-bucket CSRs)
    and changes nothing on the plain one or for max and min, as in the JAX
    package. ``exchange``: "ppermute" (the plain shift) or "rdma" (K9 on
    CUDA tensors)."""
    _check_ring_args(msg, exchange, compute_dtype)
    if agg not in ("add", "max", "min"):
        raise ValueError(f"agg must be one of ('add', 'max', 'min'), got "
                         f"{agg!r}")
    rel, layout, xs, back = _card_operands(inputs, relation, x, 1)
    if agg == "add":
        return back(_RingRspmm.apply(inputs, layout, edge_weight, rel, msg,
                                     exchange, compute_dtype == "bfloat16",
                                     *xs))
    return back(_RingExtremum.apply(inputs, layout, edge_weight, rel, msg,
                                    agg, exchange, *xs))


def ring_rspmm_maxmin(edge_weight, inputs: RingRspmmInputs, relation, x, *,
                      msg: str, exchange: str = "ppermute") -> tuple:
    """PNA's extremum pair over one ring rotation: (max, min) of each row's
    weighted messages, shapes and layouts as ``ring_rspmm``'s."""
    _check_ring_args(msg, exchange)
    rel, layout, xs, back = _card_operands(inputs, relation, x, 2)
    return back(_RingMaxMin.apply(inputs, layout, edge_weight, rel, msg,
                                  exchange, *xs))


def ring_rspmm_addsq(edge_weight, inputs: RingRspmmInputs, relation, x, *,
                     exchange: str = "ppermute") -> tuple:
    """PNA's moments of distmult messages over one ring rotation: (Σ w·m,
    Σ w·m²), m = rel ⊙ x, shapes and layouts as ``ring_rspmm``'s."""
    _check_ring_args("mul", exchange)
    rel, layout, xs, back = _card_operands(inputs, relation, x, 2)
    return back(_RingAddSq.apply(inputs, layout, edge_weight, rel, exchange,
                                 *xs))

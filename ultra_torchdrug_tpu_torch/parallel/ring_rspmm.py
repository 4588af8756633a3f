"""The ring-pipelined edge-partitioned rspmm, sum aggregation (counterpart of
ultra_torchdrug_tpu/parallel/ring_rspmm.py).

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

Not ported yet (ROADMAP Queue 1 item 9): the max/min and moments ring
schedules (``ring_rspmm_maxmin``, ``ring_rspmm_addsq``) and shards on several
devices. Reference analogue: none (the reference replicates the graph on
every GPU).
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


def ring_rspmm(edge_weight, inputs: RingRspmmInputs, relation, x, *,
               msg: str, agg: str = "add", compute_dtype: str = "float32",
               exchange: str = "ppermute") -> torch.Tensor:
    """The ring rspmm (module docstring), sum aggregation.

    edge_weight [E] in original edge order; relation [R, F], [R, D] shared
    or [R, B, D] per batch element; x flat [rows, F] or [rows, B, D], with
    rows = n * v_block block-domain rows when ``inputs.permuted_io``, else V
    original rows (padded and relabelled on entry, mapped back on exit).
    Returns the layout of x. ``compute_dtype="bfloat16"`` runs K1h/K2h on
    the kernel route (distmult with per-bucket CSRs) and changes nothing on
    the plain one, as in the JAX package. ``exchange``: "ppermute" (the
    plain shift) or "rdma" (K9 on CUDA tensors)."""
    if agg != "add":
        raise NotImplementedError(
            f"agg={agg!r} on the ring (the max/min and moments schedules) is "
            "not ported yet (ROADMAP Queue 1 item 9)")
    if msg not in _MODES:
        raise ValueError(f"msg must be one of {tuple(_MODES)}, got {msg!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, got "
                         f"{exchange!r}")
    shape = x.shape
    xf = x.reshape(shape[0], -1)
    rel = (relation if x.dim() == 2 and relation.dim() == 2
           else broadcast_rel_flat(relation, shape[1]))
    if inputs.permuted_io:
        if shape[0] != inputs.v_pad:
            raise ValueError(f"permuted_io: x has {shape[0]} rows, the block "
                             f"domain {inputs.v_pad}")
        blocks = xf
    else:
        if shape[0] != inputs.num_nodes:
            raise ValueError(f"x has {shape[0]} rows, the graph "
                             f"{inputs.num_nodes} nodes")
        pad = xf.new_zeros((inputs.v_pad - shape[0], xf.shape[1]))
        blocks = torch.cat([xf, pad])
        if inputs.to_old is not None:
            blocks = blocks[inputs.to_old]
    out = _RingRspmm.apply(inputs, edge_weight, rel.contiguous(),
                           blocks.contiguous(), msg, exchange,
                           compute_dtype == "bfloat16")
    if not inputs.permuted_io:
        out = (out[:inputs.num_nodes] if inputs.to_new is None
               else out[inputs.to_new])
    return out.reshape(out.shape[0], *shape[1:])

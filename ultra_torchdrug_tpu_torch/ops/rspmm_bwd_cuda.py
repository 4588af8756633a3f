"""Kernels K2, K2h, K3 and K8b: the relational SpMM backward with sum
aggregation, for distmult (K2; K2h with bf16 operands), transe (K3) and
RotatE (K8b) messages, by hand for Hopper (csrc/rspmm_bwd.cu,
csrc/rspmm_transe_bwd.cu, csrc/rspmm_rotate.cu), and their plain PyTorch
versions.

K2 replaces ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_bwd_fused in mode
``mul`` (via rspmm_bwd_pallas), the backward of K1's ``mul_rel``:

    dx[s] = Σ_{e=(s→v, r)} w[eid_e] · rel[r] ⊙ g[v]
    dr[r] = Σ_{e with type r} w[eid_e] · x[s_e] ⊙ g[v_e]

K2h is K2 with ``compute_dtype=bfloat16`` (rspmm_bwd_fused with bf16
operands, :2117-2153): the wrapper casts x, g and the relation to bf16
once per call; the products are taken in fp32 from the widened values,
with g·w formed first, and dx and dr are fp32:

    dx[s] = Σ_{e=(s→v, r)} rel[r] ⊙ (g[v] · w[eid_e])
    dr[r] = Σ_{e with type r} x[s_e] ⊙ (g[v_e] · w[eid_e])

K3 replaces rspmm_gather1 in mode ``none`` as rspmm_bwd_pallas's transe
branch calls it, the backward of K1's ``add_rel``; it reads neither x nor
the relation:

    dx[s] = Σ_{e=(s→v, r)} g[v] · w[eid_e]
    dr[r] = Σ_{e with type r} g[v_e] · w[eid_e]

K8b replaces rspmm_bwd_fused in mode ``rotate`` (via
rspmm_rotate_bwd_pallas), the backward of K8f's ``rot_rel``, with ⊗ the
complex product over blocks of ``dim`` features (ops/rspmm_cuda.py):

    dx[s] = Σ_{e=(s→v, r)} (conj(rel[r]) ⊗ g[v]) · w[eid_e]
    dr[r] = Σ_{e with type r} (conj(x[s_e]) ⊗ g[v_e]) · w[eid_e]

over the graph's layouts from data/graph.py::Graph.prepare_csr: K2, K2h, K3
and K8b read the source-sorted CSR cut into segments of at most 256 edges
(dx) and the (destination tile, relation) chunks (dr), the Csr's src_seg_*,
src_long_* and tile_* fields. K2h's slices are 128 bf16 features in its
dx pass and 64 in its dr pass (csrc/rspmm_staged.cuh), K8b's 32 complex
positions whose real and
imaginary parts lie apart in a row (csrc/rspmm_rotate.cu); ``k2_plan``,
``k2h_plan`` and ``k8b_plan`` report how a shape is laid out. Operands are
flat: x, g [V, F], relation [R, F], edge_weight [E] in original edge order,
all float32.

``rspmm_bwd_cuda`` (K2, K3), ``rspmm_bwd_bf16_cuda`` (K2h) and
``rotate_bwd_cuda`` (K8b) launch their kernel for CUDA tensors and count
each call in ``launches[<kernel id>]`` (one call is up to three device
launches, see the sources); for CPU tensors they run ``rspmm_bwd_plain``,
``rspmm_bwd_bf16_plain`` and ``rotate_bwd_plain``. The results are
deterministic: no float atomics, sums in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import load_library
from .rspmm_cuda import (
    _check,
    check_mode,
    check_rotate_dim,
    csr_rows,
    plan_dict,
    ptr,
    rotate_product,
    rspmm_plain_edges,
    widen_bf16,
)

# calls that launched each kernel since import (or since the caller last
# reset them)
launches = {"K2": 0, "K2h": 0, "K3": 0, "K8b": 0}


def _require_backward_layouts(csr):
    if not csr.has_backward:
        raise ValueError("the CSR has no backward layouts: build it with "
                         "Graph.prepare_csr(backward=True)")


# the first backward design's layouts, in its argument order: no kernel
# reads them any more (ROADMAP: their removal from build_csr is a follow-up)
_LAYOUT = ("src_rowptr", "src_dst", "src_etype", "src_eid", "chunk_ptr",
           "rel_chunk_ptr", "rel_src", "rel_dst", "rel_eid")
# K2's layouts, in its argument order (K2h's and K8b's too)
_K2_LAYOUT = ("src_seg_ptr", "src_seg_out", "src_dst", "src_etype", "src_eid",
              "src_long_rows", "src_long_ptr", "tile_chunk_ptr",
              "tile_chunk_slot", "tile_src", "tile_dst", "tile_eid",
              "tile_rel_ptr")
# K3's layouts, in its argument order
_K3_LAYOUT = ("src_seg_ptr", "src_seg_out", "src_dst", "src_eid",
              "src_long_rows", "src_long_ptr", "tile_chunk_ptr",
              "tile_chunk_slot", "tile_dst", "tile_eid", "tile_rel_ptr")
_PER_EDGE = ("src_dst", "src_etype", "src_eid", "rel_src", "rel_dst",
             "rel_eid", "tile_src", "tile_dst", "tile_eid")


def check_bwd_operands(kernel: str, csr, layout, edge_weight, relation, x,
                       planes: dict, dtype=torch.float32) -> tuple:
    """Device, type and shape checks of a two-pass backward kernel's
    operands (K2, K2h, K3, K5, K6b, K7b, K8b): the CSR's ``layout`` fields,
    and ``planes`` (name -> tensor), the dense operands of ``dtype``. The
    kernels index two row spaces apart: x and dx have the source CSR's
    rows, the planes (g, a saved extremum) the destination rows that the
    edges gather from, ``csr.rowptr``'s. The two are one on a graph's own
    CSR and differ on a partitioned shard's reverse CSR
    (parallel/sharded_rspmm.py). ``x`` may be None (K3 reads no x). Returns
    (num_rows of dx, num_relations, num_chunks, num_features)."""
    like = next(iter(planes.values()))
    device = like.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {device}")
    _require_backward_layouts(csr)
    for name in layout:
        _check(name, getattr(csr, name), torch.int32, device, 1)
    _check("edge_weight", edge_weight, torch.float32, device, 1)
    dense = [("relation", relation), *planes.items()]
    for name, t in dense + ([("x", x)] if x is not None else []):
        _check(name, t, dtype, device, 2)
    num_features = like.shape[1]
    rows = csr.rowptr.numel() - 1
    for name, t in planes.items():
        if tuple(t.shape) != (rows, num_features):
            raise ValueError(f"{name} {tuple(t.shape)} != the destination "
                             f"CSR's ({rows}, {num_features})")
    # edge_weight is gathered through the eid arrays: it may be longer than
    # the layouts (a ring bucket's CSR indexes the whole graph's weights)
    num_edges = csr.src_dst.numel()
    if any(getattr(csr, n).numel() != num_edges for n in _PER_EDGE):
        raise ValueError("the layouts must have one entry per edge")
    num_rows = csr.src_rowptr.numel() - 1
    num_relations = csr.rel_chunk_ptr.numel() - 1
    if x is not None and tuple(x.shape) != (num_rows, num_features):
        raise ValueError(f"x {tuple(x.shape)} != the source CSR's "
                         f"({num_rows}, {num_features})")
    if tuple(relation.shape) != (num_relations, num_features):
        raise ValueError(f"relation {tuple(relation.shape)} != "
                         f"({num_relations}, {num_features})")
    return num_rows, num_relations, csr.chunk_ptr.numel() - 1, num_features


def bwd_outputs(like, num_rows: int, num_relations: int, num_chunks: int,
                need_dx: bool, need_dr: bool) -> tuple:
    """A backward kernel's outputs on ``like``'s device and width: (dx
    [num_rows, F], dr [R, F], the dr pass's per-chunk partial rows
    [chunks, F]), None for a half not needed."""
    def empty(rows):
        return torch.empty((rows, like.shape[1]), dtype=torch.float32,
                           device=like.device)

    return (empty(num_rows) if need_dx else None,
            empty(num_relations) if need_dr else None,
            empty(num_chunks) if need_dr else None)


def rspmm_bwd_plain(csr, edge_weight, relation, x, grad, need_dx=True,
                    need_dr=True, mode="mul_rel"):
    """The same function as the kernels (K2 for ``mul_rel``, K3 for
    ``add_rel``, which reads no x: pass None), in plain PyTorch (index_select
    and index_add_), over the source-sorted CSR only: dx by source row, dr by
    edge type. The relation chunks are the kernels' own and not used here.
    Returns (dx, dr), None for a half that is not needed."""
    check_mode(mode)
    _require_backward_layouts(csr)
    src = csr_rows(csr.src_rowptr)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    w = edge_weight.index_select(0, csr.src_eid.long())
    num_rows = csr.src_rowptr.numel() - 1
    dx = dr = None
    if mode == "add_rel":
        # g[v]·w per edge, the message of both halves
        msg = grad.index_select(0, dst).mul_(w[:, None])
        if need_dx:
            dx = grad.new_zeros((num_rows, grad.shape[1])).index_add_(
                0, src, msg)
        if need_dr:
            dr = torch.zeros_like(relation).index_add_(0, etype, msg)
        return dx, dr
    if need_dx:
        dx = rspmm_plain_edges(dst, src, etype, w, relation, grad, "mul_rel",
                               num_rows)
    if need_dr:
        msg = x.index_select(0, src)
        msg.mul_(grad.index_select(0, dst))
        msg.mul_(w[:, None])
        dr = torch.zeros_like(relation).index_add_(0, etype, msg)
    return dx, dr


def rspmm_bwd_cuda(csr, edge_weight, relation, x, grad, need_dx=True,
                   need_dr=True, mode="mul_rel"):
    """K2 (``mul_rel``) or K3 (``add_rel``; x is not read and may be None)
    on CUDA tensors; the plain version on CPU tensors. Returns (dx, dr),
    None for a half that is not needed."""
    check_mode(mode)
    if grad.device.type == "cpu":
        return rspmm_bwd_plain(csr, edge_weight, relation, x, grad, need_dx,
                               need_dr, mode)
    if mode == "add_rel":
        return _transe_bwd_cuda(csr, edge_weight, relation, grad, need_dx,
                                need_dr)
    return _k2_passes("K2", _kernel(), csr, edge_weight, relation, x, grad,
                      need_dx, need_dr)


def _k2_passes(kid: str, fn, csr, edge_weight, relation, x, grad, need_dx,
               need_dr, dtype=torch.float32, dim: int = 0):
    """K2's, K2h's or K8b's two passes (``fn``, rspmm_bwd's arguments; K8b's
    block width ``dim`` before the stream) over K2's layouts on CUDA
    operands of ``dtype``; counts one launch of ``kid``. Returns fp32
    (dx, dr), None for a half that is not needed."""
    num_rows, num_relations, _, num_features = check_bwd_operands(
        kid, csr, _K2_LAYOUT, edge_weight, relation, x, {"grad": grad},
        dtype=dtype)
    num_segments, num_long_rows, num_chunks, num_long_segments = (
        _segment_counts(kid, csr, num_rows, num_relations))
    dx, dr, dr_partial = bwd_outputs(grad, num_rows, num_relations,
                                     num_chunks, need_dx, need_dr)
    dx_partial = (grad.new_empty((num_long_segments, num_features),
                                 dtype=torch.float32)
                  if need_dx and num_long_segments else None)
    num_edges = csr.src_dst.numel()
    w_scratch = edge_weight.new_empty((2 * num_edges,))
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = fn(*(getattr(csr, n).data_ptr() for n in _K2_LAYOUT),
                 edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(),
                 grad.data_ptr(), ptr(dx), ptr(dr), w_scratch.data_ptr(),
                 ptr(dx_partial), ptr(dr_partial), _plan_rows(csr),
                 num_segments, num_long_rows, num_chunks, num_relations,
                 num_edges, num_features, *((dim,) if dim else ()), stream)
    if err != 0:
        raise RuntimeError(f"{kid} ({fn.__name__}) launch failed with CUDA "
                           f"error {err}")
    launches[kid] += 1
    return dx, dr


def _plan_rows(csr) -> int:
    """The row count that sizes K2's, K2h's and K8b's CTA plans
    (csrc/rspmm_staged.cuh::plan_ctas: the rows that a pass gathers, the
    dr pass twice it for x and g): g's rows, ``csr.rowptr``'s. A
    partitioned shard's reverse CSR gathers g over the whole graph while
    its x and dx have the shard's rows, so the shard runs the plan of the
    whole graph's CSR; on a graph's own CSR the two counts are one."""
    return csr.rowptr.numel() - 1


def _segment_counts(kernel: str, csr, num_rows: int,
                    num_relations: int) -> tuple:
    """(segments, long rows, dr chunks, partial rows of the long rows) of
    the source-row segments and (destination tile, relation) chunks that K2,
    K2h, K3, K5, K6b, K7b and K8b read, after checking that they match."""
    num_segments = csr.src_seg_ptr.numel() - 1
    num_long_rows = csr.src_long_rows.numel()
    num_chunks = csr.tile_chunk_ptr.numel() - 1
    if (csr.src_seg_out.numel() != num_segments
            or csr.src_long_ptr.numel() != num_long_rows + 1
            or csr.tile_chunk_slot.numel() != num_chunks
            or csr.tile_chunk_rel.numel() != num_chunks
            or csr.tile_rel_ptr.numel() != num_relations + 1
            or num_segments < num_rows):
        raise ValueError(f"{kernel}'s segment and chunk layouts do not match: "
                         "build them with data/graph.py::build_csr")
    # the long rows' partial rows, one per segment of a row cut in several:
    # every other row is one segment
    return (num_segments, num_long_rows, num_chunks,
            num_segments - (num_rows - num_long_rows))


def k2_plan(csr, num_features: int) -> dict:
    """How K2 lays out its passes over ``csr`` at this width on the card
    (csrc/rspmm_staged.cuh): {"dx": ..., "dr": ...}, each as
    ops/rspmm_cuda.py::k1_plan's (the dr pass reads no rel)."""
    return _two_pass_plan("rspmm_bwd", "rspmm_k2_plan", csr, num_features,
                          num_features % 4 == 0)


def k2h_plan(csr, num_features: int) -> dict:
    """How K2h lays out its passes over ``csr`` at this width on the card,
    as k2_plan's (slices of bf16 features; the 16-byte path needs
    F % 8 == 0)."""
    return _two_pass_plan("rspmm_bwd", "rspmm_k2h_plan", csr, num_features,
                          num_features % 8 == 0)


def _two_pass_plan(library: str, name: str, csr, num_features: int,
                   vec: bool) -> dict:
    """The layout of a backward kernel on K2's layouts (k2_plan, k2h_plan,
    k8b_plan) from ``name`` in ``library``, on the 16-byte path where
    ``vec`` (operands aligned)."""
    num_rows = csr.src_rowptr.numel() - 1
    num_relations = csr.tile_rel_ptr.numel() - 1
    num_segments, _, num_chunks, _ = _segment_counts(name, csr, num_rows,
                                                     num_relations)
    out = (ctypes.c_int * 10)()
    fn = getattr(load_library(library), name)
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(int(vec), num_relations, num_features, _plan_rows(csr),
             num_segments, num_chunks, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    dr = plan_dict(out[5:10])
    dr["rel"] = "none"
    return {"dx": plan_dict(out[:5]), "dr": dr}


def _transe_bwd_cuda(csr, edge_weight, relation, grad, need_dx, need_dr):
    """K3 on CUDA tensors: dx over the source rows' segments, dr over the
    (destination tile, relation) chunks; the relation gives dr's shape
    only."""
    num_rows, num_relations, _, num_features = check_bwd_operands(
        "K3", csr, _K3_LAYOUT, edge_weight, relation, None, {"grad": grad})
    num_segments, num_long_rows, num_chunks, num_long_segments = (
        _segment_counts("K3", csr, num_rows, num_relations))
    dx, dr, dr_partial = bwd_outputs(grad, num_rows, num_relations,
                                     num_chunks, need_dx, need_dr)
    dx_partial = (grad.new_empty((num_long_segments, num_features))
                  if need_dx and num_long_segments else None)
    fn = _transe_kernel()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = fn(*(getattr(csr, n).data_ptr() for n in _K3_LAYOUT),
                 edge_weight.data_ptr(), grad.data_ptr(), ptr(dx), ptr(dr),
                 ptr(dx_partial), ptr(dr_partial), num_segments,
                 num_long_rows, num_chunks, num_relations, num_features,
                 stream)
    if err != 0:
        raise RuntimeError(f"K3 (rspmm_transe_bwd) launch failed with CUDA "
                           f"error {err}")
    launches["K3"] += 1
    return dx, dr


def transe_ragged_operands(feat: int, seed: int, device):
    """K3's operands at ragged shapes, for its checks on the card: V = 5,000
    rows (two full destination tiles of TILE_ROWS and a ragged third), the
    last 5 rows without an edge and the last of R = 4 relations without
    one; source row 3 sends 700 of the E = 2,700 edges (three dx segments);
    relation 1 has 400 edges into the first tile (chunks of one tile) and
    relation 0 edges in every tile; eid a permutation, not the identity;
    weights in [0.5, 1.5] with a fifth masked to 0, g ~ N(0, 1) [V, feat].
    Returns (csr, edge_weight, relation, None, grad), rspmm_bwd_cuda's
    arguments (the relation gives dr's shape only)."""
    from ..data.graph import TILE_ROWS, build_csr

    rng = np.random.default_rng(seed)
    V, R, E = 5000, 4, 2700
    src = rng.integers(0, V - 5, E)
    dst = rng.integers(0, V - 5, E)
    et = rng.integers(0, R - 1, E)
    src[:700] = 3
    et[700:1100] = 1
    dst[700:1100] = rng.integers(0, TILE_ROWS, 400)
    csr = build_csr(src, dst, et, V, R, backward=True,
                    edge_ids=rng.permutation(E))
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    grad = rng.normal(size=(V, feat)).astype(np.float32)
    return (csr.to(device), torch.from_numpy(w).to(device),
            torch.zeros((R, feat), device=device), None,
            torch.from_numpy(grad).to(device))


def rspmm_bwd_bf16_plain(csr, edge_weight, relation, x, grad, need_dx=True,
                         need_dr=True):
    """The same function as K2h, in plain PyTorch (index_select and
    index_add_), over the source-sorted CSR only: x, g and the relation
    rounded to bf16 and widened, g·w per edge, then the fp32 products
    summed by source row (dx) and edge type (dr). Returns (dx, dr), None
    for a half that is not needed."""
    _require_backward_layouts(csr)
    src = csr_rows(csr.src_rowptr)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    w = edge_weight.index_select(0, csr.src_eid.long())
    gw = widen_bf16(grad).index_select(0, dst).mul_(w[:, None])
    dx = dr = None
    if need_dx:
        msg = widen_bf16(relation).index_select(0, etype).mul_(gw)
        dx = msg.new_zeros((csr.src_rowptr.numel() - 1, grad.shape[1]))
        dx.index_add_(0, src, msg)
    if need_dr:
        msg = widen_bf16(x).index_select(0, src).mul_(gw)
        dr = msg.new_zeros(relation.shape).index_add_(0, etype, msg)
    return dx, dr


def rspmm_bwd_bf16_cuda(csr, edge_weight, relation, x, grad, need_dx=True,
                        need_dr=True):
    """K2h on CUDA tensors (fp32 relation, x and grad, cast to bf16 here);
    the plain version on CPU tensors. Returns fp32 (dx, dr), None for a
    half that is not needed."""
    if grad.device.type == "cpu":
        return rspmm_bwd_bf16_plain(csr, edge_weight, relation, x, grad,
                                    need_dx, need_dr)
    relation, x, grad = (t.to(torch.bfloat16).contiguous()
                         for t in (relation, x, grad))
    return _k2_passes("K2h", _bf16_kernel(), csr, edge_weight, relation, x,
                      grad, need_dx, need_dr, dtype=torch.bfloat16)


def rotate_bwd_plain(csr, edge_weight, relation, x, grad, dim: int,
                     need_dx=True, need_dr=True):
    """The same function as K8b, in plain PyTorch (index_select and
    index_add_), over the source-sorted CSR only. Returns (dx, dr), None for
    a half that is not needed."""
    _require_backward_layouts(csr)
    check_rotate_dim(grad.shape[1], dim)
    src = csr_rows(csr.src_rowptr)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    w = edge_weight.index_select(0, csr.src_eid.long())
    dx = dr = None
    if need_dx:
        dx = rspmm_plain_edges(dst, src, etype, w, relation, grad, "rot_conj",
                               csr.src_rowptr.numel() - 1, dim)
    if need_dr:
        msg = rotate_product(x.index_select(0, src).unflatten(-1, (-1, dim)),
                             grad.index_select(0, dst).unflatten(-1, (-1, dim)),
                             conj=True).flatten(-2)
        dr = torch.zeros_like(relation).index_add_(0, etype,
                                                   msg.mul_(w[:, None]))
    return dx, dr


def rotate_bwd_cuda(csr, edge_weight, relation, x, grad, dim: int,
                    need_dx=True, need_dr=True):
    """K8b on CUDA tensors (rows of blocks ``dim`` wide) over K2's layouts;
    the plain version on CPU tensors. Returns (dx, dr), None for a half
    that is not needed."""
    if grad.device.type == "cpu":
        return rotate_bwd_plain(csr, edge_weight, relation, x, grad, dim,
                                need_dx, need_dr)
    check_rotate_dim(grad.shape[1], dim)
    return _k2_passes("K8b", _rotate_kernel(), csr, edge_weight, relation, x,
                      grad, need_dx, need_dr, dim=dim)


def k8b_plan(csr, num_features: int, dim: int) -> dict:
    """How K8b lays out its passes over ``csr`` at this width and block
    width on the card (csrc/rspmm_rotate.cu): {"dx": ..., "dr": ...}, each
    as ops/rspmm_cuda.py::k1_plan's, a slice 32 complex positions (64
    floats; the dr pass reads no rel)."""
    check_rotate_dim(num_features, dim)
    return _two_pass_plan("rspmm_rotate", "rspmm_rotate_plan", csr,
                          num_features, (dim // 2) % 4 == 0)


@functools.lru_cache(maxsize=None)
def _rotate_kernel():
    fn = load_library("rspmm_rotate").rspmm_rotate_bwd
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bf16_kernel():
    fn = load_library("rspmm_bwd").rspmm_bwd_k2h
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("rspmm_bwd").rspmm_bwd
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _transe_kernel():
    fn = load_library("rspmm_transe_bwd").rspmm_transe_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

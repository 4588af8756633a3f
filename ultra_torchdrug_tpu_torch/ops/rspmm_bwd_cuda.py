"""Kernels K2, K2h, K3 and K8b: the relational SpMM backward with sum
aggregation, for distmult (K2; K2h with bf16 operands), transe (K3) and
RotatE (K8b) messages, by hand for Hopper (csrc/rspmm_bwd.cu,
csrc/rspmm_rotate.cu), and their plain PyTorch versions.

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

over the graph's source-sorted CSR (dx) and relation-sorted chunks (dr),
both from data/graph.py::Graph.prepare_csr. Operands are flat: x, g [V, F],
relation [R, F], edge_weight [E] in original edge order, all float32.

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

import torch

from .cuda_build import load_library
from .rspmm_cuda import (
    MODES,
    _check,
    check_mode,
    check_rotate_dim,
    csr_rows,
    rotate_product,
    rspmm_plain_edges,
    widen_bf16,
)

# calls that launched each kernel since import (or since the caller last
# reset them)
launches = {"K2": 0, "K2h": 0, "K3": 0, "K8b": 0}
_KERNEL_ID = {"mul_rel": "K2", "add_rel": "K3"}


def _require_backward_layouts(csr):
    if not csr.has_backward:
        raise ValueError("the CSR has no backward layouts: build it with "
                         "Graph.prepare_csr(backward=True)")


# K2's layouts, in its argument order
_LAYOUT = ("src_rowptr", "src_dst", "src_etype", "src_eid", "chunk_ptr",
           "rel_chunk_ptr", "rel_src", "rel_dst", "rel_eid")
_PER_EDGE = ("src_dst", "src_etype", "src_eid", "rel_src", "rel_dst",
             "rel_eid")


def check_bwd_operands(kernel: str, csr, layout, edge_weight, relation, x,
                       planes: dict, dtype=torch.float32) -> tuple:
    """Device, type and shape checks of a two-pass backward kernel's
    operands (K2, K2h, K3, K5, K6b, K7b, K8b): the CSR's ``layout`` fields,
    and ``planes`` (name -> tensor) shaped like x, the dense operands of
    ``dtype``. ``x`` may be None (K3 reads no x; the first plane then gives
    the shape). Returns (num_rows, num_relations, num_chunks,
    num_features)."""
    like = x if x is not None else next(iter(planes.values()))
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
    for name, t in planes.items():
        if t.shape != like.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
    num_edges = edge_weight.numel()
    if any(getattr(csr, n).numel() != num_edges for n in _PER_EDGE):
        raise ValueError("the layouts and edge_weight must have one entry "
                         "per edge")
    num_rows, num_features = like.shape
    num_relations = csr.rel_chunk_ptr.numel() - 1
    if csr.src_rowptr.numel() - 1 != num_rows:
        raise ValueError(f"source CSR has {csr.src_rowptr.numel() - 1} rows, "
                         f"x has {num_rows}")
    if tuple(relation.shape) != (num_relations, num_features):
        raise ValueError(f"relation {tuple(relation.shape)} != "
                         f"({num_relations}, {num_features})")
    return num_rows, num_relations, csr.chunk_ptr.numel() - 1, num_features


def bwd_outputs(x, num_relations: int, num_chunks: int, need_dx: bool,
                need_dr: bool) -> tuple:
    """A backward kernel's outputs: (dx [V, F] shaped like ``x``, dr [R, F],
    the dr pass's per-chunk partial rows [chunks, F]), None for a half not
    needed."""
    def empty(rows):
        return torch.empty((rows, x.shape[1]), dtype=torch.float32,
                           device=x.device)

    return (empty(x.shape[0]) if need_dx else None,
            empty(num_relations) if need_dr else None,
            empty(num_chunks) if need_dr else None)


def ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


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
    kid = _KERNEL_ID[mode]
    if mode == "add_rel":
        x = None
    device = grad.device
    num_rows, num_relations, num_chunks, num_features = check_bwd_operands(
        kid, csr, _LAYOUT, edge_weight, relation, x, {"grad": grad})
    dx, dr, partial = bwd_outputs(grad, num_relations, num_chunks, need_dx,
                                  need_dr)
    rel = relation if mode == "mul_rel" else None  # K3 reads no relation
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(MODES[mode], *(getattr(csr, n).data_ptr() for n in _LAYOUT),
                 edge_weight.data_ptr(), ptr(rel), ptr(x), grad.data_ptr(),
                 ptr(dx), ptr(dr), ptr(partial), num_rows, num_relations,
                 num_chunks, num_features, stream)
    if err != 0:
        raise RuntimeError(f"{kid} (rspmm_bwd) launch failed with CUDA error "
                           f"{err}")
    launches[kid] += 1
    return dx, dr


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
    device = grad.device
    relation, x, grad = (t.to(torch.bfloat16).contiguous()
                         for t in (relation, x, grad))
    num_rows, num_relations, num_chunks, num_features = check_bwd_operands(
        "K2h", csr, _LAYOUT, edge_weight, relation, x, {"grad": grad},
        dtype=torch.bfloat16)
    dx, dr, partial = bwd_outputs(grad, num_relations, num_chunks, need_dx,
                                  need_dr)
    fn = _bf16_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(getattr(csr, n).data_ptr() for n in _LAYOUT),
                 edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(),
                 grad.data_ptr(), ptr(dx), ptr(dr), ptr(partial), num_rows,
                 num_relations, num_chunks, num_features, stream)
    if err != 0:
        raise RuntimeError(f"K2h (rspmm_bwd_k2h) launch failed with CUDA "
                           f"error {err}")
    launches["K2h"] += 1
    return dx, dr


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
    """K8b on CUDA tensors (rows of blocks ``dim`` wide); the plain version
    on CPU tensors. Returns (dx, dr), None for a half that is not needed."""
    if grad.device.type == "cpu":
        return rotate_bwd_plain(csr, edge_weight, relation, x, grad, dim,
                                need_dx, need_dr)
    device = grad.device
    num_rows, num_relations, num_chunks, num_features = check_bwd_operands(
        "K8b", csr, _LAYOUT, edge_weight, relation, x, {"grad": grad})
    check_rotate_dim(num_features, dim)
    dx, dr, partial = bwd_outputs(grad, num_relations, num_chunks, need_dx,
                                  need_dr)
    fn = _rotate_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(getattr(csr, n).data_ptr() for n in _LAYOUT),
                 edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(),
                 grad.data_ptr(), ptr(dx), ptr(dr), ptr(partial), num_rows,
                 num_relations, num_chunks, num_features, dim, stream)
    if err != 0:
        raise RuntimeError(f"K8b (rspmm_rotate_bwd) launch failed with CUDA "
                           f"error {err}")
    launches["K8b"] += 1
    return dx, dr


@functools.lru_cache(maxsize=None)
def _rotate_kernel():
    fn = load_library("rspmm_rotate").rspmm_rotate_bwd
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bf16_kernel():
    fn = load_library("rspmm_bwd").rspmm_bwd_k2h
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("rspmm_bwd").rspmm_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn

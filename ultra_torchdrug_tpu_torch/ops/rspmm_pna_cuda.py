"""The row-gather aggregations beyond the sum: kernels K4 (one extremum),
K6 and K7 (the fused PNA pairs), and their backward K5 and K6b/K7b, by hand
for Hopper (csrc/rspmm_pna_fwd.cu, csrc/rspmm_pna_bwd.cu), and their plain
PyTorch versions.

K6 replaces ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather_maxmin
(via rspmm_fwd_pallas_maxmin), modes ``mul_rel`` / ``add_rel``:

    m_e = (rel[r] ⊙ x[s]) · w[eid_e]   (or (rel[r] + x[s]) · w[eid_e])
    mx[v] = max_{e=(s→v, r)} m_e,  mn[v] = min_{e=(s→v, r)} m_e,  0 where
    v has no edge

K4 replaces rspmm_gather1 with agg max / min (via rspmm_fwd_pallas): kind
``max`` or ``min``, one of the two alone, rows without edges 0.

K7 replaces rspmm_gather_addsq (via rspmm_fwd_pallas_addsq), distmult only:

    m_e = rel[r] ⊙ x[s],  s[v] = Σ m_e · w,  sq[v] = Σ m_e · (m_e · w)

K6b and K7b replace rspmm_bwd_minmax_blk in kinds ``argext_pair`` (via
rspmm_bwd_pallas_maxmin) and ``moments`` (via rspmm_bwd_pallas_addsq); K5
replaces rspmm_bwd_minmax and rspmm_bwd_minmax_blk kind ``argext`` (K5b;
rspmm_bwd_pallas_minmax picks one of the two by the TPU layout), kind
``argext`` here. Each edge gets a coefficient c per lane,

    argext_pair:  c = [m_e == mx[v]] · g_mx[v] · w + [m_e == mn[v]] · g_mn[v] · w
    argext:       c = [m_e == out[v]] · g[v] · w
    moments:      c = g_s[v] · w + (2 m_e) · (g_sq[v] · w)

and dx[s] += rel[r] ⊙ c, dr[r] += x[s] ⊙ c (both += c for add_rel). The
argext gates recompute the forward's message bit for bit, so every tied
edge gets the full gradient, the TPU kernels' convention
(ultra_torchdrug_tpu/ops/rspmm.py:195-198); XLA's segment_max gradient and
``scatter_reduce``'s backward both share it among the tied edges, so
neither is used here.

Operands are flat: x and the planes [V, F], relation [R, F], edge_weight [E]
in original edge order, all float32, over the graph's ``Csr``
(data/graph.py). Each wrapper launches its kernel for CUDA tensors and adds
one to ``launches[<kernel id>]`` (a backward call is up to three device
launches, see the source); for CPU tensors it runs the plain version. The
sources say what bounds each kernel on the card and what its design does
about it. The backward kernels are deterministic: no float atomics.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library
from .rspmm_bwd_cuda import (
    _require_backward_layouts,
    bwd_outputs,
    check_bwd_operands,
    ptr,
)
from .rspmm_cuda import MODES, check_fwd_operands, csr_rows

# launches of each kernel since import (or since the caller last reset them)
launches = {"K4": 0, "K5": 0, "K6": 0, "K7": 0, "K6b": 0, "K7b": 0}

# forward kinds: K6, K7, K4 (max), K4 (min)
KINDS = {"maxmin": 0, "addsq": 1, "max": 2, "min": 3}
# backward kinds: K6b, K7b, K5
BWD_KINDS = {"argext_pair": 0, "moments": 1, "argext": 2}
_FWD_ID = {"maxmin": "K6", "addsq": "K7", "max": "K4", "min": "K4"}
_BWD_ID = {"argext_pair": "K6b", "moments": "K7b", "argext": "K5"}
_PLANES = {"argext_pair": 4, "moments": 2, "argext": 2}
_REDUCE = {"max": "amax", "min": "amin"}  # K4's kinds, one output each


def _message(rel_e, x_e, w, mode):
    """(rel ⊙ x) · w or (rel + x) · w per edge, in the kernels' order."""
    if mode == "mul_rel":
        msg = rel_e * x_e
    elif mode == "add_rel":
        msg = rel_e + x_e
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return msg * w[:, None]


def pna_fwd_plain(kind: str, csr, edge_weight, relation, x, mode: str):
    """The same function as K6 (``maxmin``), K7 (``addsq``) and K4 (``max``,
    ``min``), in plain PyTorch on the same CSR: index_select the operands
    per edge, then scatter_reduce (amax/amin, rows without edges 0) or
    index_add_ into the destination rows. Returns a tuple of the outputs
    (two for the pairs, one for K4)."""
    src, dst = csr.src.long(), csr_rows(csr.rowptr)
    weight = edge_weight.index_select(0, csr.eid.long())
    rel_e = relation.index_select(0, csr.etype.long())
    x_e = x.index_select(0, src)
    shape = (csr.rowptr.numel() - 1, x.shape[1])
    if kind != "addsq":
        msg = _message(rel_e, x_e, weight, mode)
        del rel_e, x_e
        index = dst[:, None].expand_as(msg)
        reduces = ("amax", "amin") if kind == "maxmin" else (_REDUCE[kind],)
        return tuple(torch.zeros(shape, dtype=msg.dtype, device=x.device)
                     .scatter_reduce_(0, index, msg, reduce,
                                      include_self=False)
                     for reduce in reduces)
    m = rel_e * x_e
    del rel_e, x_e
    mw = m * weight[:, None]
    s = torch.zeros(shape, dtype=m.dtype, device=x.device).index_add_(0, dst,
                                                                      mw)
    mw.mul_(m)
    sq = torch.zeros(shape, dtype=m.dtype, device=x.device).index_add_(0, dst,
                                                                       mw)
    return s, sq


def pna_bwd_plain(kind: str, csr, edge_weight, relation, x, planes,
                  mode: str, need_dx=True, need_dr=True):
    """The same function as K6b (``argext_pair``, planes (g_mx, mx, g_mn,
    mn)), K5 (``argext``, planes (g, out)) and K7b (``moments``, planes
    (g_s, g_sq)), in plain PyTorch over the source-sorted CSR (the relation
    chunks are the kernels' own): an explicit per-edge gate or factor, then
    index_add_ by source row (dx) and by edge type (dr). Returns (dx, dr),
    None for a half not needed."""
    _require_backward_layouts(csr)
    src, dst = csr_rows(csr.src_rowptr), csr.src_dst.long()
    etype = csr.src_etype.long()
    weight = edge_weight.index_select(0, csr.src_eid.long())
    rel_e = relation.index_select(0, etype)
    x_e = x.index_select(0, src)
    w = weight[:, None]
    if kind != "moments":
        m = _message(rel_e, x_e, weight, mode)
        c = torch.zeros_like(m)
        for g, out in zip(planes[::2], planes[1::2]):
            c += torch.where(m == out.index_select(0, dst),
                             g.index_select(0, dst) * w, 0.0)
        del m
    else:
        m2 = (rel_e * x_e).mul_(2.0)
        c = planes[0].index_select(0, dst) * w
        c += m2.mul_(planes[1].index_select(0, dst) * w)
        del m2
    dx = dr = None
    if need_dx:
        msg = rel_e * c if mode == "mul_rel" else c
        dx = torch.zeros_like(x).index_add_(0, src, msg)
        del msg
    if need_dr:
        msg = x_e * c if mode == "mul_rel" else c
        dr = torch.zeros_like(relation).index_add_(0, etype, msg)
    return dx, dr


def _check_kind(kind: str, mode: str, kinds, planes=None):
    if kind not in kinds:
        raise ValueError(f"kind must be one of {tuple(kinds)}, got {kind!r}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if kind in ("addsq", "moments") and mode != "mul_rel":
        raise ValueError(f"{kind} is distmult (mul_rel) only")
    if planes is not None and len(planes) != _PLANES[kind]:
        raise ValueError(f"kind {kind!r} takes {_PLANES[kind]} planes, got "
                         f"{len(planes)}")


def pna_fwd_cuda(kind: str, csr, edge_weight, relation, x, mode: str):
    """K6 (``maxmin``: returns (mx, mn)), K7 (``addsq``: returns (s, sq)) or
    K4 (``max``, ``min``: returns (out,)) on CUDA tensors; the plain version
    on CPU tensors."""
    _check_kind(kind, mode, KINDS)
    if x.device.type == "cpu":
        return pna_fwd_plain(kind, csr, edge_weight, relation, x, mode)
    device = x.device
    num_rows, num_features = check_fwd_operands(
        _FWD_ID[kind], csr.rowptr, csr.src, csr.etype, csr.eid, edge_weight,
        relation, x)
    outputs = 1 if kind in _REDUCE else 2
    out = [torch.empty((num_rows, num_features), dtype=torch.float32,
                       device=device) for _ in range(outputs)]
    fn = _fwd_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(KINDS[kind], MODES[mode], csr.rowptr.data_ptr(),
                 csr.src.data_ptr(), csr.etype.data_ptr(), csr.eid.data_ptr(),
                 edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(),
                 out[0].data_ptr(), ptr(out[1] if outputs == 2 else None),
                 num_rows, num_features, stream)
    if err != 0:
        raise RuntimeError(f"{_FWD_ID[kind]} (rspmm_pna_fwd) launch failed "
                           f"with CUDA error {err}")
    launches[_FWD_ID[kind]] += 1
    return tuple(out)


# the backward's layouts, in the kernel's argument order
_BWD_LAYOUT = ("src_rowptr", "src_dst", "src_etype", "src_eid", "chunk_ptr",
               "chunk_rel", "rel_chunk_ptr", "rel_src", "rel_dst", "rel_eid")


def pna_bwd_cuda(kind: str, csr, edge_weight, relation, x, planes,
                 mode: str, need_dx=True, need_dr=True):
    """K6b (``argext_pair``, planes (g_mx, mx, g_mn, mn)), K5 (``argext``,
    planes (g, out)) or K7b (``moments``, planes (g_s, g_sq)) on CUDA
    tensors; the plain version on CPU tensors. Returns (dx, dr), None for a
    half that is not needed."""
    _check_kind(kind, mode, BWD_KINDS, planes)
    if x.device.type == "cpu":
        return pna_bwd_plain(kind, csr, edge_weight, relation, x, planes,
                             mode, need_dx, need_dr)
    device = x.device
    num_rows, num_relations, num_chunks, num_features = check_bwd_operands(
        _BWD_ID[kind], csr, _BWD_LAYOUT, edge_weight, relation, x,
        {f"plane {i}": p for i, p in enumerate(planes)})
    dx, dr, partial = bwd_outputs(x, num_relations, num_chunks, need_dx,
                                  need_dr)
    q = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
    fn = _bwd_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(BWD_KINDS[kind], MODES[mode],
                 *(getattr(csr, n).data_ptr() for n in _BWD_LAYOUT),
                 edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(),
                 *q, ptr(dx), ptr(dr), ptr(partial), num_rows, num_relations,
                 num_chunks, num_features, stream)
    if err != 0:
        raise RuntimeError(f"{_BWD_ID[kind]} (rspmm_pna_bwd) launch failed "
                           f"with CUDA error {err}")
    launches[_BWD_ID[kind]] += 1
    return dx, dr


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    fn = load_library("rspmm_pna_fwd").rspmm_pna_fwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = load_library("rspmm_pna_bwd").rspmm_pna_bwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 20
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn

"""Kernels K1 and K8f: the relational SpMM forward with sum aggregation, by
hand for Hopper (csrc/rspmm_fwd.cu, csrc/rspmm_rotate.cu), and their plain
PyTorch version.

Replaces ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather1 in modes
``mul_rel`` / ``add_rel`` with agg ``add`` (via rspmm_fwd_pallas):

    out[v] = Σ_{e=(s→v, r)} w[eid_e] · (rel[r] ⊙ x[s])      (mul_rel)
    out[v] = Σ_{e=(s→v, r)} w[eid_e] · (rel[r] + x[s])      (add_rel)

over a destination-sorted CSR (data/graph.py::Graph.prepare_csr); K1
reads it cut into segments of at most 256 edges (``Csr.segments``), so that
a hub row spreads over many warps. K8f
replaces rspmm_gather1 in mode ``rot_rel`` (via rspmm_rotate_fwd_pallas),
the RotatE message:

    out[v] = Σ_{e=(s→v, r)} (rel[r] ⊗ x[s]) · w[eid_e]          (rot_rel)

where each block of ``dim`` features holds the real parts in its first
half and the imaginary parts in its second, and ⊗ is the complex product
(``rotate_product``); K8f reads K1's segments too, in slices of 32
complex positions (csrc/rspmm_rotate.cu). Operands are flat: x [V_in, F],
relation [R, F], edge_weight [E] in original edge order, all float32;
out [V, F] with V = len(rowptr) - 1.

K1h is K1 with ``compute_dtype=bfloat16`` (rspmm_gather1 with bf16
operands, :1689-1724): the wrapper casts relation and x to bf16 once per
call, each message rel ⊙ x (or rel + x) is rounded to bf16 before the fp32
weight multiplies it, and the sum and the output stay fp32. It runs K1's
kernels with bf16 operands over K1's segments (csrc/rspmm_fwd.cu).

``rspmm_fwd_cuda`` (K1), ``rspmm_fwd_bf16_cuda`` (K1h) and
``rotate_fwd_cuda`` (K8f) launch their kernel for CUDA tensors and count
each launch in ``launches``, ``bf16_launches`` and ``rotate_launches``; for
CPU tensors they run ``rspmm_fwd_plain`` and ``rspmm_fwd_bf16_plain``.
``k1_plan``, ``k1h_plan`` and ``k8f_plan`` report how K1, K1h and K8f lay
out a call (the feature slice and whether the relation slice sits in
shared memory);
``hub_operands`` makes the hub rows their checks on the card use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .cuda_build import load_library

MODES = {"mul_rel": 0, "add_rel": 1}

# launches of the K1, K1h and K8f kernels since import (or since the caller
# last reset them)
launches = 0
bf16_launches = 0
rotate_launches = 0


def rotate_product(a, b, conj: bool = False) -> torch.Tensor:
    """a ⊗ b, or conj(a) ⊗ b, the complex product over the last axis, whose
    first half holds the real parts and second half the imaginary parts:
    the JAX package's formula (ultra_torchdrug_tpu/ops/rspmm.py:64-73; its
    ``rotate_conj`` negates a's imaginary part, which is conj here)."""
    h = a.shape[-1] // 2
    ar, ai, br, bi = a[..., :h], a[..., h:], b[..., :h], b[..., h:]
    if conj:
        return torch.cat([ar * br + ai * bi, ar * bi - br * ai], dim=-1)
    return torch.cat([ar * br - ai * bi, ar * bi + br * ai], dim=-1)


def rspmm_plain_edges(src, dst, etype, weight, relation, x, mode: str,
                      num_nodes: int, dim: int = 0) -> torch.Tensor:
    """The plain version over edge arrays: index_select the operands per edge,
    form the messages, index_add_ them into their destination rows. Modes
    ``rot_rel`` and ``rot_conj`` (rel ⊗ x and conj(rel) ⊗ x) take flat rows
    of blocks ``dim`` wide."""
    rel_e = relation.index_select(0, etype)
    x_e = x.index_select(0, src)
    if mode == "mul_rel":
        msg = rel_e * x_e
    elif mode == "add_rel":
        msg = rel_e + x_e
    elif mode in ("rot_rel", "rot_conj"):
        check_rotate_dim(x_e.shape[-1], dim)
        msg = rotate_product(rel_e.unflatten(-1, (-1, dim)),
                             x_e.unflatten(-1, (-1, dim)),
                             conj=mode == "rot_conj").flatten(-2)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    msg = msg * weight.reshape((-1,) + (1,) * (msg.dim() - 1))
    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=msg.dtype,
                      device=x.device)
    return out.index_add_(0, dst, msg)


def csr_rows(rowptr: torch.Tensor) -> torch.Tensor:
    """The row of each entry of a CSR: rowptr [N + 1] -> int64 [nnz]."""
    return torch.repeat_interleave(
        torch.arange(rowptr.numel() - 1, device=rowptr.device),
        (rowptr[1:] - rowptr[:-1]).long())


def check_rotate_dim(num_features: int, dim: int):
    """A rotate block must be even and divide the row."""
    if dim <= 0 or dim % 2 or num_features % dim:
        raise ValueError(f"rotate needs an even block width dividing the "
                         f"row: dim={dim}, {num_features} features")


def check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")


def rspmm_fwd_plain(rowptr, src, etype, eid, edge_weight, relation, x,
                    mode: str, dim: int = 0) -> torch.Tensor:
    """The same function as the kernels (K1; K8f for ``rot_rel``), in plain
    PyTorch, on the same CSR."""
    num_nodes = rowptr.numel() - 1
    return rspmm_plain_edges(src.long(), csr_rows(rowptr), etype.long(),
                             edge_weight.index_select(0, eid.long()),
                             relation, x, mode, num_nodes, dim)


def widen_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest, ties to even) and widened back to
    fp32: the values a bf16 kernel computes with."""
    return t.to(torch.bfloat16).float()


def rspmm_fwd_bf16_plain(rowptr, src, etype, eid, edge_weight, relation, x,
                         mode: str) -> torch.Tensor:
    """The same function as K1h, in plain PyTorch, on the same CSR: the
    operands rounded to bf16, each message formed in fp32 (exact for a
    product of two bf16 values) and rounded to bf16, then weighted and
    summed in fp32."""
    check_mode(mode)
    etype, src = etype.long(), src.long()
    rel_e = widen_bf16(relation).index_select(0, etype)
    x_e = widen_bf16(x).index_select(0, src)
    msg = widen_bf16(rel_e * x_e if mode == "mul_rel" else rel_e + x_e)
    msg.mul_(edge_weight.index_select(0, eid.long())[:, None])
    out = msg.new_zeros((rowptr.numel() - 1, x.shape[1]))
    return out.index_add_(0, csr_rows(rowptr), msg)


def _check(name, t, dtype, device, dim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_fwd_operands(kernel: str, rowptr, src, etype, eid, edge_weight,
                       relation, x, dtype=torch.float32) -> tuple:
    """Device, type and shape checks of a row-gather kernel's operands (K1,
    K1h, K4, K6, K7, K8f) over a destination-sorted CSR, relation and x of
    ``dtype``; returns (num_rows, num_features)."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {device}")
    for name, t in (("rowptr", rowptr), ("src", src), ("etype", etype),
                    ("eid", eid)):
        _check(name, t, torch.int32, device, 1)
    _check("edge_weight", edge_weight, torch.float32, device, 1)
    _check("relation", relation, dtype, device, 2)
    _check("x", x, dtype, device, 2)
    # edge_weight is gathered through eid: it may be longer than the CSR
    # (a ring bucket's CSR indexes the whole graph's weights)
    num_edges = src.numel()
    if etype.numel() != num_edges or eid.numel() != num_edges:
        raise ValueError("src, etype and eid must have one entry per edge")
    if relation.shape[1] != x.shape[1]:
        raise ValueError(f"relation width {relation.shape[1]} != x width "
                         f"{x.shape[1]}")
    if rowptr.numel() < 1:
        raise ValueError("rowptr must have at least one entry")
    return rowptr.numel() - 1, x.shape[1]


@dataclasses.dataclass(frozen=True)
class RowSegments:
    """K1's destination-row segments of one CSR (data/graph.py's
    ``Csr.segments``: seg_ptr, seg_out, long_rows, long_ptr), checked once,
    when made by ``of``: int32, 1-D and contiguous on one device, and
    consistent with each other and with the CSR's ``num_rows`` rows.
    ``num_partials`` counts the long rows' partial rows (every other row is
    one segment). K1's wrapper checks only their device and row count."""

    seg_ptr: torch.Tensor
    seg_out: torch.Tensor
    long_rows: torch.Tensor
    long_ptr: torch.Tensor
    num_rows: int
    num_segments: int
    num_long_rows: int
    num_partials: int

    @classmethod
    def of(cls, seg_ptr, seg_out, long_rows, long_ptr,
           num_rows: int) -> "RowSegments":
        for name, t in (("seg_ptr", seg_ptr), ("seg_out", seg_out),
                        ("long_rows", long_rows), ("long_ptr", long_ptr)):
            _check(name, t, torch.int32, seg_ptr.device, 1)
        num_segments, num_long = seg_ptr.numel() - 1, long_rows.numel()
        if (seg_out.numel() != num_segments
                or long_ptr.numel() != num_long + 1
                or num_segments < num_rows):
            raise ValueError("the segments do not match the CSR: build them "
                             "with data/graph.py::build_csr")
        return cls(seg_ptr, seg_out, long_rows, long_ptr, num_rows,
                   num_segments, num_long,
                   num_segments - (num_rows - num_long))


def rspmm_fwd_cuda(rowptr, src, etype, eid, edge_weight, relation, x,
                   mode: str, *, segments) -> torch.Tensor:
    """K1 on CUDA tensors; the plain version on CPU tensors, which does not
    read ``segments``. ``segments``: the CSR's destination-row segments
    (``Csr.segments``, a RowSegments), which cut each row of more than 256
    edges into segments summed apart, then in segment order."""
    check_mode(mode)
    if x.device.type == "cpu":
        return rspmm_fwd_plain(rowptr, src, etype, eid, edge_weight, relation,
                               x, mode)
    num_rows, num_features = check_fwd_operands(
        "K1", rowptr, src, etype, eid, edge_weight, relation, x)
    out = _segment_call(_kernel(), "K1", segments, src, etype, eid,
                        edge_weight, relation, x, num_rows, num_features,
                        MODES[mode])
    global launches
    launches += 1
    return out


def _segment_call(fn, kid: str, segments, src, etype, eid, edge_weight,
                  relation, x, num_rows: int, num_features: int, last: int):
    """One call of K1's, K1h's or K8f's entry point (``fn``: rspmm_fwd_k1's
    arguments, ``last`` its mode or K8f's block width) over ``segments``,
    with its output, weights' scratch and partial rows allocated here;
    raises naming ``kid`` where the call fails. Returns the output."""
    device = x.device
    check_segments(segments, device, num_rows)
    num_edges = src.numel()
    out = torch.empty((num_rows, num_features), dtype=torch.float32,
                      device=device)
    w_scratch = torch.empty((num_edges,), dtype=torch.float32, device=device)
    partial = (torch.empty((segments.num_partials, num_features),
                           dtype=torch.float32, device=device)
               if segments.num_partials else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(segments.seg_ptr.data_ptr(), segments.seg_out.data_ptr(),
                 segments.long_rows.data_ptr(), segments.long_ptr.data_ptr(),
                 src.data_ptr(), etype.data_ptr(), eid.data_ptr(),
                 edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(),
                 out.data_ptr(), w_scratch.data_ptr(), ptr(partial),
                 segments.num_segments, segments.num_long_rows, num_edges,
                 relation.shape[0], x.shape[0], num_features, last, stream)
    if err != 0:
        raise RuntimeError(f"{kid} ({fn.__name__}) launch failed with CUDA "
                           f"error {err}")
    return out


def check_segments(segments, device, num_rows: int):
    """``segments`` is a CSR's RowSegments (``Csr.segments``) of
    ``num_rows`` rows on ``device``."""
    if not isinstance(segments, RowSegments):
        raise TypeError(f"segments must be the CSR's RowSegments "
                        f"(Csr.segments), got {type(segments).__name__}")
    if segments.seg_ptr.device != device or segments.num_rows != num_rows:
        raise ValueError("the segments are not this CSR's: Csr.segments of "
                         "the CSR on x's device")


def ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def hub_operands(seed: int, device, V: int = 3000, E: int = 40000,
                 R: int = 7, duplicated: int = 0, hub: int = 10000) -> tuple:
    """K1's and K2's hub-row checks on the card: a Csr with destination hubs
    of ``hub`` (10,000) and 1,000 in-edges (rows 0 and 1), source hubs of
    ``hub`` and 1,000 out-edges (rows 2, 3), rows of 256 and 257 in- and
    out-edges (rows 4, 5 and 5, 4; each of 257 is cut into two segments),
    the last 5 rows without edges and the last relation without one; eid a
    permutation; weights in [0.5, 1.5] with a fifth masked to 0, from
    numpy's generator seeded with ``seed``. With ``duplicated`` the first
    that many edges that no planted row holds come twice, with the same
    weight (K6b's checks: their messages tie exactly). E must exceed the
    planted edges, 2 * hub + 3,026. Returns (csr, w) on ``device``."""
    from ..data.graph import build_csr

    rng = np.random.default_rng(seed)
    planted = {0: (hub, 0), 1: (1000, 0), 2: (0, hub), 3: (0, 1000),
               4: (256, 257), 5: (257, 256)}
    others = np.arange(len(planted), V - 5)
    src, dst = rng.choice(others, E), rng.choice(others, E)
    at = 0
    for row, (n_in, n_out) in planted.items():
        dst[at:at + n_in] = row
        src[at + n_in:at + n_in + n_out] = row
        at += n_in + n_out
    et = rng.integers(0, R - 1, E)
    copies = np.arange(at, at + duplicated)
    src, dst, et = (np.concatenate([a, a[copies]]) for a in (src, dst, et))
    ids = rng.permutation(E + duplicated)
    csr = build_csr(src, dst, et, V, R, backward=True, edge_ids=ids)
    w = rng.uniform(0.5, 1.5, E + duplicated).astype(np.float32)
    w[rng.uniform(size=E + duplicated) < 0.2] = 0.0
    w[ids[E:]] = w[ids[copies]]
    return csr.to(device), torch.from_numpy(w).to(device)


def k1_plan(num_relations: int, num_features: int, num_x_rows: int,
            num_segments: int, mode: str = "mul_rel") -> dict:
    """How K1 lays out a call of this shape on the card
    (csrc/rspmm_staged.cuh): features a slice, where the rel slice sits
    ("shared" memory, or rel rows "gathered" above the budget), its bytes,
    the slices and the CTAs a slice, on the 16-byte path where F % 4 == 0
    (operands aligned)."""
    return _fwd_plan("rspmm_k1_plan", num_features % 4 == 0, num_relations,
                     num_features, num_x_rows, num_segments, mode)


def k1h_plan(num_relations: int, num_features: int, num_x_rows: int,
             num_segments: int, mode: str = "mul_rel") -> dict:
    """How K1h lays out a call of this shape on the card, as k1_plan's: bf16
    slices of 128 features (the rel slice staged in bf16) on the 16-byte
    path where F % 8 == 0 (operands aligned)."""
    return _fwd_plan("rspmm_k1h_plan", num_features % 8 == 0, num_relations,
                     num_features, num_x_rows, num_segments, mode)


def _fwd_plan(name: str, vec: bool, num_relations: int, num_features: int,
              num_x_rows: int, num_segments: int, mode: str) -> dict:
    check_mode(mode)
    out = (ctypes.c_int * 5)()
    fn = getattr(load_library("rspmm_fwd"), name)
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(int(vec), num_relations, num_features, num_x_rows, num_segments,
             MODES[mode], ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    return plan_dict(out[:5])


def plan_dict(values) -> dict:
    slice_floats, shared, smem, slices, ctas = values
    return dict(slice_floats=slice_floats,
                rel="shared" if shared else "gathered", rel_smem_bytes=smem,
                slices=slices, ctas_per_slice=ctas)


def rspmm_fwd_bf16_cuda(rowptr, src, etype, eid, edge_weight, relation, x,
                        mode: str, *, segments) -> torch.Tensor:
    """K1h on CUDA tensors (fp32 relation and x, cast to bf16 here) over K1's
    destination-row segments (``Csr.segments``, as for rspmm_fwd_cuda); the
    plain version on CPU tensors, which does not read ``segments``. Returns
    fp32."""
    check_mode(mode)
    if x.device.type == "cpu":
        return rspmm_fwd_bf16_plain(rowptr, src, etype, eid, edge_weight,
                                    relation, x, mode)
    relation = relation.to(torch.bfloat16).contiguous()
    x = x.to(torch.bfloat16).contiguous()
    num_rows, num_features = check_fwd_operands(
        "K1h", rowptr, src, etype, eid, edge_weight, relation, x,
        dtype=torch.bfloat16)
    out = _segment_call(_bf16_kernel(), "K1h", segments, src, etype, eid,
                        edge_weight, relation, x, num_rows, num_features,
                        MODES[mode])
    global bf16_launches
    bf16_launches += 1
    return out


def rotate_fwd_cuda(rowptr, src, etype, eid, edge_weight, relation, x,
                    dim: int, *, segments) -> torch.Tensor:
    """K8f on CUDA tensors (rows of blocks ``dim`` wide) over K1's
    destination-row segments (``Csr.segments``, as for rspmm_fwd_cuda); the
    plain version on CPU tensors, which does not read ``segments``."""
    if x.device.type == "cpu":
        return rspmm_fwd_plain(rowptr, src, etype, eid, edge_weight, relation,
                               x, "rot_rel", dim)
    num_rows, num_features = check_fwd_operands(
        "K8f", rowptr, src, etype, eid, edge_weight, relation, x)
    check_rotate_dim(num_features, dim)
    out = _segment_call(_rotate_kernel(), "K8f", segments, src, etype, eid,
                        edge_weight, relation, x, num_rows, num_features, dim)
    global rotate_launches
    rotate_launches += 1
    return out


def k8f_plan(num_relations: int, num_features: int, num_x_rows: int,
             num_segments: int, dim: int) -> dict:
    """How K8f lays out a call of this shape on the card
    (csrc/rspmm_rotate.cu), as k1_plan's: a slice of 32 complex positions
    (64 floats), on the float4 path where D/2 % 4 == 0 (operands
    aligned)."""
    check_rotate_dim(num_features, dim)
    out = (ctypes.c_int * 5)()
    fn = load_library("rspmm_rotate").rspmm_rotate_fwd_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(int((dim // 2) % 4 == 0), num_relations, num_features,
             num_x_rows, num_segments, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"rspmm_rotate_fwd_plan failed with CUDA error "
                           f"{err}")
    return plan_dict(out[:5])


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("rspmm_fwd").rspmm_fwd_k1
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bf16_kernel():
    fn = load_library("rspmm_fwd").rspmm_fwd_k1h
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rotate_kernel():
    fn = load_library("rspmm_rotate").rspmm_rotate_fwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

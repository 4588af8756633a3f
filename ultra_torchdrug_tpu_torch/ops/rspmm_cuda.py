"""Kernels K1 and K8f: the relational SpMM forward with sum aggregation, by
hand for Hopper (csrc/rspmm_fwd.cu, csrc/rspmm_rotate.cu), and their plain
PyTorch version.

Replaces ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather1 in modes
``mul_rel`` / ``add_rel`` with agg ``add`` (via rspmm_fwd_pallas):

    out[v] = Σ_{e=(s→v, r)} w[eid_e] · (rel[r] ⊙ x[s])      (mul_rel)
    out[v] = Σ_{e=(s→v, r)} w[eid_e] · (rel[r] + x[s])      (add_rel)

over a destination-sorted CSR (data/graph.py::Graph.prepare_csr). K8f
replaces rspmm_gather1 in mode ``rot_rel`` (via rspmm_rotate_fwd_pallas),
the RotatE message:

    out[v] = Σ_{e=(s→v, r)} (rel[r] ⊗ x[s]) · w[eid_e]          (rot_rel)

where each block of ``dim`` features holds the real parts in its first
half and the imaginary parts in its second, and ⊗ is the complex product
(``rotate_product``). Operands are flat: x [V_in, F], relation [R, F],
edge_weight [E] in original edge order, all float32; out [V, F] with
V = len(rowptr) - 1.

K1h is K1 with ``compute_dtype=bfloat16`` (rspmm_gather1 with bf16
operands, :1689-1724): the wrapper casts relation and x to bf16 once per
call, each message rel ⊙ x (or rel + x) is rounded to bf16 before the fp32
weight multiplies it, and the sum and the output stay fp32.

``rspmm_fwd_cuda`` (K1), ``rspmm_fwd_bf16_cuda`` (K1h) and
``rotate_fwd_cuda`` (K8f) launch their kernel for CUDA tensors and count
each launch in ``launches``, ``bf16_launches`` and ``rotate_launches``; for
CPU tensors they run ``rspmm_fwd_plain`` and ``rspmm_fwd_bf16_plain``.
"""

from __future__ import annotations

import ctypes
import functools

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
    num_edges = src.numel()
    if (etype.numel() != num_edges or eid.numel() != num_edges
            or edge_weight.numel() != num_edges):
        raise ValueError("src, etype, eid and edge_weight must have one "
                         "entry per edge")
    if relation.shape[1] != x.shape[1]:
        raise ValueError(f"relation width {relation.shape[1]} != x width "
                         f"{x.shape[1]}")
    if rowptr.numel() < 1:
        raise ValueError("rowptr must have at least one entry")
    return rowptr.numel() - 1, x.shape[1]


def rspmm_fwd_cuda(rowptr, src, etype, eid, edge_weight, relation, x,
                   mode: str) -> torch.Tensor:
    """K1 on CUDA tensors; the plain version on CPU tensors."""
    check_mode(mode)
    if x.device.type == "cpu":
        return rspmm_fwd_plain(rowptr, src, etype, eid, edge_weight, relation,
                               x, mode)
    device = x.device
    num_rows, num_features = check_fwd_operands(
        "K1", rowptr, src, etype, eid, edge_weight, relation, x)
    out = torch.empty((num_rows, num_features), dtype=torch.float32,
                      device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(rowptr.data_ptr(), src.data_ptr(), etype.data_ptr(),
                 eid.data_ptr(), edge_weight.data_ptr(), relation.data_ptr(),
                 x.data_ptr(), out.data_ptr(), num_rows, num_features,
                 MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"rspmm_fwd_k1 launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out


def rspmm_fwd_bf16_cuda(rowptr, src, etype, eid, edge_weight, relation, x,
                        mode: str) -> torch.Tensor:
    """K1h on CUDA tensors (fp32 relation and x, cast to bf16 here); the
    plain version on CPU tensors. Returns fp32."""
    check_mode(mode)
    if x.device.type == "cpu":
        return rspmm_fwd_bf16_plain(rowptr, src, etype, eid, edge_weight,
                                    relation, x, mode)
    device = x.device
    relation = relation.to(torch.bfloat16).contiguous()
    x = x.to(torch.bfloat16).contiguous()
    num_rows, num_features = check_fwd_operands(
        "K1h", rowptr, src, etype, eid, edge_weight, relation, x,
        dtype=torch.bfloat16)
    out = torch.empty((num_rows, num_features), dtype=torch.float32,
                      device=device)
    fn = _bf16_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(rowptr.data_ptr(), src.data_ptr(), etype.data_ptr(),
                 eid.data_ptr(), edge_weight.data_ptr(), relation.data_ptr(),
                 x.data_ptr(), out.data_ptr(), num_rows, num_features,
                 MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"rspmm_fwd_k1h launch failed with CUDA error "
                           f"{err}")
    global bf16_launches
    bf16_launches += 1
    return out


def rotate_fwd_cuda(rowptr, src, etype, eid, edge_weight, relation, x,
                    dim: int) -> torch.Tensor:
    """K8f on CUDA tensors (rows of blocks ``dim`` wide); the plain version
    on CPU tensors."""
    if x.device.type == "cpu":
        return rspmm_fwd_plain(rowptr, src, etype, eid, edge_weight, relation,
                               x, "rot_rel", dim)
    device = x.device
    num_rows, num_features = check_fwd_operands(
        "K8f", rowptr, src, etype, eid, edge_weight, relation, x)
    check_rotate_dim(num_features, dim)
    out = torch.empty((num_rows, num_features), dtype=torch.float32,
                      device=device)
    fn = _rotate_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(rowptr.data_ptr(), src.data_ptr(), etype.data_ptr(),
                 eid.data_ptr(), edge_weight.data_ptr(), relation.data_ptr(),
                 x.data_ptr(), out.data_ptr(), num_rows, num_features, dim,
                 stream)
    if err != 0:
        raise RuntimeError(f"K8f (rspmm_rotate_fwd) launch failed with CUDA "
                           f"error {err}")
    global rotate_launches
    rotate_launches += 1
    return out


def _fwd_symbol(name: str):
    fn = getattr(load_library("rspmm_fwd"), name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return _fwd_symbol("rspmm_fwd_k1")


@functools.lru_cache(maxsize=None)
def _bf16_kernel():
    return _fwd_symbol("rspmm_fwd_k1h")


@functools.lru_cache(maxsize=None)
def _rotate_kernel():
    fn = load_library("rspmm_rotate").rspmm_rotate_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

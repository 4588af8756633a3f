"""Kernel K9, the ring shift of the edge-partitioned ring path, by hand for
Hopper (csrc/ring_shift.cu), and its plain PyTorch version (counterpart of
ultra_torchdrug_tpu/parallel/rdma.py).

Replaces ultra_torchdrug_tpu/parallel/rdma.py::_rotate_leaf (reached
through ``rdma_rotate``), the TPU's remote-copy boundary exchange: after the
call, shard s holds what shard s - 1 held, the function of
``jax.lax.ppermute(perm=[(i, (i + 1) % n)])``, for any dtype and shape.

The ring keeps the n shards' blocks as one block-stacked tensor
[n * v_block, ...] on the mesh's one device (parallel/mesh.py), block s
being shard s's. ``ring_shift`` returns a new tensor whose block (s + 1) mod n
is a copy of block s: ``ring_shift_blocks`` (K9) on CUDA tensors, counting
each launch in ``launches``, and ``ring_shift_plain`` on CPU tensors.
``ring_shift_plain`` is also the ``ppermute`` exchange on both devices.
``ring_shift_blocks`` takes per-shard block lists, so that the same kernel
serves shards on separate cards once the mesh places them there.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Sequence

import torch

from ..ops.cuda_build import load_library

MAX_SHARDS = 64  # csrc/ring_shift.cu's kMaxShards

# launches of K9 since import (or since the caller last reset it)
launches = 0


def _blocks(x: torch.Tensor, n_shards: int) -> list:
    if x.shape[0] % n_shards:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_shards} "
                         "equal blocks")
    return list(x.chunk(n_shards, dim=0)) if x.shape[0] else [x] * n_shards


def ring_shift_plain(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The plain version: a new tensor whose block s is a copy of block
    s - 1 of the block-stacked x [n_shards * v_block, ...]."""
    if n_shards == 1:
        return x.clone()
    blocks = _blocks(x, n_shards)
    return torch.cat([blocks[(s - 1) % n_shards] for s in range(n_shards)])


def ring_shift(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """K9 on a CUDA tensor, the plain version on a CPU tensor: x
    [n_shards * v_block, ...] block-stacked, returns a new tensor whose
    block (s + 1) mod n is block s."""
    if x.device.type == "cpu":
        return ring_shift_plain(x, n_shards)
    if x.device.type != "cuda":
        raise ValueError(f"K9 runs on CUDA tensors, got {x.device}")
    _check_shards(n_shards, n_shards)
    if x.shape[0] % n_shards:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_shards} "
                         "equal blocks")
    # the blocks of one contiguous tensor share its device, dtype and block
    # shape and are contiguous; the output is a new allocation, so no block
    # of it overlaps a source block
    x = x.contiguous()
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size() // n_shards
    src, dst = x.data_ptr(), out.data_ptr()
    _launch(x.device, [src + s * nbytes for s in range(n_shards)],
            [dst + s * nbytes for s in range(n_shards)], nbytes)
    return out


def ring_shift_blocks(src: Sequence[torch.Tensor],
                      dst: Sequence[torch.Tensor]) -> None:
    """K9: copy src[s] into dst[(s + 1) % n] for every shard s, on CUDA
    tensors of one dtype and one size, each contiguous; no destination may
    overlap a source. All blocks must lie on one device (shards on several
    cards are ROADMAP Queue 1 item 9, several cards)."""
    n = len(src)
    _check_shards(n, len(dst))
    first = src[0]
    device = first.device
    if device.type != "cuda":
        raise ValueError(f"K9 runs on CUDA tensors, got {device}")
    for name, blocks in (("source", src), ("destination", dst)):
        for t in blocks:
            if t.device != device:
                raise NotImplementedError(
                    f"K9 {name} block on {t.device}, expected {device}: "
                    "shards on several cards are not ported yet (ROADMAP "
                    "Queue 1 item 9, several cards)")
            if t.dtype != first.dtype or t.shape != first.shape:
                raise ValueError(f"K9 blocks must share one dtype and shape: "
                                 f"{t.dtype} {tuple(t.shape)} vs "
                                 f"{first.dtype} {tuple(first.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"K9 {name} blocks must be contiguous")
    nbytes = first.numel() * first.element_size()
    starts = [t.data_ptr() for t in src]
    targets = [t.data_ptr() for t in dst]
    if nbytes and any(s < d + nbytes and d < s + nbytes
                      for d in targets for s in starts):
        raise ValueError("K9 destination blocks must not overlap the "
                         "source blocks")
    _launch(device, starts, targets, nbytes)


def _check_shards(n_src: int, n_dst: int):
    if n_src != n_dst or not 1 <= n_src <= MAX_SHARDS:
        raise ValueError(f"K9 takes 1 to {MAX_SHARDS} source and as many "
                         f"destination blocks, got {n_src} and {n_dst}")


def _launch(device: torch.device, src: list, dst: list, nbytes: int):
    """Launch K9 on ``device``'s current stream over the block addresses
    ``src`` and ``dst`` (block s of src lands in block (s + 1) % n of
    dst), each ``nbytes`` long; count the launch."""
    if nbytes == 0:
        return
    n = len(src)
    fn = _kernel()
    # entering torch.cuda.device costs more than the launch: only when the
    # blocks lie on another device than the current one
    current = (device.index is None
               or device.index == torch.cuda.current_device())
    with contextlib.nullcontext() if current else torch.cuda.device(device):
        err = fn((ctypes.c_void_p * n)(*src), (ctypes.c_void_p * n)(*dst), n,
                 nbytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K9 (ring_shift) launch failed with CUDA error "
                           f"{err}")
    global launches
    launches += 1


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("ring_shift").ring_shift_k9
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

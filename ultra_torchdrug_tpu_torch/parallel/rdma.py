"""Kernel K9, the ring shift of the edge-partitioned ring path, by hand for
Hopper (csrc/ring_shift.cu), and its plain PyTorch version (counterpart of
ultra_torchdrug_tpu/parallel/rdma.py).

Replaces ultra_torchdrug_tpu/parallel/rdma.py::_rotate_leaf (reached
through ``rdma_rotate``), the TPU's remote-copy boundary exchange: after the
call, shard s holds what shard s - 1 held, the function of
``jax.lax.ppermute(perm=[(i, (i + 1) % n)])``, for any dtype and shape.

The ring (parallel/ring_rspmm.py) keeps one block a shard, block s on
shard s's device (parallel/mesh.py). ``shift_blocks`` returns the shifted
list: K9 on CUDA blocks, each source device pushing its blocks into the
right neighbours' new blocks with one launch, as the TPU kernel pushes a
shard's block into its right neighbour's buffer; ``shift_blocks_plain``
(PyTorch's copies between devices) is its plain version and the
``ppermute`` exchange. Across cards a launch stores to peer memory: peer
access is checked and enabled once a pair of cards, outside the launch
path (``enable_peer_access``), and the launch is ordered against both
cards' current streams with events (``_launch_ordered``). With every
block on one device one launch shifts them all. Each launch adds one to
``launches``, and one to ``peer_launches`` when it stores to another card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Sequence

import torch

from ..ops.cuda_build import load_library
from .placement import indexed

MAX_SHARDS = 64  # csrc/ring_shift.cu's kMaxShards

# launches of K9 since import (or since the caller last reset them), and
# those of them that stored to another card
launches = 0
peer_launches = 0


def shift_blocks_plain(blocks: Sequence[torch.Tensor],
                       devices: Sequence) -> list:
    """The plain version over per-shard blocks: entry s of the result is
    block s - 1 on ``devices[s]`` (the block itself where it already lies
    there; no block is written in place)."""
    n = len(blocks)
    return [blocks[(s - 1) % n].to(devices[s]) for s in range(n)]


def shift_blocks(blocks: Sequence[torch.Tensor], devices: Sequence) -> list:
    """K9 over per-shard blocks, block s on ``devices[s]``: returns new
    blocks whose entry (s + 1) mod n is a copy of block s on ``devices[(s
    + 1) % n]``, one allocation a destination device and one launch a
    source device (one launch in all when every block lies on one device).
    The blocks share one dtype and shape and are contiguous. CPU blocks
    take the plain version."""
    first = blocks[0]
    if first.device.type == "cpu":
        return shift_blocks_plain(blocks, devices)
    n = len(blocks)
    devices = [indexed(d) for d in devices]
    _check_blocks(blocks, devices)
    out = [None] * n
    for d in dict.fromkeys(devices):
        shards = [t for t in range(n) if devices[t] == d]
        buf = torch.empty((len(shards),) + tuple(first.shape),
                          dtype=first.dtype, device=d)
        for i, t in enumerate(shards):
            out[t] = buf[i]
    nbytes = first.numel() * first.element_size()
    plan = []
    for a in dict.fromkeys(devices):
        pairs = [(s, (s + 1) % n) for s in range(n) if devices[s] == a]
        dst = [0] * len(pairs)
        for i, (_, t) in enumerate(pairs):
            # K9 sends source block i to destination block (i + 1) mod m
            dst[(i + 1) % len(pairs)] = out[t].data_ptr()
        peers = list(dict.fromkeys(devices[t] for _, t in pairs
                                   if devices[t] != a))
        for peer in peers:
            enable_peer_access(a, peer)
        plan.append((a, peers, [blocks[s].data_ptr() for s, _ in pairs], dst,
                     nbytes))
    _launch_ordered(plan)
    return out


def _check_blocks(blocks: Sequence[torch.Tensor], devices: Sequence):
    n, first = len(blocks), blocks[0]
    if len(devices) != n or not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"K9 takes 1 to {MAX_SHARDS} blocks and a device "
                         f"each, got {n} blocks and {len(devices)} devices")
    for t, d in zip(blocks, devices):
        if d.type != "cuda" or t.device != d:
            raise ValueError(f"K9 runs on CUDA blocks, each on its shard's "
                             f"device: a block on {t.device} for {d}")
        if t.dtype != first.dtype or t.shape != first.shape:
            raise ValueError(f"K9 blocks must share one dtype and shape: "
                             f"{t.dtype} {tuple(t.shape)} vs "
                             f"{first.dtype} {tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError("K9 blocks must be contiguous")


# (card, peer) pairs whose peer access this process has enabled
_PEERS = set()


def enable_peer_access(device, peer) -> None:
    """Let ``device``'s kernels store to ``peer``'s memory (once a pair,
    outside the launch path). Raises where the host offers no peer access
    between the two cards: K9 then cannot push between them, and the
    ``ppermute`` exchange is the one that runs there."""
    device, peer = torch.device(device), torch.device(peer)
    key = (device.index, peer.index)
    if key in _PEERS:
        return
    if not torch.cuda.can_device_access_peer(device, peer):
        raise RuntimeError(
            f"K9 between cards needs peer access from {device} to {peer}, "
            "which this host does not offer (ring_exchange: ppermute copies "
            "through PyTorch instead)")
    fn = _enable_peer()
    with torch.cuda.device(device):
        err = fn(peer.index)
    if err != 0:
        raise RuntimeError(f"enabling peer access from {device} to {peer} "
                           f"failed with CUDA error {err}")
    _PEERS.add(key)


def _launch_ordered(launches: list):
    """``_launch`` each of ``launches`` ((device, peers, source addresses,
    destination addresses, block bytes), one a source card) on its card's current stream, ordered against the current
    streams of the peers that own its destination blocks: first every
    sender waits for the work that its receivers queued before (the
    allocator may have handed a destination block out of memory that they
    were still reading), then every card launches, then every receiver
    waits for its senders' stores before anything it queues next, its
    frees included, so a destination block is not reused while a store to
    it is in flight. A receiver's wait comes after its own launch, so the
    cards' launches of one shift do not wait for one another."""
    for device, peers, *_ in launches:
        for peer in peers:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(peer))
            torch.cuda.current_stream(device).wait_event(ready)
    for device, peers, src, dst, nbytes in launches:
        _launch(device, src, dst, nbytes)
        if peers:
            global peer_launches
            peer_launches += 1
    for device, peers, *_ in launches:
        if peers:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            for peer in peers:
                torch.cuda.current_stream(peer).wait_event(done)


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
def _enable_peer():
    fn = load_library("ring_shift").ring_shift_enable_peer
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("ring_shift").ring_shift_k9
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

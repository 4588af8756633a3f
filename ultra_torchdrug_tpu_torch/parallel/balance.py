"""Degree-balanced node relabelling for the ring path (counterpart of
ultra_torchdrug_tpu/parallel/balance.py).

The ring splits node rows into n contiguous blocks of v_block = ceil(V/n)
rows, and a shard's work in each ring step is the edge count of its bucket.
On a hub-dominated graph contiguous id blocks can carry very different edge
counts, and the slowest shard gates every step. The fix is a host-side
relabelling: a permutation of node ids under which the contiguous equal
blocks of the new id space carry near-equal total degree. Kernels, layouts
and the ring are untouched; the model maps indices at its boundary scatter
and its readout.

On the undirected propagation graph ([directed; inverse] edge order) each
node's in-degree equals its out-degree, so one permutation balances both the
forward (destination-block) and backward (source-block) buckets.

The JAX package runs the assignment in native/graphlib.cpp and keeps
``_lpt_python`` as its bit-identical fallback; this port keeps the Python
version.
"""

from __future__ import annotations

import heapq

import numpy as np


def degree_balanced_permutation(src, dst, num_nodes: int, n_blocks: int):
    """Greedy capacity-constrained LPT assignment of nodes to blocks.

    Nodes are taken in decreasing total-degree order; each goes to the
    currently lightest block that still has a free slot (every block holds
    exactly vb = ceil(V/n) new ids).

    Returns (to_new, to_old):
      to_new: int32 [V] — new id of each original node
      to_old: int32 [n_blocks * vb] — original node for each new id; empty
        slots (when n*vb > V) point at row ``num_nodes``, the zero pad row
        of a row-padded operand.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    vb = -(-num_nodes // n_blocks)
    deg = (np.bincount(src, minlength=num_nodes)
           + np.bincount(dst, minlength=num_nodes))
    to_new = _lpt_python(deg, n_blocks, vb)
    to_old = np.full(n_blocks * vb, num_nodes, np.int32)
    to_old[to_new] = np.arange(num_nodes, dtype=np.int32)
    return to_new, to_old


def _lpt_python(deg: np.ndarray, n_blocks: int, vb: int) -> np.ndarray:
    """The LPT assignment: each node, heaviest first, to the lightest block
    with a free slot (ties to the lower block)."""
    order = np.argsort(-deg, kind="stable")
    heap = [(0, s) for s in range(n_blocks)]
    heapq.heapify(heap)
    counts = np.zeros(n_blocks, np.int64)
    to_new = np.empty(len(deg), np.int32)
    for node in order:
        load, s = heapq.heappop(heap)
        to_new[node] = s * vb + counts[s]
        counts[s] += 1
        if counts[s] < vb:
            heapq.heappush(heap, (load + int(deg[node]), s))
    return to_new


def block_edge_counts(key, num_nodes: int, n_blocks: int) -> np.ndarray:
    """Edges per block when rows are split into contiguous ceil(V/n) blocks
    keyed by ``key`` (dst for the forward buckets, src for the backward)."""
    vb = -(-num_nodes // n_blocks)
    return np.bincount(np.asarray(key, np.int64) // vb, minlength=n_blocks)


def imbalance(key, num_nodes: int, n_blocks: int) -> float:
    """max/mean per-block edge count (1.0 == perfectly balanced)."""
    counts = block_edge_counts(key, num_nodes, n_blocks)
    mean = counts.mean()
    return float(counts.max() / mean) if mean else 1.0


def resolve_balance(balance, src, dst, num_nodes: int, n_blocks: int) -> bool:
    """balance='auto': relabel only when the contiguous split is imbalanced
    (more than 25% above the mean on either partition)."""
    if balance != "auto":
        return bool(balance)
    return (imbalance(dst, num_nodes, n_blocks) > 1.25
            or imbalance(src, num_nodes, n_blocks) > 1.25)

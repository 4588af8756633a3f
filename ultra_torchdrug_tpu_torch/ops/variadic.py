"""Ragged-batch ("variadic") primitives in static-shape form (counterpart of
ultra_torchdrug_tpu/ops/variadic.py): the reference's sort-trick
formulations (each segment keyed apart, one global sort) with padded
fixed-size outputs instead of ragged ones. Classic NBFNet's beam search
uses ``variadic_topk``.

A ragged batch is (values [N], sizes [S]) with sum(sizes) == N: segment s
holds the next sizes[s] values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def segment_ids_from_sizes(sizes: torch.Tensor, total: int) -> torch.Tensor:
    """repeat_interleave(sizes) with the output length ``total``: position i
    belongs to segment j iff cumsum(sizes)[j-1] <= i < cumsum(sizes)[j]."""
    ends = torch.cumsum(sizes, 0)
    return torch.searchsorted(
        ends, torch.arange(total, device=sizes.device), right=True)


def _segment_order(keys: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by segment, then by ``keys`` ascending,
    ties in index order (jnp.lexsort((keys, seg)))."""
    order = torch.argsort(keys, stable=True)
    return order[torch.argsort(seg[order], stable=True)]


def variadic_sort(values: torch.Tensor, sizes: torch.Tensor,
                  descending: bool = False):
    """Sort within each segment; returns (sorted values, permutation)."""
    seg = segment_ids_from_sizes(sizes, values.shape[0])
    order = _segment_order(-values if descending else values, seg)
    return values[order], order


def variadic_shuffle(generator: Optional[torch.Generator],
                     values: torch.Tensor, sizes: torch.Tensor):
    """An independent uniform shuffle within each segment, drawn from
    ``generator``; returns (shuffled values, sizes)."""
    rand = torch.rand(values.shape[0], generator=generator,
                      device=values.device)
    _, order = variadic_sort(rand, sizes)
    return values[order], sizes


def _worst_value(dtype: torch.dtype, largest: bool):
    """The padding value of empty segments: the worst under the order."""
    if dtype.is_floating_point:
        return -math.inf if largest else math.inf
    info = torch.iinfo(dtype)
    return info.min if largest else info.max


def variadic_topk(values: torch.Tensor, sizes: torch.Tensor, k: int,
                  largest: bool = True):
    """Per-segment top-k, padded: segments shorter than k repeat their last
    valid entry (torchdrug's variadic_topk, which the reference's beam
    search uses).

    Returns (topk_values [S, k], topk_index [S, k]), the index into
    ``values``. Ties keep the order of ``values``. Empty segments get
    sentinel rows: index -1 and the dtype's worst value (-inf or iinfo.min
    when largest, +inf or iinfo.max otherwise); without them an empty
    segment's start would be the next segment's and give that segment's
    best entry.
    """
    n = values.shape[0]
    seg = segment_ids_from_sizes(sizes, n)
    v = values if largest else -values
    # within a segment descending by v, ties in index order: a stable sort
    # by -v, then a stable sort by segment
    order = _segment_order(-v, seg)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.minimum(torch.arange(k, device=values.device)[None, :],
                         torch.clamp(sizes[:, None] - 1, min=0))
    pos = torch.clamp(starts[:, None] + rank, 0, max(n - 1, 0))
    idx = order[pos]
    empty = sizes[:, None] == 0
    vals = torch.where(empty, _worst_value(values.dtype, largest), values[idx])
    idx = torch.where(empty, -1, idx)
    return vals, idx


def variadic_topks(values: torch.Tensor, sizes: torch.Tensor,
                   ks: torch.Tensor, largest: bool = True):
    """Per-segment top-k with a k per segment: (top values [S, max_k], top
    index [S, max_k], valid [S, max_k]); row s holds its top
    min(ks[s], sizes[s]) entries, then repeats of its last valid entry, and
    ``valid`` marks its first ks[s] slots. Empty segments get
    ``variadic_topk``'s sentinel rows and no valid slot."""
    n = values.shape[0]
    max_k = int(ks.max()) if ks.numel() else 0
    seg = segment_ids_from_sizes(sizes, n)
    order = _segment_order(-(values if largest else -values), seg)
    starts = torch.cumsum(sizes, 0) - sizes
    slots = torch.arange(max_k, device=values.device)[None, :]
    rank = torch.minimum(slots, torch.clamp(sizes[:, None] - 1, min=0))
    pos = torch.clamp(starts[:, None] + rank, 0, max(n - 1, 0))
    idx = order[pos]
    empty = sizes[:, None] == 0
    vals = torch.where(empty, _worst_value(values.dtype, largest), values[idx])
    idx = torch.where(empty, -1, idx)
    valid = (slots < ks[:, None]) & ~empty
    return vals, idx, valid


def variadic_unique(values: torch.Tensor, sizes: torch.Tensor):
    """Deduplicate within segments: (unique values [N], new sizes [S], keep
    [N]). Each segment's distinct values, ascending, are compacted to the
    front of its slots; the slots behind them hold 0 and keep False."""
    n = values.shape[0]
    seg = segment_ids_from_sizes(sizes, n)
    order = _segment_order(values, seg)
    sv, sseg = values[order], seg[order]
    first = torch.ones(n, dtype=torch.bool, device=values.device)
    first[1:] = (sv[1:] != sv[:-1]) | (sseg[1:] != sseg[:-1])
    new_sizes = torch.zeros_like(sizes).index_add_(
        0, sseg, first.to(sizes.dtype))
    rank = torch.cumsum(first.to(torch.int64), 0) - 1  # rank among uniques
    starts_new = torch.cumsum(new_sizes, 0) - new_sizes
    starts_old = torch.cumsum(sizes, 0) - sizes
    dest = starts_old[sseg] + rank - starts_new[sseg]
    # the duplicates of one (segment, value) share a slot and write the
    # same value to it
    out = torch.zeros_like(values)
    out[dest] = sv
    keep = torch.zeros(n, dtype=torch.int32, device=values.device)
    keep = keep.scatter_reduce(0, dest, first.to(torch.int32), "amax") > 0
    return out, new_sizes, keep


def bincount(values: torch.Tensor, length: int) -> torch.Tensor:
    """The int32 count of each value in [0, length); values outside it are
    dropped (jax.ops.segment_sum's rule)."""
    inside = (values >= 0) & (values < length)
    return torch.zeros(length, dtype=torch.int32,
                       device=values.device).index_add_(
        0, values[inside].long(),
        torch.ones(int(inside.sum()), dtype=torch.int32,
                   device=values.device))

"""Ragged-batch ("variadic") primitives in static-shape form (counterpart of
ultra_torchdrug_tpu/ops/variadic.py): the parts that classic NBFNet's beam
search uses.

A ragged batch is (values [N], sizes [S]) with sum(sizes) == N: segment s
holds the next sizes[s] values.
"""

from __future__ import annotations

import math

import torch


def segment_ids_from_sizes(sizes: torch.Tensor, total: int) -> torch.Tensor:
    """repeat_interleave(sizes) with the output length ``total``: position i
    belongs to segment j iff cumsum(sizes)[j-1] <= i < cumsum(sizes)[j]."""
    ends = torch.cumsum(sizes, 0)
    return torch.searchsorted(
        ends, torch.arange(total, device=sizes.device), right=True)


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
    order = torch.argsort(-v, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.minimum(torch.arange(k, device=values.device)[None, :],
                         torch.clamp(sizes[:, None] - 1, min=0))
    pos = torch.clamp(starts[:, None] + rank, 0, max(n - 1, 0))
    idx = order[pos]
    empty = sizes[:, None] == 0
    vals = torch.where(empty, _worst_value(values.dtype, largest), values[idx])
    idx = torch.where(empty, -1, idx)
    return vals, idx

"""Filtered-ranking truth masks (counterpart of the mask half of
ultra_torchdrug_tpu/ops/match.py): fixed-shape boolean masks with the
semantics of torchdrug's wildcard ``graph.match``."""

from __future__ import annotations

import torch


def _truth_mask(anchor, rel, batch_anchor, batch_rel, other, num_nodes):
    """[B, V] bool: True at (b, v) if some edge has (anchor == batch_anchor[b],
    rel == batch_rel[b]) and its ``other`` endpoint is v."""
    hit = ((anchor[None, :] == batch_anchor[:, None])
           & (rel[None, :] == batch_rel[:, None]))  # [B, E]
    counts = torch.zeros((hit.shape[0], num_nodes), dtype=torch.int32,
                         device=hit.device)
    return counts.index_add_(1, other, hit.to(torch.int32)) > 0


def tail_truth_mask(edge_list, pos_h, pos_r, num_nodes: int) -> torch.Tensor:
    """[B, V] bool: v is a true tail of (pos_h[b], v, pos_r[b])."""
    return _truth_mask(edge_list[:, 0], edge_list[:, 2], pos_h, pos_r,
                       edge_list[:, 1], num_nodes)


def head_truth_mask(edge_list, pos_t, pos_r, num_nodes: int) -> torch.Tensor:
    """[B, V] bool: v is a true head of (v, pos_t[b], pos_r[b])."""
    return _truth_mask(edge_list[:, 1], edge_list[:, 2], pos_t, pos_r,
                       edge_list[:, 0], num_nodes)

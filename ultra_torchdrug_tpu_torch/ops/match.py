"""Static-shape triple matching (counterpart of ultra_torchdrug_tpu/ops/match.py):
fixed-shape boolean masks with the semantics of torchdrug's wildcard
``graph.match``.

  * ``edges_in_patterns`` — [E] bool: does edge e equal any (h, t, r)
    pattern? (sort-merge join; used for easy-edge removal)
  * ``build_pattern_join`` / ``edges_in_patterns_indexed`` — the same mask
    against edges sorted once on the host: one binary search per pattern
  * ``tail_truth_mask`` / ``head_truth_mask`` — [B, V] bool: which candidate
    entities complete a true triple (filtered ranking, strict negatives)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def edges_in_patterns(edge_list: torch.Tensor,
                      patterns: torch.Tensor) -> torch.Tensor:
    """[E] bool — True where edge (h, t, r) equals ANY pattern row.

    edge_list: int [E, 3] (head, tail, relation); patterns: int [P, 3], fully
    specified (for a wildcard relation pass 0 in column 2 of both)."""
    E = edge_list.shape[0]
    rows = torch.cat([edge_list, patterns.to(edge_list.dtype)])
    # unique(dim=0) sorts the rows lexicographically: equal rows share an id
    _, run_id = torch.unique(rows, dim=0, return_inverse=True)
    run_has_pattern = torch.zeros(rows.shape[0], dtype=torch.bool,
                                  device=rows.device)
    run_has_pattern[run_id[E:]] = True
    return run_has_pattern[run_id[:E]]


@dataclasses.dataclass(frozen=True)
class PatternJoinIndex:
    """Edges sorted by the pair key (h, t * r_mult + r) (or (h, t) for the
    remove_one_hop wildcard), packed into one int64 ``h << 32 | tr``, with
    the sort permutation. A pure function of topology."""

    key_sorted: torch.Tensor  # int64 [E]
    perm: torch.Tensor  # int64 [E]: sorted position -> original edge id
    r_mult: int

    def to(self, device) -> "PatternJoinIndex":
        return dataclasses.replace(self, key_sorted=self.key_sorted.to(device),
                                   perm=self.perm.to(device))


def build_pattern_join(edge_index: np.ndarray, edge_type: np.ndarray,
                       wildcard_rel: bool = False
                       ) -> Optional[PatternJoinIndex]:
    """Host-side index construction. Returns None when the combined (t, r)
    key does not fit 31 bits (callers then take the sort join), as the JAX
    package does."""
    ei = np.asarray(edge_index, np.int64)
    et = np.asarray(edge_type, np.int64)
    h, t = ei[:, 0], ei[:, 1]
    if wildcard_rel:
        r_mult, r = 1, np.zeros_like(t)
    else:
        r_mult = 1 << int(max(et.max(initial=0), 0)).bit_length()
        r = et
    tr = t * r_mult + r
    if tr.size and int(tr.max()) >= 2**31:
        return None
    key = (h << 32) | tr
    order = np.argsort(key, kind="stable")
    return PatternJoinIndex(key_sorted=torch.from_numpy(key[order]),
                            perm=torch.from_numpy(order),
                            r_mult=int(r_mult))


def edges_in_patterns_indexed(index: PatternJoinIndex,
                              patterns: torch.Tensor) -> torch.Tensor:
    """[E] bool in ORIGINAL edge order — the same result as
    ``edges_in_patterns`` against the edges the index was built over
    (duplicate edges all match). patterns: [P, 3]; for a wildcard-relation
    index pass relation 0 in column 2."""
    E = index.key_sorted.shape[0]
    p = patterns.long()
    q = (p[:, 0] << 32) | (p[:, 1] * index.r_mult + p[:, 2])
    left = torch.searchsorted(index.key_sorted, q, side="left")
    right = torch.searchsorted(index.key_sorted, q, side="right")
    # union of the [left, right) runs: +1/-1 fences and a prefix sum
    delta = torch.zeros(E + 1, dtype=torch.int32, device=q.device)
    ones = torch.ones_like(left, dtype=torch.int32)
    delta.index_add_(0, left, ones).index_add_(0, right, -ones)
    covered = torch.cumsum(delta, 0)[:E] > 0
    out = torch.empty(E, dtype=torch.bool, device=q.device)
    out[index.perm] = covered
    return out


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

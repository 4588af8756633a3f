"""Negative sampling under static shapes (counterpart of
ultra_torchdrug_tpu/ops/sampling.py).

Strict negatives: uniform draws *with replacement* from each query's
candidate set (every entity that does NOT complete a true triple in the fact
graph), as [B, V] masks and inverse-CDF sampling. The uniform draws come
from an explicit ``torch.Generator``; ``indices_from_uniform`` turns given
draws into indices, so the same draws give the same negatives as the JAX
package.
"""

from __future__ import annotations

import torch

from .match import head_truth_mask, tail_truth_mask


def indices_from_uniform(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """mask: bool [B, V]; u: float32 [B, S] uniform in [0, 1). Returns int64
    [B, S]: for each draw, the j-th True position of its row with
    j = floor(u * count). Rows with no True position return V - 1 (cannot
    occur for strict negatives: a positive triple leaves >= 1 candidate)."""
    counts = mask.sum(dim=-1)
    j = torch.floor(u * counts.clamp(min=1)[:, None]).long()
    j = torch.minimum(j, (counts - 1).clamp(min=0)[:, None])
    cum = torch.cumsum(mask.to(torch.int32), dim=-1)
    # index of the (j+1)-th True = first v with cum[v] == j + 1
    idx = torch.searchsorted(cum, (j + 1).to(torch.int32), side="left")
    return idx.clamp(max=mask.shape[1] - 1)


def sample_from_mask(generator: torch.Generator, mask: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
    """Uniform draws (with replacement) from the True positions of each row:
    int64 [B, num_samples]."""
    u = torch.rand((mask.shape[0], num_samples), generator=generator,
                   device=mask.device)
    return indices_from_uniform(mask, u)


def _candidates(fact_edge_list, pos_h, pos_t, pos_r, num_nodes: int):
    """Candidate masks: [B/2, V] tails for the first half of the batch,
    [B - B/2, V] heads for the second; an entity is a candidate unless it
    completes a true triple in the fact graph."""
    half = pos_h.shape[0] // 2
    t_truth = tail_truth_mask(fact_edge_list, pos_h[:half], pos_r[:half],
                              num_nodes)
    h_truth = head_truth_mask(fact_edge_list, pos_t[half:], pos_r[half:],
                              num_nodes)
    return ~t_truth, ~h_truth


def strict_negatives(generator: torch.Generator, fact_edge_list, pos_h, pos_t,
                     pos_r, num_nodes: int, num_negative: int,
                     u=None) -> torch.Tensor:
    """[B, num_negative] strict negatives: corrupted tails in the first half
    of the batch, corrupted heads in the second (task.py's batch
    assembly). ``u = (u_t [B/2, N], u_h [B - B/2, N])`` replaces the
    generator's uniform draws."""
    t_ok, h_ok = _candidates(fact_edge_list, pos_h, pos_t, pos_r, num_nodes)
    if u is None:
        return torch.cat([sample_from_mask(generator, t_ok, num_negative),
                          sample_from_mask(generator, h_ok, num_negative)], 0)
    return torch.cat([indices_from_uniform(t_ok, u[0]),
                      indices_from_uniform(h_ok, u[1])], 0)

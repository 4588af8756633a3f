"""Knowledge-graph completion losses, ranking and metrics (counterpart of
ultra_torchdrug_tpu/tasks/kg.py):

  * BCE with self-adversarial negative weights; margin ranking; cross
    entropy on the positive
  * filtered rank = 1 + #{allowed v : score_v >= score_pos}, ties pessimistic
  * metrics mr, mrr, hits@k, the unbiased hits@k_N estimator against N
    sampled negatives, each optionally restricted to the tail or head
    direction by a -tail / -head suffix, and per relation
  * the toy protocol: 50 sampled negatives, the optimistic/pessimistic
    average rank
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch


def bce_self_adversarial(scores: torch.Tensor,
                         adversarial_temperature: float = 1.0,
                         sample_weight: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """scores: [B, 1+N], column 0 is the positive. Returns the scalar loss.
    The negatives' softmax weights carry no gradient."""
    num_negative = scores.shape[1] - 1
    target = torch.zeros_like(scores)
    target[:, 0] = 1.0
    # binary_cross_entropy_with_logits, written out as the JAX package does
    loss = (scores.clamp(min=0) - scores * target
            + torch.log1p(torch.exp(-scores.abs())))
    if adversarial_temperature > 0:
        neg_w = torch.softmax(
            scores[:, 1:].detach() / adversarial_temperature, dim=-1)
    else:
        neg_w = torch.full_like(scores[:, 1:], 1.0 / num_negative)
    weight = torch.cat([torch.ones_like(scores[:, :1]), neg_w], dim=1)
    loss = (loss * weight).sum(dim=-1) / weight.sum(dim=-1)
    if sample_weight is not None:
        return (loss * sample_weight).sum() / sample_weight.sum()
    return loss.mean()


def margin_ranking(scores: torch.Tensor, margin: float = 6.0) -> torch.Tensor:
    """criterion='ranking'."""
    pos, neg = scores[:, :1], scores[:, 1:]
    return (margin - (pos - neg)).clamp(min=0).mean()


def cross_entropy_positive(scores: torch.Tensor) -> torch.Tensor:
    """criterion='ce': the positive is class 0."""
    return (-torch.log_softmax(scores, dim=-1)[:, 0]).mean()


def filtered_ranking(scores: torch.Tensor, target: torch.Tensor,
                     truth_mask: torch.Tensor,
                     filtered: bool = True) -> torch.Tensor:
    """scores [B, V]; target [B]; truth_mask [B, V] True where the candidate
    completes a known true triple (filtered out, the target included).
    Returns the int64 ranking [B]."""
    pos = scores.gather(1, target[:, None])  # [B, 1]
    geq = scores >= pos
    if filtered:
        geq = geq & ~truth_mask
    return geq.sum(dim=-1) + 1


def _metric_scores(ranking: torch.Tensor, name: str,
                   num_candidates: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Per-sample scores for one metric over a ranking (integer, or float
    under the toy protocol). ``hits@k_N`` is the unbiased estimate of
    hits@k against N sampled negatives from the rank among
    ``num_candidates`` allowed candidates: Σ_{i<k} C(N, i) p^i (1-p)^(N-i)
    with p = (rank - 1) / num_candidates."""
    if name == "mr":
        return ranking.to(torch.float32)
    if name == "mrr":
        return 1.0 / ranking.to(torch.float32)
    if name.startswith("hits@"):
        values = name[5:].split("_")
        threshold = int(values[0])
        if len(values) > 1:
            num_sample = int(values[1])
            fp_rate = (ranking - 1).to(torch.float32) / num_candidates
            score = torch.zeros_like(fp_rate)
            for i in range(threshold):
                score = score + math.comb(num_sample, i) * (fp_rate ** i) * (
                    (1 - fp_rate) ** (num_sample - i))
            return score
        return (ranking <= threshold).to(torch.float32)
    raise ValueError(f"unknown metric {name!r}")


def evaluate_ranking(ranking: torch.Tensor, metrics: Sequence[str],
                     num_candidates: Optional[torch.Tensor] = None,
                     rel_index: Optional[torch.Tensor] = None,
                     num_relations: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """ranking: [N, 2] (tail direction in column 0, head in column 1) or
    [N]. Metric names may carry a -tail / -head suffix. ``num_candidates``
    (the ranking's shape) is the count of allowed candidates that the
    sampled hits@k_N estimator needs; ``rel_index`` (the same shape) with
    ``num_relations`` adds each undirected metric's mean per relation as
    ``{metric}_rel_{r}`` (0 for a relation without samples)."""
    out = {}
    for m in metrics:
        if "-" in m:
            base, direction = m.split("-")
            col = {"tail": 0, "head": 1}[direction]
            r = ranking[:, col]
            nc = None if num_candidates is None else num_candidates[:, col]
        else:
            base, r, nc = m, ranking, num_candidates
        score = _metric_scores(r, base, nc)
        if rel_index is not None and num_relations is not None \
                and "-" not in m:
            flat_s, flat_r = score.reshape(-1), rel_index.reshape(-1)
            sums = torch.zeros(num_relations, dtype=score.dtype).index_add_(
                0, flat_r, flat_s)
            counts = torch.bincount(flat_r, minlength=num_relations)
            per_rel = sums / counts.clamp(min=1)
            for ridx in range(num_relations):
                out[f"{m}_rel_{ridx}"] = per_rel[ridx]
        out[m] = score.mean()
    return out


def toy_eval_negatives(generator: Optional[torch.Generator],
                       allowed_mask: torch.Tensor,
                       num_samples: int = 50) -> torch.Tensor:
    """The toy protocol's draw: [B, min(num_samples, V)] candidate indices
    per row, distinct, uniform without replacement among the allowed ones
    (``allowed_mask`` [B, V]); a row with fewer allowed candidates fills up
    with disallowed ones. The top-k of uniform keys, disallowed keys set
    below every allowed one."""
    B, V = allowed_mask.shape
    keys = torch.rand((B, V), generator=generator, device=allowed_mask.device)
    keys = torch.where(allowed_mask, keys, keys - 2.0)
    return keys.topk(min(num_samples, V), dim=1).indices


def toy_eval_ranking(scores_pos: torch.Tensor, scores: torch.Tensor,
                     neg_index: torch.Tensor) -> torch.Tensor:
    """The toy protocol's rank of each positive (``scores_pos`` [B, 1])
    among its sampled negatives (``neg_index`` [B, S] into ``scores``
    [B, V]): the average of the optimistic and the pessimistic rank, a
    float (x.5 on ties)."""
    neg = scores.gather(1, neg_index)
    optimistic = (scores_pos < neg).sum(dim=-1)
    pessimistic = (scores_pos <= neg).sum(dim=-1)
    return 0.5 * (optimistic + pessimistic).to(torch.float32) + 1

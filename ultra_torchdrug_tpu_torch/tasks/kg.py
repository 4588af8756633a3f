"""Knowledge-graph completion losses, ranking and metrics (counterpart of
ultra_torchdrug_tpu/tasks/kg.py):

  * BCE with self-adversarial negative weights; margin ranking; cross
    entropy on the positive
  * filtered rank = 1 + #{allowed v : score_v >= score_pos}, ties pessimistic
  * metrics mr, mrr, hits@k, each optionally restricted to the tail or head
    direction by a -tail / -head suffix
"""

from __future__ import annotations

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


def _metric_scores(ranking: torch.Tensor, name: str) -> torch.Tensor:
    """Per-sample scores for one metric over an integer ranking."""
    if name == "mr":
        return ranking.to(torch.float32)
    if name == "mrr":
        return 1.0 / ranking.to(torch.float32)
    if name.startswith("hits@"):
        if "_" in name:
            raise NotImplementedError(
                f"{name}: the sampled hits@k estimator comes with the "
                "inductive evaluation slice")
        return (ranking <= int(name[5:])).to(torch.float32)
    raise ValueError(f"unknown metric {name!r}")


def evaluate_ranking(ranking: torch.Tensor,
                     metrics: Sequence[str]) -> Dict[str, torch.Tensor]:
    """ranking: [N, 2] (tail direction in column 0, head in column 1) or
    [N]. Metric names may carry a -tail / -head suffix."""
    out = {}
    for m in metrics:
        if "-" in m:
            base, direction = m.split("-")
            r = ranking[:, {"tail": 0, "head": 1}[direction]]
        else:
            base, r = m, ranking
        out[m] = _metric_scores(r, base).mean()
    return out

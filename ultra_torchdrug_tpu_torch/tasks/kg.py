"""Knowledge-graph completion ranking and metrics (counterpart of the ranking
half of ultra_torchdrug_tpu/tasks/kg.py):

  * filtered rank = 1 + #{allowed v : score_v >= score_pos}, ties pessimistic
  * metrics mr, mrr, hits@k, each optionally restricted to the tail or head
    direction by a -tail / -head suffix
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


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

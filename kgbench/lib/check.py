"""The numbers that decide ``correct``, each held to its limit.

The reference computes in float64. Eval: ``score_gap``, the widest gap
between the program's and the reference's score of an entity, over the
largest |score| of its row; ``rank_off``, the program's filtered ranks
that differ from those its own scores give among the entities the
reference's filter allows; ``cand_off``, the counts of allowed candidates
that differ. Training: ``loss_gap``, the
widest relative gap of a step's loss; ``grad_gap`` and ``update_gap``, the
worst leaf's gap between the norms of the program's and the reference's
first gradient and of the parameters' change over the checked steps, over
the larger of the reference leaf's norm and the median leaf's
(``grad_gap_median`` and ``update_gap_median``: the median leaf's gap);
``loss1_gap``, the first step's loss alone; ``neg_bad``,
the program's negatives that complete a fact triple; ``loss_nonfinite``,
the window's steps whose loss is not finite. A limit of 0 is exact.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, Optional

import torch


def score_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    scale = ref.abs().amax(dim=1).clamp(min=1e-30)
    return float(((prog - ref).abs().amax(dim=1) / scale).max())


def rank_off(prog_rank: torch.Tensor, prog_scores: torch.Tensor, target,
             truth) -> int:
    """How many of the program's filtered ranks differ from the rank that
    its own scores give among the entities the reference allows."""
    pos = prog_scores.gather(1, target[:, None])
    want = ((prog_scores >= pos) & ~truth).sum(-1) + 1
    return int((prog_rank != want).sum())


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖),
    over ``names`` (every leaf by default)."""
    names = list(ref if names is None else names)
    ref_norms = {n: float(ref[n].norm()) for n in names}
    median = float(torch.tensor(list(ref_norms.values())).median())
    return {n: abs(float(prog[n].norm()) - ref_norms[n])
            / max(ref_norms[n], median, 1e-30) for n in names}


def worst_and_median(gaps: Dict[str, float]) -> tuple:
    """(the worst leaf's gap, its name, the median leaf's gap)."""
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, float(torch.tensor(list(gaps.values())).median())


def moving_leaves(ref_grads: Dict[str, torch.Tensor],
                  share: float = 1e-3) -> list:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others are nought to rounding (a key's bias under
    softmax) and move under Adam by round-off alone."""
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return [n for n, v in norms.items() if v >= share * median]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, [[name, number, limit], ...]): every number at or under its
    limit (a missing or non-finite number fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        rows.append([name, value, limit])
    return ok, rows


def report(rows) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)

"""The skewed knowledge graph of a traffic mix, drawn with numpy from the
run's seed: heads and tails with p(i) ∝ i^-exponent over a seeded
permutation of the entities, relations uniform; the first distinct triples
in draw order, split at random into train, valid and test by the counts
the mix gives (a published dataset's)."""

from __future__ import annotations

import numpy as np
import torch

from . import seeds
from ..reference import common


def skewed_kg(params: dict, seed: int, index: int = 0) -> dict:
    """{"train", "valid", "test": int64 [n, 3] (h, t, r) arrays,
    "entities", "relations"} of the graph ``params`` describes (keys
    entities, relations, train, valid, test, exponent)."""
    rng = seeds.rng(seed, "graph", index)
    V, R = int(params["entities"]), int(params["relations"])
    counts = [int(params[k]) for k in ("train", "valid", "test")]
    total = sum(counts)
    order = rng.permutation(V)
    cdf = np.cumsum(np.arange(1, V + 1, dtype=np.float64)
                    ** -float(params["exponent"]))
    cdf /= cdf[-1]
    keys = np.empty(0, np.int64)
    while True:
        h = order[np.searchsorted(cdf, rng.random(total), side="right")
                  .clip(max=V - 1)]
        t = order[np.searchsorted(cdf, rng.random(total), side="right")
                  .clip(max=V - 1)]
        r = rng.integers(0, R, total)
        keys = np.concatenate([keys, (h * V + t) * R + r])
        _, first = np.unique(keys, return_index=True)
        if len(first) >= total:
            break
    keys = keys[np.sort(first)[:total]]
    tri = np.stack([keys // R // V, keys // R % V, keys % R], 1)
    tri = tri[rng.permutation(total)]
    n_train, n_valid = counts[0], counts[1]
    return {"train": tri[:n_train], "valid": tri[n_train:n_train + n_valid],
            "test": tri[n_train + n_valid:], "entities": V, "relations": R}


def degrees(graph: dict) -> np.ndarray:
    """Each entity's count of triples (any split) that it heads or tails."""
    tri = np.concatenate([graph[k] for k in ("train", "valid", "test")])
    V = graph["entities"]
    return (np.bincount(tri[:, 0], minlength=V)
            + np.bincount(tri[:, 1], minlength=V))


def relation_edges(graph: dict, device) -> int:
    """The edges of the graph's relation graph (the reference's)."""
    h, t, r = (torch.as_tensor(graph["train"][:, i], device=device)
               for i in range(3))
    return int(common.relation_adjacency(h, t, r, graph["entities"],
                                         graph["relations"]).sum())

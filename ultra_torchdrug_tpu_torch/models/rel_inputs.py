"""Initial node features for relation-graph models (counterpart of
ultra_torchdrug_tpu/models/rel_inputs.py): an input type joins one or more
of ones, zeros, glorot, embedding, degree_encoding, random_walk_encoding and
random_walk (or rrpe) with "__", and the features of its parts are summed.
The shipped RelNBFNet conditions on the query relation alone and does not
read these features.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.rwse import random_walk_se

NUM_DEGREES = 1000
NUM_RANDOM_WALK_BUCKETS = 40


def rel_input_param_init(input_type: str, num_relations: int, dim: int,
                         generator: torch.Generator) -> dict:
    """The learned tables that some input types read, each
    ``{"weight": [rows, dim]}`` drawn N(0, 1) from ``generator`` (on its
    device) as an embedding: ``rel_embedding`` [num_relations],
    ``deg_embedding`` [NUM_DEGREES] and ``random_walk_embedding``
    [NUM_RANDOM_WALK_BUCKETS + 1]."""
    rows = {"rel_embedding": ("embedding", num_relations),
            "deg_embedding": ("degree_encoding", NUM_DEGREES),
            "random_walk_embedding": ("random_walk_encoding",
                                      NUM_RANDOM_WALK_BUCKETS + 1)}
    return {name: {"weight": torch.empty(n, dim, device=generator.device)
                   .normal_(generator=generator)}
            for name, (part, n) in rows.items() if part in input_type}


def build_initial_features(graph, input_type: str, dim: int,
                           params: Optional[dict] = None,
                           node_feature: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """[V, dim] summed initial features for an input_type recipe.
    ``params`` holds ``rel_input_param_init``'s tables, ``node_feature``
    replaces the random-walk features computed from the graph, and
    ``generator`` draws glorot's U(-s, s), s = sqrt(6 / (V + dim))."""
    params = params or {}
    V = graph.num_nodes
    out = torch.zeros((V, dim), dtype=torch.float32, device=graph.device)

    def random_walk(k):
        if node_feature is not None:
            return node_feature.to(graph.device)
        return torch.from_numpy(random_walk_se(graph, k)).to(graph.device)

    for k in input_type.split("__"):
        if k == "ones":
            out = out + 1.0
        elif k == "zeros":
            pass
        elif k == "glorot":
            if generator is None:
                raise ValueError("input type 'glorot' draws from a generator: "
                                 "pass generator=")
            scale = (6.0 / (V + dim)) ** 0.5
            draw = torch.empty((V, dim), device=generator.device)
            out = out + draw.uniform_(-scale, scale,
                                      generator=generator).to(graph.device)
        elif k == "embedding":
            out = out + params["rel_embedding"]["weight"][:V]
        elif k == "degree_encoding":
            # the weighted degree truncated toward zero, then clipped
            deg = torch.clamp(graph.degree_out().to(torch.int32), 0,
                              NUM_DEGREES - 1)
            out = out + params["deg_embedding"]["weight"][deg.long()]
        elif k == "random_walk_encoding":
            # 8 landing probabilities in buckets of 1/1000, truncated toward
            # zero and clipped to the last bucket
            buckets = (random_walk(8) * 1000).to(torch.int32)[:, :8]
            buckets = torch.clamp(buckets, max=NUM_RANDOM_WALK_BUCKETS)
            out = out + params["random_walk_embedding"]["weight"][
                buckets.long()].mean(dim=1)
        elif k in ("random_walk", "rrpe"):
            out = out + random_walk(dim)
        else:
            raise ValueError(f"unknown input type component {k!r}")
    return out

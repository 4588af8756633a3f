"""Initial node features for relation-graph models (counterpart of
ultra_torchdrug_tpu/models/rel_inputs.py). The shipped configs use the
``ones`` input type only; the other types are ROADMAP Queue 1 item 7.
Note that the shipped RelNBFNet conditions on the query relation alone and
does not read these features."""

from __future__ import annotations

import torch


def build_initial_features(graph, input_type: str, dim: int) -> torch.Tensor:
    """[V, dim] summed initial features for an input_type recipe
    (components joined by "__")."""
    out = torch.zeros((graph.num_nodes, dim), dtype=torch.float32,
                      device=graph.device)
    for k in input_type.split("__"):
        if k == "ones":
            out = out + 1.0
        else:
            raise NotImplementedError(
                f"input type {k!r}: only 'ones' is ported; the others are "
                "ROADMAP Queue 1 item 7")
    return out

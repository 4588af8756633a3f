"""The harness's view of the program: the datasets it is handed, built
from the harness's triples with the program's own containers."""

from __future__ import annotations

import numpy as np


def dataset(graph: dict, name: str = "kgbench"):
    from ultra_torchdrug_tpu_torch.data.datasets import TransductiveDataset
    from ultra_torchdrug_tpu_torch.data.graph import Graph

    splits = [graph[k].astype(np.int32) for k in ("train", "valid", "test")]
    every = Graph.from_triplets(np.concatenate(splits), graph["entities"],
                                graph["relations"])
    return TransductiveDataset(name, every, *splits)

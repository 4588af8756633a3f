"""Dataset containers and synthetic generators (counterpart of
ultra_torchdrug_tpu/data/datasets.py). The generators use numpy's
``default_rng``, so a seed gives the same triples in both packages."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .graph import Graph


@dataclasses.dataclass
class TransductiveDataset:
    name: str
    graph: Graph  # all edges (train + valid + test): the filter graph
    train: np.ndarray  # [N, 3] (h, t, r)
    valid: np.ndarray
    test: np.ndarray

    @property
    def num_entities(self) -> int:
        return self.graph.num_nodes

    @property
    def num_relations(self) -> int:
        return self.graph.num_relations

    def fact_graph(self, fact_ratio: Optional[float] = None, seed: int = 0):
        """Train-edge graph (optionally only a fact_ratio subset as facts,
        the rest of train kept as supervision). Returns
        (fact_graph, train_triplets)."""
        if not fact_ratio:
            return (Graph.from_triplets(self.train, self.num_entities,
                                        self.num_relations),
                    self.train)
        rng = np.random.default_rng(seed)
        n = len(self.train)
        perm = rng.permutation(n)
        length = int(n * fact_ratio)
        fact_idx, train_idx = perm[:length], perm[length:]
        fact = Graph.from_triplets(self.train[fact_idx], self.num_entities,
                                   self.num_relations)
        return fact, self.train[train_idx]


@dataclasses.dataclass
class InductiveDataset:
    name: str
    train_graph: Graph
    valid_graph: Graph
    test_graph: Graph
    graph: Graph  # transductive edges (filter graph for train/valid)
    inductive_graph: Graph  # inductive edges (filter graph for test)
    train: np.ndarray
    valid: np.ndarray
    test: np.ndarray

    @property
    def num_relations(self) -> int:
        return self.train_graph.num_relations


@dataclasses.dataclass
class JointDataset:
    name: str
    datasets: List[TransductiveDataset]


def synthetic_transductive(
    name="SynthKG", num_nodes=60, num_edges=400, num_relations=7, seed=0,
    valid_frac=0.1, test_frac=0.1,
) -> TransductiveDataset:
    rng = np.random.default_rng(seed)
    triplets = np.unique(
        np.stack([
            rng.integers(0, num_nodes, num_edges),
            rng.integers(0, num_nodes, num_edges),
            rng.integers(0, num_relations, num_edges),
        ], axis=1),
        axis=0,
    ).astype(np.int32)
    rng.shuffle(triplets)
    n = len(triplets)
    nv, nt = int(n * valid_frac), int(n * test_frac)
    valid, test, train = (triplets[:nv], triplets[nv:nv + nt],
                          triplets[nv + nt:])
    graph = Graph.from_triplets(triplets, num_nodes, num_relations)
    return TransductiveDataset(name, graph, train, valid, test)


def synthetic_inductive(name="SynthInductiveKG", num_relations=7,
                        seed=0) -> InductiveDataset:
    trans = synthetic_transductive(
        name + "-trans", num_nodes=50, num_edges=350,
        num_relations=num_relations, seed=seed)
    ind = synthetic_transductive(
        name + "-ind", num_nodes=40, num_edges=280,
        num_relations=num_relations, seed=seed + 1)
    train_graph = Graph.from_triplets(trans.train, trans.num_entities,
                                      num_relations)
    test_graph = Graph.from_triplets(ind.train, ind.num_entities,
                                     num_relations)
    return InductiveDataset(
        name=name,
        train_graph=train_graph,
        valid_graph=test_graph,  # use_inductive_valid=yes (shipped config)
        test_graph=test_graph,
        graph=trans.graph,
        inductive_graph=ind.graph,
        train=trans.train,
        valid=ind.valid,
        test=ind.test,
    )


def synthetic_compositional(
    name="SynthCompositionalKG",
    num_nodes=200,
    offsets=(1, 2, 3, 5, 8),
    per_relation=400,
    seed=0,
) -> TransductiveDataset:
    """Learnable-structure KG: relation r maps h -> (h + offset_r) mod V,
    with compositional offsets (3 = 1+2, 8 = 3+5, ...), so held-out triples
    follow from multi-hop paths and training must lift eval MRR far above
    random."""
    rng = np.random.default_rng(seed)
    tri = []
    for r, o in enumerate(offsets):
        for h in rng.integers(0, num_nodes, per_relation):
            tri.append((h, (h + o) % num_nodes, r))
    tri = np.unique(np.asarray(tri, np.int32), axis=0)
    rng.shuffle(tri)
    n = len(tri)
    valid, test, train = tri[: n // 10], tri[n // 10: n // 5], tri[n // 5:]
    graph = Graph.from_triplets(tri, num_nodes, len(offsets))
    return TransductiveDataset(name, graph, train, valid, test)

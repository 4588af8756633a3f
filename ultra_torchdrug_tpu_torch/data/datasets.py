"""Dataset containers and synthetic generators (counterpart of
ultra_torchdrug_tpu/data/datasets.py). The generators use numpy's
``default_rng``, so a seed gives the same triples in both packages."""

from __future__ import annotations

import dataclasses
from typing import Optional

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

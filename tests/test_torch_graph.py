"""Graph, relation graph and synthetic data of the PyTorch port against the
JAX package: exact equality of every integer array, on numpy inputs made
from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data import datasets as jds
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu_torch.data import datasets as tds
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.data.relgraph import (
    build_relation_graph as t_relgraph,
)


def _triplets(rng, V=37, E=300, R=6):
    return np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                     rng.integers(0, R, E)], 1).astype(np.int32)


def _same(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def test_from_triplets_and_edge_list(rng):
    tri = _triplets(rng)
    jg, tg = JGraph.from_triplets(tri, 37, 6), TGraph.from_triplets(tri, 37, 6)
    assert (tg.num_nodes, tg.num_edges, tg.num_relations) == (
        jg.num_nodes, jg.num_edges, jg.num_relations)
    _same(tg.edge_index, jg.edge_index)
    _same(tg.edge_type, jg.edge_type)
    _same(tg.edge_weight, jg.edge_weight)
    _same(tg.edge_list, jg.edge_list)


def test_undirected_with_inverse_order(rng):
    tri = _triplets(rng)
    jg = JGraph.from_triplets(tri, 37, 6).undirected_with_inverse()
    tg = TGraph.from_triplets(tri, 37, 6).undirected_with_inverse()
    assert tg.num_relations == jg.num_relations == 12
    _same(tg.edge_index, jg.edge_index)
    _same(tg.edge_type, jg.edge_type)
    _same(tg.edge_weight, jg.edge_weight)
    # [directed; inverse], inverse etype r + R
    E = len(tri)
    np.testing.assert_array_equal(tg.edge_index[E:].numpy(), tri[:, 1::-1])
    np.testing.assert_array_equal(tg.edge_type[E:].numpy(), tri[:, 2] + 6)


def test_degree_out_and_masking(rng):
    tri = _triplets(rng)
    keep = rng.uniform(size=len(tri)) > 0.3
    jg = JGraph.from_triplets(tri, 37, 6)
    tg = TGraph.from_triplets(tri, 37, 6)
    _same(tg.degree_out(), jg.degree_out())  # unit weights: exact counts
    jm = jg.mask_edges(jnp.asarray(keep))
    tm = tg.mask_edges(torch.from_numpy(keep))
    assert tm.num_edges == len(tri)  # masked edges keep their rows
    _same(tm.edge_weight, jm.edge_weight)
    _same(tm.degree_out(), jm.degree_out())


def test_relation_graph_edges(rng):
    tri = _triplets(rng, V=30, E=200, R=5)
    jr = j_relgraph(JGraph.from_triplets(tri, 30, 5))
    tr = t_relgraph(TGraph.from_triplets(tri, 30, 5))
    assert (tr.num_nodes, tr.num_relations) == (jr.num_nodes, 4)

    def rows(edge_list):
        return sorted(map(tuple, np.asarray(edge_list).tolist()))

    assert rows(tr.edge_list.numpy()) == rows(jr.edge_list)


def test_prepare_dense_adjacency(rng):
    tri = _triplets(rng, V=30, E=200, R=5)
    jr = j_relgraph(JGraph.from_triplets(tri, 30, 5)).prepare_dense()
    tr = t_relgraph(TGraph.from_triplets(tri, 30, 5)).prepare_dense()
    assert tr.dense_adj is not None and jr.dense_adj is not None
    _same(tr.dense_adj, jr.dense_adj)
    # same thresholds: too large or too sparse returns the graph unchanged
    jg, tg = JGraph.from_triplets(tri, 30, 5), TGraph.from_triplets(tri, 30, 5)
    for kw in (dict(max_bytes=0), dict(min_density=0.05),
               dict(min_density=0.06), dict(max_bytes=30 * 30 * 5 * 4)):
        assert (tg.prepare_dense(**kw).dense_adj is None) == (
            jg.prepare_dense(**kw).dense_adj is None), kw
    # weight-only transforms drop the folded-in adjacency
    assert tr.with_edge_weight(tr.edge_weight * 2).dense_adj is None


@pytest.mark.parametrize("V,E", [(37, 300), (50, 20)])
def test_prepare_csr_covers_every_edge_once(rng, V, E):
    tri = _triplets(rng, V=V, E=E)
    g = TGraph.from_triplets(tri, V, 6).undirected_with_inverse().prepare_csr()
    csr = g.csr
    assert all(t.dtype == torch.int32 for t in (csr.rowptr, csr.src,
                                                 csr.etype, csr.eid))
    rowptr = csr.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == g.num_edges
    assert np.all(np.diff(rowptr) >= 0)
    eid = csr.eid.numpy()
    np.testing.assert_array_equal(np.sort(eid), np.arange(g.num_edges))
    ei, et = g.edge_index.numpy(), g.edge_type.numpy()
    np.testing.assert_array_equal(csr.src.numpy(), ei[eid, 0])
    np.testing.assert_array_equal(csr.etype.numpy(), et[eid])
    dst = np.repeat(np.arange(V), np.diff(rowptr))
    np.testing.assert_array_equal(dst, ei[eid, 1])
    # stable within a row: original order is kept
    for v in range(V):
        row = eid[rowptr[v]:rowptr[v + 1]]
        assert np.all(np.diff(row) > 0)
    # topology only: a weight change keeps the CSR
    assert g.mask_edges(torch.zeros(g.num_edges)).csr is csr


def test_synthetic_transductive_splits():
    j = jds.synthetic_transductive("SynthKG", 40, 300, 5, seed=0)
    t = tds.synthetic_transductive("SynthKG", 40, 300, 5, seed=0)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(t, split), getattr(j, split))
    _same(t.graph.edge_list, j.graph.edge_list)
    jf, jtrain = j.fact_graph(0.5, seed=3)
    tf, ttrain = t.fact_graph(0.5, seed=3)
    _same(tf.edge_list, jf.edge_list)
    np.testing.assert_array_equal(ttrain, jtrain)


def test_synthetic_inductive_splits():
    j = jds.synthetic_inductive(num_relations=4, seed=2)
    t = tds.synthetic_inductive(num_relations=4, seed=2)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(t, split), getattr(j, split))
    for name in ("train_graph", "valid_graph", "test_graph", "graph",
                 "inductive_graph"):
        _same(getattr(t, name).edge_list, getattr(j, name).edge_list)

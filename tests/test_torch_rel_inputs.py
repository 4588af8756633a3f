"""The relation-graph input types and the graph tools the JAX package has
beside them, against the JAX package on the CPU: ``random_walk_se`` (with
and without self-loops, and its dense matrices), every input type of
``build_initial_features`` with the JAX package's tables, glorot's shape
and bound (the port draws its own values), ``rel_input_param_init``'s
tables, and ``Graph.degree_in``, ``select_edges`` and ``pack``.

Tolerances: the random-walk features and every table lookup are exact
(the same float64 host computation, cast to float32 once; the bucketing
truncates the same float32 products); summed features 1e-6 (the mean over
8 buckets and the sums round in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.graph import pack as j_pack
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.rel_inputs import (
    build_initial_features as j_features,
    rel_input_param_init as j_param_init,
)
from ultra_torchdrug_tpu.utils.rwse import random_walk_se as j_rwse
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.data.graph import pack
from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph
from ultra_torchdrug_tpu_torch.models.rel_inputs import (
    NUM_DEGREES,
    NUM_RANDOM_WALK_BUCKETS,
    build_initial_features,
    rel_input_param_init,
)
from ultra_torchdrug_tpu_torch.utils.rwse import random_walk_se

V, E, R, DIM = 24, 120, 5, 16
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
ALL_TABLES = "embedding__degree_encoding__random_walk_encoding"
TYPES = ["ones", "zeros", "embedding", "degree_encoding",
         "random_walk_encoding", "random_walk", "rrpe",
         "ones__embedding__degree_encoding__random_walk_encoding",
         "zeros__rrpe__degree_encoding"]


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(11)
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    w = rng.uniform(0.5, 3.0, E).astype(np.float32)
    jg = JGraph.from_triplets(tri, V, R, edge_weight=w)
    tg = TGraph.from_triplets(tri, V, R, edge_weight=w)
    return dict(tri=tri, w=w, jg=jg, tg=tg, jrel=j_relgraph(jg),
                trel=build_relation_graph(tg))


@pytest.mark.parametrize("remove_loops", [False, True])
@pytest.mark.parametrize("return_all", [False, True])
def test_random_walk_se_matches_jax(graphs, remove_loops, return_all):
    want = j_rwse(graphs["jg"], 6, return_all=return_all,
                  remove_loops=remove_loops)
    got = random_walk_se(graphs["tg"], 6, return_all=return_all,
                         remove_loops=remove_loops)
    for a, b in zip(got if return_all else [got],
                    want if return_all else [want]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("input_type", TYPES)
@pytest.mark.parametrize("graph", ["rel", "entity"])
def test_input_types_match_jax(graphs, input_type, graph):
    """Each type on the relation graph (2R nodes) and on the weighted
    entity graph (fractional degrees, which the encoding truncates), with
    the JAX package's tables."""
    jg, tg = ((graphs["jrel"], graphs["trel"]) if graph == "rel"
              else (graphs["jg"], graphs["tg"]))
    tables = j_param_init(jax.random.PRNGKey(3), ALL_TABLES, jg.num_nodes,
                          DIM)
    want = j_features(jax.random.PRNGKey(0), jg, input_type, DIM, tables)
    got = build_initial_features(
        tg, input_type, DIM, {k: {"weight": torch.tensor(np.asarray(
            v["weight"]))} for k, v in tables.items()})
    assert got.shape == (tg.num_nodes, DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)


def test_node_feature_replaces_the_random_walk(graphs):
    tables = j_param_init(jax.random.PRNGKey(3), ALL_TABLES, V, DIM)
    feats = np.random.default_rng(4).uniform(0, 0.06, (V, DIM)).astype(
        np.float32)
    for input_type in ("random_walk_encoding", "random_walk"):
        want = j_features(jax.random.PRNGKey(0), graphs["jg"], input_type,
                          DIM, tables, node_feature=jnp.asarray(feats))
        got = build_initial_features(
            graphs["tg"], input_type, DIM,
            {k: {"weight": torch.tensor(np.asarray(v["weight"]))}
             for k, v in tables.items()}, node_feature=torch.tensor(feats))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)


def test_glorot_bound_and_tables(graphs):
    """glorot: U(-s, s), s = sqrt(6 / (V + dim)), drawn from the given
    generator (the same draw twice from one seed); the tables' shapes are
    JAX's and each is N(0, 1)-like."""
    tg = graphs["trel"]
    n = tg.num_nodes
    a, b = (build_initial_features(tg, "glorot", DIM,
                                   generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    scale = (6.0 / (n + DIM)) ** 0.5
    assert a.shape == (n, DIM) and torch.equal(a, b)
    assert a.abs().max() <= scale and a.abs().max() > 0.8 * scale
    with pytest.raises(ValueError, match="generator"):
        build_initial_features(tg, "glorot", DIM)
    want = j_param_init(jax.random.PRNGKey(0), ALL_TABLES, n, DIM)
    got = rel_input_param_init(ALL_TABLES, n, DIM,
                               torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k in want:
        assert got[k]["weight"].shape == want[k]["weight"].shape
    assert got["deg_embedding"]["weight"].shape[0] == NUM_DEGREES
    assert got["random_walk_embedding"]["weight"].shape[0] == (
        NUM_RANDOM_WALK_BUCKETS + 1)
    assert abs(got["deg_embedding"]["weight"].std().item() - 1) < 0.05
    assert rel_input_param_init("ones", n, DIM, torch.Generator()) == {}


def test_degree_in_select_edges_pack(graphs):
    jg, tg = graphs["jg"], graphs["tg"]
    np.testing.assert_allclose(tg.degree_in().numpy(),
                               np.asarray(jg.degree_in()), rtol=1e-6)
    np.testing.assert_allclose(tg.degree_out().numpy(),
                               np.asarray(jg.degree_out()), rtol=1e-6)
    keep = np.random.default_rng(5).random(E) < 0.6
    prepared = tg.prepare_csr().prepare_dense(max_bytes=1 << 30,
                                              min_density=0.0)
    for mask in (keep, torch.from_numpy(keep)):
        got = prepared.select_edges(mask)
        want = jg.select_edges(keep)
        assert got.num_edges == int(keep.sum()) == want.num_edges
        assert (got.num_nodes, got.num_relations) == (V, R)
        np.testing.assert_array_equal(got.edge_index.numpy(),
                                      np.asarray(want.edge_index))
        np.testing.assert_array_equal(got.edge_type.numpy(),
                                      np.asarray(want.edge_type))
        np.testing.assert_array_equal(got.edge_weight.numpy(),
                                      np.asarray(want.edge_weight))
        assert got.csr is None and got.dense_adj is None
        assert got.join_index is None and got.ring_inputs is None
    packed = pack([tg, graphs["trel"]])
    assert isinstance(packed, tuple) and packed == (tg, graphs["trel"])
    assert len(j_pack([jg])) == len(pack([tg])) == 1

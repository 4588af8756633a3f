"""Classic NBFNet's path tools and the edge-weight gradient route of the port
against the JAX package's on the CPU: the O(E) route's gradients to the
edge weights (every message with sum, max and min, and PNA's pairs),
``edge_gradients``, ``beam_search_paths`` and ``visualize`` (the cases of
tests/test_classic_nbfnet.py), ``variadic_topk`` with its sentinel rows, and
``concat_hidden`` in ULTRA's entity tower and in classic NBFNet.

Tolerances: values 1e-5; gradients 1e-4 norm-wise (‖a - b‖ / ‖b‖), sums
of per-edge products being taken in other orders; beam search on the same
gradients exactly (paths and their mean gradients).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models import classic_nbfnet as j_classic
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_eval
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.ops.variadic import variadic_topk as j_topk
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph
from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
    ClassicNBFNet,
    beam_search_paths,
    classic_nbfnet_config,
    classic_score_all,
    edge_gradients,
    visualize,
)
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import ultra_eval_scores
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    generalized_rspmm,
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.ops.variadic import variadic_topk
from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

GRAD_RTOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _norm_err(a, b) -> float:
    b = _t(b)
    return ((a - b).norm() / b.norm().clamp(min=1e-12)).item()


def _op_inputs(seed=0, V=15, E=60, R=3, B=2, D=4):
    rng = np.random.default_rng(seed)
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - 2, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    return dict(tri=tri, V=V, R=R,
                w=rng.uniform(0.5, 1.5, E).astype(np.float32),
                rel=rng.normal(size=(R, B, D)).astype(np.float32),
                x=rng.normal(size=(V, B, D)).astype(np.float32),
                cot=rng.normal(size=(V, B, D)).astype(np.float32))


def _port_grads(inp, fn):
    """(value, d w, d rel, d x) of <cot, fn(graph, w, rel, x)> on the port."""
    g = TGraph.from_triplets(inp["tri"], inp["V"], inp["R"]).prepare_csr(
        backward=True)
    w, rel, x = (_t(inp[k]).requires_grad_() for k in ("w", "rel", "x"))
    outs = fn(g, w, rel, x)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * _t(inp["cot"])).sum() for o in outs)
    return outs, torch.autograd.grad(total, (w, rel, x))


def _jax_grads(inp, fns):
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])

    def f(w, rel, x):
        outs = [fn(ei, et, w, rel, x) for fn in fns]
        return sum(jnp.sum(o * inp["cot"]) for o in outs), outs

    (_, outs), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ("w", "rel", "x")))
    return outs, grads


@pytest.mark.parametrize("agg", ["add", "max", "min"])
@pytest.mark.parametrize("msg", ["mul", "add", "rotate"])
def test_edge_weight_gradient_matches_jax(msg, agg):
    """An edge weight that requires grad sends the op to the O(E) route
    (here on a graph with its CSR, where max and min would take the K4/K5
    node): values and the gradients to the edge weights, the relations and
    the states against the JAX package's edge_grad route."""
    inp = _op_inputs()
    V = inp["V"]
    (got,), grads = _port_grads(inp, lambda g, w, rel, x: generalized_rspmm(
        g.edge_index, g.edge_type, w, rel, x, msg=msg, agg=agg, num_nodes=V,
        csr=g.csr))
    (want,), want_grads = _jax_grads(inp, [
        lambda ei, et, w, rel, x: j_rspmm(ei, et, w, rel, x, msg=msg, agg=agg,
                                          num_nodes=V, edge_grad=True)])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for a, b in zip(grads, want_grads):
        assert _norm_err(a, b) <= GRAD_RTOL, (msg, agg)


def test_pna_pairs_route_edge_weight_gradients():
    """The fused pairs with an edge weight that requires grad: two O(E)
    calls each, as the JAX package's conv makes under edge_grad."""
    inp = _op_inputs(seed=1)
    V = inp["V"]

    def pairs(g, w, rel, x):
        e = (g.edge_index, g.edge_type, w)
        return (generalized_rspmm_maxmin(*e, rel, x, msg="mul", num_nodes=V,
                                         csr=g.csr)
                + generalized_rspmm_addsq(*e, rel, x, num_nodes=V,
                                          csr=g.csr))

    got, grads = _port_grads(inp, pairs)

    def jop(agg, square=False):
        def fn(ei, et, w, rel, x):
            if square:
                rel, x = rel ** 2, x ** 2
            return j_rspmm(ei, et, w, rel, x, msg="mul", agg=agg,
                           num_nodes=V, edge_grad=True)
        return fn

    want, want_grads = _jax_grads(inp, [jop("max"), jop("min"), jop("add"),
                                        jop("add", square=True)])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for a, b in zip(grads, want_grads):
        assert _norm_err(a, b) <= GRAD_RTOL


def chain_graph(module):
    """tests/test_classic_nbfnet.py::chain_graph: 0 -r0-> 1 -r0-> 2 -r0-> 3
    plus distractor edges, in the JAX or the port's Graph."""
    tri = np.array([[0, 1, 0], [1, 2, 0], [2, 3, 0], [0, 3, 1], [3, 1, 1]],
                   np.int32)
    return module.from_triplets(tri, 4, 2)


def _classic_pair(aggregate_func, seed=3, num_relations=2, **kw):
    jcfg = j_classic.classic_nbfnet_config(
        input_dim=8, hidden_dims=(8, 8, 8), num_relations=num_relations,
        aggregate_func=aggregate_func, **kw)
    tcfg = classic_nbfnet_config(
        input_dim=8, hidden_dims=(8, 8, 8), num_relations=num_relations,
        aggregate_func=aggregate_func, **kw)
    params = j_classic.classic_nbfnet_init(jax.random.PRNGKey(seed), jcfg)
    model = load_jax_params(ClassicNBFNet(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


@pytest.mark.parametrize("aggregate_func", ["sum", "pna"])
def test_edge_gradients_and_visualize_match_jax(aggregate_func):
    """tests/test_classic_nbfnet.py::test_edge_gradients_and_visualize:
    each layer's edge gradient against JAX's; visualize's paths equal to
    JAX's (its beam search on its edge gradients, which is what its
    visualize runs), connected from the head to the tail, their mean
    gradients within 1e-4; and the port's beam search on JAX's gradients
    gives JAX's paths and means exactly."""
    jcfg, params, model = _classic_pair(aggregate_func)
    jg, tg = chain_graph(JGraph), chain_graph(TGraph)
    j_und, t_und = jg.undirected_with_inverse(), tg.undirected_with_inverse()
    want = j_classic.edge_gradients(params, jcfg, j_und, 0, 3, 0)
    got = edge_gradients(model, t_und, 0, 3, 0)
    assert len(got) == 3 and all(g.shape == (t_und.num_edges,) for g in got)
    for a, b in zip(got, want):
        assert _norm_err(a, b) <= GRAD_RTOL
    j_paths, j_weights = j_classic.beam_search_paths(j_und, want, 0, 3,
                                                     num_beam=5, path_topk=5)
    paths, weights = visualize(model, tg, 0, 3, 0, num_beam=5, path_topk=5)
    assert paths == j_paths and len(paths) > 0
    np.testing.assert_allclose(weights, j_weights, rtol=1e-4, atol=1e-6)
    for path in paths:
        assert path[0][0] == 0 and path[-1][1] == 3
        for (_, v1, _), (u2, _, _) in zip(path, path[1:]):
            assert v1 == u2
    same = beam_search_paths(t_und, [_t(np.asarray(g)) for g in want], 0, 3,
                             num_beam=5, path_topk=5)
    assert same == (j_paths, j_weights)


def test_beam_search_scales_to_100k_edges():
    """tests/test_classic_nbfnet.py::test_beam_search_scales_to_100k_edges:
    the tensor beam on 240k undirected edges within a minute, with valid
    paths (test_edge_gradients_and_visualize_match_jax holds the beam to
    JAX's on the same gradients)."""
    rng = np.random.default_rng(0)
    V, E, R, L = 8000, 120000, 7, 4
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    tg = TGraph.from_triplets(tri, V, R).undirected_with_inverse()
    grads = [rng.normal(size=tg.num_edges).astype(np.float32) * 0.01
             for _ in range(L)]
    t0 = time.perf_counter()
    paths, weights = beam_search_paths(tg, [_t(g) for g in grads], 0, 5,
                                       num_beam=10, path_topk=10)
    elapsed = time.perf_counter() - t0
    assert elapsed < 60, f"beam search took {elapsed:.1f} s"
    assert len(paths) == 10
    for path, w in zip(paths, weights):
        assert path[-1][1] == 5 and np.isfinite(w)
        for (_, v1, _), (u2, _, _) in zip(path, path[1:]):
            assert v1 == u2
    assert weights == sorted(weights, reverse=True)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_variadic_topk_matches_jax(largest, dtype):
    """Ragged top-k with ties, short segments (padded by their last entry)
    and empty ones (sentinel rows: index -1, the dtype's worst value)."""
    rng = np.random.default_rng(4)
    sizes = np.array([3, 0, 5, 1, 0, 7, 2])
    values = rng.integers(-3, 4, sizes.sum()).astype(dtype)
    want = j_topk(jnp.asarray(values), jnp.asarray(sizes), 4, largest)
    got = variadic_topk(torch.from_numpy(values), torch.from_numpy(sizes), 4,
                        largest)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1][sizes == 0] == -1).all()


def test_concat_hidden_matches_jax():
    """concat_hidden: ULTRA's entity tower and classic NBFNet feed the head
    every layer's state side by side (the head L times wider); scores
    against the JAX package's."""
    rng = np.random.default_rng(6)
    V, E, R = 24, 90, 4
    tri = np.unique(np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                              rng.integers(0, R, E)], 1), axis=0)
    tri = tri.astype(np.int32)
    jg, tg = JGraph.from_triplets(tri, V, R), TGraph.from_triplets(tri, V, R)
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=8, hidden_dims=(8, 8, 8),
                         num_relations=2 * R, concat_hidden=True),
        relation=j_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=8, hidden_dims=(8, 8, 8),
                         num_relations=2 * R, concat_hidden=True),
        relation=t_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    params = ultra_init(jax.random.PRNGKey(2), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    assert model.model.mlp.layers[0].in_features == 3 * 8 + 8
    q = rng.integers(0, [V, V, R], (4, 3))
    want = j_eval(params, jcfg, jg, j_relgraph(jg),
                  *(jnp.asarray(q[:, i]) for i in range(3)))
    qt = _t(q, np.int64)
    with torch.inference_mode():
        got = ultra_eval_scores(model, tg, build_relation_graph(tg),
                                qt[:, 0], qt[:, 1], qt[:, 2])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    jcfg, params, model = _classic_pair("pna", seed=5, num_relations=R,
                                        concat_hidden=True)
    j_und = jg.undirected_with_inverse()
    t_und = tg.undirected_with_inverse().prepare_csr()
    src, rel = q[:, 0], q[:, 2]
    want = j_classic.classic_score_all(params, jcfg, j_und, jnp.asarray(src),
                                       jnp.asarray(rel))
    with torch.inference_mode():
        got = classic_score_all(model, t_und, _t(src, np.int64),
                                _t(rel, np.int64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

"""The PyTorch port's single-extremum rspmm (agg max / min: kernels K4 and
K5 on the card), the transe backward (kernel K3), and the conv's sum, mean
and max aggregations (each also ``*_nobound``) against the JAX package on
the CPU. Inputs are made by numpy from a seed, with masked (weight-0) edges,
all-zero x rows and duplicated edges, so that messages tie exactly.

The JAX package reaches three TPU kernel routes for max / min, and each is
held here: the blocked layouts without interleaving (the blocked K4 forward,
the per-edge K5 backward ``rspmm_bwd_minmax``), the interleaved blocked
layouts (the blocked K4 forward, the K5b backward ``rspmm_bwd_minmax_blk``)
and the per-edge layouts with a hot-row split (the per-edge K4 body and its
hot pass, K5 with its hot pass).

Tolerances, each with its reason:
  * max/min values: exact, against interpret-mode Pallas and the XLA
    segment-op oracle: an extremum does not depend on the order of the
    edges, and the messages are the same fp32 products in all three;
  * max/min gradients against interpret-mode Pallas: rtol 1e-6, atol 1e-5:
    the same gates (every tied edge gets the full gradient), with the gated
    terms summed per source row and relation in another order;
  * transe gradients: rtol = atol = 1e-5 against Pallas and XLA, sums of
    the same products in another order;
  * one conv layer: rtol = atol = 1e-5 for values and 1e-4 for gradients
    (matmuls and layer norm in another order, then their backward);
  * whole ULTRA scores: rtol = atol = 1e-4, as for the towers in
    test_torch_ultra.py (two stacked towers of such layers).
The max/min gradients are never compared with XLA: its segment_max shares
the gradient among the tied edges, where the Pallas kernels give each the
whole of it (ROADMAP Queue 3, "Tie convention").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.models.layers import ConvConfig as JConvConfig
from ultra_torchdrug_tpu.models.layers import conv_apply as j_conv
from ultra_torchdrug_tpu.models.layers import conv_init as j_conv_init
from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import _xla_bwd
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.models import layers as t_layers
from ultra_torchdrug_tpu_torch.models.layers import (
    ConvConfig,
    GeneralizedRelationalConv,
    conv_apply,
)
from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_pna_cuda
from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm
from ultra_torchdrug_tpu_torch.utils.convert import jax_params_to_state_dict

EXACT = dict(rtol=0, atol=0)
ARGEXT_GRAD_TOL = dict(rtol=1e-6, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a, dtype=None):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _inputs(rng, V=37, E=400, R=6, B=2, D=5):
    """A graph with ties: 40 duplicated edges, 30 % of the weights 0, the
    first 6 node rows of x all 0, and the last 4 nodes without in-edges."""
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - 4, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    tri[300:340] = tri[:40]
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.3] = 0.0
    x = rng.normal(size=(V, B * D)).astype(np.float32)
    x[:6] = 0.0
    return dict(tri=tri, w=w, V=V, R=R, x=x,
                rel=rng.normal(size=(R, B * D)).astype(np.float32),
                g=rng.normal(size=(V, B * D)).astype(np.float32))


# the JAX package's three routes to its max/min kernels (module docstring)
LAYOUTS = {
    "blocked": dict(blocked=True, interleave=0),
    "interleaved": dict(blocked=True, interleave=8),
    "per_edge_hot": dict(blocked=False, hot_rows=8),
}


def _layouts(inp, layout, include_rel_layout=False):
    return build_rspmm_layouts(
        inp["tri"][:, :2], inp["tri"][:, 2], inp["V"], inp["R"],
        tile_rows=16, tile_edges=32, block_rows=16, bwd_block_rows=8,
        include_rel_layout=include_rel_layout, **LAYOUTS[layout])


def _jax_op(inp, impl, layouts=None, **kw):
    """(out, d_relation, d_x) of a JAX rspmm under <g, out>."""
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])
    w = jnp.asarray(inp["w"])

    def f(rel, x):
        out = j_rspmm(ei, et, w, rel, x, num_nodes=inp["V"], impl=impl,
                      layouts=layouts, **kw)
        return jnp.sum(out * inp["g"]), out

    (_, out), (dr, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inp["rel"]), jnp.asarray(inp["x"]))
    return [np.asarray(v) for v in (out, dr, dx)]


def _graph(inp):
    return TGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                                edge_weight=inp["w"]).prepare_csr(
                                    backward=True)


def _port_op(inp, **kw):
    g = _graph(inp)
    rel, x = _t(inp["rel"]).requires_grad_(), _t(inp["x"]).requires_grad_()
    out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, rel, x,
                            num_nodes=inp["V"], csr=g.csr, **kw)
    dr, dx = torch.autograd.grad((out * _t(inp["g"])).sum(), (rel, x))
    return [v.detach().numpy() for v in (out, dr, dx)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_extremum_matches_jax(rng, msg, agg, layout):
    """Values exactly against interpret-mode Pallas on each layout and
    against the XLA oracle; gradients against Pallas on each layout (K5,
    K5b and K5 with its hot pass are different TPU kernels)."""
    inp = _inputs(rng)
    got = _port_op(inp, msg=msg, agg=agg)
    want = _jax_op(inp, "pallas", _layouts(inp, layout), msg=msg, agg=agg)
    np.testing.assert_allclose(got[0], want[0], **EXACT)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **ARGEXT_GRAD_TOL)
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])
    oracle = j_rspmm(ei, et, jnp.asarray(inp["w"]), jnp.asarray(inp["rel"]),
                     jnp.asarray(inp["x"]), msg=msg, agg=agg,
                     num_nodes=inp["V"], impl="xla")
    np.testing.assert_allclose(got[0], np.asarray(oracle), **EXACT)
    assert np.all(got[0][-4:] == 0)  # rows without edges give 0


@pytest.mark.parametrize("agg", ["max", "min"])
def test_every_tied_edge_gets_the_full_gradient(agg):
    """rel = 3, D = 1 (distmult). Node 0 receives 6 (from 1, w 1), 6 (from
    2, w 1), 6 (from 3, w 2) and 3 (from 4); node 1 receives 0 (from 2,
    masked) and 3 (from 3). For max, the three edges at 6 each get g · w
    (· rel); for min, the edge from 4 into node 0 and the masked edge into
    node 1 (its message 0 takes part, and its gradient is 0 · g)."""
    tri = np.array([[1, 0, 0], [2, 0, 0], [3, 0, 0], [4, 0, 0],
                    [2, 1, 0], [3, 1, 0]], np.int32)
    w = np.array([1, 1, 2, 1, 0, 1], np.float32)
    x = np.array([[0], [2], [2], [1], [1]], np.float32)
    g = TGraph.from_triplets(tri, 5, 1,
                             edge_weight=w).prepare_csr(backward=True)
    xt, rt = _t(x).requires_grad_(), torch.full((1, 1), 3.0,
                                                requires_grad=True)
    out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, rt, xt,
                            agg=agg, num_nodes=5, csr=g.csr)
    dx, dr = torch.autograd.grad(out[0, 0] + out[1, 0], (xt, rt))
    if agg == "max":
        assert out[:, 0].tolist() == [6.0, 3.0, 0.0, 0.0, 0.0]
        assert dx[:, 0].tolist() == [0.0, 3.0, 3.0, 3.0 * 2 + 3.0, 0.0]
        assert dr.item() == 2.0 + 2.0 + 1.0 * 2 + 1.0
    else:
        assert out[:, 0].tolist() == [3.0, 0.0, 0.0, 0.0, 0.0]
        assert dx[:, 0].tolist() == [0.0, 0.0, 0.0, 0.0, 3.0]
        assert dr.item() == 1.0


def test_extremum_wrappers_run_the_plain_versions_on_cpu_tensors(rng):
    """On CPU tensors K4's and K5's wrappers count no launch and agree with
    the op and its gradients; the kinds and planes they do not take
    raise."""
    inp = _inputs(rng)
    g = _graph(inp)
    rel, x, gr = _t(inp["rel"]), _t(inp["x"]), _t(inp["g"])
    before = dict(rspmm_pna_cuda.launches)
    for agg, mode in (("max", "mul_rel"), ("min", "add_rel")):
        outs = rspmm_pna_cuda.pna_fwd_cuda(agg, g.csr, g.edge_weight, rel, x,
                                           mode)
        assert len(outs) == 1
        want = _port_op(inp, msg=mode[:3], agg=agg)
        np.testing.assert_array_equal(outs[0].numpy(), want[0])
        dx, dr = rspmm_pna_cuda.pna_bwd_cuda("argext", g.csr, g.edge_weight,
                                             rel, x, (gr, outs[0]), mode)
        np.testing.assert_array_equal(dx.numpy(), want[2])
        np.testing.assert_array_equal(dr.numpy(), want[1])
        assert rspmm_pna_cuda.pna_bwd_cuda(
            "argext", g.csr, g.edge_weight, rel, x, (gr, outs[0]), mode,
            need_dr=False)[1] is None
    assert rspmm_pna_cuda.launches == before
    with pytest.raises(ValueError, match="kind"):
        rspmm_pna_cuda.pna_fwd_cuda("mean", g.csr, g.edge_weight, rel, x,
                                    "mul_rel")
    with pytest.raises(ValueError, match="planes"):
        rspmm_pna_cuda.pna_bwd_cuda("argext", g.csr, g.edge_weight, rel, x,
                                    (gr, gr, gr, gr), "mul_rel")
    with pytest.raises(ValueError, match="agg"):
        generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, rel, x,
                          agg="mean", num_nodes=inp["V"], csr=g.csr)
    with pytest.raises(ValueError, match="CSR"):
        generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, rel, x,
                          agg="max", num_nodes=inp["V"])


# ---------------------------------------------------------------------------
# the transe backward (K3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["blocked", "per_edge_hot"])
def test_transe_backward_matches_jax(rng, layout):
    """Gradients of the transe (add) rspmm: the port's CPU op (autograd
    through the plain forward) and K3's plain version against the JAX
    custom VJP on interpret-mode Pallas (the relation-sorted layout and the
    reverse layout, blocked or per-edge with its hot pass) and against
    _xla_bwd."""
    inp = _inputs(rng)
    got = _port_op(inp, msg="add")
    want = _jax_op(inp, "pallas", _layouts(inp, layout,
                                           include_rel_layout=True),
                   msg="add")
    np.testing.assert_allclose(got[0], want[0], **SUM_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **SUM_TOL)
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])
    xla_dr, xla_dx = _xla_bwd(ei, et, jnp.asarray(inp["w"]),
                              jnp.asarray(inp["rel"]), jnp.asarray(inp["x"]),
                              jnp.asarray(inp["g"]), msg="add")
    g = _graph(inp)
    before = dict(rspmm_bwd_cuda.launches)
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight,
                                           _t(inp["rel"]), None, _t(inp["g"]),
                                           mode="add_rel")
    assert rspmm_bwd_cuda.launches == before
    for port in ((got[1], got[2]), (dr.numpy(), dx.numpy())):
        np.testing.assert_allclose(port[0], np.asarray(xla_dr), **SUM_TOL)
        np.testing.assert_allclose(port[1], np.asarray(xla_dx), **SUM_TOL)


def test_transe_backward_plain_halves(rng):
    """K3's plain version: each half alone equals the pair's, the rows
    that send no edge and the relation without edges get 0, and the modes
    it does not know raise."""
    inp = _inputs(rng)
    inp["tri"][:, 2] = np.minimum(inp["tri"][:, 2], inp["R"] - 2)
    g = _graph(inp)
    args = (g.csr, g.edge_weight, _t(inp["rel"]), None, _t(inp["g"]))
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel")
    none, dr2 = rspmm_bwd_cuda.rspmm_bwd_plain(*args, need_dx=False,
                                               mode="add_rel")
    dx2, none2 = rspmm_bwd_cuda.rspmm_bwd_plain(*args, need_dr=False,
                                                mode="add_rel")
    assert none is None and none2 is None
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
    assert torch.all(dr[inp["R"] - 1] == 0)
    senders = set(inp["tri"][:, 0].tolist())
    for v in set(range(inp["V"])) - senders:
        assert torch.all(dx[v] == 0)
    with pytest.raises(ValueError, match="mode"):
        rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="rot_rel")


# ---------------------------------------------------------------------------
# the conv's sum, mean and max aggregations
# ---------------------------------------------------------------------------

CONV_D, CONV_B, CONV_R = 8, 3, 5
NEW_AGGREGATIONS = ["sum_nobound", "mean", "mean_nobound", "max",
                    "max_nobound"]


def _conv_setup(rng, aggregate, message, impl="xla"):
    jcfg = JConvConfig(input_dim=CONV_D, output_dim=CONV_D,
                       num_relations=2 * CONV_R, query_input_dim=CONV_D,
                       message_func=message, aggregate_func=aggregate,
                       layer_norm=True, rel_mode="dependent", project=False,
                       rspmm_impl=impl)
    params = j_conv_init(jax.random.PRNGKey(1), jcfg)
    cfg = ConvConfig(input_dim=CONV_D, output_dim=CONV_D,
                     num_relations=2 * CONV_R, query_input_dim=CONV_D,
                     message_func=message, aggregate_func=aggregate,
                     layer_norm=True, rel_mode="dependent", project=False)
    layer = GeneralizedRelationalConv(cfg)
    state = jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, params)]})
    layer.load_state_dict({k.partition(".0.")[2]: v for k, v in state.items()})
    V, E = 34, 260
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - 3, E),
                    rng.integers(0, CONV_R, E)], 1).astype(np.int32)
    tri[200:230] = tri[:30]  # duplicated edges
    w = (rng.uniform(size=E) > 0.25).astype(np.float32)  # masked edges
    x = np.maximum(rng.normal(size=(V, CONV_B * CONV_D)), 0).astype(
        np.float32)  # post-ReLU states: many exact zeros
    bnd = np.zeros_like(x)
    bnd[rng.integers(0, V, CONV_B), np.arange(CONV_B) * CONV_D] = 1.0
    query = rng.normal(size=(CONV_B, CONV_D)).astype(np.float32)
    jg = JGraph.from_triplets(tri, V, CONV_R, edge_weight=w)
    jg = jg.undirected_with_inverse()
    tg = TGraph.from_triplets(tri, V, CONV_R, edge_weight=w)
    tg = tg.undirected_with_inverse().prepare_csr(backward=True)
    return dict(jcfg=jcfg, params=params, layer=layer, x=x, bnd=bnd,
                query=query, jg=jg, tg=tg)


@pytest.mark.parametrize("message", ["distmult", "transe"])
@pytest.mark.parametrize("aggregate", NEW_AGGREGATIONS)
def test_conv_matches_jax(rng, aggregate, message):
    s = _conv_setup(rng, aggregate, message)
    assert s["layer"].linear.in_features == 2 * CONV_D
    want = jax.jit(lambda p, x, bnd, q: j_conv(p, s["jcfg"], s["jg"], x, bnd,
                                               query=q))(
        s["params"], jnp.asarray(s["x"]), jnp.asarray(s["bnd"]),
        jnp.asarray(s["query"]))
    with torch.no_grad():
        got = conv_apply(s["layer"], s["tg"], _t(s["x"]), _t(s["bnd"]),
                         query=_t(s["query"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)


@pytest.mark.parametrize("aggregate,message", [
    ("max", "distmult"), ("max_nobound", "distmult"), ("max", "transe"),
    ("max_nobound", "transe"), ("mean", "transe")])
def test_conv_gradients_match_jax_pallas(rng, aggregate, message):
    """Gradients of one layer with respect to x, the query and every
    weight, against the JAX conv on interpret-mode Pallas: for max the
    argext backward on the interleaved layouts (K5b), for transe mean the
    transe backward over the relation-sorted layout (K3)."""
    s = _conv_setup(rng, aggregate, message, impl="pallas")
    jg = s["jg"].prepare_pallas(interleave=8,
                                include_rel_layout=message == "transe")
    cot = rng.normal(size=s["x"].shape).astype(np.float32)

    def j_loss(params, x, query):
        out = j_conv(params, s["jcfg"], jg, x, jnp.asarray(s["bnd"]),
                     query=query)
        return jnp.sum(out * cot)

    # jitted: one lowering of the interpret-mode kernels, not one per call
    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        s["params"], jnp.asarray(s["x"]), jnp.asarray(s["query"]))
    x, query = _t(s["x"]).requires_grad_(), _t(s["query"]).requires_grad_()
    layer = s["layer"]
    out = conv_apply(layer, s["tg"], x, _t(s["bnd"]), query=query)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out * _t(cot)).sum(),
                                [x, query] + list(layer.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want[1]),
                               **CONV_GRAD_TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(want[2]),
                               **CONV_GRAD_TOL)
    want_p = {k.partition(".0.")[2]: v for k, v in jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, want[0])]}).items()}
    assert set(names) == set(want_p)
    for name, gr in zip(names, grads[2:]):
        np.testing.assert_allclose(gr.numpy(), want_p[name].numpy(),
                                   err_msg=name, **CONV_GRAD_TOL)


def test_injected_max_conv_takes_the_sparse_route(rng, monkeypatch):
    """ULTRA's relation-tower layout (injected mode, a per-query relation)
    with max on a graph that carries a dense adjacency: the conv never
    calls the dense route, goes through the sparse extremum on the graph's
    CSR, and agrees with the JAX conv (which sends max to its segment ops);
    sum on the same graph takes the dense route."""
    V, E, R, D, B = 12, 90, 4, 8, 2
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    jcfg = JConvConfig(input_dim=D, output_dim=D, num_relations=R,
                       query_input_dim=D, aggregate_func="max",
                       layer_norm=True, rel_mode="injected", project=True)
    params = j_conv_init(jax.random.PRNGKey(3), jcfg)
    layer = GeneralizedRelationalConv(ConvConfig(
        input_dim=D, output_dim=D, num_relations=R, query_input_dim=D,
        aggregate_func="max", layer_norm=True, rel_mode="injected",
        project=True))
    state = jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, params)]})
    layer.load_state_dict({k.partition(".0.")[2]: v for k, v in state.items()})
    x = np.maximum(rng.normal(size=(V, B * D)), 0).astype(np.float32)
    bnd = np.zeros_like(x)
    bnd[[1, 5], [0, D]] = 1.0
    rel = rng.normal(size=(B, R, D)).astype(np.float32)
    jg = JGraph.from_triplets(tri, V, R).prepare_dense(min_density=0.0)
    tg = TGraph.from_triplets(tri, V, R).prepare_dense(min_density=0.0)
    tg = tg.prepare_csr(backward=True)
    assert jg.dense_adj is not None and tg.dense_adj is not None
    want = j_conv(params, jcfg, jg, jnp.asarray(x), jnp.asarray(bnd),
                  rel_injected=jnp.asarray(rel))

    def no_dense(*args, **kwargs):
        raise AssertionError("max took the dense route")

    monkeypatch.setattr(t_layers, "dense_rspmm", no_dense)
    with torch.no_grad():
        got = conv_apply(layer, tg, _t(x), _t(bnd), rel_injected=_t(rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)
    monkeypatch.undo()
    calls, dense_rspmm = [], t_layers.dense_rspmm

    def dense(*args, **kwargs):
        calls.append(1)
        return dense_rspmm(*args, **kwargs)

    sum_layer = GeneralizedRelationalConv(ConvConfig(
        input_dim=D, output_dim=D, num_relations=R, query_input_dim=D,
        aggregate_func="sum", layer_norm=True, rel_mode="injected",
        project=True))
    monkeypatch.setattr(t_layers, "dense_rspmm", dense)
    with torch.no_grad():
        conv_apply(sum_layer, tg, _t(x), _t(bnd), rel_injected=_t(rel))
    assert calls == [1]


def test_conv_rejects_unknown_aggregations_and_messages():
    kw = dict(input_dim=4, output_dim=4, num_relations=2, query_input_dim=4)
    with pytest.raises(ValueError, match="aggregate_func"):
        GeneralizedRelationalConv(ConvConfig(aggregate_func="min", **kw))
    with pytest.raises(ValueError, match="message_func"):
        GeneralizedRelationalConv(ConvConfig(message_func="complex", **kw))


def test_ultra_with_a_max_relation_tower(rng):
    """The task gives ULTRA's relation graph its CSR beside its dense
    adjacency when the relation tower aggregates by max, which never takes
    the dense route: the scores of both towers agree with the JAX task's,
    and a loss step has finite gradients for every parameter."""
    import dataclasses

    from ultra_torchdrug_tpu.data.datasets import (
        synthetic_transductive as j_synth,
    )
    from ultra_torchdrug_tpu.models.nbfnet import (
        entity_nbfnet_config as j_ent_cfg,
        rel_nbfnet_config as j_rel_cfg,
    )
    from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
    from ultra_torchdrug_tpu.models.ultra import ultra_init as j_ultra_init
    from ultra_torchdrug_tpu.tasks.task import TransductiveKGTask as JTask
    from ultra_torchdrug_tpu_torch.data.datasets import (
        synthetic_transductive as t_synth,
    )
    from ultra_torchdrug_tpu_torch.models.nbfnet import (
        entity_nbfnet_config as t_ent_cfg,
        rel_nbfnet_config as t_rel_cfg,
    )
    from ultra_torchdrug_tpu_torch.models.ultra import Ultra
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask
    from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=8, hidden_dims=(8, 8), num_relations=10),
        relation=dataclasses.replace(j_rel_cfg(input_dim=8, hidden=8,
                                               num_layers=2),
                                     aggregate_func="max"))
    tcfg = UltraConfig(
        entity=t_ent_cfg(input_dim=8, hidden_dims=(8, 8), num_relations=10),
        relation=dataclasses.replace(t_rel_cfg(input_dim=8, hidden=8,
                                               num_layers=2),
                                     aggregate_func="max"))
    params = j_ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    jtask = JTask(j_synth("SynthKG", 40, 300, 5, seed=0), jcfg)
    task = TransductiveKGTask(t_synth("SynthKG", 40, 300, 5, seed=0), tcfg,
                              device="cpu")
    und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
    assert rel_graph.dense_adj is not None and rel_graph.csr is not None
    jund, jrel = jtask._prepare_graphs(jtask.fact_graph, jtask.rel_graph)
    assert jrel.dense_adj is not None
    batch = task.dataset.test[:4]
    want = jtask._eval_scores(params, jtask.fact_graph, jrel,
                              *(jnp.asarray(batch[:, i]) for i in range(3)),
                              jund)
    b = _t(batch, np.int64)
    with torch.no_grad():
        got = task._eval_scores(model, task.fact_graph, rel_graph, b[:, 0],
                                b[:, 1], b[:, 2], und)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    loss, _ = task.loss_step(model, torch.Generator().manual_seed(0),
                             task.train_triples[:4])
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())

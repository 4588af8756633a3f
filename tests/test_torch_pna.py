"""PNA's fused rspmm pairs and the pna conv of the PyTorch port against the
JAX package on the CPU: ``generalized_rspmm_maxmin`` (kernels K6/K6b on the
card) and ``generalized_rspmm_addsq`` (K7/K7b), forward and gradient, and
``conv_apply`` with ``aggregate_func`` pna and pna_nobound in dependent mode.
Inputs are made by numpy from a seed, with masked (weight-0) edges, all-zero
x rows and duplicated edges, so that messages tie exactly.

Tolerances, each with its reason:
  * max/min values: exact — an extremum does not depend on the order of
    the edges, and the messages are the same fp32 products in both;
  * max/min gradients against interpret-mode Pallas: rtol 1e-6, atol 1e-5 —
    the same gates (the every-tied-edge convention), with the gated terms
    summed per source row and relation in another order;
  * sum / sum of squares: rtol = atol = 1e-5, and their gradients rtol 5e-4,
    atol 2e-4 against the two-call XLA formulation (the JAX package's own
    bound for the fused pair, tests/test_rspmm_pallas.py), 1e-5 against the
    fused Pallas pair (the same products summed in another order);
  * one conv layer: rtol = atol = 1e-5 for values; its gradients 1e-4, where
    std = sqrt(clip(sq_mean - mean², 1e-6)) scales rounding by up to 500x
    near the clip.
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
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_addsq as j_addsq
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_maxmin as j_maxmin
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.models.layers import ConvConfig, conv_apply
from ultra_torchdrug_tpu_torch.models.layers import GeneralizedRelationalConv
from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.utils.convert import jax_params_to_state_dict

EXACT = dict(rtol=0, atol=0)
ARGEXT_GRAD_TOL = dict(rtol=1e-6, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
TWO_CALL_GRAD_TOL = dict(rtol=5e-4, atol=2e-4)
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
    return dict(tri=tri, w=w, V=V, R=R, B=B, D=D, x=x,
                rel=rng.normal(size=(R, B * D)).astype(np.float32),
                g=[rng.normal(size=(V, B * D)).astype(np.float32)
                   for _ in range(2)])


def _jax_pair(op, inp, impl, layouts=None, grad=True, **kw):
    """(a, b) of a JAX pair op and, with ``grad``, jax.grad of <g0, a> +
    <g1, b> with respect to (relation, x)."""
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])

    def f(rel, x):
        a, b = op(ei, et, jnp.asarray(inp["w"]), rel, x, num_nodes=inp["V"],
                  impl=impl, layouts=layouts, **kw)
        return (jnp.sum(a * inp["g"][0]) + jnp.sum(b * inp["g"][1])), (a, b)

    args = (jnp.asarray(inp["rel"]), jnp.asarray(inp["x"]))
    if not grad:
        return [np.asarray(v) for v in f(*args)[1]]
    (_, (a, b)), (dr, dx) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(*args)
    return [np.asarray(v) for v in (a, b, dr, dx)]


def _port_pair(op, inp, **kw):
    g = TGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                             edge_weight=inp["w"]).prepare_csr(backward=True)
    rel, x = _t(inp["rel"]).requires_grad_(), _t(inp["x"]).requires_grad_()
    a, b = op(g.edge_index, g.edge_type, g.edge_weight, rel, x,
              num_nodes=inp["V"], csr=g.csr, **kw)
    loss = (a * _t(inp["g"][0])).sum() + (b * _t(inp["g"][1])).sum()
    dr, dx = torch.autograd.grad(loss, (rel, x))
    return [v.detach().numpy() for v in (a, b, dr, dx)]


def _blocked_layouts(inp, interleave):
    return build_rspmm_layouts(
        inp["tri"][:, :2], inp["tri"][:, 2], inp["V"], inp["R"],
        tile_rows=16, tile_edges=32, blocked=True, block_rows=16,
        bwd_block_rows=8, interleave=interleave)


@pytest.mark.parametrize("interleave", [0, 8])
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_maxmin_matches_jax_pallas(rng, msg, interleave):
    """Values against both of the JAX package's blocked layouts, gradients
    against the interleaved one (the JAX package's own tests hold the two
    layouts' gradients bitwise equal, tests/test_rspmm_pallas.py)."""
    inp = _inputs(rng)
    want = _jax_pair(j_maxmin, inp, "pallas", _blocked_layouts(inp, interleave),
                     grad=interleave == 8, msg=msg)
    got = _port_pair(generalized_rspmm_maxmin, inp, msg=msg)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, **EXACT)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, **ARGEXT_GRAD_TOL)
    assert np.all(got[0][-4:] == 0) and np.all(got[1][-4:] == 0)
    # values against the XLA segment-op oracle
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])
    for out, agg in zip(got[:2], ("max", "min")):
        ref = j_rspmm(ei, et, jnp.asarray(inp["w"]), jnp.asarray(inp["rel"]),
                      jnp.asarray(inp["x"]), msg=msg, agg=agg,
                      num_nodes=inp["V"], impl="xla")
        np.testing.assert_allclose(out, np.asarray(ref), **EXACT)


@pytest.mark.parametrize("interleave", [0, 8])
def test_addsq_matches_jax_pallas(rng, interleave):
    """Values against both blocked layouts, gradients against the
    interleaved one, as for maxmin; values and gradients against XLA."""
    inp = _inputs(rng)
    want = _jax_pair(j_addsq, inp, "pallas", _blocked_layouts(inp, interleave),
                     grad=interleave == 8)
    got = _port_pair(generalized_rspmm_addsq, inp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **SUM_TOL)
    # and the two-call XLA formulation, sum(w·rel·x) and sum(w·rel²·x²)
    want = _jax_pair(j_addsq, inp, "xla")
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, **SUM_TOL)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, **TWO_CALL_GRAD_TOL)


def test_every_tied_edge_gets_the_full_gradient():
    """rel = 3, D = 1. Node 0 receives messages 6 (from 1, w 1), 6 (from 2,
    w 1), 6 (from 3, w 2) and 3 (from 4): three edges tie at the max. Node 1
    receives 0 (from 2, masked) and 3 (from 3). Each tied edge gets the
    full g_mx · w (· rel); the masked edge sends 0, the min of node 1."""
    tri = np.array([[1, 0, 0], [2, 0, 0], [3, 0, 0], [4, 0, 0],
                    [2, 1, 0], [3, 1, 0]], np.int32)
    w = np.array([1, 1, 2, 1, 0, 1], np.float32)
    x = np.array([[0], [2], [2], [1], [1]], np.float32)
    g = TGraph.from_triplets(tri, 5, 1,
                             edge_weight=w).prepare_csr(backward=True)
    xt, rt = _t(x).requires_grad_(), torch.full((1, 1), 3.0,
                                                requires_grad=True)
    mx, mn = generalized_rspmm_maxmin(g.edge_index, g.edge_type,
                                      g.edge_weight, rt, xt, num_nodes=5,
                                      csr=g.csr)
    assert mx[:, 0].tolist() == [6.0, 3.0, 0.0, 0.0, 0.0]
    assert mn[:, 0].tolist() == [3.0, 0.0, 0.0, 0.0, 0.0]
    dx, dr = torch.autograd.grad(mx[0, 0] + mx[1, 0], (xt, rt))
    assert dx[:, 0].tolist() == [0.0, 3.0, 3.0, 3.0 * 2 + 3.0, 0.0]
    assert dr.item() == 2.0 + 2.0 + 1.0 * 2 + 1.0


def test_wrappers_run_the_plain_versions_on_cpu_tensors(rng):
    """On CPU tensors the kernel wrappers count no launch and agree with the
    op and its gradients; the kinds and modes they do not take raise."""
    inp = _inputs(rng)
    g = TGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                             edge_weight=inp["w"]).prepare_csr(backward=True)
    rel, x = _t(inp["rel"]), _t(inp["x"])
    g0, g1 = _t(inp["g"][0]), _t(inp["g"][1])
    before = dict(rspmm_pna_cuda.launches)
    for kind, bwd_kind, op in (("maxmin", "argext_pair",
                                generalized_rspmm_maxmin),
                               ("addsq", "moments", generalized_rspmm_addsq)):
        a, b = rspmm_pna_cuda.pna_fwd_cuda(kind, g.csr, g.edge_weight, rel, x,
                                           "mul_rel")
        want = _port_pair(op, inp)
        np.testing.assert_array_equal(a.numpy(), want[0])
        np.testing.assert_array_equal(b.numpy(), want[1])
        planes = (g0, a, g1, b) if kind == "maxmin" else (g0, g1)
        dx, dr = rspmm_pna_cuda.pna_bwd_cuda(bwd_kind, g.csr, g.edge_weight,
                                             rel, x, planes, "mul_rel")
        np.testing.assert_array_equal(dx.numpy(), want[3])
        np.testing.assert_array_equal(dr.numpy(), want[2])
        assert rspmm_pna_cuda.pna_bwd_cuda(bwd_kind, g.csr, g.edge_weight,
                                           rel, x, planes, "mul_rel",
                                           need_dx=False)[0] is None
    assert rspmm_pna_cuda.launches == before
    with pytest.raises(ValueError, match="mul_rel"):
        rspmm_pna_cuda.pna_fwd_cuda("addsq", g.csr, g.edge_weight, rel, x,
                                    "add_rel")
    with pytest.raises(ValueError, match="planes"):
        rspmm_pna_cuda.pna_bwd_cuda("argext_pair", g.csr, g.edge_weight, rel,
                                    x, (g0, g1), "mul_rel")
    with pytest.raises(ValueError, match="backward=True"):
        rspmm_pna_cuda.pna_bwd_cuda(
            "moments", g.prepare_csr().csr, g.edge_weight, rel, x, (g0, g1),
            "mul_rel")


# ---------------------------------------------------------------------------
# the pna conv
# ---------------------------------------------------------------------------

CONV_D, CONV_B, CONV_R = 8, 3, 5


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
@pytest.mark.parametrize("aggregate", ["pna", "pna_nobound"])
def test_pna_conv_matches_jax(rng, aggregate, message):
    s = _conv_setup(rng, aggregate, message)
    assert s["layer"].linear.in_features == 13 * CONV_D
    want = jax.jit(lambda p, x, bnd, q: j_conv(p, s["jcfg"], s["jg"], x, bnd,
                                               query=q))(
        s["params"], jnp.asarray(s["x"]), jnp.asarray(s["bnd"]),
        jnp.asarray(s["query"]))
    with torch.no_grad():
        got = conv_apply(s["layer"], s["tg"], _t(s["x"]), _t(s["bnd"]),
                         query=_t(s["query"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)


@pytest.mark.parametrize("aggregate", ["pna", "pna_nobound"])
def test_pna_conv_gradients_match_jax_pallas(rng, aggregate):
    """Gradients of one distmult pna layer with respect to x, the query and
    every weight, against the JAX conv on the fused Pallas pairs (interpret
    mode, the every-tied-edge convention)."""
    s = _conv_setup(rng, aggregate, "distmult", impl="pallas")
    jg = s["jg"].prepare_pallas(interleave=8, bwd_block_rows=256)
    assert jg.layouts.fwd_blk is not None and jg.layouts.rev_blk is not None
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

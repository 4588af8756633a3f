"""RotatE messages in the PyTorch port against the JAX package on the CPU:
the op (``generalized_rspmm(msg="rotate")``, whose sum is kernel K8f with
its backward K8b on the card), the plain versions of K8f and K8b, the O(E)
route of max, min and PNA's second moment, the conv with every aggregation,
and classic NBFNet's (rotate, sum) and (rotate, pna) rows. Inputs are made
by numpy from a seed; each block of D features holds the real parts in
[:D/2] and the imaginary parts in [D/2:].

The JAX package's rotate sum reaches its Pallas kernels only on the blocked
layouts (``rspmm_rotate_fwd_pallas`` / ``_bwd_pallas``; elsewhere it
silently takes XLA), so the Pallas comparisons build them explicitly and
assert that they exist.

Tolerances, each with its reason:
  * rotate sums: rtol = atol = 1e-5, the same products summed in another
    order (index_add_, segment_sum, the kernel's rows);
  * their gradients: 1e-4 against XLA and the plain K8b against _xla_bwd
    (sums of products of the gradient in another order), 6e-4 against
    interpret-mode Pallas, that kernel's own budget against XLA
    (tests/test_rspmm_pallas.py::test_pallas_rotate_matches_xla: the
    complex product doubles the fp32 operations per message);
  * the O(E) route: max and min exactly (an extremum of the same fp32
    products), sums 1e-5, gradients 1e-5; tied edges share the gradient
    in both packages (XLA's segment_max and scatter_reduce average it);
  * one conv layer: 1e-5 for values, 1e-4 for gradients (matmuls, layer
    norm and, for pna, std = sqrt(clip(sq_mean - mean², 1e-6)) in another
    order);
  * classic NBFNet scores, loss and gradients: 1e-4, as in
    test_torch_classic_variants.py (two stacked layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.models.classic_nbfnet import (
    classic_nbfnet_config as j_classic_cfg,
    classic_nbfnet_init as j_classic_init,
    classic_score_all as j_score_all,
)
from ultra_torchdrug_tpu.models.layers import ConvConfig as JConvConfig
from ultra_torchdrug_tpu.models.layers import _rotate_messages_aggregate
from ultra_torchdrug_tpu.models.layers import conv_apply as j_conv
from ultra_torchdrug_tpu.models.layers import conv_init as j_conv_init
from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import _xla_bwd
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.tasks.task import ClassicNBFNetTask as JTask
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.engine.engine import Engine
from ultra_torchdrug_tpu_torch.models import layers as t_layers
from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
    ClassicNBFNet,
    classic_nbfnet_config,
    classic_score_all,
)
from ultra_torchdrug_tpu_torch.models.layers import (
    ConvConfig,
    GeneralizedRelationalConv,
    conv_apply,
    sparse_only,
)
from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_cuda
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    broadcast_rel_flat,
    generalized_rspmm,
    generalized_rspmm_maxmin,
    rotate_aggregate,
)
from ultra_torchdrug_tpu_torch.tasks.task import ClassicNBFNetTask as TTask
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)
from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
XLA_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS_GRAD_TOL = dict(rtol=6e-4, atol=6e-4)
EXACT = dict(rtol=0, atol=0)
V, E, R, B, D = 37, 400, 6, 3, 8
EMPTY_ROWS = 4  # the last rows neither send nor receive an edge


def _t(a, dtype=None):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _inputs(rng, dim=D):
    """Edges with 40 duplicates (exact ties), 30 % of the weights 0, the
    first 5 rows of x all 0; relations shared [R, D] and per batch."""
    tri = np.stack([rng.integers(0, V - EMPTY_ROWS, E),
                    rng.integers(0, V - EMPTY_ROWS, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    tri[300:340] = tri[:40]
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.3] = 0.0
    x = rng.normal(size=(V, B, dim)).astype(np.float32)
    x[:5] = 0.0
    return dict(tri=tri, w=w, x=x,
                rel=rng.normal(size=(R, dim)).astype(np.float32),
                rel_b=rng.normal(size=(R, B, dim)).astype(np.float32),
                cot=rng.normal(size=(V, B, dim)).astype(np.float32))


def _relation(inp, per_batch):
    return inp["rel_b"] if per_batch else inp["rel"]


def _jax_op(inp, rel, agg="add", impl="xla", layouts=None):
    """(out, d_relation, d_x) of the JAX rotate rspmm under <cot, out>."""
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])

    def f(r, x):
        out = j_rspmm(ei, et, jnp.asarray(inp["w"]), r, x, msg="rotate",
                      agg=agg, num_nodes=V, impl=impl, layouts=layouts)
        return jnp.sum(out * inp["cot"]), out

    (_, out), (dr, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rel), jnp.asarray(inp["x"]))
    return [np.asarray(v) for v in (out, dr, dx)]


def _graph(inp):
    return TGraph.from_triplets(inp["tri"], V, R,
                                edge_weight=inp["w"]).prepare_csr(
                                    backward=True)


def _port_op(inp, rel, agg="add"):
    g = _graph(inp)
    r, x = _t(rel).requires_grad_(), _t(inp["x"]).requires_grad_()
    out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, r, x,
                            msg="rotate", agg=agg, num_nodes=V, csr=g.csr)
    dr, dx = torch.autograd.grad((out * _t(inp["cot"])).sum(), (r, x))
    return [v.detach().numpy() for v in (out, dr, dx)]


# ---------------------------------------------------------------------------
# the op and the plain versions of K8f and K8b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_batch", [False, True])
def test_op_matches_jax_xla(rng, per_batch):
    inp = _inputs(rng)
    rel = _relation(inp, per_batch)
    got = _port_op(inp, rel)
    want = _jax_op(inp, rel)
    np.testing.assert_allclose(got[0], want[0], **SUM_TOL)
    assert np.all(got[0][V - EMPTY_ROWS:] == 0)
    assert got[1].shape == rel.shape
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **XLA_GRAD_TOL)


@pytest.mark.parametrize("per_batch", [False, True])
def test_op_matches_jax_pallas_interpret(rng, per_batch):
    """Against the TPU kernels K8f (rspmm_gather1, mode rot_rel) and K8b
    (rspmm_bwd_fused, mode rotate) in interpret mode, on blocked layouts
    built as tests/test_rspmm_pallas.py builds them."""
    inp = _inputs(rng)
    rel = _relation(inp, per_batch)
    layouts = build_rspmm_layouts(inp["tri"][:, :2], inp["tri"][:, 2], V, R,
                                  tile_rows=16, tile_edges=32, blocked=True,
                                  block_rows=16)
    assert layouts.fwd_blk is not None and layouts.rev_blk is not None
    got = _port_op(inp, rel)
    want = _jax_op(inp, rel, impl="pallas", layouts=layouts)
    np.testing.assert_allclose(got[0], want[0], **SUM_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("dim", [6, 8])
def test_kernel_plain_versions_match_jax(rng, dim):
    """K8f's and K8b's wrappers on CPU tensors run their plain versions over
    the CSR (no launch counted): the forward against the JAX XLA op, the
    backward against _xla_bwd(msg="rotate"), per batch; each backward half
    alone equals the pair's. D/2 = 3 is the kernel's scalar path, 4 its
    float4 path."""
    inp = _inputs(rng, dim)
    g = _graph(inp)
    csr, F = g.csr, B * dim
    rel, x = _t(inp["rel_b"]).reshape(R, F), _t(inp["x"]).reshape(V, F)
    grad = _t(inp["cot"]).reshape(V, F)
    before = (rspmm_cuda.rotate_launches, dict(rspmm_bwd_cuda.launches))
    out = rspmm_cuda.rotate_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                                     g.edge_weight, rel, x, dim)
    dx, dr = rspmm_bwd_cuda.rotate_bwd_cuda(csr, g.edge_weight, rel, x, grad,
                                            dim)
    assert (rspmm_cuda.rotate_launches, rspmm_bwd_cuda.launches) == before
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])
    args = (ei, et, jnp.asarray(inp["w"]), jnp.asarray(inp["rel_b"]),
            jnp.asarray(inp["x"]))
    want = j_rspmm(*args, msg="rotate", agg="add", num_nodes=V, impl="xla")
    want_dr, want_dx = _xla_bwd(*args, jnp.asarray(inp["cot"]), msg="rotate")
    np.testing.assert_allclose(out.numpy(), np.asarray(want).reshape(V, F),
                               **SUM_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx).reshape(V, F),
                               **XLA_GRAD_TOL)
    np.testing.assert_allclose(dr.numpy(), np.asarray(want_dr).reshape(R, F),
                               **XLA_GRAD_TOL)
    assert torch.all(dx[V - EMPTY_ROWS:] == 0)
    dx2, none = rspmm_bwd_cuda.rotate_bwd_plain(csr, g.edge_weight, rel, x,
                                                grad, dim, need_dr=False)
    none2, dr2 = rspmm_bwd_cuda.rotate_bwd_plain(csr, g.edge_weight, rel, x,
                                                 grad, dim, need_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx2, dx) and torch.equal(dr2, dr)


def test_rotate_rejects_what_the_jax_op_rejects(rng):
    """Flat inputs and odd D raise with the JAX package's words; the kernels'
    wrappers reject a block width that does not divide the row; the fused
    max/min pair has no rotate."""
    inp = _inputs(rng, dim=5)
    g = _graph(inp)
    edges = (g.edge_index, g.edge_type, g.edge_weight)
    for rel, x in ((_t(inp["rel"]), _t(inp["x"])),
                   (_t(inp["rel_b"]).reshape(R, -1),
                    _t(inp["x"]).reshape(V, -1))):
        with pytest.raises(ValueError, match="even D"):
            generalized_rspmm(*edges, rel, x, msg="rotate", num_nodes=V,
                              csr=g.csr)
    x = torch.zeros((V, 12))
    with pytest.raises(ValueError, match="block width"):
        rspmm_cuda.rotate_fwd_cuda(g.csr.rowptr, g.csr.src, g.csr.etype,
                                   g.csr.eid, g.edge_weight,
                                   torch.zeros((R, 12)), x, 8)
    with pytest.raises(ValueError, match="fused max/min pair"):
        generalized_rspmm_maxmin(*edges, torch.zeros((R, 12)), x,
                                 msg="rotate", num_nodes=V, csr=g.csr)


# ---------------------------------------------------------------------------
# the O(E) route: max, min and PNA's second moment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agg", ["add", "max", "min", "sq_add"])
def test_o_e_route_matches_jax(rng, agg):
    """rotate_aggregate against the JAX package's
    _rotate_messages_aggregate, forward and gradients, on a graph with
    duplicated edges, weight-0 edges and all-zero x rows, so that messages
    tie exactly; generalized_rspmm sends max and min there."""
    inp = _inputs(rng)
    rel = inp["rel_b"]
    jg = JGraph.from_triplets(inp["tri"], V, R, edge_weight=inp["w"])

    def f(r, x):
        out = _rotate_messages_aggregate(jg, r, x, agg)
        return jnp.sum(out * inp["cot"]), out

    (_, want), want_grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(rel),
                                         jnp.asarray(inp["x"]))
    g = TGraph.from_triplets(inp["tri"], V, R, edge_weight=inp["w"])
    r, x = _t(rel).requires_grad_(), _t(inp["x"]).requires_grad_()
    got = rotate_aggregate(g.edge_index, g.edge_type, g.edge_weight, r, x,
                           agg, V)
    grads = torch.autograd.grad((got * _t(inp["cot"])).sum(), (r, x))
    tol = EXACT if agg in ("max", "min") else SUM_TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    assert torch.all(got[V - EMPTY_ROWS:] == 0)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SUM_TOL)
    if agg in ("max", "min"):
        op = _port_op(inp, rel, agg)
        np.testing.assert_array_equal(op[0], got.detach().numpy())


def test_tied_edges_share_the_gradient():
    """D = 2 and rel = 1 + 0i, so the message is the source's value. Node 0
    receives 1, 3, 3 and node 1 receives 2, 3: the maxima 3 and 3 give the
    gradients [0, 1/2, 1/2, 0, 1] to the five sources in both packages
    (the Pallas kernels would give 1 to each tied edge)."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 1, 0], [4, 1, 0]],
                   np.int32)
    x = np.zeros((5, 1, 2), np.float32)
    x[:, 0, 0] = [1, 3, 3, 2, 3]
    x[:, 0, 1] = [0.5, -1, 2, 0.25, 1]
    rel = np.array([[1.0, 0.0]], np.float32)
    cot = np.zeros((5, 1, 2), np.float32)
    cot[:2, 0, 0] = 1.0  # the real maxima of nodes 0 and 1
    jg = JGraph.from_triplets(tri, 5, 1)

    def f(xx):
        return jnp.sum(j_rspmm(jg.edge_index, jg.edge_type, jg.edge_weight,
                               jnp.asarray(rel), xx, msg="rotate", agg="max",
                               num_nodes=5, impl="xla") * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    g = TGraph.from_triplets(tri, 5, 1)
    xt = _t(x).requires_grad_()
    out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight,
                            _t(rel), xt, msg="rotate", agg="max", num_nodes=5)
    (dx,) = torch.autograd.grad((out * _t(cot)).sum(), (xt,))
    assert out[:2, 0, 0].tolist() == [3.0, 3.0]
    assert dx[:, 0, 0].tolist() == [0.0, 0.5, 0.5, 0.0, 1.0]
    np.testing.assert_array_equal(dx.numpy(), want)


# ---------------------------------------------------------------------------
# the conv
# ---------------------------------------------------------------------------

CONV_D, CONV_B, CONV_R = 8, 3, 5
AGGREGATIONS = [f"{base}{bound}" for base in ("sum", "mean", "max", "pna")
                for bound in ("", "_nobound")]


def _conv_setup(rng, aggregate):
    """A rotate conv in dependent mode with the JAX layer's weights, on an
    undirected graph with duplicated and masked edges and post-ReLU
    states."""
    kw = dict(input_dim=CONV_D, output_dim=CONV_D, num_relations=2 * CONV_R,
              query_input_dim=CONV_D, message_func="rotate",
              aggregate_func=aggregate, layer_norm=True, rel_mode="dependent",
              project=False)
    jcfg = JConvConfig(**kw)
    params = j_conv_init(jax.random.PRNGKey(1), jcfg)
    layer = GeneralizedRelationalConv(ConvConfig(**kw))
    state = jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, params)]})
    layer.load_state_dict({k.partition(".0.")[2]: v for k, v in state.items()})
    Vc, Ec = 34, 260
    tri = np.stack([rng.integers(0, Vc, Ec), rng.integers(0, Vc - 3, Ec),
                    rng.integers(0, CONV_R, Ec)], 1).astype(np.int32)
    tri[200:230] = tri[:30]
    w = (rng.uniform(size=Ec) > 0.25).astype(np.float32)
    x = np.maximum(rng.normal(size=(Vc, CONV_B * CONV_D)), 0).astype(
        np.float32)
    bnd = np.zeros_like(x)
    bnd[rng.integers(0, Vc, CONV_B), np.arange(CONV_B) * CONV_D] = 1.0
    query = rng.normal(size=(CONV_B, CONV_D)).astype(np.float32)
    jg = JGraph.from_triplets(tri, Vc, CONV_R, edge_weight=w)
    tg = TGraph.from_triplets(tri, Vc, CONV_R, edge_weight=w)
    return dict(jcfg=jcfg, params=params, layer=layer, x=x, bnd=bnd,
                query=query, cot=rng.normal(size=x.shape).astype(np.float32),
                jg=jg.undirected_with_inverse(),
                tg=tg.undirected_with_inverse().prepare_csr(backward=True))


@pytest.mark.parametrize("aggregate", AGGREGATIONS)
def test_conv_matches_jax(rng, aggregate):
    """One rotate layer's output and its gradients with respect to x, the
    query and every weight, against the JAX conv (whose rotate takes the
    O(E) route here: the graph has no Pallas layouts)."""
    s = _conv_setup(rng, aggregate)
    cot = s["cot"]

    def j_loss(params, x, query):
        out = j_conv(params, s["jcfg"], s["jg"], x, jnp.asarray(s["bnd"]),
                     query=query)
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True))(
        s["params"], jnp.asarray(s["x"]), jnp.asarray(s["query"]))
    x, query = _t(s["x"]).requires_grad_(), _t(s["query"]).requires_grad_()
    layer = s["layer"]
    out = conv_apply(layer, s["tg"], x, _t(s["bnd"]), query=query)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **SUM_TOL)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out * _t(cot)).sum(),
                                [x, query] + list(layer.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_g[1]),
                               **XLA_GRAD_TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(want_g[2]),
                               **XLA_GRAD_TOL)
    want_p = {k.partition(".0.")[2]: v for k, v in jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, want_g[0])]}).items()}
    assert set(names) == set(want_p)
    for name, gr in zip(names, grads[2:]):
        np.testing.assert_allclose(gr.numpy(), want_p[name].numpy(),
                                   err_msg=name, **XLA_GRAD_TOL)


def test_rotate_never_takes_the_dense_route(rng, monkeypatch):
    """ULTRA's relation-tower layout (injected mode, per-query relations)
    with rotate sum on a graph that carries a dense adjacency: the conv
    never calls the dense route, runs the sum over the graph's CSR and
    agrees with the JAX conv (whose rotate branch returns before its dense
    check); sparse_only asks for the CSR for every rotate aggregation."""
    Vd, Ed, Rd, Dd, Bd = 12, 90, 4, 8, 2
    tri = np.stack([rng.integers(0, Vd, Ed), rng.integers(0, Vd, Ed),
                    rng.integers(0, Rd, Ed)], 1).astype(np.int32)
    kw = dict(input_dim=Dd, output_dim=Dd, num_relations=Rd,
              query_input_dim=Dd, message_func="rotate",
              aggregate_func="sum", layer_norm=True, rel_mode="injected",
              project=True)
    jcfg = JConvConfig(**kw)
    params = j_conv_init(jax.random.PRNGKey(3), jcfg)
    layer = GeneralizedRelationalConv(ConvConfig(**kw))
    state = jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, params)]})
    layer.load_state_dict({k.partition(".0.")[2]: v for k, v in state.items()})
    x = np.maximum(rng.normal(size=(Vd, Bd * Dd)), 0).astype(np.float32)
    bnd = np.zeros_like(x)
    bnd[[1, 5], [0, Dd]] = 1.0
    rel = rng.normal(size=(Bd, Rd, Dd)).astype(np.float32)
    jg = JGraph.from_triplets(tri, Vd, Rd).prepare_dense(min_density=0.0)
    tg = TGraph.from_triplets(tri, Vd, Rd).prepare_dense(min_density=0.0)
    tg = tg.prepare_csr(backward=True)
    assert jg.dense_adj is not None and tg.dense_adj is not None
    want = j_conv(params, jcfg, jg, jnp.asarray(x), jnp.asarray(bnd),
                  rel_injected=jnp.asarray(rel))

    def no_dense(*args, **kwargs):
        raise AssertionError("rotate took the dense route")

    monkeypatch.setattr(t_layers, "dense_rspmm", no_dense)
    with torch.no_grad():
        got = conv_apply(layer, tg, _t(x), _t(bnd), rel_injected=_t(rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)
    assert all(sparse_only(a, "rotate") for a in AGGREGATIONS)
    assert not sparse_only("sum", "distmult")


def test_shared_relation_gradient_sums_over_the_batch(rng):
    """A shared [R, D] relation reaches the rotate sum broadcast to every
    query (broadcast_rel_flat), so autograd sums its gradient over the
    batch, as rspmm_rotate_bwd_pallas does."""
    inp = _inputs(rng)
    g = _graph(inp)
    r = _t(inp["rel"]).requires_grad_()
    x = _t(inp["x"]).reshape(V, -1)
    out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight,
                            broadcast_rel_flat(r, B).reshape(R, B, D),
                            x.reshape(V, B, D), msg="rotate", num_nodes=V,
                            csr=g.csr)
    (dr,) = torch.autograd.grad((out * _t(inp["cot"])).sum(), (r,))
    want = _port_op(inp, inp["rel"])[1]
    np.testing.assert_allclose(dr.numpy(), want, **SUM_TOL)


# ---------------------------------------------------------------------------
# classic NBFNet with rotate messages
# ---------------------------------------------------------------------------

NUM_ENT, NUM_EDGES, NUM_REL, DIM = 40, 300, 5, 8
CLASSIC_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg_kw(aggregate):
    return dict(input_dim=DIM, hidden_dims=(DIM, DIM), num_relations=NUM_REL,
                message_func="rotate", aggregate_func=aggregate,
                layer_norm=True)


def _models(aggregate, seed=0):
    """(JAX config, JAX params, port model with the same weights)."""
    jcfg = j_classic_cfg(**_cfg_kw(aggregate))
    params = j_classic_init(jax.random.PRNGKey(seed), jcfg)
    model = load_jax_params(ClassicNBFNet(classic_nbfnet_config(
        **_cfg_kw(aggregate))), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


@pytest.fixture(scope="module")
def datasets():
    return (j_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0),
            t_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0))


@pytest.mark.parametrize("aggregate", ["sum", "pna"])
def test_classic_score_all_matches_jax(datasets, aggregate):
    jds, tds = datasets
    jcfg, params, model = _models(aggregate, seed=2)
    jund = jds.fact_graph(None)[0].undirected_with_inverse()
    tund = tds.fact_graph(None)[0].undirected_with_inverse().prepare_csr()
    rng = np.random.default_rng(3)
    src = rng.integers(0, NUM_ENT, 4)
    rel = rng.integers(0, 2 * NUM_REL, 4)
    want = np.asarray(jax.jit(lambda p, h, r: j_score_all(p, jcfg, jund, h, r))(
        params, jnp.asarray(src), jnp.asarray(rel)))
    with torch.no_grad():
        got = classic_score_all(model, tund, _t(src, np.int64),
                                _t(rel, np.int64))
    assert got.shape == (4, NUM_ENT)
    np.testing.assert_allclose(got.numpy(), want, **CLASSIC_TOL)


@pytest.mark.parametrize("aggregate", ["sum", "pna"])
def test_loss_step_matches_jax_pallas(datasets, aggregate):
    """One loss step with injected negatives: the loss and every
    parameter's gradient against the JAX task on interpret-mode Pallas
    (the rotate sums on K8f/K8b's TPU kernels over the blocked layouts;
    pna's max, min and second moment on the O(E) route)."""
    jds, tds = datasets
    jcfg, params, model = _models(aggregate)
    jcfg = dataclasses.replace(jcfg, rspmm_impl="pallas")
    jtask = JTask(jds, jcfg, JTaskConfig(num_negative=5))
    fact = jtask.fact_graph.prepare_join()
    fact_und = fact.undirected_with_inverse().prepare_pallas(
        tile_rows=16, tile_edges=32, blocked=True, block_rows=16)
    assert fact_und.layouts.fwd_blk is not None
    assert fact_und.layouts.rev_blk is not None
    rng = np.random.default_rng(7)
    train = tds.train
    batch = train[rng.choice(len(train), 6, replace=False)]
    neg = rng.integers(0, NUM_ENT, (6, 5)).astype(np.int32)

    def j_loss(p):
        scores = jtask._train_scores(
            p, fact, None, *(jnp.asarray(batch[:, i]) for i in range(3)),
            jnp.asarray(neg), fact_und)
        return j_criterion(jtask.cfg, scores)

    # jitted: one lowering of the interpret-mode kernels, not one per call
    want_loss, want_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads))
    ttask = TTask(tds, classic_nbfnet_config(**_cfg_kw(aggregate)),
                  TaskConfig(num_negative=5), device="cpu")
    loss, _ = ttask.loss_step(model, None, batch, neg=_t(neg, np.int64))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **CLASSIC_TOL)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **CLASSIC_TOL)
    assert all(p.grad.abs().sum() > 0 for p in got.values())


@pytest.mark.parametrize("aggregate", ["sum", "pna"])
def test_engine_trains_rotate(datasets, aggregate):
    """Engine takes each rotate row as it is: Adam at lr 5e-3, strict
    negatives, finite metrics, every parameter moved; then evaluation.
    (rotate, pna) trains here only: on the card it waits for
    recomputation (PERF.md)."""
    _, tds = datasets
    task = TTask(tds, classic_nbfnet_config(**_cfg_kw(aggregate)),
                 TaskConfig(num_negative=8, strict_negative=True,
                            adversarial_temperature=1), device="cpu")
    eng = Engine(task, batch_size=8, optimizer="Adam", lr=5e-3, seed=3,
                 log_interval=100, logger=get_root_logger(None))
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    eng.train(num_epoch=1, batch_per_epoch=3)
    window = eng.meter.last_window
    assert len(window) == 3
    assert all(np.isfinite(v) for step in window for v in step.values())
    after = eng.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    metrics = eng.evaluate("test", fast_test=8)
    assert all(np.isfinite(v) for v in metrics.values())

"""The ring's other schedules against the JAX package's single-device ops
on the CPU: ``ring_rspmm`` with agg max and min, PNA's extremum pair
``ring_rspmm_maxmin`` and its moments ``ring_rspmm_addsq``, both
exchanges, and ULTRA with a max and a pna entity tower on the balanced,
permuted-IO ring (tests/test_parallel.py's scenario, held against JAX
here). No JAX mesh is built: the port's shards all live on the CPU.

The graphs are deduplicated, as tests/test_parallel.py deduplicates them
where extrema's gradients are compared: a duplicated edge is an exact tie
that the JAX package's XLA route and its kernels resolve apart. Exact ties
remain: the first x rows are 0 (distmult messages 0, transe messages
rel[r] from every such source), a fifth of the weights are 0 and the last
rows have no in-edge.

Tolerances, each with its reason:
  * extrema: equal (``==``) to interpret-mode Pallas: an extremum does not
    depend on the order of the edges, and the messages are the same fp32
    products;
  * extrema's gradients: 1e-5, every tied edge taking all of the gradient
    in both, the gated terms summed in another order;
  * the moments: 1e-5, sums in another order;
  * the two exchanges: bitwise, the same data moved;
  * ULTRA: scores and loss 1e-5, gradients 1e-4 norm-wise, as in
    tests/test_torch_ring_ultra.py; the JAX model runs interpret-mode
    Pallas, whose tie convention the ring shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ring_ultra import one_torch_thread  # noqa: F401  (a fixture)

from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_maxmin as j_maxmin
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.data.relgraph import (
    build_relation_graph as t_relgraph,
)
from ultra_torchdrug_tpu_torch.models.layers import (
    ConvConfig,
    GeneralizedRelationalConv,
    conv_apply,
)
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import ultra_train_scores
from ultra_torchdrug_tpu_torch.nn.core import init_parameters_
from ultra_torchdrug_tpu_torch.parallel import ring_rspmm as ring_mod
from ultra_torchdrug_tpu_torch.parallel.mesh import make_mesh, use_mesh
from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
    build_ring_rspmm_inputs,
    ring_rspmm,
    ring_rspmm_addsq,
    ring_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig
from ultra_torchdrug_tpu_torch.tasks.task import _criterion_loss
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, R, B, D = 43, 260, 5, 2, 4  # V divides by none of 2, 3, 4
F = B * D
# (shards, balance, permuted_io, exchange): relabelled and contiguous
# blocks, block-domain and original-order operands, both exchanges
RINGS = ((1, False, False, "ppermute"), (3, True, True, "rdma"),
         (4, False, True, "ppermute"), (4, True, False, "rdma"))


def _inputs(seed):
    """Deduplicated edges with ties (module docstring), flat operands and
    two cotangents."""
    rng = np.random.default_rng(seed)
    tri = np.unique(np.stack([rng.integers(0, V, E),
                              rng.integers(0, V - 3, E),
                              rng.integers(0, R, E)], 1), axis=0)
    tri = tri.astype(np.int32)
    w = rng.uniform(0.5, 1.5, len(tri)).astype(np.float32)
    w[rng.uniform(size=len(tri)) < 0.2] = 0.0
    x = rng.normal(size=(V, F)).astype(np.float32)
    x[:6] = 0.0
    return dict(tri=tri, w=w, x=x,
                rel=rng.normal(size=(R, F)).astype(np.float32),
                g=[rng.normal(size=(V, F)).astype(np.float32)
                   for _ in range(2)])


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_pairs(inp, msg):
    """The JAX package's fused pair on interpret-mode Pallas over the
    interleaved blocked layouts (the JAX task's for extrema): (max, min)
    and the gradients with respect to (relation, x) of <g0, max> +
    <g1, min>, of <g0, max> alone and of <g1, min> alone (the same jitted
    function with a zero cotangent, one compilation for the three)."""
    tri = inp["tri"]
    layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], V, R, tile_rows=16,
                                  tile_edges=32, blocked=True, block_rows=16,
                                  bwd_block_rows=8, interleave=8)
    ei, et = jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2])

    def f(rel, x, g0, g1):
        mx, mn = j_maxmin(ei, et, jnp.asarray(inp["w"]), rel, x, num_nodes=V,
                          impl="pallas", layouts=layouts, msg=msg)
        return jnp.sum(mx * g0) + jnp.sum(mn * g1), (mx, mn)

    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    rel, x = jnp.asarray(inp["rel"]), jnp.asarray(inp["x"])
    g0, g1 = (jnp.asarray(g) for g in inp["g"])
    zero = jnp.zeros_like(g0)
    runs = [fn(rel, x, *cot) for cot in ((g0, g1), (g0, zero), (zero, g1))]
    (_, (mx, mn)), _ = runs[0]
    return ([np.asarray(mx), np.asarray(mn)],
            [[np.asarray(v) for v in grads] for _, grads in runs])


def _port(fn, inp, ring, cotangents=None, **kw):
    """The ring op's outputs and the gradients of Σ <g_i, out_i> with
    respect to (relation, x), with the operands taken to the ring's block
    domain by the caller when its buckets were built with
    ``permuted_io``."""
    n, balance, permuted_io, exchange = ring
    ri = build_ring_rspmm_inputs(inp["tri"][:, :2], inp["tri"][:, 2], V, n,
                                 num_relations=R, balance=balance,
                                 permuted_io=permuted_io)
    rel, x = _t(inp["rel"]).requires_grad_(), _t(inp["x"]).requires_grad_()
    xx = x
    if permuted_io:
        xx = torch.cat([x, x.new_zeros((ri.v_pad - V, F))])
        xx = xx if ri.to_old is None else xx[ri.to_old]
    out = fn(_t(inp["w"]), ri, rel, xx, exchange=exchange, **kw)
    out = out if isinstance(out, tuple) else (out,)
    if permuted_io:
        out = tuple(o[:V] if ri.to_new is None else o[ri.to_new]
                    for o in out)
    loss = sum((o * _t(g)).sum()
               for o, g in zip(out, cotangents or inp["g"]))
    grads = torch.autograd.grad(loss, (rel, x))
    return [v.detach().numpy() for v in (*out, *grads)]


def _check(got, values, grads):
    for a, b in zip(got, values):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[len(values):], grads):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_ring_extrema_match_pallas(msg):
    """``ring_rspmm`` with agg max and with agg min, and the pair of one
    rotation (``ring_rspmm_maxmin``, the four planes' transposed ring),
    against the JAX package's fused pair: every extremum equal, every
    gradient within 1e-5, on each ring of RINGS."""
    inp = _inputs(1 + (msg == "add"))
    (mx, mn), (pair, max_only, min_only) = _jax_pairs(inp, msg)
    assert np.all(mx[-3:] == 0) and np.all(mn[-3:] == 0)  # no in-edges
    for ring in RINGS:
        _check(_port(ring_rspmm_maxmin, inp, ring, msg=msg), (mx, mn), pair)
        _check(_port(ring_rspmm, inp, ring, msg=msg, agg="max"), (mx,),
               max_only)
        _check(_port(ring_rspmm, inp, ring, [inp["g"][1]], msg=msg,
                     agg="min"), (mn,), min_only)


def test_ring_addsq_matches_jax():
    """The moments of one rotation against the JAX package's two XLA sums,
    Σ w·rel·x and Σ w·rel²·x² (the same sums as Σ w·m and Σ w·m²), and
    their gradients."""
    inp = _inputs(5)
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])

    def f(rel, x):
        s = j_rspmm(ei, et, jnp.asarray(inp["w"]), rel, x, msg="mul",
                    num_nodes=V, impl="xla")
        sq = j_rspmm(ei, et, jnp.asarray(inp["w"]), rel ** 2, x ** 2,
                     msg="mul", num_nodes=V, impl="xla")
        return (jnp.sum(s * inp["g"][0]) + jnp.sum(sq * inp["g"][1]),
                (s, sq))

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(inp["rel"]),
                                          jnp.asarray(inp["x"]))
    want = [np.asarray(v) for v in (*out, *grads)]
    for ring in RINGS:
        got = _port(ring_rspmm_addsq, inp, ring)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("schedule", ["max", "maxmin", "addsq"])
def test_exchanges_agree_bitwise(schedule):
    """ppermute (the plain shift) and rdma (K9's plain version here) move
    the same blocks, packed planes included: forward and gradients
    bitwise."""
    inp = _inputs(7)
    fn, kw = {"max": (ring_rspmm, dict(msg="mul", agg="max")),
              "maxmin": (ring_rspmm_maxmin, dict(msg="add")),
              "addsq": (ring_rspmm_addsq, {})}[schedule]
    a = _port(fn, inp, (4, True, True, "ppermute"), **kw)
    b = _port(fn, inp, (4, True, True, "rdma"), **kw)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_pna_conv_takes_the_block_degree_on_the_ring():
    """A pna conv on a balanced, permuted-IO ring, states in the block
    domain, against the single-device conv. V = 44 splits into 4 blocks of
    11 with no pad row, so a degree left in original order has the block
    domain's shape and only the relabelling tells them apart: the degree
    must be the block domain's (layers.block_degree)."""
    rng = np.random.default_rng(9)
    n = 44
    tri = np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300),
                    rng.integers(0, R, 300)], 1)
    tri[:100, 1] = rng.integers(0, 3, 100)  # hubs: the blocks relabel
    w = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    g = Graph.from_triplets(tri, n, R, edge_weight=w).prepare_csr(
        backward=True)
    g = g.prepare_ring(4, pallas=True, balance=True, permuted_io=True)
    ri = g.ring_inputs
    assert ri.v_pad == n and ri.to_new is not None
    cfg = ConvConfig(input_dim=D, output_dim=D, num_relations=R,
                     query_input_dim=D, aggregate_func="pna",
                     layer_norm=True, rel_mode="embedding",
                     rspmm_impl="ring", edge_axis="edge",
                     ring_exchange="rdma")
    layer = GeneralizedRelationalConv(cfg)
    init_parameters_(layer, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32))
    bnd = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32))
    want = conv_apply(layer, g, x, bnd)  # off the mesh: one device
    with use_mesh(make_mesh(edge=4, device="cpu")):
        got = conv_apply(layer, g, x[ri.to_old], bnd[ri.to_old],
                         block_domain=True)[ri.to_new]
    torch.testing.assert_close(got, want, **TOL)


@pytest.fixture(scope="module")
def ultra_graph():
    """tests/test_parallel.py's hub graph shape: 30 entities, 3
    relations, half its 120 edges deduplicated, hubs among 6 nodes."""
    rng = np.random.default_rng(0)
    n, rel = 30, 3
    src = np.where(rng.uniform(size=60) < 0.5, rng.integers(0, 6, 60),
                   rng.integers(0, n, 60))
    tri = np.unique(np.stack([src, rng.integers(0, n, 60),
                              rng.integers(0, rel, 60)], 1), axis=0)
    pos = tri[rng.choice(len(tri), 3, replace=False)]
    neg = rng.integers(0, n, (3, 5))
    return n, rel, tri.astype(np.int32), pos, neg


@pytest.mark.parametrize("aggregate_func", ["max", "pna"])
def test_ultra_ring_extrema_match_jax_single_device(ultra_graph,
                                                    aggregate_func,
                                                    monkeypatch):
    """ULTRA (2x8 towers) whose entity tower aggregates by max or pna on
    a balanced, permuted-IO ring of 4 shards with rdma, against the JAX
    single-device model on interpret-mode Pallas: train scores, the loss
    and every gradient, on converted weights."""
    n, rel_count, tri, pos, neg = ultra_graph
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=8, hidden_dims=(8, 8),
                         num_relations=2 * rel_count,
                         aggregate_func=aggregate_func, rspmm_impl="pallas"),
        relation=j_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    jg = JGraph.from_triplets(tri, n, rel_count)
    jund = jg.undirected_with_inverse().prepare_pallas(
        interleave=8, **(dict(bwd_block_rows=256)
                         if aggregate_func == "pna" else {}))

    jrel = j_relgraph(jg).prepare_dense()

    def j_loss(p):
        s = j_train(p, jcfg, jg, jrel,
                    *(jnp.asarray(pos[:, i]) for i in range(3)),
                    jnp.asarray(neg.astype(np.int32)), fact_graph_und=jund)
        return j_criterion(JTaskConfig(), s, None), s

    (want_loss, want_scores), want_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(params)
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads))

    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=8, hidden_dims=(8, 8),
                         num_relations=2 * rel_count,
                         aggregate_func=aggregate_func, rspmm_impl="ring",
                         edge_axis="edge", ring_exchange="rdma"),
        relation=t_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    graph = Graph.from_triplets(tri, n, rel_count)
    und = graph.undirected_with_inverse().prepare_csr(backward=True)
    und = und.prepare_ring(4, pallas=True, balance=True, permuted_io=True)
    assert und.ring_inputs.to_new is not None
    calls = []
    for name in ("_RingExtremum", "_RingMaxMin", "_RingAddSq"):
        fn = getattr(ring_mod, name)
        monkeypatch.setattr(fn, "apply", lambda *a, real=fn.apply:
                            calls.append(a[0]) or real(*a))
    with use_mesh(make_mesh(edge=4, device="cpu")):
        scores = ultra_train_scores(
            model, graph, t_relgraph(graph).prepare_dense(),
            *(torch.from_numpy(pos[:, i]) for i in range(3)),
            torch.from_numpy(neg), fact_graph_und=und)
        loss = _criterion_loss(TaskConfig(), scores)
        loss.backward()
    # 2 layers in the block domain: max one schedule, pna two
    assert len(calls) == (2 if aggregate_func == "max" else 4)
    assert all(c is und.ring_inputs for c in calls)
    np.testing.assert_allclose(scores.detach().numpy(),
                               np.asarray(want_scores), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5,
                               atol=0)
    for name, p in model.named_parameters():
        want = want_grads[name]
        err = ((p.grad - want).norm() / want.norm().clamp(min=1e-12)).item()
        assert err <= 1e-4, (name, err)

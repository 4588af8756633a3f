"""The port's bf16 operand mode (``compute_dtype="bfloat16"``: kernels K1h
and K2h on the card, their plain versions here) against the JAX package's
interpret-mode Pallas kernels with the same mode, on the CPU: the op and
its gradients, a product that bf16 cannot hold, the conv's routes, and a
2-layer ULTRA's scores, loss and every gradient on converted weights.

The JAX references are compiled with ``xla_allow_excess_precision`` off:
XLA's CPU backend otherwise keeps the Pallas kernel's bf16 product in fp32
and skips its rounding, which the TPU kernel (and K1h) performs.
Interpret-mode Pallas pads bf16 rows to 1024 features, so the graphs stay
at a few hundred edges.

Tolerances, each with its reason. Operands round to the same bf16 values
in both packages and every message is rounded from the same exact fp32
product, so only the order of the fp32 sums differs:
  * the op and its gradients: rtol = atol = 1e-5, as for the fp32 sums of
    test_torch_extremum.py;
  * the unrepresentable product: 1e-6 against the rounded expectation,
    while the unrounded sum lies 6e-5 away;
  * one conv layer: 1e-5 for values, 1e-4 for gradients (norms and matmuls
    in another order, then their backward), as for the fp32 conv;
  * ULTRA scores, loss and gradients: 1e-4, as for the fp32 towers. A bf16
    rounding of a layer's input that falls on the other side of a rounding
    boundary in the two packages would move a value by 2^-8 of itself; at
    these sizes none does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.layers import ConvConfig as JConvConfig
from ultra_torchdrug_tpu.models.layers import conv_apply as j_conv
from ultra_torchdrug_tpu.models.layers import conv_init as j_conv_init
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_eval
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
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
from ultra_torchdrug_tpu_torch.models.ultra import ultra_eval_scores
from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda, rspmm_cuda
from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig
from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask as TTask
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

BF16 = "bfloat16"
OP_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TOWER_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT_XLA = {"xla_allow_excess_precision": False}


def _t(a, dtype=None):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _jax_exact(fn, *args):
    """fn(*args) jitted with the bf16 roundings the kernels perform."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_XLA)(*args)


def _op_graph(rng, V=24, E=90, R=4):
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - 3, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], V, R, tile_rows=16,
                                  tile_edges=32, include_rel_layout=True)
    graph = TGraph.from_triplets(tri, V, R, edge_weight=w)
    return tri, w, layouts, graph.prepare_csr(backward=True)


def _op(tri, w, graph, relation, x, msg):
    return generalized_rspmm(graph.edge_index, graph.edge_type,
                             graph.edge_weight, relation, x, msg=msg,
                             num_nodes=graph.num_nodes, csr=graph.csr,
                             compute_dtype=BF16)


# (msg, relation form): distmult with a relation shared by the batch,
# transe with one relation per query
OP_CASES = (("mul", "shared"), ("add", "per_batch"))


@pytest.fixture(scope="module")
def op_results():
    """Each OP_CASES case's operands and, in one compilation, the JAX op's
    output and its vjp (dr, dx) on interpret-mode Pallas."""
    rng = np.random.default_rng(11)
    tri, w, layouts, graph = _op_graph(rng)
    V, R, B, D = graph.num_nodes, graph.num_relations, 2, 4
    cases = []
    for _, rel_form in OP_CASES:
        rel = rng.normal(size=(R, D) if rel_form == "shared" else (R, B, D))
        cases.append((rel.astype(np.float32),
                      rng.normal(size=(V, B, D)).astype(np.float32),
                      rng.normal(size=(V, B, D)).astype(np.float32)))

    def j_fn(cases):
        results = []
        for (msg, _), (rel, x, cot) in zip(OP_CASES, cases):
            def f(rel, x, msg=msg):
                return j_rspmm(jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2]),
                               jnp.asarray(w), rel, x, msg=msg, num_nodes=V,
                               impl="pallas", layouts=layouts,
                               compute_dtype=BF16)
            out, vjp = jax.vjp(f, rel, x)
            results.append((out, *vjp(cot)))
        return results

    want = _jax_exact(j_fn, cases)
    return tri, w, graph, cases, [[np.asarray(a) for a in r] for r in want]


@pytest.mark.parametrize("case", range(len(OP_CASES)))
def test_op_and_gradients_match_jax_pallas(op_results, case):
    """The plain K1h (mul, add), and for mul the plain K2h's dx and dr,
    against jax.vjp through the JAX op on interpret-mode Pallas (transe's
    backward is K3 in fp32 in both)."""
    tri, w, graph, cases, results = op_results
    msg = OP_CASES[case][0]
    (rel, x, cot), (want, want_dr, want_dx) = cases[case], results[case]
    trel, tx = _t(rel).requires_grad_(), _t(x).requires_grad_()
    out = _op(tri, w, graph, trel, tx, msg)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), want, **OP_TOL)
    np.testing.assert_allclose(trel.grad.numpy(), want_dr, **OP_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, **OP_TOL)
    # the operands were rounded: the fp32 op differs by far more
    f32 = generalized_rspmm(graph.edge_index, graph.edge_type,
                            graph.edge_weight, _t(rel), _t(x), msg=msg,
                            num_nodes=graph.num_nodes, csr=graph.csr)
    assert np.abs(f32.numpy() - want).max() > 1e-3


def test_forward_rounds_the_product_to_bf16():
    """(1 + 2^-7)² = 1 + 2^-6 + 2^-14 has no bf16 value: both packages sum
    the rounded 1 + 2^-6 over the two edges into node 0, not the exact
    product."""
    a = 1 + 2.0 ** -7
    tri = np.array([[1, 0, 0], [2, 0, 0], [1, 2, 1]], np.int32)
    w = np.ones(3, np.float32)
    rel = np.full((2, 8), a, np.float32)
    x = np.full((3, 8), a, np.float32)
    layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], 3, 2, tile_rows=16,
                                  tile_edges=32)
    want = np.asarray(_jax_exact(
        lambda rel, x: j_rspmm(jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2]),
                               jnp.asarray(w), rel, x, msg="mul", num_nodes=3,
                               impl="pallas", layouts=layouts,
                               compute_dtype=BF16), rel, x))
    graph = TGraph.from_triplets(tri, 3, 2).prepare_csr(backward=True)
    got = _op(tri, w, graph, _t(rel), _t(x), "mul").numpy()
    rounded = 2 * (1 + 2.0 ** -6)
    np.testing.assert_allclose(got[0], rounded, rtol=0, atol=1e-6)
    np.testing.assert_allclose(want[0], rounded, rtol=0, atol=1e-6)
    assert abs(rounded - 2 * a * a) > 6e-5
    # add_rel: a + a = 2 + 2^-6 is a bf16 value, so the sum is exact
    csr = graph.csr
    add = rspmm_cuda.rspmm_fwd_bf16_plain(csr.rowptr, csr.src, csr.etype,
                                          csr.eid, _t(w), _t(rel), _t(x),
                                          "add_rel")
    np.testing.assert_allclose(add[0].numpy(), 2 * (2 * a), rtol=0,
                               atol=1e-6)


def test_bf16_plain_halves_and_dtype_checks(rng):
    tri, w, _, graph = _op_graph(rng)
    R, V = graph.num_relations, graph.num_nodes
    rel = _t(rng.normal(size=(R, 8)).astype(np.float32))
    x = _t(rng.normal(size=(V, 8)).astype(np.float32))
    g = _t(rng.normal(size=(V, 8)).astype(np.float32))
    args = (graph.csr, graph.edge_weight, rel, x, g)
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_bf16_plain(*args)
    none, dr2 = rspmm_bwd_cuda.rspmm_bwd_bf16_plain(*args, need_dx=False)
    dx2, none2 = rspmm_bwd_cuda.rspmm_bwd_bf16_plain(*args, need_dr=False)
    assert none is None and none2 is None
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
    assert dx.dtype == dr.dtype == torch.float32
    # the wrappers take the plain versions for CPU tensors only because they
    # lie on the CPU; bf16 inputs give the same (their cast is a no-op)
    same = rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(
        graph.csr, graph.edge_weight, rel.bfloat16(), x.bfloat16(),
        g.bfloat16())
    assert torch.equal(same[0], dx) and torch.equal(same[1], dr)
    with pytest.raises(ValueError, match="compute_dtype"):
        generalized_rspmm(graph.edge_index, graph.edge_type,
                          graph.edge_weight, rel, x, num_nodes=V,
                          csr=graph.csr, compute_dtype="float16")
    with pytest.raises(ValueError, match="CSR"):
        generalized_rspmm(graph.edge_index, graph.edge_type,
                          graph.edge_weight, rel, x, num_nodes=V,
                          compute_dtype=BF16)


# ---------------------------------------------------------------------------
# the conv's routes under bf16
# ---------------------------------------------------------------------------

CONV_D, CONV_B, CONV_R = 4, 2, 3


@pytest.mark.parametrize("message,aggregate", [
    ("distmult", "sum"), ("distmult", "pna"), ("distmult", "max"),
    ("transe", "sum"), ("rotate", "sum")])
def test_conv_matches_jax_pallas(rng, message, aggregate):
    """One layer's output against the JAX conv: sum takes K1h; pna leaves
    the fused moments for two K1h sums (rel, x and rel², x²) and keeps the
    fp32 max/min pair; transe sums take K1h in mode add_rel; max and rotate
    stay fp32. For pna also the gradients with respect to x, the query and
    every weight (K2h on both sums, and on the squares' chain rule); the
    sum's and transe's backward are held in the op and ULTRA tests."""
    jcfg = JConvConfig(input_dim=CONV_D, output_dim=CONV_D,
                       num_relations=2 * CONV_R, query_input_dim=CONV_D,
                       message_func=message, aggregate_func=aggregate,
                       layer_norm=True, rel_mode="dependent", project=False,
                       rspmm_impl="pallas", compute_dtype=BF16)
    params = j_conv_init(jax.random.PRNGKey(1), jcfg)
    layer = GeneralizedRelationalConv(ConvConfig(
        input_dim=CONV_D, output_dim=CONV_D, num_relations=2 * CONV_R,
        query_input_dim=CONV_D, message_func=message,
        aggregate_func=aggregate, layer_norm=True, rel_mode="dependent",
        project=False, compute_dtype=BF16))
    state = jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, params)]})
    layer.load_state_dict({k.partition(".0.")[2]: v for k, v in state.items()})
    V, E = 20, 60
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - 2, E),
                    rng.integers(0, CONV_R, E)], 1).astype(np.int32)
    w = (rng.uniform(size=E) > 0.25).astype(np.float32)
    x = np.maximum(rng.normal(size=(V, CONV_B * CONV_D)), 0).astype(np.float32)
    bnd = np.zeros_like(x)
    bnd[rng.integers(0, V, CONV_B), np.arange(CONV_B) * CONV_D] = 1.0
    query = rng.normal(size=(CONV_B, CONV_D)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jg = JGraph.from_triplets(tri, V, CONV_R, edge_weight=w)
    jg = jg.undirected_with_inverse().prepare_pallas(
        interleave=8, bwd_block_rows=256,
        include_rel_layout=message == "transe")
    tg = TGraph.from_triplets(tri, V, CONV_R, edge_weight=w)
    tg = tg.undirected_with_inverse().prepare_csr(backward=True)

    def f(params, x, query):
        return j_conv(params, jcfg, jg, x, jnp.asarray(bnd), query=query)

    if aggregate != "pna":
        want = _jax_exact(f, params, x, query)
        with torch.no_grad():
            out = conv_apply(layer, tg, _t(x), _t(bnd), query=_t(query))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **OP_TOL)
        return

    def j_fn(params, x, query):
        out, vjp = jax.vjp(f, params, x, query)
        return out, vjp(jnp.asarray(cot))

    want, (want_p, want_x, want_q) = _jax_exact(j_fn, params, x, query)
    tx, tq = _t(x).requires_grad_(), _t(query).requires_grad_()
    out = conv_apply(layer, tg, tx, _t(bnd), query=tq)
    grads = torch.autograd.grad((out * _t(cot)).sum(),
                                [tx, tq] + list(layer.parameters()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **OP_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x),
                               **CONV_GRAD_TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(want_q),
                               **CONV_GRAD_TOL)
    want_p = {k.partition(".0.")[2]: v for k, v in jax_params_to_state_dict(
        {"layers": [jax.tree_util.tree_map(np.asarray, want_p)]}).items()}
    names = [n for n, _ in layer.named_parameters()]
    assert set(names) == set(want_p)
    for name, got in zip(names, grads[2:]):
        np.testing.assert_allclose(got.numpy(), want_p[name].numpy(),
                                   err_msg=name, **CONV_GRAD_TOL)


# ---------------------------------------------------------------------------
# 2-layer ULTRA in bf16
# ---------------------------------------------------------------------------

DIM, NUM_REL, NUM_ENT = 8, 3, 20


@pytest.fixture(scope="module")
def ultra_bf16():
    jds = j_synth("tiny", NUM_ENT, 80, NUM_REL, seed=1)
    tds = t_synth("tiny", NUM_ENT, 80, NUM_REL, seed=1)
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * 2,
                         num_relations=2 * NUM_REL, rspmm_impl="pallas",
                         compute_dtype=BF16),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2,
                           rspmm_impl="pallas", compute_dtype=BF16))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * 2,
                         num_relations=2 * NUM_REL, compute_dtype=BF16),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2,
                           compute_dtype=BF16))
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    jfact, train = jds.fact_graph(None)
    return dict(jds=jds, tds=tds, jcfg=jcfg, tcfg=tcfg, params=params,
                model=model, jfact=jfact, train=train,
                jund=jfact.undirected_with_inverse().prepare_pallas(),
                # both relation towers take the dense fp32 route, as on FB
                jrel=j_relgraph(jfact).prepare_dense())


def test_ultra_bf16_scores_match_jax(ultra_bf16):
    s = ultra_bf16
    batch = s["train"][:4]
    jt, jh = _jax_exact(
        lambda p, h, t, r: j_eval(p, s["jcfg"], s["jfact"], s["jrel"], h, t,
                                  r, fact_graph_und=s["jund"]),
        s["params"], *(jnp.asarray(batch[:, i]) for i in range(3)))
    tfact = s["tds"].fact_graph(None)[0]
    trel = t_relgraph(tfact).prepare_dense()
    b = _t(batch, np.int64)
    with torch.inference_mode():
        tt, th = ultra_eval_scores(s["model"], tfact, trel, b[:, 0], b[:, 1],
                                   b[:, 2])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOWER_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOWER_TOL)


def test_ultra_bf16_loss_step_matches_jax(ultra_bf16):
    """One loss step with injected negatives: the loss and every
    parameter's gradient (the entity tower's through K2h's plain version)
    against jax.value_and_grad through interpret-mode Pallas."""
    s = ultra_bf16
    rng = np.random.default_rng(7)
    batch = s["train"][rng.choice(len(s["train"]), 4, replace=False)]
    neg = rng.integers(0, NUM_ENT, (4, 5)).astype(np.int32)
    jtask_cfg = JTaskConfig(num_negative=5)

    def j_loss(params):
        scores = j_train(params, s["jcfg"], s["jfact"], s["jrel"],
                         *(jnp.asarray(batch[:, i]) for i in range(3)),
                         jnp.asarray(neg), fact_graph_und=s["jund"])
        return j_criterion(jtask_cfg, scores)

    want_loss, want_grads = _jax_exact(jax.value_and_grad(j_loss),
                                       s["params"])
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads))
    model = s["model"]
    model.zero_grad(set_to_none=True)
    task = TTask(s["tds"], s["tcfg"], TaskConfig(num_negative=5),
                 device="cpu")
    loss, _ = task.loss_step(model, None, batch, neg=_t(neg, np.int64))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOWER_TOL)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOWER_TOL)
    model.zero_grad(set_to_none=True)

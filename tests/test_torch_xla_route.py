"""``rspmm_impl: xla``, the JAX package's segment-op route, against the JAX
package's ``impl="xla"`` on the CPU, on a graph where a third of the edges
are repeated, so that their messages tie in every max and min: every
message (distmult, transe, rotate) with sum, mean, max and pna through
classic NBFNet (scores and every gradient), max and min of each message at
the op (tied edges share the gradient, as XLA's do), and ULTRA (eval
scores, train scores and every gradient; its dense relation graph keeps
its matmuls, as JAX's dense branch does on every route). Every kernel
wrapper, and each wrapper's plain version, raises while the route runs,
which shows that none is called; ``compute_dtype`` has no effect on it.

Tolerances: scores 1e-5 and gradients 1e-4 norm-wise (‖a - b‖ / ‖b‖) as
tests/test_torch_memory.py's; PNA scores 1e-4 (its std amplifies rounding
near the clip, tests/test_torch_classic.py); the op 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultra_torchdrug_tpu_torch.models.layers as layers_mod
import ultra_torchdrug_tpu_torch.ops.rspmm as rspmm_mod
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.classic_nbfnet import (
    classic_nbfnet_config as j_classic_cfg,
    classic_nbfnet_init as j_classic_init,
    classic_score_all as j_score_all,
)
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_eval
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph
from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
    ClassicNBFNet,
    classic_nbfnet_config,
    classic_score_all,
)
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import (
    ultra_eval_scores,
    ultra_train_scores,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import aggregate_edges
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

V, E, R, DIM, LAYERS = 20, 90, 4, 8, 2
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
PNA_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 1e-4
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# every kernel wrapper of ops/rspmm.py, and the ring's
KERNEL_WRAPPERS = ("rspmm_plain_edges", "rspmm_fwd_cuda",
                   "rspmm_fwd_bf16_cuda", "rspmm_bwd_cuda",
                   "rspmm_bwd_bf16_cuda", "rotate_fwd_cuda",
                   "rotate_bwd_cuda", "pna_fwd_cuda", "pna_bwd_cuda")


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _norm_err(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-12)).item()


@pytest.fixture
def no_kernels(monkeypatch):
    def raiser(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} called on the xla route")
        return call

    for name in KERNEL_WRAPPERS:
        monkeypatch.setattr(rspmm_mod, name, raiser(name))
    monkeypatch.setattr(layers_mod, "ring_rspmm", raiser("ring_rspmm"))


@pytest.fixture(scope="module")
def kg():
    """A KG whose every third edge is repeated (the same head, tail and
    relation): repeated edges send equal messages, which tie."""
    rng = np.random.default_rng(7)
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    tri = np.concatenate([tri, tri[::3]])
    pos = tri[rng.choice(len(tri), 4, replace=False)]
    return dict(tri=tri, jg=JGraph.from_triplets(tri, V, R),
                tg=TGraph.from_triplets(tri, V, R), pos=pos,
                neg=rng.integers(0, V, (4, 5)).astype(np.int32),
                cot=rng.normal(size=(4, 6)).astype(np.float32))


def _check_grads(names, grads, want_grads):
    assert set(names) == set(want_grads)
    for name, g in zip(names, grads):
        assert _norm_err(g, want_grads[name]) <= GRAD_RTOL, name


@pytest.mark.parametrize("agg", ["sum", "mean", "max", "pna"])
@pytest.mark.parametrize("msg", ["distmult", "transe", "rotate"])
def test_classic_matches_jax_xla(kg, no_kernels, msg, agg):
    kw = dict(input_dim=DIM, hidden_dims=(DIM,) * LAYERS, num_relations=R,
              message_func=msg, aggregate_func=agg, layer_norm=True,
              rspmm_impl="xla")
    jcfg = j_classic_cfg(**kw)
    params = j_classic_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(ClassicNBFNet(classic_nbfnet_config(**kw)),
                            jax.tree_util.tree_map(np.asarray, params))
    assert model.cfg.rspmm_impl == "xla"
    jund = kg["jg"].undirected_with_inverse()
    tund = kg["tg"].undirected_with_inverse()  # no CSR: the route needs none
    src, rel = kg["pos"][:, 0], kg["pos"][:, 2]
    cot = np.random.default_rng(1).normal(size=(4, V)).astype(np.float32)

    def j_loss(p):
        s = j_score_all(p, jcfg, jund, jnp.asarray(src), jnp.asarray(rel))
        return (s * cot).sum(), s

    (_, want), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        params)
    scores = classic_score_all(model, tund, _t(src, np.int64),
                               _t(rel, np.int64))
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want),
                               **(PNA_TOL if agg == "pna" else SCORE_TOL))
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad((scores * _t(cot)).sum(), ps)
    _check_grads(names, grads, jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, j_grads)))


@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("msg", ["mul", "add", "rotate"])
def test_extremum_op_shares_tied_gradients_as_xla(kg, no_kernels, msg, agg):
    """The op on the tied graph, relation [R, D] over [V, B, D] states:
    values and gradients to the relation and the states against XLA's
    segment ops, which split a row's gradient among its tied edges."""
    rng = np.random.default_rng(2)
    tri = kg["tri"]
    w = np.ones(len(tri), np.float32)
    rel = rng.normal(size=(R, DIM)).astype(np.float32)
    x = rng.normal(size=(V, 3, DIM)).astype(np.float32)
    cot = rng.normal(size=(V, 3, DIM)).astype(np.float32)

    def j_f(rel, x):
        out = j_rspmm(jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2]),
                      jnp.asarray(w), rel, x, msg=msg, agg=agg, num_nodes=V,
                      impl="xla")
        return (out * cot).sum(), out

    (_, want), (want_dr, want_dx) = jax.value_and_grad(
        j_f, argnums=(0, 1), has_aux=True)(jnp.asarray(rel), jnp.asarray(x))
    tr, tx = _t(rel).requires_grad_(), _t(x).requires_grad_()
    out = aggregate_edges(_t(tri[:, :2], np.int64), _t(tri[:, 2], np.int64),
                          _t(w), tr, tx, msg=msg, agg=agg, num_nodes=V)
    dr, dx = torch.autograd.grad((out * _t(cot)).sum(), (tr, tx))
    for a, b in ((out.detach(), want), (dr, want_dr), (dx, want_dx)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OP_TOL)


def _ultra_configs(compute_dtype="float32"):
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * LAYERS,
                         num_relations=2 * R, rspmm_impl="xla"),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2,
                           rspmm_impl="xla"))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * LAYERS,
                         num_relations=2 * R, rspmm_impl="xla",
                         compute_dtype=compute_dtype),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2,
                           rspmm_impl="xla", compute_dtype=compute_dtype))
    return jcfg, tcfg


def test_ultra_matches_jax_xla(kg, no_kernels):
    jcfg, tcfg = _ultra_configs()
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    trg = build_relation_graph(kg["tg"]).prepare_dense()
    assert trg.dense_adj is not None
    jrg = j_relgraph(kg["jg"])
    pos, neg, cot = kg["pos"], kg["neg"], kg["cot"]
    jq = [jnp.asarray(pos[:, i]) for i in range(3)]
    tq = [_t(pos[:, i], np.int64) for i in range(3)]
    want = j_eval(params, jcfg, kg["jg"], jrg, *jq)
    with torch.inference_mode():
        got = ultra_eval_scores(model, kg["tg"], trg, *tq,
                                fact_graph_und=kg["tg"]
                                .undirected_with_inverse())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCORE_TOL)

    def j_loss(p):
        s = j_train(p, jcfg, kg["jg"], jrg, *jq, jnp.asarray(neg))
        return (s * cot).sum(), s

    (_, want_s), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(params)
    und = kg["tg"].undirected_with_inverse()
    scores = ultra_train_scores(model, kg["tg"], trg, *tq, _t(neg, np.int64),
                                fact_graph_und=und)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_s),
                               **SCORE_TOL)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad((scores * _t(cot)).sum(), ps)
    _check_grads(names, grads, jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, j_grads)))

    # compute_dtype has no effect on the route: bitwise the fp32 scores
    _, bf16 = _ultra_configs("bfloat16")
    bf16_model = Ultra(bf16)
    bf16_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        again = ultra_eval_scores(bf16_model, kg["tg"], trg, *tq,
                                  fact_graph_und=und)
    for a, b in zip(again, got):
        assert torch.equal(a, b)

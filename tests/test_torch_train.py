"""The PyTorch port's training slice against the JAX package on the CPU: the
rspmm backward, the easy-edge joins, strict negatives, the train scores, the
loss and every parameter's gradient of one loss step, the optimizer, and the
engine's batch order. Inputs are made by numpy from a seed; weights cross
with ``load_jax_params`` and gradients with ``jax_params_to_state_dict``.

Tolerances, each with its reason:
  * rspmm backward: rtol 1e-5, atol 1e-4 — fp32 sums over up to a few
    hundred edges of products of N(0, 1) values, taken in other orders (the
    port's CSR / chunk order, segment_sum, the Pallas tiles);
  * train scores, loss, gradients: rtol = atol = 1e-4, as for whole towers
    in test_torch_ultra.py (two stacked layers of norms, matmuls and sums);
  * optimizer: rtol = atol = 1e-6 — the same update in fp32, rounded in
    other orders;
  * joins and negatives: exact (integer work).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.engine.engine import Engine as JEngine
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train_scores
from ultra_torchdrug_tpu.ops.match import (
    build_pattern_join as j_build_join,
    edges_in_patterns as j_edges_in_patterns,
)
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.ops.sampling import strict_negatives as j_strict
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import TransductiveKGTask as JTask
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.graph import DR_CHUNK_EDGES
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.engine.engine import Engine, Optimizer
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import ultra_train_scores
from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda
from ultra_torchdrug_tpu_torch.ops.match import (
    build_pattern_join,
    edges_in_patterns,
    edges_in_patterns_indexed,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import _RspmmK1K2, generalized_rspmm
from ultra_torchdrug_tpu_torch.ops.sampling import strict_negatives
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig as TTaskConfig
from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask as TTask
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)
from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

BWD_TOL = dict(rtol=1e-5, atol=1e-4)
TOWER_TOL = dict(rtol=1e-4, atol=1e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a, dtype=None):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


# ---------------------------------------------------------------------------
# the rspmm backward
# ---------------------------------------------------------------------------

# (V, E, R, B, D): ragged widths; the second graph puts ~350 edges on each of
# two relations (two chunks each) and leaves relation 2 without edges
BWD_SHAPES = [(37, 300, 6, 2, 5), (40, 700, 3, 3, 4)]


def _bwd_inputs(rng, V, E, R, B, D):
    used = R - 1 if E > 2 * DR_CHUNK_EDGES else R
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - 5, E),
                    rng.integers(0, used, E)], 1).astype(np.int32)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0  # masked edges
    return dict(tri=tri, w=w, V=V, R=R, B=B, D=D,
                rel=rng.normal(size=(R, D)).astype(np.float32),
                rel_b=rng.normal(size=(R, B, D)).astype(np.float32),
                x=rng.normal(size=(V, B, D)).astype(np.float32),
                g=rng.normal(size=(V, B, D)).astype(np.float32))


def _rel_x(inp, rel_form):
    """(relation, x) in one of the three forms the op takes."""
    R, B, D = inp["R"], inp["B"], inp["D"]
    if rel_form == "shared":
        return inp["rel"], inp["x"]
    if rel_form == "per_batch":
        return inp["rel_b"], inp["x"]
    return (inp["rel_b"].reshape(R, B * D),
            inp["x"].reshape(inp["V"], B * D))


def _jax_grads(inp, rel, x, impl="xla", layouts=None):
    """jax.grad of <g, rspmm(rel, x)> with respect to (rel, x)."""
    ei, et = inp["tri"][:, :2], inp["tri"][:, 2]
    g = jnp.asarray(inp["g"].reshape(x.shape))

    def f(rel, x):
        out = j_rspmm(jnp.asarray(ei), jnp.asarray(et), jnp.asarray(inp["w"]),
                      rel, x, msg="mul", agg="add", num_nodes=inp["V"],
                      impl=impl, layouts=layouts)
        return jnp.sum(out * g)

    d_rel, d_x = jax.grad(f, argnums=(0, 1))(jnp.asarray(rel), jnp.asarray(x))
    return np.asarray(d_rel), np.asarray(d_x)


def _port_grads(inp, rel, x, via_csr):
    """Autograd through the port's op: the CPU path (plain index_add_), or
    the card path's autograd node (K1/K2 wrappers, plain on CPU tensors)."""
    g = TGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                             edge_weight=inp["w"]).prepare_csr(backward=True)
    rel_t, x_t = _t(rel).requires_grad_(), _t(x).requires_grad_()
    if via_csr:
        from ultra_torchdrug_tpu_torch.ops.rspmm import broadcast_rel_flat

        flat = x_t.dim() == 2
        rf = rel_t if flat else broadcast_rel_flat(rel_t, x_t.shape[1])
        xf = x_t if flat else x_t.reshape(x_t.shape[0], -1)
        out = _RspmmK1K2.apply(g.csr, g.edge_weight, rf.contiguous(), xf,
                               "mul_rel").reshape(x_t.shape)
    else:
        out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight,
                                rel_t, x_t, msg="mul", num_nodes=inp["V"])
    d_rel, d_x = torch.autograd.grad(out, (rel_t, x_t),
                                     _t(inp["g"].reshape(x.shape)))
    return d_rel.numpy(), d_x.numpy()


@pytest.mark.parametrize("via_csr", [False, True])
@pytest.mark.parametrize("rel_form", ["flat", "per_batch", "shared"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_matches_jax_xla(rng, shape, rel_form, via_csr):
    inp = _bwd_inputs(rng, *shape)
    rel, x = _rel_x(inp, rel_form)
    want = _jax_grads(inp, rel, x)
    got = _port_grads(inp, rel, x, via_csr)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **BWD_TOL)
    assert np.abs(got[1][inp["V"] - 5:]).max() > 0  # sources keep gradients


@pytest.mark.parametrize("rel_form", ["per_batch", "shared"])
def test_backward_matches_jax_pallas_interpret(rng, rel_form):
    inp = _bwd_inputs(rng, *BWD_SHAPES[0])
    rel, x = _rel_x(inp, rel_form)
    jg = JGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                              edge_weight=inp["w"]).prepare_pallas()
    want = _jax_grads(inp, rel, x, impl="pallas", layouts=jg.layouts)
    got = _port_grads(inp, rel, x, via_csr=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BWD_TOL)


def test_bwd_plain_halves_and_empty_relation(rng):
    """rspmm_bwd_cuda on CPU tensors is the plain version: no launch, each
    half on its own, and a relation without edges gets a zero gradient."""
    inp = _bwd_inputs(rng, *BWD_SHAPES[1])
    rel, x = _rel_x(inp, "flat")
    g = TGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                             edge_weight=inp["w"]).prepare_csr(backward=True)
    args = (g.csr, g.edge_weight, _t(rel), _t(x), _t(inp["g"].reshape(x.shape)))
    before = dict(rspmm_bwd_cuda.launches)
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    assert rspmm_bwd_cuda.launches == before
    assert rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dx=False)[0] is None
    assert rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dr=False)[1] is None
    assert torch.all(dr[inp["R"] - 1] == 0)
    want_dr, want_dx = _jax_grads(inp, rel, x)
    np.testing.assert_allclose(dx.numpy(), want_dx, **BWD_TOL)
    np.testing.assert_allclose(dr.numpy(), want_dr, **BWD_TOL)


def test_bwd_needs_the_backward_layouts(rng):
    """A forward-only CSR (eval graphs) makes the backward raise, on the CPU
    path as on the card's."""
    inp = _bwd_inputs(rng, *BWD_SHAPES[0])
    rel, x = _rel_x(inp, "flat")
    g = TGraph.from_triplets(inp["tri"], inp["V"], inp["R"],
                             edge_weight=inp["w"]).prepare_csr()
    with pytest.raises(ValueError, match="backward=True"):
        rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight, _t(rel), _t(x),
                                      _t(inp["g"].reshape(x.shape)))


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_prepare_csr_backward_layouts(rng, shape):
    inp = _bwd_inputs(rng, *shape)
    V, R = inp["V"], inp["R"]
    assert not TGraph.from_triplets(inp["tri"], V, R).prepare_csr(
    ).csr.has_backward  # forward-only graphs skip the backward's sorts
    g = TGraph.from_triplets(inp["tri"], V, R).prepare_csr(backward=True)
    c = {k: v.numpy() for k, v in dataclasses.asdict(g.csr).items()}
    ei, et = inp["tri"][:, :2], inp["tri"][:, 2]
    # source-sorted CSR: every edge once, stable within a row
    np.testing.assert_array_equal(np.sort(c["src_eid"]), np.arange(len(et)))
    rows = np.repeat(np.arange(V), np.diff(c["src_rowptr"]))
    np.testing.assert_array_equal(rows, ei[c["src_eid"], 0])
    np.testing.assert_array_equal(c["src_dst"], ei[c["src_eid"], 1])
    np.testing.assert_array_equal(c["src_etype"], et[c["src_eid"]])
    for v in range(V):
        assert np.all(np.diff(c["src_eid"][c["src_rowptr"][v]:
                                         c["src_rowptr"][v + 1]]) > 0)
    # relation chunks: a partition of the relation-sorted edges into runs of
    # at most DR_CHUNK_EDGES edges of one relation, in relation order
    np.testing.assert_array_equal(c["rel_eid"], np.argsort(et, kind="stable"))
    np.testing.assert_array_equal(c["rel_src"], ei[c["rel_eid"], 0])
    np.testing.assert_array_equal(c["rel_dst"], ei[c["rel_eid"], 1])
    sizes = np.diff(c["chunk_ptr"])
    assert c["chunk_ptr"][0] == 0 and c["chunk_ptr"][-1] == len(et)
    assert np.all((sizes > 0) & (sizes <= DR_CHUNK_EDGES))
    edge_chunk = np.repeat(np.arange(len(sizes)), sizes)
    np.testing.assert_array_equal(c["chunk_rel"][edge_chunk],
                                  et[c["rel_eid"]])
    owner = np.repeat(np.arange(R), np.diff(c["rel_chunk_ptr"]))
    np.testing.assert_array_equal(owner, c["chunk_rel"])
    if shape == BWD_SHAPES[1]:
        assert np.diff(c["rel_chunk_ptr"]).tolist() == [2, 2, 0]


# ---------------------------------------------------------------------------
# easy-edge joins and strict negatives
# ---------------------------------------------------------------------------


def _join_inputs(rng):
    V, E, R = 20, 150, 4
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    tri[100:120] = tri[:20]  # duplicate edges
    pats = np.concatenate([tri[rng.choice(E, 30)],
                           np.stack([rng.integers(0, V, 30),
                                     rng.integers(0, V, 30),
                                     rng.integers(0, R, 30)], 1)]
                          ).astype(np.int32)
    return tri, pats


@pytest.mark.parametrize("wildcard_rel", [False, True])
def test_edge_joins_match_jax(rng, wildcard_rel):
    tri, pats = _join_inputs(rng)
    if wildcard_rel:
        tri, pats = tri.copy(), pats.copy()
        pats[:, 2] = 0
    edges = tri.copy()
    if wildcard_rel:
        edges[:, 2] = 0
    want = np.asarray(j_edges_in_patterns(jnp.asarray(edges),
                                          jnp.asarray(pats)))
    assert want[:20].any() and not want.all()
    got = edges_in_patterns(_t(edges, np.int64), _t(pats, np.int64)).numpy()
    np.testing.assert_array_equal(got, want)
    index = build_pattern_join(tri[:, :2], tri[:, 2],
                               wildcard_rel=wildcard_rel)
    got = edges_in_patterns_indexed(index, _t(pats, np.int64)).numpy()
    np.testing.assert_array_equal(got, want)
    # duplicates match together
    np.testing.assert_array_equal(got[100:120], got[:20])
    j_index = j_build_join(tri[:, :2], tri[:, 2], wildcard_rel=wildcard_rel)
    assert index.r_mult == j_index.r_mult


def test_strict_negatives_match_jax_with_injected_draws():
    ds = t_synth("SynthKG", 40, 300, 5, seed=0)
    fact = ds.fact_graph(None)[0]
    batch = ds.train[:8]
    N, B = 16, 8
    key = jax.random.PRNGKey(3)
    edges = fact.edge_list
    want = np.asarray(j_strict(key, jnp.asarray(edges.numpy()),
                               *(jnp.asarray(batch[:, i]) for i in range(3)),
                               40, N))
    key_t, key_h = jax.random.split(key)
    u_t = np.asarray(jax.random.uniform(key_t, (B // 2, N)))
    u_h = np.asarray(jax.random.uniform(key_h, (B - B // 2, N)))
    b = _t(batch, np.int64)
    got = strict_negatives(None, edges, b[:, 0], b[:, 1], b[:, 2], 40, N,
                           u=(_t(u_t), _t(u_h)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_strict_negatives_never_complete_a_true_triple():
    ds = t_synth("SynthKG", 40, 300, 5, seed=0)
    fact = ds.fact_graph(None)[0]
    batch = _t(ds.train[:16], np.int64)
    gen = torch.Generator().manual_seed(0)
    neg = strict_negatives(gen, fact.edge_list, batch[:, 0], batch[:, 1],
                           batch[:, 2], 40, 64)
    true = {tuple(e) for e in fact.edge_list.tolist()}
    h, t, r = batch.T.tolist()
    for b in range(16):
        for n in neg[b].tolist():
            triple = (h[b], n, r[b]) if b < 8 else (n, t[b], r[b])
            assert triple not in true
    assert len(set(neg[:8].flatten().tolist())) > 10  # spread, not clamped


# ---------------------------------------------------------------------------
# train scores, loss and gradients
# ---------------------------------------------------------------------------

NUM_REL, DIM = 5, 8


def _configs():
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM, DIM),
                         num_relations=2 * NUM_REL),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM, DIM),
                         num_relations=2 * NUM_REL),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def train_setup():
    # the data of config/synthetic/smoke.yaml: SynthKG 40/300/5, 2x8 layers
    jds = j_synth("SynthKG", 40, 300, NUM_REL, seed=0)
    tds = t_synth("SynthKG", 40, 300, NUM_REL, seed=0)
    jcfg, tcfg = _configs()
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    jfact, train = jds.fact_graph(None)
    rng = np.random.default_rng(7)
    batch = train[rng.choice(len(train), 6, replace=False)]
    neg = rng.integers(0, 40, (6, 9)).astype(np.int32)
    return dict(jds=jds, tds=tds, jcfg=jcfg, tcfg=tcfg, params=params,
                model=model, jfact=jfact, jrel=j_relgraph(jfact).prepare_dense(),
                batch=batch, neg=neg)


@pytest.mark.parametrize("join", ["indexed", "sort"])
def test_ultra_train_scores_match_jax(train_setup, join):
    s = train_setup
    batch, neg = s["batch"], s["neg"]
    want = j_train_scores(s["params"], s["jcfg"], s["jfact"], s["jrel"],
                          *(jnp.asarray(batch[:, i]) for i in range(3)),
                          jnp.asarray(neg), remove_easy=True)
    tfact = s["tds"].fact_graph(None)[0]
    if join == "indexed":
        tfact = tfact.prepare_join()
    trel = s["tds"].fact_graph(None)[0]
    from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph

    trel = build_relation_graph(trel).prepare_dense()
    b = _t(batch, np.int64)
    with torch.no_grad():
        got = ultra_train_scores(s["model"], tfact, trel, b[:, 0], b[:, 1],
                                 b[:, 2], _t(neg, np.int64), remove_easy=True)
    assert got.shape == (6, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)


@pytest.mark.parametrize("remove_one_hop", [False, True])
def test_mask_easy_edges_matches_jax(train_setup, remove_one_hop):
    from ultra_torchdrug_tpu.models.ultra import _mask_easy_edges as j_mask
    from ultra_torchdrug_tpu_torch.models.ultra import _mask_easy_edges

    s = train_setup
    jcfg = dataclasses.replace(s["jcfg"], remove_one_hop=remove_one_hop)
    tcfg = dataclasses.replace(s["tcfg"], remove_one_hop=remove_one_hop)
    idx = np.stack([s["batch"][:, 0], s["batch"][:, 1], s["batch"][:, 2]])
    want = j_mask(jcfg, s["jfact"], *(jnp.asarray(a[:, None]) for a in idx))
    tfact = s["tds"].fact_graph(None)[0]
    for graph in (tfact, tfact.prepare_join(one_hop=remove_one_hop)):
        got = _mask_easy_edges(tcfg, graph, *(_t(a[:, None], np.int64)
                                              for a in idx))
        np.testing.assert_array_equal(got.edge_weight.numpy(),
                                      np.asarray(want.edge_weight))
    assert (np.asarray(want.edge_weight) == 0).sum() >= 6


@pytest.mark.parametrize("criterion,sample_weight", [
    ("bce", False), ("bce", True), ("ce", False), ("ranking", False)])
def test_loss_and_gradients_match_jax(train_setup, criterion, sample_weight):
    s = train_setup
    batch, neg = s["batch"], s["neg"]
    jtask_cfg = JTaskConfig(criterion=criterion, sample_weight=sample_weight)
    sw = None
    if sample_weight:
        jtask = JTask(s["jds"], s["jcfg"], jtask_cfg)
        sw = jtask.sample_weight_for(batch)

    def j_loss(params):
        scores = j_train_scores(params, s["jcfg"], s["jfact"], s["jrel"],
                                *(jnp.asarray(batch[:, i]) for i in range(3)),
                                jnp.asarray(neg))
        return j_criterion(jtask_cfg, scores, sw)

    want_loss, want_grads = jax.value_and_grad(j_loss)(s["params"])
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads))

    ttask = TTask(s["tds"], s["tcfg"], TTaskConfig(
        criterion=criterion, sample_weight=sample_weight), device="cpu")
    model = s["model"]
    model.zero_grad(set_to_none=True)
    loss, metrics = ttask.loss_step(model, None, batch,
                                    neg=_t(neg, np.int64))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOWER_TOL)
    assert metrics["loss"].item() == loss.item()
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOWER_TOL)
    model.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# optimizer and engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,clip_grad,interval", [
    ("adamw", None, 1), ("adamw", 0.5, 1), ("adamw", None, 2),
    ("adamw", 0.5, 2), ("adam", None, 1), ("sgd", None, 1)])
def test_optimizer_matches_optax(rng, name, clip_grad, interval):
    shapes = [(4, 3), (3,), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = 3 * interval
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    inner = {"adamw": lambda: optax.adamw(1e-2, weight_decay=0.01),
             "adam": lambda: optax.adam(1e-2),
             "sgd": lambda: optax.sgd(1e-2)}[name]()
    tx = inner
    if clip_grad:
        tx = optax.chain(optax.clip_by_global_norm(clip_grad), tx)
    if interval > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=interval)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = Optimizer(tp, name, lr=1e-2, gradient_interval=interval,
                    clip_grad=clip_grad)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([_t(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **OPT_TOL)
    assert not np.allclose(tp[0].detach().numpy(), params[0])


def test_engine_trains_in_the_jax_engines_batch_order(tmp_path):
    jcfg, tcfg = _configs()
    jds = j_synth("SynthKG", 40, 300, NUM_REL, seed=0)
    tds = t_synth("SynthKG", 40, 300, NUM_REL, seed=0)
    cfg = dict(num_negative=8)
    jeng = JEngine(JTask(jds, jcfg, JTaskConfig(**cfg)), batch_size=16,
                   seed=5, work_dir=str(tmp_path))
    want = [np.asarray(b) for _, _, b, _ in jeng._epoch_chunks(4)]
    want += [np.asarray(b) for _, _, b, _ in jeng._epoch_chunks(None)]
    eng = Engine(TTask(tds, tcfg, TTaskConfig(**cfg), device="cpu"),
                 batch_size=16, seed=5, log_interval=100,
                 logger=get_root_logger(None))
    got = list(eng._epoch_batches(4)) + list(eng._epoch_batches(None))
    assert len(got) == len(want) == 4 + len(tds.train) // 16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    eng.train(num_epoch=2, batch_per_epoch=3)
    assert eng.meter.global_step == 6 and eng.epoch == 2
    window = eng.meter.last_window
    assert len(window) == 3
    for step in window:
        assert set(step) == {"loss", "pos_score", "neg_score", "grad_norm"}
        assert all(np.isfinite(v) for v in step.values())
    after = eng.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    metrics = eng.evaluate("test", fast_test=8)
    assert all(np.isfinite(v) for v in metrics.values())

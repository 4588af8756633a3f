"""The port's memory policies against the JAX package's on the CPU:
recomputation (``remat`` none, full and save_rspmm), micro-batches and
score chunks change no loss, gradient or score; the auto policies
(``_resolve_model_cfg``, ``auto_micro_batch``, the eval batch) decide as the
JAX package's do when the port's constants are set to JAX's; and the
fail-soft demotion of the engine (the cases of tests/test_failsoft.py).

Tolerances: losses 1e-5 relative and gradients 1e-4 norm-wise (‖a - b‖ /
‖b‖) against JAX, the sums being taken in other orders; across the port's
own modes 1e-6 norm-wise, and bitwise where the mode only recomputes (the
replayed max/min gates the same edges); scores 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultra_torchdrug_tpu.tasks.task as j_task_mod
import ultra_torchdrug_tpu_torch.tasks.task as task_mod
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_eval
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.tasks.kg import bce_self_adversarial as j_bce
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph
from ultra_torchdrug_tpu_torch.engine.engine import Engine, _is_oom_error
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
from ultra_torchdrug_tpu_torch.parallel.mesh import make_mesh, use_mesh
from ultra_torchdrug_tpu_torch.tasks.kg import bce_self_adversarial
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig, TransductiveKGTask
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

DIM = 8
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SELF_RTOL = 1e-6
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX package's constants, which the port's are refitted from
JAX_CONSTANTS = dict(_FULL_SAVE_PEAK_FACTOR=6.2,
                     _SAVE_RSPMM_UNITS_PER_LAYER=2.0,
                     _SAVE_RSPMM_UNITS_BASE=4.0, _MB_BUDGET_FRACTION=0.25,
                     _EVAL_STATE_COPIES=6.0)
FAKE_OOM = RuntimeError(
    "RESOURCE_EXHAUSTED: Out of memory allocating 17179869184 bytes.")


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _norm_err(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-12)).item()


def _configs(aggregate_func="sum", layers=2, **entity):
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * layers,
                         num_relations=10, aggregate_func=aggregate_func),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * layers,
                         num_relations=10, aggregate_func=aggregate_func,
                         **entity),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    return jcfg, tcfg


def _with(cfg, **changes):
    """Both towers' policies set (JAX's test sets remat on both)."""
    rel = {k: v for k, v in changes.items() if k == "remat"}
    return dataclasses.replace(
        cfg, entity=dataclasses.replace(cfg.entity, **changes),
        relation=dataclasses.replace(cfg.relation, **rel))


@pytest.fixture(scope="module", params=["sum", "max"])
def kg(request):
    """A tiny KG (tests/test_ultra.py::tiny_kg's draws), 2x8 towers with the
    entity tower on ``sum`` or ``max``, the JAX weights in the port's model,
    8 queries with 6 negatives each. With ``max`` the gradients are held to
    the port's own run only: the first layer's zero states send zero
    messages that tie in most rows, and there JAX's XLA route (which splits
    a row's gradient among its ties) and its Pallas kernels (which give each
    tied edge all of it, as the port's do) part by up to 35 % norm-wise;
    the loss is held to JAX's, taken once without remat (JAX's own tests
    hold its modes' losses equal)."""
    rng = np.random.default_rng(1024)
    V, E, R = 20, 80, 5
    tri = np.unique(np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                              rng.integers(0, R, E)], 1), axis=0)
    tri = tri.astype(np.int32)
    jg = JGraph.from_triplets(tri, V, R)
    tg = TGraph.from_triplets(tri, V, R)
    jcfg, tcfg = _configs(request.param)
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    pos = tri[rng.choice(len(tri), 8, replace=False)]
    neg = rng.integers(0, V, (8, 6)).astype(np.int32)
    s = dict(jg=jg, jrg=j_relgraph(jg), tg=tg, trg=build_relation_graph(tg),
             jcfg=jcfg, tcfg=tcfg, params=params, model=model, pos=pos,
             neg=neg, grad_rtol=GRAD_RTOL if request.param == "sum" else None)
    if request.param == "max":
        s["jax_loss"] = _jax_step(s, jcfg)
    return s


def _jax_step(s, cfg):
    """JAX's loss and gradients under ``cfg``; with the max tower the
    fixture's one reading (see ``kg``)."""
    if "jax_loss" in s:
        return s["jax_loss"]

    def loss(p):
        return j_bce(j_train(p, cfg, s["jg"], s["jrg"],
                             *(jnp.asarray(s["pos"][:, i]) for i in range(3)),
                             jnp.asarray(s["neg"])))

    value, grads = jax.jit(jax.value_and_grad(loss))(s["params"])
    return float(value), jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads))


def _port_step(s, cfg):
    model = s["model"]
    pos = _t(s["pos"], np.int64)
    scores = ultra_train_scores(model, s["tg"], s["trg"], pos[:, 0],
                                pos[:, 1], pos[:, 2], _t(s["neg"], np.int64),
                                model_cfg=cfg)
    loss = bce_self_adversarial(scores)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.item(), dict(zip(names, grads))


def _check_against(got, want, rtol, label):
    """The loss within LOSS_RTOL, and unless ``rtol`` is None every
    gradient within ``rtol`` norm-wise."""
    (loss, grads), (want_loss, want_grads) = got, want
    assert abs(loss - want_loss) <= LOSS_RTOL * max(1.0, abs(want_loss)), \
        (label, loss, want_loss)
    assert set(grads) == set(want_grads)
    if rtol is None:
        return
    for name, g in grads.items():
        err = _norm_err(g, want_grads[name])
        assert err <= rtol, (label, name, err)


@pytest.mark.parametrize("remat", [False, True, "save_rspmm"])
def test_remat_modes_match_jax(kg, remat):
    """tests/test_ultra.py::test_remat_modes_identical_gradients: each
    remat mode's loss and gradients against the JAX package's under the
    same mode, and against the port's own run that keeps everything:
    bitwise, since a mode only recomputes (with the entity tower on max
    the replayed extremum gates the same edges)."""
    s = kg
    got = _port_step(s, _with(s["tcfg"], remat=remat))
    _check_against(got, _jax_step(s, _with(s["jcfg"], remat=remat)),
                   s["grad_rtol"], remat)
    base_loss, base_grads = _port_step(s, _with(s["tcfg"], remat=False))
    assert got[0] == base_loss
    for name, g in got[1].items():
        assert torch.equal(g, base_grads[name]), (remat, name)


@pytest.mark.parametrize("mb,remat", [(2, False), (4, True),
                                      (2, "save_rspmm")])
def test_micro_batch_matches_jax(kg, mb, remat):
    """tests/test_ultra.py::test_micro_batch_identical_scores_and_gradients:
    the entity tower in checkpointed chunks of ``mb`` queries (with the
    layers' own remat inside) against JAX's micro-batches and the port's
    whole batch."""
    s = kg
    got = _port_step(s, _with(s["tcfg"], micro_batch=mb, remat=remat))
    _check_against(got, _jax_step(s, _with(s["jcfg"], micro_batch=mb,
                                           remat=remat)), s["grad_rtol"], mb)
    _check_against(got, _port_step(s, s["tcfg"]), SELF_RTOL, mb)


def test_score_chunking_matches_unchunked():
    """tests/test_ultra.py::test_score_chunking_matches_unchunked: eval
    scores with score_chunk 8 over a V not divisible by it, against the
    port's unchunked and JAX's chunked scores."""
    rng = np.random.default_rng(5)
    V, E, R = 23, 80, 5
    tri = np.unique(np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                              rng.integers(0, R, E)], 1), axis=0)
    tri = tri.astype(np.int32)
    jg, tg = JGraph.from_triplets(tri, V, R), TGraph.from_triplets(tri, V, R)
    jcfg, tcfg = _configs()
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    q = rng.integers(0, [V, V, R], (4, 3))
    want = j_eval(params, _with(jcfg, score_chunk=8), jg, j_relgraph(jg),
                  *(jnp.asarray(q[:, i]) for i in range(3)))
    qt = _t(q, np.int64)
    with torch.inference_mode():
        args = (model, tg, build_relation_graph(tg), qt[:, 0], qt[:, 1],
                qt[:, 2])
        whole = ultra_eval_scores(*args)
        chunked = ultra_eval_scores(*args, model_cfg=_with(tcfg,
                                                           score_chunk=8))
    for a, b, w in zip(chunked, whole, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **SCORE_TOL)


def test_auto_micro_batch_sizing(monkeypatch):
    """tests/test_ultra.py::test_auto_micro_batch_sizing: the chunk halves
    until the layers' saved inputs fit the budget's share; a fitting batch
    and an explicit micro_batch are kept; with JAX's fraction the port
    chooses as JAX does."""
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(task_mod, name, value)
    jcfg, tcfg = _configs()
    budget = 16 << 30
    share = j_task_mod._MB_BUDGET_FRACTION * budget
    assert task_mod.auto_micro_batch(tcfg, 1000, 64,
                                     budget).entity.micro_batch == 0
    huge_v = int(share / (2 * 8 * 4 * 8)) + 1  # fits only at mb <= 8
    mb = task_mod.auto_micro_batch(tcfg, huge_v, 64, budget).entity.micro_batch
    assert 0 < mb <= 8 and 64 % mb == 0
    assert mb == j_task_mod.auto_micro_batch(
        jcfg, huge_v, 64, budget_bytes=budget).entity.micro_batch
    explicit = _with(tcfg, micro_batch=16)
    assert task_mod.auto_micro_batch(explicit, huge_v, 64,
                                     budget).entity.micro_batch == 16


def _bare_task(cls, model_cfg, device="cpu"):
    """A task object with only what the policy methods read."""
    t = object.__new__(cls)
    t.model_cfg, t.cfg, t.device = model_cfg, TaskConfig(), device
    return t


def test_remat_auto_policy_tiers(monkeypatch):
    """tests/test_task.py::test_remat_auto_policy_tiers with the JAX
    package's constants and its 16 GiB budget: FB15k-237's V keeps
    everything, WN18RR's takes save_rspmm, ATOMIC's full recomputation;
    stack resolves to scan (off the TPU); the relation tower (2R nodes)
    keeps everything."""
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(task_mod, name, value)
    monkeypatch.setattr(task_mod, "_device_bytes", lambda device: 16 << 30)
    cfg = TUltraConfig.default(237)
    t = _bare_task(TransductiveKGTask, dataclasses.replace(
        cfg,
        entity=dataclasses.replace(cfg.entity, remat="auto", stack="auto"),
        relation=dataclasses.replace(cfg.relation, remat="auto",
                                     stack="auto")))
    want = {14541: False, 40943: "save_rspmm", 304388: True}
    for v, remat in want.items():
        got = t._resolve_model_cfg(types.SimpleNamespace(num_nodes=v), 64)
        assert got.entity.remat == remat and got.entity.stack == "scan"
        assert got.relation.remat is False and got.relation.stack == "scan"


def test_port_policies_on_an_h100(monkeypatch):
    """The port's own constants on an 80 GB card (the budget that
    torch.cuda reports for an H100 80GB HBM3): the shipped configs' graphs
    keep everything; an ATOMIC-sized graph takes full recomputation with
    micro-batches of 32 (its whole batch measured 55.9 GiB, 0.706 of the
    card, above the 0.7 that the models keep to); the auto eval batch is
    128 on FB15k-237's V and 64 on ATOMIC's."""
    monkeypatch.setattr(task_mod, "_device_bytes",
                        lambda device: 85_018_877_624)
    cfg = TUltraConfig.default(237)
    t = _bare_task(TransductiveKGTask, _with(cfg, remat="auto"))
    want = {14541: (False, 0, 128), 40943: (False, 0, 128),
            304388: (True, 32, 64)}
    for v, (remat, mb, eval_batch) in want.items():
        got = t._train_model_cfg(types.SimpleNamespace(num_nodes=v), 64)
        assert (got.entity.remat, got.entity.micro_batch) == (remat, mb), v
        assert got.relation.remat is False
        assert t._resolve_eval_batch(64, v) == eval_batch, v


def test_auto_policies_decide_as_jax_on_a_grid(monkeypatch):
    """With the port's constants set to JAX's, every auto decision
    (remat, stack, micro-batch, eval batch) equals the JAX package's on a
    grid of entity counts, batches and budgets."""
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(task_mod, name, value)
    jcfg, tcfg = _configs(layers=6)
    jcfg, tcfg = (_with(c, remat="auto", stack="auto") for c in (jcfg, tcfg))
    jcfg = dataclasses.replace(jcfg, relation=dataclasses.replace(
        jcfg.relation, stack="auto"))
    jt = object.__new__(j_task_mod.TransductiveKGTask)
    jt.model_cfg, jt.cfg = jcfg, j_task_mod.TaskConfig()
    tt = _bare_task(TransductiveKGTask, tcfg)
    decisions = set()
    for budget in (80 << 20, 1 << 30, 16 << 30, 80 << 30):
        monkeypatch.setattr(j_task_mod, "_hbm_bytes", lambda b=budget: b)
        monkeypatch.setattr(task_mod, "_device_bytes", lambda d, b=budget: b)
        for v in (300, 14541, 40943, 304388, 2_500_000):
            for batch in (1, 8, 48, 64):
                g = types.SimpleNamespace(num_nodes=v)
                want = j_task_mod.auto_micro_batch(
                    jt._resolve_model_cfg(g, batch), v, batch,
                    budget_bytes=budget)
                got = tt._train_model_cfg(g, batch)
                for tower in ("entity", "relation"):
                    a, b = getattr(got, tower), getattr(want, tower)
                    assert (a.remat, a.stack, a.micro_batch) == (
                        b.remat, b.stack, b.micro_batch), (budget, v, batch)
                decisions.add((got.entity.remat, got.entity.micro_batch))
                assert tt._resolve_eval_batch(batch, v) == \
                    jt._resolve_eval_batch(batch, v), (budget, v, batch)
    # the grid reaches every tier, micro-batches included
    assert {r for r, _ in decisions} == {False, "save_rspmm", True}
    assert any(mb for _, mb in decisions)


@pytest.fixture(scope="module")
def small():
    """config/synthetic/smoke.yaml's KG (40 entities, 300 triples, 5
    relations) and a 2x8 ULTRA with auto remat and stack."""
    ds = t_synth("SynthKG", 40, 300, 5, seed=0)
    _, tcfg = _configs(remat="auto", stack="auto")
    return ds, tcfg


def test_auto_eval_batch_policy_and_invariance(small, tmp_path):
    """tests/test_engine.py::test_auto_eval_batch_policy_and_invariance:
    small graphs are raised to the cap, huge ones shrink below the request,
    an integer pins the batch, and the metrics do not depend on it."""
    ds, tcfg = small
    task = TransductiveKGTask(ds, tcfg, TaskConfig(num_negative=8),
                              device="cpu")
    assert task._resolve_eval_batch(16, num_nodes=40) == 128
    b_huge = task._resolve_eval_batch(64, num_nodes=3_000_000)
    assert b_huge < 64 and b_huge & (b_huge - 1) == 0
    pinned = TransductiveKGTask(ds, tcfg, TaskConfig(num_negative=8,
                                                     eval_batch_size=7),
                                device="cpu")
    assert pinned._resolve_eval_batch(16, num_nodes=40) == 7
    eng = Engine(task, batch_size=16, work_dir=str(tmp_path),
                 log_interval=1000)
    eng_pin = Engine(pinned, batch_size=16, work_dir=str(tmp_path),
                     log_interval=1000)
    eng_pin.model.load_state_dict(eng.model.state_dict())
    m_auto, m_pin = eng.evaluate("valid"), eng_pin.evaluate("valid")
    assert abs(m_auto["mrr"] - m_pin["mrr"]) < 1e-6


def test_is_oom_error_matcher():
    assert _is_oom_error(FAKE_OOM)
    assert _is_oom_error(RuntimeError("Allocator ran out of memory"))
    assert _is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert not _is_oom_error(RuntimeError("INVALID_ARGUMENT: shape mismatch"))


def test_demotion_walks_the_policy_ladder(monkeypatch):
    """tests/test_failsoft.py::test_demotion_walks_the_policy_ladder: with
    JAX's constants and an 80 MiB budget each level re-resolves one tier
    down, as the JAX task does at the same level; the ladder ends."""
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(task_mod, name, value)
    monkeypatch.setattr(task_mod, "_device_bytes", lambda device: 80 << 20)
    monkeypatch.setattr(j_task_mod, "_hbm_bytes", lambda: 80 << 20)
    ds = t_synth("x", 300, 1500, 6, seed=0)
    _, tcfg = _configs(layers=6, remat="auto", stack="auto")
    tcfg = dataclasses.replace(tcfg, entity=dataclasses.replace(
        tcfg.entity, input_dim=64, hidden_dims=(64,) * 6))
    task = TransductiveKGTask(ds, tcfg, TaskConfig(num_negative=8),
                              device="cpu")
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=64, hidden_dims=(64,) * 6,
                         num_relations=12, remat="auto", stack="auto"),
        relation=j_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    jt = object.__new__(j_task_mod.TransductiveKGTask)
    jt.model_cfg, jt.cfg = jcfg, j_task_mod.TaskConfig()
    g = types.SimpleNamespace(num_nodes=300)

    def both():
        jt._policy_demotion = task._policy_demotion
        got = task._train_model_cfg(g, 16).entity
        want = j_task_mod.auto_micro_batch(
            jt._resolve_model_cfg(g, 16), 300, 16,
            budget_bytes=jt._budget_bytes()).entity
        assert (got.remat, got.micro_batch) == (want.remat, want.micro_batch)
        return got.remat, got.micro_batch

    assert both() == (False, 0)
    seen = [both()]
    while task.demote_policy("test"):
        seen.append(both())
    assert [r for r, _ in seen[:3]] == [False, "save_rspmm", True]
    assert seen[-1][1] and seen[-1][1] <= max(1, seen[3][1] or 16)
    assert task._policy_demotion == task._MAX_POLICY_DEMOTION
    assert not task.demote_policy("test")


def _engine(small, tmp_path, **kw):
    ds, tcfg = small
    task = TransductiveKGTask(ds, tcfg, TaskConfig(num_negative=8),
                              device="cpu")
    return Engine(task, batch_size=16, lr=5e-3, work_dir=str(tmp_path),
                  log_interval=1000, **kw)


def test_engine_survives_injected_oom(small, tmp_path, monkeypatch):
    """tests/test_failsoft.py::test_engine_survives_injected_oom: the first
    step raises an out-of-memory error; the engine restores its snapshot,
    demotes one level and retries, and the epoch ends where an engine that
    never failed ends (the retried step is the failed one: the same batch,
    negatives and weights)."""
    clean = _engine(small, tmp_path)
    clean.train(num_epoch=1, batch_per_epoch=4)
    eng = _engine(small, tmp_path)
    real = Engine._apply
    state = {"oomed": False}

    def failing(self, flat, grads, metrics):
        if not state["oomed"]:
            state["oomed"] = True
            real(self, flat, grads, metrics)  # an update that then fails
            raise FAKE_OOM
        return real(self, flat, grads, metrics)

    monkeypatch.setattr(Engine, "_apply", failing)
    eng.train(num_epoch=1, batch_per_epoch=4)
    assert state["oomed"] and eng.task._policy_demotion == 1
    for a, b in zip(eng.model.parameters(), clean.model.parameters()):
        assert torch.equal(a, b)
    assert [m["loss"] for m in eng.meter.last_window] == \
        [m["loss"] for m in clean.meter.last_window]
    m = eng.evaluate("valid")
    assert 0 < m["mrr"] <= 1


def test_engine_reraises_non_oom(small, tmp_path, monkeypatch):
    eng = _engine(small, tmp_path)

    def raiser(self, graph_id, batch):
        raise RuntimeError("INVALID_ARGUMENT: not an OOM")

    monkeypatch.setattr(Engine, "_grads", raiser)
    with pytest.raises(RuntimeError, match="INVALID_ARGUMENT"):
        eng.train(num_epoch=1, batch_per_epoch=2)
    assert eng.task._policy_demotion == 0


def test_eval_oom_demotes_and_retries(small, tmp_path, monkeypatch):
    eng = _engine(small, tmp_path)
    task = eng.task
    real = type(task).evaluate
    state = {"calls": 0}

    def failing(self, *a, **k):
        state["calls"] += 1
        if state["calls"] == 1:
            raise FAKE_OOM
        return real(self, *a, **k)

    monkeypatch.setattr(type(task), "evaluate", failing)
    m = eng.evaluate("valid")
    assert state["calls"] == 2 and task._policy_demotion == 1
    assert 0 < m["mrr"] <= 1


@pytest.mark.parametrize("remat", [True, "save_rspmm"])
def test_remat_on_the_edge_ring_and_in_bf16(small, remat):
    """Recomputation on the edge ring (3 shards on the CPU) and with bf16
    operands against the same path keeping everything: loss and
    gradients bitwise, since only recomputation differs."""
    ds, _ = small
    for entity in (dict(rspmm_impl="ring", edge_axis="edge",
                        ring_exchange="rdma"),
                   dict(compute_dtype="bfloat16")):
        _, tcfg = _configs(**entity)
        mesh = make_mesh(edge=3, device="cpu") if "edge_axis" in entity \
            else None
        with use_mesh(mesh):
            task = TransductiveKGTask(ds, tcfg, TaskConfig(num_negative=8),
                                      device="cpu")
            model = task.init_params(seed=0)
            params = list(model.parameters())
            neg = torch.from_numpy(
                np.random.default_rng(2).integers(0, 40, (6, 8)))
            runs = []
            for mode in (False, remat):
                task.model_cfg = _with(tcfg, remat=mode)
                loss, _ = task.loss_step(model, None, task.train_triples[:6],
                                         neg=neg)
                runs.append((loss, torch.autograd.grad(loss, params)))
        (l0, g0), (l1, g1) = runs
        assert torch.equal(l0, l1), entity
        assert all(torch.equal(a, b) for a, b in zip(g0, g1)), entity

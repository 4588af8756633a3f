"""Training at length on the CPU: the port's learning check against the JAX
package's, a multi-step trajectory against the JAX engine's update rule,
resuming from a checkpoint, and rehearsals of the learning and endurance
tools (diagnostics/learning.py, diagnostics/endurance.py).

The data is the JAX learning test's (tests/test_engine.py:281-307):
``synthetic_compositional(100, (1, 2, 3), 150)`` with its tiny config (2x8
towers), batch 32, AdamW at lr 5e-3, 16 negatives. The JAX side runs on
its xla route throughout.

Why the initial weights are the JAX engine's: the JAX test's criterion
``m1 > max(3 m0, 0.08)`` depends on the random draw. On this data the JAX
engine fails it at some seeds and the port's own initial weights at
others, both learning all the same. So the learning test starts both
packages from the JAX engine's weights at seed 1024 (its step-0 MRR must
equal the JAX engine's), and the trajectory test injects every batch and
negative so that both packages take the same steps. The JAX test's
``batch_per_epoch=60`` is one epoch of the data's 5 whole batches; the
port's engine takes those 5 steps again with the JAX engine's negatives
injected, and is held to the JAX engine's losses, weights and MRR.

Tolerances, each with its reason:
  * step-0 MRR: 1e-5 absolute — the same weights and filtered rankings
    (ties broken alike) give the same ranks;
  * trajectory and the engines' 5 steps: each step's loss 1e-4 relative,
    every parameter 1e-3 norm-wise after the last step, valid MRR 0.005
    absolute — fp32 losses and gradients agree to about 1e-6
    (test_torch_train.py), and AdamW steps carry that rounding into the
    parameters, most into entries whose gradient is near 0, where Adam's
    normalised step is largest; at this config a start one rounding step
    away stays within these tolerances over 20 steps;
  * resume: bitwise — one process, the same CPU ops on the same values.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_engine import tiny_model_cfg
from test_torch_ring_ultra import one_torch_thread  # noqa: F401  (a fixture)
from ultra_torchdrug_tpu.data.datasets import (
    synthetic_compositional as j_compositional,
)
from ultra_torchdrug_tpu.data.relgraph import (
    build_relation_graph as j_relgraph,
)
from ultra_torchdrug_tpu.engine.engine import Engine as JEngine
from ultra_torchdrug_tpu.engine.engine import make_optimizer
from ultra_torchdrug_tpu.models.ultra import (
    ultra_train_scores as j_train_scores,
)
from ultra_torchdrug_tpu.ops.sampling import strict_negatives as j_strict
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import TransductiveKGTask as JTask
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import synthetic_compositional
from ultra_torchdrug_tpu_torch.diagnostics import endurance, learning
from ultra_torchdrug_tpu_torch.engine.engine import Engine
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config,
    rel_nbfnet_config,
)
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig, TransductiveKGTask
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)
from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

DATA = dict(num_nodes=100, offsets=(1, 2, 3), per_relation=150)
BATCH, LR, NEGATIVES, SEED = 32, 5e-3, 16, 1024
STEPS = 60
TRAJECTORY_STEPS = 20
MRR0_ATOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-3
MRR_ATOL = 5e-3


def port_config(num_relations: int, impl: str = "auto") -> UltraConfig:
    """The port's counterpart of test_engine.py's ``tiny_model_cfg``."""
    return UltraConfig(
        entity=entity_nbfnet_config(input_dim=8, hidden_dims=(8, 8),
                                    num_relations=num_relations * 2,
                                    rspmm_impl=impl),
        relation=rel_nbfnet_config(input_dim=8, hidden=8, num_layers=2,
                                   rspmm_impl=impl))


def port_engine(impl: str = "auto", seed: int = SEED) -> Engine:
    ds = synthetic_compositional(**DATA)
    task = TransductiveKGTask(ds, port_config(ds.num_relations, impl),
                              TaskConfig(num_negative=NEGATIVES),
                              device="cpu")
    return Engine(task, batch_size=BATCH, lr=LR, seed=seed,
                  log_interval=10**9, logger=get_root_logger(None))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX learning test's task on the xla route, the JAX engine's
    initial weights at seed 1024 and their valid MRR; then the JAX test's
    training (``batch_per_epoch=60``, its 5 steps): the key its negatives
    derive from, each step's loss, the weights and the valid MRR after."""
    ds = j_compositional(**DATA)
    cfg = tiny_model_cfg(ds.num_relations)
    cfg = dataclasses.replace(
        cfg, entity=dataclasses.replace(cfg.entity, rspmm_impl="xla"),
        relation=dataclasses.replace(cfg.relation, rspmm_impl="xla"))
    task = JTask(ds, cfg, JTaskConfig(num_negative=NEGATIVES))
    eng = JEngine(task, batch_size=BATCH, lr=LR, seed=SEED,
                  work_dir=str(tmp_path_factory.mktemp("jax_engine")),
                  log_interval=10**9)
    params = jax.tree_util.tree_map(np.array, eng.params)
    mrr0 = eng.evaluate("valid")["mrr"]
    # the engine's first step function splits its key once more, and step i
    # draws its negatives from fold_in(that key, i)
    base_key = jax.random.split(eng.key)[1]
    losses = []
    update_many = eng.meter.update_many

    def record(metrics, n, rates=None):
        losses.append(float(metrics["loss"]))
        update_many(metrics, n, rates)

    eng.meter.update_many = record
    eng.train(num_epoch=1, batch_per_epoch=STEPS)
    return dict(ds=ds, cfg=cfg, task=task, params=params, mrr0=mrr0,
                base_key=base_key, losses=losses,
                trained=jax.tree_util.tree_map(np.array, eng.params),
                mrr_trained=eng.evaluate("valid")["mrr"])


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_learning_on_compositional_structure(jax_side, impl):
    """The port's counterpart of test_engine.py's learning test, from the
    JAX engine's initial weights, on the plain kernels and on xla."""
    eng = port_engine(impl)
    load_jax_params(eng.model, jax_side["params"])
    m0 = eng.evaluate("valid")["mrr"]
    assert abs(m0 - jax_side["mrr0"]) <= MRR0_ATOL, (m0, jax_side["mrr0"])
    eng.train(num_epoch=1, batch_per_epoch=STEPS)
    m1 = eng.evaluate("valid")["mrr"]
    print(f"[{impl}] {eng.meter.global_step} steps: MRR {m0:.6g} -> "
          f"{m1:.6g} (JAX at step 0 {jax_side['mrr0']:.6g})")
    assert m1 > max(3 * m0, 0.08), (m0, m1)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_engine_steps_match_the_jax_engines(jax_side, impl):
    """The JAX learning test's training itself (its engine's 5 steps at
    ``batch_per_epoch=60``) taken by the port's engine from the same
    weights, in the same batch order, with the JAX engine's negatives
    injected: each step's loss, the weights and the valid MRR after it
    against the JAX engine's, at the trajectory test's tolerances."""
    eng = port_engine(impl)
    load_jax_params(eng.model, jax_side["params"])
    task = eng.task
    edges = jnp.asarray(jax_side["task"].fact_graph.prepare_join(
        one_hop=jax_side["cfg"].remove_one_hop).edge_list)
    loss_step = task.loss_step

    def with_jax_negatives(model, generator, batch, rows=None):
        key = jax.random.fold_in(jax_side["base_key"],
                                 np.uint32(eng.meter.global_step))
        neg = j_strict(key, edges, *(jnp.asarray(batch[:, i])
                                     for i in range(3)),
                       task.dataset.num_entities, NEGATIVES)
        return loss_step(model, generator, batch, rows=rows,
                         neg=torch.from_numpy(np.asarray(neg, np.int64)))

    task.loss_step = with_jax_negatives
    eng.train(num_epoch=1, batch_per_epoch=STEPS)
    got = [m["loss"] for m in eng.meter.last_window]
    want = jax_side["losses"]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    want_params = jax_params_to_state_dict(jax_side["trained"])
    gaps = {name: ((p.detach() - want_params[name]).norm()
                   / want_params[name].norm()).item()
            for name, p in eng.model.named_parameters()}
    mrr = eng.evaluate("valid")["mrr"]
    worst = max(gaps, key=gaps.get)
    print(f"[{impl}] 5 steps with the JAX engine's negatives: worst loss "
          f"gap {max(abs(a - b) / abs(b) for a, b in zip(got, want)):.3g}, "
          f"worst parameter {gaps[worst]:.3g} ({worst}); valid MRR "
          f"{mrr:.6g} vs the JAX engine's {jax_side['mrr_trained']:.6g}")
    assert gaps[worst] <= PARAM_RTOL, (worst, gaps[worst])
    assert abs(mrr - jax_side["mrr_trained"]) <= MRR_ATOL, (
        mrr, jax_side["mrr_trained"])


def test_trajectory_matches_jax(jax_side):
    """20 steps with injected batches and negatives: the JAX package's loss
    and gradients (``jax.value_and_grad`` of the train scores and the
    criterion) and optax's adamw through ``make_optimizer``, against the
    port's ``task.loss_step`` and the engine's ``Optimizer``."""
    eng = port_engine()
    task, model = eng.task, eng.model
    load_jax_params(model, jax_side["params"])
    draws = learning.injected_draws(task.train_triples,
                                    task.dataset.num_entities,
                                    TRAJECTORY_STEPS, BATCH, NEGATIVES)
    jcfg = jax_side["cfg"]
    jfact = jax_side["ds"].fact_graph(None)[0]
    jrel = j_relgraph(jfact).prepare_dense()

    def j_loss(params, batch, neg):
        scores = j_train_scores(params, jcfg, jfact, jrel, batch[:, 0],
                                batch[:, 1], batch[:, 2], neg)
        return j_criterion(jax_side["task"].cfg, scores)

    step = jax.jit(jax.value_and_grad(j_loss))
    tx = make_optimizer("AdamW", LR)
    params = jax.tree_util.tree_map(jnp.asarray, jax_side["params"])
    state = tx.init(params)
    want = []
    for batch, neg in draws:
        loss, grads = step(params, jnp.asarray(batch),
                           jnp.asarray(neg.astype(np.int32)))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    got = learning.injected_trajectory(task, model, draws, LR)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    want_params = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params))
    gaps = {name: ((p.detach() - want_params[name]).norm()
                   / want_params[name].norm()).item()
            for name, p in model.named_parameters()}
    j_mrr = jax_side["task"].evaluate(params, "valid", BATCH)["mrr"]
    t_mrr = task.evaluate(model, "valid", BATCH)["mrr"]
    worst = max(gaps, key=gaps.get)
    print(f"losses: worst relative gap "
          f"{max(abs(a - b) / abs(b) for a, b in zip(got, want)):.3g}; "
          f"parameters: worst {gaps[worst]:.3g} ({worst}); valid MRR "
          f"{t_mrr:.6g} vs JAX {j_mrr:.6g}")
    assert max(gaps.values()) <= PARAM_RTOL, (worst, gaps[worst])
    assert abs(t_mrr - j_mrr) <= MRR_ATOL, (t_mrr, j_mrr)


def test_rounding_sized_start_stays_within_the_tolerances(jax_side):
    """Why the trajectory test can hold 1e-4 and 1e-3 over 20 steps: at this
    config the port's own CPU run, started again from weights changed by
    about one fp32 rounding step (``learning.perturbed``), stays within
    those tolerances of the unchanged run. (At the learning tool's 6x64
    config the same witness, ``learning.trajectory(witness=True)``, grows
    past them.)"""
    eng = port_engine()
    task = eng.task
    load_jax_params(eng.model, jax_side["params"])
    draws = learning.injected_draws(task.train_triples,
                                    task.dataset.num_entities,
                                    TRAJECTORY_STEPS, BATCH, NEGATIVES)
    runs = []
    for model in (eng.model, learning.perturbed(eng.model)):
        runs.append((learning.injected_trajectory(task, model, draws, LR),
                     dict(model.named_parameters())))
    gaps = learning._gaps(runs[1][0], runs[0][0], runs[1][1], runs[0][1])
    print(f"one rounding step at the start, {TRAJECTORY_STEPS} steps: worst "
          f"loss gap {gaps['max_loss_gap']:.3g}, worst parameter "
          f"{gaps['max_param_gap']:.3g} ({gaps['worst_param']})")
    assert 0 < gaps["max_loss_gap"] <= LOSS_RTOL, gaps
    assert gaps["max_param_gap"] <= PARAM_RTOL, gaps


def test_resume_continues_the_trajectory(tmp_path):
    """4 steps, a checkpoint, 3 more; a fresh engine that loads the
    checkpoint with its optimizer state and is given the same random states
    takes the same 3 steps bitwise."""
    eng = port_engine()
    eng.train(num_epoch=1, batch_per_epoch=4)
    path = str(tmp_path / "ckpt.pt")
    eng.save(path)
    generator = eng.generator.get_state()
    rng = eng.rng.bit_generator.state
    eng.train(num_epoch=1, batch_per_epoch=3)
    want = [m["loss"] for m in eng.meter.last_window]

    fresh = port_engine(seed=7)
    fresh.load(path, drop_optimizer=False)
    fresh.generator.set_state(generator)
    fresh.rng.bit_generator.state = rng
    fresh.train(num_epoch=1, batch_per_epoch=3)
    assert [m["loss"] for m in fresh.meter.last_window] == want
    got = dict(fresh.model.named_parameters())
    for name, p in eng.model.named_parameters():
        assert torch.equal(got[name], p), name
    # AdamW's step count came back with the state: a fresh optimizer state
    # takes another step
    assert all(s["step"] == 7 for s in
               fresh.optimizer.inner.state_dict()["state"].values())


def _finite(value) -> bool:
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


@pytest.mark.parametrize("ring", [False, True])
def test_learning_tool_rehearsal(ring):
    readings = learning.run(ring=ring, steps=2, window=1, device="cpu",
                            **learning.REHEARSAL)
    assert set(readings) >= {
        "mrr_before", "mrr_after", "verdict", "ok", "ms_per_step",
        "launches", "launches_per_step", "max_memory_allocated", "windows",
        "policy", "card"}
    assert len(readings["windows"]) == 2
    assert all(w["finite"] for w in readings["windows"])
    assert readings["max_memory_allocated"] is None  # not measured here
    assert not any(readings["launches"].values())  # the plain versions
    assert readings["verdict"] in ("LEARNING OK", "SUSPECT")
    assert _finite(readings)


def test_endurance_tool_rehearsal():
    summary = endurance.run(steps=2, window=1, eval_every=2, ckpt_every=2,
                            resume_check_at=1, device="cpu",
                            **endurance.REHEARSAL)
    assert set(summary) >= {
        "setup_s", "steady_ms_per_step", "drift_second_half_vs_first",
        "rss_start_bytes", "rss_end_bytes", "allocated_start_bytes",
        "allocated_end_bytes", "host_creep_bytes", "device_creep_bytes",
        "projected_200k_steps_hours", "windows", "events", "resume_check"}
    assert [w["step"] for w in summary["windows"]] == [1, 2]
    assert all(sum(w["graphs"].values()) == 1 for w in summary["windows"])
    kinds = [tuple(sorted(set(e) - {"step"})) for e in summary["events"]]
    assert kinds == [("ckpt_s",), ("resume_check",), ("ckpt_s",),
                     ("eval_s", "mrr", "per_graph")]
    assert summary["resume_check"]["bitwise"]
    assert summary["rss_end_bytes"] > 0
    assert summary["allocated_end_bytes"] is None  # not measured here
    assert endurance.failures(summary) == []
    assert _finite(summary)


def test_eval_takes_the_loss_functions_layouts(monkeypatch):
    """A graph's propagation layouts are prepared once a task: the
    evaluation of a graph that trained takes its loss function's layouts
    (the endurance run read 75.8 MiB more allocated on the card after its
    first evaluation when each eval function prepared its own), and ranks
    as an eval-only task does."""
    from ultra_torchdrug_tpu_torch.tasks.task import MultiGraphPretrainTask

    graphs = (("a", 60, 400, 5), ("b", 80, 300, 3))
    ds = endurance.mixture(graphs)

    def task():
        return MultiGraphPretrainTask(
            ds, port_config(5), TaskConfig(num_negative=4, eval_batch_size=8),
            device="cpu")

    calls = []
    prepare = MultiGraphPretrainTask._prepare_graphs

    def counted(self, fact_graph, rel_graph, backward=False):
        calls.append(backward)
        return prepare(self, fact_graph, rel_graph, backward)

    monkeypatch.setattr(MultiGraphPretrainTask, "_prepare_graphs", counted)
    trained = task()
    model = trained.init_params(seed=0)
    for gid in range(len(graphs)):
        trained.loss_step(model, None, trained.train_triples[gid][:4], gid,
                          neg=torch.zeros((4, 4), dtype=torch.int64))
    got = trained.evaluate(model, "valid", 8, fast_test=16)
    assert calls == [True, True]
    want = task().evaluate(model, "valid", 8, fast_test=16)
    assert calls == [True, True, False, False]
    assert got == want


def _counted_prepares(monkeypatch) -> list:
    """The ``backward`` flag of each ``_prepare_graphs`` call of a
    pre-training task during the test."""
    from ultra_torchdrug_tpu_torch.tasks.task import MultiGraphPretrainTask

    calls = []
    prepare = MultiGraphPretrainTask._prepare_graphs

    def counted(self, fact_graph, rel_graph, backward=False):
        calls.append(backward)
        return prepare(self, fact_graph, rel_graph, backward)

    monkeypatch.setattr(MultiGraphPretrainTask, "_prepare_graphs", counted)
    return calls


def _two_graph_task(cfg=None):
    from ultra_torchdrug_tpu_torch.tasks.task import MultiGraphPretrainTask

    ds = endurance.mixture((("a", 60, 400, 5), ("b", 80, 300, 3)))
    return MultiGraphPretrainTask(
        ds, cfg or port_config(5),
        TaskConfig(num_negative=4, eval_batch_size=8), device="cpu")


def _one_step_a_graph(task, model):
    """A loss and its gradients on each graph."""
    for gid in range(task.num_graphs):
        loss, _ = task.loss_step(model, None, task.train_triples[gid][:4],
                                 gid, neg=torch.zeros((4, 4), dtype=torch.int64))
        loss.backward()


def test_eval_before_training_leaves_one_copy_of_the_layouts(monkeypatch):
    """An evaluation before the first training step prepares the forward
    layouts; the first loss function of each graph replaces them with the
    backward ones (which hold the same forward ones), the forward-only
    copies are freed, and later evaluations take the loss functions'
    layouts and rank as an eval-only task does."""
    import gc
    import weakref

    calls = _counted_prepares(monkeypatch)
    task = _two_graph_task()
    model = task.init_params(seed=0)
    task.evaluate(model, "valid", 8, fast_test=16)
    assert calls == [False, False]
    forward_only = [weakref.ref(graphs[0]) for *_, graphs in task._prepared]
    _one_step_a_graph(task, model)
    assert calls == [False, False, True, True]
    gc.collect()
    assert [ref() for ref in forward_only] == [None, None]
    assert [bwd for *_, bwd, _ in task._prepared] == [True, True]
    got = task.evaluate(model, "valid", 8, fast_test=16)
    assert calls == [False, False, True, True]
    want = _two_graph_task().evaluate(model, "valid", 8, fast_test=16)
    assert calls == [False, False, True, True, False, False]
    assert got == want


def test_eval_under_another_mesh_prepares_its_own(monkeypatch):
    """The layouts are shared within one active mesh: a task that trained
    with its entity tower on a ring of 3 shards and evaluates under a ring
    of 4 prepares the 4-shard layouts (and ranks as an eval-only task
    under that mesh), and under its training mesh takes the loss
    functions' layouts."""
    from ultra_torchdrug_tpu_torch.parallel.mesh import make_mesh, use_mesh

    cfg = port_config(5)
    cfg = dataclasses.replace(cfg, entity=dataclasses.replace(
        cfg.entity, rspmm_impl="ring", edge_axis="edge",
        ring_exchange="rdma"))
    calls = _counted_prepares(monkeypatch)
    task = _two_graph_task(cfg)
    model = task.init_params(seed=0)
    three, four = (make_mesh(edge=n, device="cpu") for n in (3, 4))
    with use_mesh(three):
        _one_step_a_graph(task, model)
    assert calls == [True, True]
    with use_mesh(four):
        got = task.evaluate(model, "valid", 8, fast_test=16)
        assert calls == [True, True, False, False]
        assert [graphs[0].ring_inputs.n_shards
                for *_, graphs in task._prepared] == [3, 3, 4, 4]
        want = _two_graph_task(cfg).evaluate(model, "valid", 8,
                                             fast_test=16)
    assert got == want
    with use_mesh(three):
        task.evaluate(model, "valid", 8, fast_test=16)
    assert calls == [True, True, False, False, False, False]

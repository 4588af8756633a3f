"""Multi-graph pre-training (tasks/task.py ``MultiGraphPretrainTask``, the
engine's multi-graph steps, ``run_full`` on config/transductive/
pretrain_3g.yaml) against the JAX package, on the CPU: three generated
graphs of different sizes and relation counts, 2x8 towers, the same
weights (``load_jax_params``).

The mixture weights must be equal; one loss step per graph with injected
negatives matches jax.grad of the JAX loss (loss and gradients at 1e-4);
the per-graph rankings match under test_torch_inductive.py's tie rule and
the averaged metrics are the means of the per-graph ones; the engine's
(graph, batch) sequence equals the JAX engine's under one seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_inductive import (
    GRAD_TOL,
    assert_metrics_close,
    assert_rankings_match,
    both_scores,
    configs,
    seeded_models,
)

from ultra_torchdrug_tpu.data.datasets import JointDataset as JJoint
from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.engine.engine import Engine as JEngine
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.tasks.task import MultiGraphPretrainTask as JTask
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch import run_full
from ultra_torchdrug_tpu_torch.data.datasets import JointDataset
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.engine.engine import Engine
from ultra_torchdrug_tpu_torch.tasks.task import (
    DEFAULT_PRETRAIN_METRICS,
    MultiGraphPretrainTask,
    TaskConfig,
)
from ultra_torchdrug_tpu_torch.utils.config import load_config
from ultra_torchdrug_tpu_torch.utils.convert import jax_params_to_state_dict
from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

BATCH = 16
# (name, entities, triples drawn, relations) of each graph
GRAPHS = (("g0", 40, 300, 5), ("g1", 45, 200, 3), ("g2", 30, 150, 7))


def _joint(synth, cls):
    return cls("joint", [synth(name, v, e, r, seed=i)
                         for i, (name, v, e, r) in enumerate(GRAPHS)])


@pytest.fixture(scope="module")
def pretrain():
    jds, tds = _joint(j_synth, JJoint), _joint(t_synth, JointDataset)
    jcfg, tcfg = configs(max(r for *_, r in GRAPHS))
    params, model = seeded_models(jcfg, tcfg)
    metrics = ("mr", "mrr", "hits@1", "hits@3", "hits@10")
    jtask = JTask(jds, jcfg, JTaskConfig(metrics=metrics,
                                         eval_batch_size=BATCH, num_negative=9))
    ttask = MultiGraphPretrainTask(tds, tcfg, TaskConfig(
        metrics=DEFAULT_PRETRAIN_METRICS, num_negative=9), device="cpu")
    return jtask, ttask, params, model


def test_mixture_weights_and_relations_match_jax(pretrain):
    jtask, ttask, _, _ = pretrain
    assert ttask.cfg.metrics == DEFAULT_PRETRAIN_METRICS == jtask.cfg.metrics
    assert ttask.num_graphs == jtask.num_graphs == 3
    assert ttask.num_relations == jtask.num_relations == 7
    np.testing.assert_array_equal(ttask._graph_probs, jtask._graph_probs)
    for a, b in zip(ttask.train_triples, jtask.train_triples):
        np.testing.assert_array_equal(a, b)


def _steps(ttask):
    """Per graph: 4 train triples and 9 injected negatives each."""
    out = []
    for gid, train in enumerate(ttask.train_triples):
        rng = np.random.default_rng(gid)
        out.append((train[rng.choice(len(train), 4, replace=False)],
                    rng.integers(0, ttask.fact_graphs[gid].num_nodes,
                                 (4, 9))))
    return out


@pytest.fixture(scope="module")
def jax_steps(pretrain):
    """The JAX loss and gradients of each graph's step, in one jit."""
    jtask, ttask, params, _ = pretrain
    steps = _steps(ttask)

    def losses(p):
        out = []
        for gid, (batch, neg) in enumerate(steps):
            scores = j_train(p, jtask.model_cfg, jtask.fact_graphs[gid],
                             jtask.rel_graphs[gid].prepare_dense(),
                             *(jnp.asarray(batch[:, i]) for i in range(3)),
                             jnp.asarray(neg))
            out.append(j_criterion(jtask.cfg, scores))
        return out

    grads = [jax.grad(lambda p, g=g: losses(p)[g]) for g in range(3)]
    loss, grad = jax.jit(lambda p: (losses(p), [g(p) for g in grads]))(params)
    return [(float(l), jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, g))) for l, g in zip(loss, grad)]


@pytest.mark.parametrize("gid", [0, 1, 2])
def test_loss_step_per_graph_matches_jax(pretrain, jax_steps, gid):
    """One loss step on each graph, its negatives injected: the loss and
    every gradient against jax.grad of the JAX loss on that graph."""
    _, ttask, _, model = pretrain
    batch, neg = _steps(ttask)[gid]
    want_loss, want_grads = jax_steps[gid]
    model.zero_grad(set_to_none=True)
    loss, metrics = ttask.loss_step(model, None, batch, gid,
                                    neg=torch.from_numpy(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **GRAD_TOL)
    assert set(metrics) == {"loss", "pos_score", "neg_score"}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    model.zero_grad(set_to_none=True)


def test_evaluate_per_graph_matches_jax(pretrain):
    """Each graph's rankings against the JAX task's, then the averaged
    metrics: the mean of the per-graph ones, each the JAX metric code's on
    the port's rankings."""
    jtask, ttask, params, model = pretrain
    got = ttask.evaluate(model, "test", BATCH, fast_test=30)
    assert set(got["per_graph"]) == {name for name, *_ in GRAPHS}
    sets = ttask.eval_sets("test")
    for (name, gid, triples), (j_name, j_gid, _) in zip(
            sets, jtask.eval_sets("test")):
        assert (name, gid) == (j_name, j_gid)
        triples = ttask._fast_subset(triples, 30)
        jrank, cand = jtask._run_eval(
            jax.jit(jtask._build_eval_fn(jtask.fact_graphs[gid],
                                         jtask.rel_graphs[gid],
                                         jtask.graphs[gid])),
            params, triples, BATCH)
        trank, tcand = ttask._run_eval(ttask._eval_fns[gid], model, triples,
                                       BATCH)
        np.testing.assert_array_equal(tcand, np.asarray(cand))
        fact = ttask.fact_graphs[gid]
        assert_rankings_match(jrank, trank, triples, both_scores(
            params, jtask.model_cfg, jtask.fact_graphs[gid],
            jtask.rel_graphs[gid], model, fact, ttask.rel_graphs[gid]),
            ttask.graphs[gid].edge_list, fact.num_nodes)
        assert_metrics_close(got["per_graph"][name],
                             jtask._metrics_from_rankings(
                                 trank.astype(np.int32), cand, None))
    for k in DEFAULT_PRETRAIN_METRICS:
        assert got[k] == pytest.approx(np.mean(
            [m[k] for m in got["per_graph"].values()]), abs=1e-12)
    assert set(got) == set(DEFAULT_PRETRAIN_METRICS) | {"per_graph"}


def _engines(pretrain, seed):
    jtask, ttask, _, _ = pretrain
    jeng = JEngine(jtask, batch_size=BATCH, seed=seed, log_interval=10**9,
                   logger=get_root_logger(None), steps_per_call=1)
    eng = Engine(ttask, batch_size=BATCH, seed=seed, log_interval=10**9,
                 logger=get_root_logger(None))
    return jeng, eng


def test_engine_draws_the_jax_engines_graphs_and_batches(pretrain):
    jeng, eng = _engines(pretrain, seed=5)
    want = [(gid, np.asarray(b)) for gid, _, b, _ in jeng._epoch_chunks(20)]
    got = [(gid, b) for gid, chunk in eng._epoch_chunks(20) for b in chunk]
    assert len(got) == len(want) == 20
    assert len({gid for gid, _ in got}) == 3
    for (gid, batch), (j_gid, j_batch) in zip(got, want):
        assert gid == j_gid
        np.testing.assert_array_equal(batch, j_batch)
    assert sum(1 for _ in eng._epoch_chunks(None)) == 1000


def test_mixture_follows_the_edge_counts(pretrain):
    """2,000 draws: each graph's share within 3 standard deviations of its
    edge-count weight."""
    _, eng = _engines(pretrain, seed=123)
    n = 2000
    counts = np.bincount([gid for gid, _ in eng._epoch_chunks(n)],
                         minlength=3)
    p = eng.task._graph_probs
    sigma = np.sqrt(p * (1 - p) / n)
    assert (np.abs(counts / n - p) <= 3 * sigma).all(), (counts / n, p)


def test_engine_trains_each_drawn_graph(pretrain):
    _, ttask, _, model = pretrain
    eng = Engine(ttask, batch_size=8, seed=2, log_interval=10**9,
                 logger=get_root_logger(None))
    eng.model.load_state_dict(model.state_dict())
    steps = []
    run_step = eng._run_step
    eng._run_step = lambda gid, batch: steps.append(gid) or run_step(gid,
                                                                     batch)
    eng.train(num_epoch=1, batch_per_epoch=6)
    assert len(steps) == 6 and eng.meter.global_step == 6
    assert all(math.isfinite(v) for m in eng.meter.last_window
               for v in m.values())
    assert eng._edges_per_step(2) == 2 * ttask.fact_graphs[2].num_edges * 2 * 2
    metrics = eng.evaluate("valid", fast_test=8)
    assert eng.metrics["valid"] is metrics and len(metrics["per_graph"]) == 3


def test_run_full_pretrain_3g_on_synthjoint(tmp_path):
    """config/transductive/pretrain_3g.yaml as shipped (6x64 towers, batch
    64, 128 strict negatives, AdamW), rendered for SynthJoint with one
    epoch of 3 batches."""
    cfg = load_config(str(run_full.__file__).replace(
        "ultra_torchdrug_tpu_torch/run_full.py",
        "config/transductive/pretrain_3g.yaml"), context=dict(gpus=[0]))[0]
    cfg["dataset"] = {"class": "SynthJoint"}
    cfg["train"].update(num_epoch=1, batch_per_epoch=3)
    cfg["output_dir"] = str(tmp_path)
    engine = run_full.run(cfg, device="cpu")
    assert engine.epoch == 1 and engine.meter.global_step == 3
    assert isinstance(engine.task, MultiGraphPretrainTask)
    assert engine.batch_size == 64 and engine.task.cfg.num_negative == 128
    for split in ("valid", "test"):
        m = engine.metrics[split]
        assert set(m["per_graph"]) == {"synth0", "synth1"}
        assert m["mrr"] == pytest.approx(np.mean(
            [g["mrr"] for g in m["per_graph"].values()]))
        assert 0 < m["mrr"] <= 1

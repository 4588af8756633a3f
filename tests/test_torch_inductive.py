"""Inductive evaluation and the evaluation options (tasks/task.py
``InductiveKGTask``, ``TaskConfig.metric_per_rel``, ``toy_eval`` and
``eval_batch_size``; tasks/kg.py's sampled hits@k_N estimator and toy
protocol) against the JAX package, on the CPU: SynthInductiveKG, 2x8
towers, the same weights (``load_jax_params``), eval batch 16.

Rankings must be equal except where a rank is decided by candidates that
tie the target within TIE_BAND in both packages (test_torch_eval.py gives
the reason: rounding orders exact ties differently); num_candidates must be
equal and the metrics equal to 1e-6 on the same rankings. JAX's toy draw
(a Gumbel top-k) cannot be reproduced in torch: its ranking is held
against JAX on the indices JAX drew, and the port's draw to its
properties.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import InductiveDataset as JInductive
from ultra_torchdrug_tpu.data.datasets import synthetic_inductive as j_ind
from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_scores
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.tasks import kg as j_kg
from ultra_torchdrug_tpu.tasks.task import DEFAULT_INDUCTIVE_METRICS as J_IND
from ultra_torchdrug_tpu.tasks.task import InductiveKGTask as JInductiveTask
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import TransductiveKGTask as JTransTask
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import InductiveDataset
from ultra_torchdrug_tpu_torch.data.datasets import synthetic_inductive
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import ultra_eval_scores
from ultra_torchdrug_tpu_torch.ops.match import (
    head_truth_mask,
    tail_truth_mask,
)
from ultra_torchdrug_tpu_torch.tasks import kg
from ultra_torchdrug_tpu_torch.tasks.task import (
    DEFAULT_INDUCTIVE_METRICS,
    InductiveKGTask,
    TaskConfig,
    TransductiveKGTask,
)
from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

BATCH = 16
TIE_BAND = 1e-5
METRIC_TOL = 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def configs(num_relations: int, d: int = 8, layers: int = 2):
    """The JAX and the port's model config of 2x8 towers."""
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=d, hidden_dims=(d,) * layers,
                         num_relations=2 * num_relations),
        relation=j_rel_cfg(input_dim=d, hidden=d, num_layers=layers))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=d, hidden_dims=(d,) * layers,
                         num_relations=2 * num_relations),
        relation=t_rel_cfg(input_dim=d, hidden=d, num_layers=layers))
    return jcfg, tcfg


def seeded_models(jcfg, tcfg, seed: int = 0):
    """JAX params from a seed, and the port model carrying them."""
    params = ultra_init(jax.random.PRNGKey(seed), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    return params, model


def assert_rankings_match(jrank, trank, triples, scores, filter_edges,
                          num_nodes: int):
    """``trank`` equals ``jrank`` except where the rank is decided by
    candidates within TIE_BAND of the target's score in both packages.
    ``scores(chunk)`` gives both packages' ((tail, head), (tail, head))
    [B, V] scores of a chunk of triples; ``filter_edges`` is the split's
    filter graph's edge list."""
    jrank, trank = np.asarray(jrank), np.asarray(trank)
    assert trank.shape == jrank.shape == (len(triples), 2)
    rows = np.nonzero((trank != jrank).any(axis=1))[0]
    if not len(rows):
        return
    chunk = triples[rows]
    (jt, jh), (tt, th) = scores(chunk)
    b = torch.from_numpy(chunk.astype(np.int64))
    masks = (tail_truth_mask(filter_edges, b[:, 0], b[:, 2], num_nodes),
             head_truth_mask(filter_edges, b[:, 1], b[:, 2], num_nodes))
    for i, row in enumerate(rows):
        for col, (js, ts, target) in enumerate(((jt, tt, chunk[i, 1]),
                                                (jh, th, chunk[i, 0]))):
            truth = masks[col][i].numpy()
            j_geq = (js[i] >= js[i, target]) & ~truth
            t_geq = (ts[i] >= ts[i, target]) & ~truth
            assert t_geq.sum() + 1 == trank[row, col]
            for v in np.nonzero(j_geq != t_geq)[0]:
                gaps = (js[i, v] - js[i, target], ts[i, v] - ts[i, target])
                assert max(map(abs, gaps)) <= TIE_BAND, (row, col, v, gaps)


def both_scores(params, jcfg, jgraph, jrel, model, tgraph, trel):
    """A ``scores`` function for ``assert_rankings_match`` on one graph."""
    def scores(chunk):
        want = j_scores(params, jcfg, jgraph, jrel.prepare_dense(),
                        *(jnp.asarray(chunk[:, i]) for i in range(3)))
        b = torch.from_numpy(chunk.astype(np.int64))
        with torch.inference_mode():
            got = ultra_eval_scores(model, tgraph, trel.prepare_dense(),
                                    b[:, 0], b[:, 1], b[:, 2])
        return [np.asarray(w) for w in want], [g.numpy() for g in got]
    return scores


def assert_metrics_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])


@pytest.fixture(scope="module")
def inductive():
    jds, tds = j_ind(), synthetic_inductive()
    jcfg, tcfg = configs(tds.num_relations)
    params, model = seeded_models(jcfg, tcfg)
    jtask = JInductiveTask(jds, jcfg, JTaskConfig(metrics=J_IND,
                                                  eval_batch_size=BATCH))
    ttask = InductiveKGTask(tds, tcfg, device="cpu")
    return jtask, ttask, params, model


@pytest.mark.parametrize("split", ["test", "valid"])
def test_inductive_rankings_and_metrics_match_jax(inductive, split):
    jtask, ttask, params, model = inductive
    assert ttask.cfg.metrics == DEFAULT_INDUCTIVE_METRICS == J_IND
    triples = ttask.eval_triples(split)
    assert len(triples) % BATCH != 0  # the last batch is ragged
    jrank, jcand = jtask._run_eval(jtask._eval_fns[split], params, triples,
                                   BATCH)
    trank, tcand = ttask._run_eval(ttask.eval_fn(split), model, triples,
                                   BATCH)
    assert trank.dtype.kind == "i" and tcand.dtype == np.float32
    np.testing.assert_array_equal(tcand, np.asarray(jcand))
    graph = ttask.graphs[split]
    assert_rankings_match(jrank, trank, triples, both_scores(
        params, jtask.model_cfg, jtask.graphs[split], jtask.rel_graphs[split],
        model, graph, ttask.rel_graphs[split]),
        ttask.filter_graphs[split].edge_list, graph.num_nodes)
    rel = np.stack([triples[:, 2], triples[:, 2]], 1)
    got = ttask.evaluate(model, split, BATCH)
    assert_metrics_close(got, jtask._metrics_from_rankings(
        trank.astype(np.int32), jcand, rel))
    assert all(math.isfinite(v) for v in got.values())
    if np.array_equal(trank, np.asarray(jrank)):
        assert_metrics_close(got, jtask.evaluate(params, split, BATCH))


@pytest.mark.parametrize("valid_is", ["test graph", "train graph", "a copy"])
def test_filter_graph_choice(inductive, valid_is):
    """Valid ranks against the transductive filter graph exactly when its
    propagation graph is the train graph (the same object or equal edges),
    as in the JAX package; each distinct propagation graph gets one
    relation graph and its splits share one eval function."""
    jtask, ttask, _, _ = inductive
    tds, jds = ttask.dataset, jtask.dataset
    if valid_is != "test graph":
        def train_like(g):  # the train graph, or an equal copy of it
            return g if valid_is == "train graph" else type(g).from_triplets(
                np.asarray(g.edge_list), g.num_nodes, g.num_relations)
        tds = dataclasses.replace(tds, valid_graph=train_like(tds.train_graph))
        jds = dataclasses.replace(jds, valid_graph=train_like(jds.train_graph))
    jt = JInductiveTask(jds, jtask.model_cfg, jtask.cfg)
    tt = InductiveKGTask(tds, ttask.model_cfg, device="cpu")
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(
            tt.filter_graphs[split].edge_list.numpy(),
            np.asarray(jt.filter_graphs[split].edge_list))
    want = tds.graph if valid_is != "test graph" else tds.inductive_graph
    assert tt.filter_graphs["valid"] is want
    assert tt.filter_graphs["test"] is tds.inductive_graph
    shared = tds.valid_graph is tds.test_graph
    assert (tt.rel_graphs["valid"] is tt.rel_graphs["test"]) == shared
    assert (tt.eval_fn("valid") is tt.eval_fn("test")) == shared
    assert (tt.rel_graphs["valid"] is tt.rel_graphs["train"]) == (
        tds.valid_graph is tds.train_graph)


def test_inductive_loss_step_matches_jax(inductive):
    """One loss step over the train graph with sample_weight (degrees over
    the train graph's nodes) and injected negatives against the JAX task's
    loss; its gradients reach every parameter. (The loss function and its
    gradients are the transductive task's, held against jax.grad in
    test_torch_train.py.)"""
    jtask, ttask, params, model = inductive
    cfg = dict(sample_weight=True, num_negative=9)
    jt = JInductiveTask(jtask.dataset, jtask.model_cfg,
                        JTaskConfig(metrics=J_IND, **cfg))
    tt = InductiveKGTask(ttask.dataset, ttask.model_cfg,
                         TaskConfig(metrics=DEFAULT_INDUCTIVE_METRICS, **cfg),
                         device="cpu")
    rng = np.random.default_rng(3)
    batch = tt.train_triples[rng.choice(len(tt.train_triples), 6,
                                        replace=False)]
    neg = rng.integers(0, tt.dataset.train_graph.num_nodes, (6, 9))
    sw = jt.sample_weight_for(batch)
    np.testing.assert_allclose(tt.sample_weight_for(batch).numpy(),
                               np.asarray(sw), rtol=1e-6)
    assert len(np.unique(np.asarray(sw))) > 1
    scores = j_train(params, jt.model_cfg, jt.dataset.train_graph,
                     jt.rel_graphs["train"].prepare_dense(),
                     *(jnp.asarray(batch[:, i]) for i in range(3)),
                     jnp.asarray(neg))
    want = j_criterion(jt.cfg, scores, sw)
    model.zero_grad(set_to_none=True)
    loss, _ = tt.loss_step(model, None, batch, neg=torch.from_numpy(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **GRAD_TOL)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    model.zero_grad(set_to_none=True)


@pytest.fixture(scope="module")
def transductive():
    jds = j_synth("SynthKG", 40, 300, 5, seed=0)
    tds = t_synth("SynthKG", 40, 300, 5, seed=0)
    jcfg, tcfg = configs(5)
    params, model = seeded_models(jcfg, tcfg)
    return jds, tds, jcfg, tcfg, params, model


@pytest.mark.parametrize("kind", ["inductive", "transductive"])
def test_metric_per_rel_matches_jax(inductive, transductive, kind):
    """metric_per_rel's keys and values against the JAX metric code on the
    port's rankings: the inductive task counts both directions under the
    base relation, the transductive one under r and r + R."""
    cfg = dict(metric_per_rel=True, metrics=("mrr", "hits@3", "mrr-tail"),
               eval_batch_size=BATCH)
    if kind == "inductive":
        jtask, ttask, params, model = inductive
        jt = JInductiveTask(jtask.dataset, jtask.model_cfg, JTaskConfig(**cfg))
        tt = InductiveKGTask(ttask.dataset, ttask.model_cfg,
                             TaskConfig(**cfg), device="cpu")
        fn = tt.eval_fn("test")
    else:
        jds, tds, jcfg, tcfg, params, model = transductive
        jt = JTransTask(jds, jcfg, JTaskConfig(**cfg))
        tt = TransductiveKGTask(tds, tcfg, TaskConfig(**cfg), device="cpu")
        fn = tt._eval_fn
    triples = tt.eval_triples("test")
    trank, tcand = tt._run_eval(fn, model, triples, BATCH)
    R = tt.num_relations
    rel = np.stack([triples[:, 2],
                    triples[:, 2] + (0 if kind == "inductive" else R)], 1)
    got = tt.evaluate(model, "test", 64)
    want = jt._metrics_from_rankings(trank.astype(np.int32), tcand, rel)
    assert_metrics_close(got, want)
    assert {f"mrr_rel_{r}" for r in range(2 * R)} <= set(got)
    assert not any(k.startswith("mrr-tail_rel") for k in got)
    used = np.unique(rel)
    assert all(got[f"hits@3_rel_{r}"] == 0 for r in range(2 * R)
               if r not in used)


@pytest.mark.parametrize("name", ["hits@10_50", "hits@3_20", "hits@1_5"])
def test_sampled_hits_estimator_matches_jax(rng, name):
    ranking = rng.integers(1, 300, (200, 2))
    cand = rng.integers(299, 400, (200, 2)).astype(np.float32)
    want = j_kg._metric_scores(jnp.asarray(ranking), name, jnp.asarray(cand))
    got = kg._metric_scores(torch.from_numpy(ranking), name,
                            torch.from_numpy(cand))
    # per sample: a sum of up to 10 fp32 power terms, in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    metrics = [name, "mr", f"{name}-tail", f"{name}-head"]
    want = j_kg.evaluate_ranking(jnp.asarray(ranking), metrics,
                                 num_candidates=jnp.asarray(cand))
    got = kg.evaluate_ranking(torch.from_numpy(ranking), metrics,
                              num_candidates=torch.from_numpy(cand))
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=METRIC_TOL)


@pytest.mark.parametrize("V", [30, 200])
def test_toy_eval_ranking_matches_jax_on_its_draw(rng, V):
    """The ranking part on the indices JAX's own Gumbel top-k drew, with
    scores on a coarse grid so that ties (x.5 ranks) occur."""
    B = 12
    scores = np.round(rng.normal(size=(B, V)), 1).astype(np.float32)
    target = rng.integers(0, V, B)
    allowed = rng.uniform(size=(B, V)) < 0.7
    pos = scores[np.arange(B), target][:, None]
    key = jax.random.PRNGKey(11)
    want = j_kg.toy_eval_ranking(key, jnp.asarray(pos), jnp.asarray(scores),
                                 jnp.asarray(allowed))
    k = min(50, V)
    logits = jnp.where(jnp.asarray(allowed), 0.0, -jnp.inf)
    idx = jax.lax.top_k(logits + jax.random.gumbel(key, (B, V)), k)[1]
    got = kg.toy_eval_ranking(torch.from_numpy(pos), torch.from_numpy(scores),
                              torch.from_numpy(np.asarray(idx, np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() % 1 == 0.5).any()


@pytest.mark.parametrize("V", [30, 200])
def test_toy_eval_draw_properties(rng, V):
    """min(50, V) distinct candidates a row, all allowed where a row allows
    that many, the same draw from the same seed."""
    B = 64
    allowed = torch.from_numpy(rng.uniform(size=(B, V)) < 0.8)
    allowed[0] = False
    allowed[0, :3] = True  # a row with fewer allowed than samples
    draw = kg.toy_eval_negatives(torch.Generator().manual_seed(4), allowed)
    again = kg.toy_eval_negatives(torch.Generator().manual_seed(4), allowed)
    k = min(50, V)
    assert draw.shape == (B, k) and torch.equal(draw, again)
    for b in range(B):
        assert len(set(draw[b].tolist())) == k
        picked = allowed[b, draw[b]]
        assert picked.sum() == min(k, int(allowed[b].sum()))
    assert set(draw[0, :3].tolist()) == {0, 1, 2}
    if V > k:  # uniform: every allowed candidate is drawn somewhere
        counts = torch.zeros(V).index_add_(0, draw[1:].flatten(),
                                           torch.ones(draw[1:].numel()))
        assert (counts[allowed[1:].any(0)] > 0).all()


def test_toy_eval_end_to_end(inductive):
    """toy_eval through the task: float ranks in [1, 51] with 51
    candidates, the same metrics on a second run, finite metrics."""
    jtask, ttask, params, model = inductive
    tt = InductiveKGTask(ttask.dataset, ttask.model_cfg,
                         TaskConfig(metrics=DEFAULT_INDUCTIVE_METRICS,
                                    toy_eval=True), device="cpu")
    triples = tt.eval_triples("test")
    rank, cand = tt._run_eval(tt.eval_fn("test"), model, triples, BATCH)
    assert rank.dtype == np.float32 and (cand == 51).all()
    assert ((rank >= 1) & (rank <= 51)).all()
    got = tt.evaluate(model, "test", BATCH)
    assert got == tt.evaluate(model, "test", BATCH)
    assert all(math.isfinite(v) for v in got.values())
    want = jtask._metrics_from_rankings(rank, cand, None)
    assert_metrics_close(got, want)


def test_eval_batch_size_pins_the_batch(inductive):
    jtask, ttask, params, model = inductive
    seen = []
    tasks = {}
    for pinned in (3, 16):
        tt = InductiveKGTask(ttask.dataset, ttask.model_cfg,
                             TaskConfig(metrics=DEFAULT_INDUCTIVE_METRICS,
                                        eval_batch_size=pinned), device="cpu")
        fn = tt.eval_fn("test")
        tt._eval_fns = {k: (lambda m, b, g=None, fn=fn: seen.append(
            len(b)) or fn(m, b, g)) for k in tt._eval_fns}
        tasks[pinned] = tt.evaluate(model, "test", 64)
        assert set(seen) == {pinned}
        seen.clear()
    assert_metrics_close(tasks[3], tasks[16])
    unpinned = InductiveKGTask(ttask.dataset, ttask.model_cfg, device="cpu")
    assert unpinned._eval_batch_size(64) == 64


def test_inductive_dataset_is_the_jax_one():
    jds, tds = j_ind(), synthetic_inductive()
    assert isinstance(tds, InductiveDataset) and isinstance(jds, JInductive)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(tds, split), getattr(jds, split))
    assert tds.valid_graph is tds.test_graph
    assert isinstance(tds.test_graph, Graph)

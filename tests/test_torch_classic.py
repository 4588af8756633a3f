"""Classic NBFNet (PNA aggregation, distmult, dependent relations) in the
PyTorch port against the JAX package on the CPU: the converter, all-entity
and candidate scores, ``ClassicNBFNetTask`` rankings, one loss step's loss
and every parameter's gradient, and ``Engine`` training the classic task.
The model is the published NBFNet architecture cut to 2 layers of 8 on a
synthetic KG of 40 entities and 5 relations; weights come from the JAX
package's ``classic_nbfnet_init`` through ``load_jax_params``.

Tolerances, each with its reason:
  * scores: rtol = atol = 1e-4, as for whole ULTRA towers
    (test_torch_ultra.py): two stacked pna layers of sums, norms and
    matmuls in another order, with std = sqrt(clip(sq_mean - mean², 1e-6))
    amplifying the rounding of sq_mean - mean² by up to 500x near the clip;
  * loss and gradients against interpret-mode Pallas: rtol = atol = 1e-4,
    for the same reason; the max/min gradients follow the same
    every-tied-edge convention on both sides (XLA's differs, so the loss
    step is not compared with it);
  * rankings: equal, up to candidates within TIE_BAND of the target's score
    in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.models.classic_nbfnet import (
    classic_nbfnet_config as j_classic_cfg,
    classic_nbfnet_init as j_classic_init,
    classic_score_all as j_score_all,
)
from ultra_torchdrug_tpu.tasks.task import ClassicNBFNetTask as JTask
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.engine.engine import Engine
from ultra_torchdrug_tpu_torch.ops.match import (
    head_truth_mask,
    tail_truth_mask,
)
from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
    ClassicNBFNet,
    classic_nbfnet_config,
    classic_score_all,
)
from ultra_torchdrug_tpu_torch.tasks.task import ClassicNBFNetTask as TTask
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)
from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

NUM_ENT, NUM_EDGES, NUM_REL, DIM = 40, 300, 5, 8
TOL = dict(rtol=1e-4, atol=1e-4)
TIE_BAND = 1e-5
BATCH = 8


def _t(a, dtype=None):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _cfg_kw(aggregate="pna"):
    return dict(input_dim=DIM, hidden_dims=(DIM, DIM), num_relations=NUM_REL,
                aggregate_func=aggregate, layer_norm=True)


@pytest.fixture(scope="module")
def setup():
    jds = j_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0)
    tds = t_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0)
    jcfg, tcfg = j_classic_cfg(**_cfg_kw()), classic_nbfnet_config(**_cfg_kw())
    params = j_classic_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(ClassicNBFNet(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    return dict(jds=jds, tds=tds, jcfg=jcfg, tcfg=tcfg, params=params,
                model=model)


def test_converter_carries_the_classic_tree(setup):
    state = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, setup["params"]))
    assert set(state) == set(setup["model"].state_dict())
    assert {k.split(".")[0] for k in state} == {"layers", "query", "mlp"}
    assert state["layers.0.linear.weight"].shape == (DIM, 13 * DIM)
    assert state["layers.1.relation_linear.weight"].shape == (
        2 * NUM_REL * DIM, DIM)
    assert state["query.weight"].shape == (2 * NUM_REL, DIM)
    np.testing.assert_array_equal(
        state["mlp.layers.0.weight"].numpy(),
        np.asarray(setup["params"]["mlp"]["layers"][0]["w"]).T)
    for key, value in setup["model"].state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key].numpy())
    # a tree whose keys differ from the module's raises
    extra = dict(setup["params"], bogus={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(ClassicNBFNet(setup["tcfg"]), extra)
    missing = dict(setup["params"])
    del missing["query"]
    with pytest.raises(KeyError, match="query.weight"):
        load_jax_params(ClassicNBFNet(setup["tcfg"]), missing)


@pytest.mark.parametrize("aggregate", ["pna", "pna_nobound"])
def test_classic_score_all_matches_jax(setup, aggregate):
    s = setup
    jcfg = j_classic_cfg(**_cfg_kw(aggregate))
    params = j_classic_init(jax.random.PRNGKey(2), jcfg)
    model = load_jax_params(
        ClassicNBFNet(classic_nbfnet_config(**_cfg_kw(aggregate))),
        jax.tree_util.tree_map(np.asarray, params))
    jund = s["jds"].fact_graph(None)[0].undirected_with_inverse()
    tund = s["tds"].fact_graph(None)[0].undirected_with_inverse().prepare_csr()
    rng = np.random.default_rng(3)
    src = rng.integers(0, NUM_ENT, 4)
    rel = rng.integers(0, 2 * NUM_REL, 4)
    want = np.asarray(jax.jit(lambda p, h, r: j_score_all(p, jcfg, jund, h, r))(
        params, jnp.asarray(src), jnp.asarray(rel)))
    targets = rng.integers(0, NUM_ENT, (4, 6))
    with torch.no_grad():
        got = classic_score_all(model, tund, _t(src, np.int64),
                                _t(rel, np.int64))
        got_t = classic_score_all(model, tund, _t(src, np.int64),
                                  _t(rel, np.int64),
                                  targets=_t(targets, np.int64))
    assert got.shape == (4, NUM_ENT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_t.numpy(),
                               np.take_along_axis(want, targets, 1), **TOL)


def test_classic_task_rankings_match_jax(setup):
    """Filtered rankings of the test split through both tasks' eval
    functions (batch 8, a ragged last batch); a rank may differ only through
    candidates within TIE_BAND of the target in both packages."""
    s = setup
    jtask = JTask(s["jds"], s["jcfg"], JTaskConfig(eval_batch_size=BATCH))
    ttask = TTask(s["tds"], s["tcfg"], device="cpu")
    triples = s["tds"].test
    assert len(triples) % BATCH != 0
    jrank = np.asarray(jtask._run_eval(jtask._eval_fn, s["params"], triples,
                                       BATCH)[0])
    trank, _ = ttask._run_eval(ttask._eval_fn, s["model"], triples, BATCH)
    assert trank.shape == jrank.shape == (len(triples), 2)
    differ = np.nonzero((trank != jrank).any(axis=1))[0]
    if len(differ):
        tri = triples[differ]
        jund = jtask.fact_graph.undirected_with_inverse()
        j_sc = [np.asarray(j_score_all(s["params"], s["jcfg"], jund,
                                       jnp.asarray(tri[:, a]),
                                       jnp.asarray(tri[:, 2] + off)))
                for a, off in ((0, 0), (1, NUM_REL))]
        b = _t(tri, np.int64)
        tund = ttask._prepare_graphs(ttask.fact_graph, None)[0]
        with torch.no_grad():
            t_sc = [s_.numpy() for s_ in ttask._eval_scores(
                s["model"], ttask.fact_graph, None, b[:, 0], b[:, 1],
                b[:, 2], tund)]
        filt = ttask.graph.edge_list
        truth = (tail_truth_mask(filt, b[:, 0], b[:, 2], NUM_ENT).numpy(),
                 head_truth_mask(filt, b[:, 1], b[:, 2], NUM_ENT).numpy())
        for i in range(len(tri)):
            for col, target in ((0, tri[i, 1]), (1, tri[i, 0])):
                js, ts, tr = j_sc[col][i], t_sc[col][i], truth[col][i]
                flipped = np.nonzero(((js >= js[target]) & ~tr)
                                     != ((ts >= ts[target]) & ~tr))[0]
                gaps = [(js[v] - js[target], ts[v] - ts[target])
                        for v in flipped]
                assert all(abs(a) <= TIE_BAND and abs(c) <= TIE_BAND
                           for a, c in gaps), (differ[i], col, gaps)
    got = ttask.evaluate(s["model"], "test", BATCH)
    assert all(np.isfinite(v) for v in got.values())
    assert abs(got["mrr"] - float(np.mean(1.0 / trank))) < 1e-6


def test_loss_step_matches_jax_pallas(setup):
    """One loss step with injected negatives: the loss and every parameter's
    gradient against the JAX task on the fused Pallas pairs (interpret
    mode), which masks the batch's easy edges as the port does."""
    s = setup
    jcfg = dataclasses.replace(s["jcfg"], rspmm_impl="pallas")
    jtask = JTask(s["jds"], jcfg, JTaskConfig(num_negative=5))
    fact = jtask.fact_graph.prepare_join()
    fact_und, _ = jtask._prepare_graphs(fact, jtask.rel_graph)
    assert fact_und.layouts.fwd_blk is not None
    rng = np.random.default_rng(7)
    train = s["tds"].train
    batch = train[rng.choice(len(train), 6, replace=False)]
    neg = rng.integers(0, NUM_ENT, (6, 5)).astype(np.int32)

    def j_loss(params):
        scores = jtask._train_scores(
            params, fact, None, *(jnp.asarray(batch[:, i]) for i in range(3)),
            jnp.asarray(neg), fact_und)
        return j_criterion(jtask.cfg, scores)

    # jitted: one lowering of the interpret-mode kernels, not one per call
    want_loss, want_grads = jax.jit(jax.value_and_grad(j_loss))(s["params"])
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads))

    ttask = TTask(s["tds"], s["tcfg"], TaskConfig(num_negative=5),
                  device="cpu")
    model = s["model"]
    model.zero_grad(set_to_none=True)
    loss, metrics = ttask.loss_step(model, None, batch,
                                    neg=_t(neg, np.int64))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOL)
    assert any(p.grad.abs().sum() > 0 for p in got.values())
    model.zero_grad(set_to_none=True)


def test_engine_trains_the_classic_task():
    """Engine takes the classic task as it is: Adam at lr 5e-3 (the NBFNet
    FB15k-237 setting), strict negatives, finite metrics, every parameter
    moved; then evaluation."""
    tds = t_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0)
    task = TTask(tds, classic_nbfnet_config(**_cfg_kw()),
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

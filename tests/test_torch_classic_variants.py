"""Classic NBFNet's other messages and aggregations in the PyTorch port
against the JAX package on the CPU: the converter for every (distmult,
transe, rotate) x (sum, mean, max, pna, each also ``*_nobound``) tree (rotate
has the same keys; tests/test_torch_rotate.py holds its rows), all-entity
scores, one loss step's loss and every gradient against the JAX task on
interpret-mode Pallas for (distmult, max) and (transe, pna), and ``Engine``
training both. The rows are those of the NBFNet paper's ablation of message
and aggregation functions (Zhu et al., NeurIPS 2021), cut to 2 layers of 8
on a synthetic KG of 40 entities and 5 relations; weights come from the JAX
package's ``classic_nbfnet_init`` through ``load_jax_params``.

Tolerances, as in test_torch_classic.py and for the same reasons: scores,
the loss and gradients rtol = atol = 1e-4 (two stacked layers of sums,
norms and matmuls in another order; pna's std amplifies rounding near its
clip). The max gradients follow the every-tied-edge convention on both
sides, so the loss step is held against Pallas, not XLA.
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
AGGREGATIONS = [f"{base}{bound}" for base in ("sum", "mean", "max", "pna")
                for bound in ("", "_nobound")]


def _t(a, dtype=None):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _cfg_kw(message, aggregate):
    return dict(input_dim=DIM, hidden_dims=(DIM, DIM), num_relations=NUM_REL,
                message_func=message, aggregate_func=aggregate,
                layer_norm=True)


def _models(message, aggregate, seed=0):
    """(JAX config, JAX params, port model with the same weights)."""
    jcfg = j_classic_cfg(**_cfg_kw(message, aggregate))
    params = j_classic_init(jax.random.PRNGKey(seed), jcfg)
    model = load_jax_params(
        ClassicNBFNet(classic_nbfnet_config(**_cfg_kw(message, aggregate))),
        jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


@pytest.fixture(scope="module")
def datasets():
    return (j_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0),
            t_synth("SynthKG", NUM_ENT, NUM_EDGES, NUM_REL, seed=0))


@pytest.mark.parametrize("aggregate", AGGREGATIONS)
@pytest.mark.parametrize("message", ["distmult", "transe", "rotate"])
def test_converter_carries_every_tree(message, aggregate):
    """The linear is 2·D wide for sum, mean and max and 13·D for pna; the
    converted state equals the JAX tree leaf by leaf."""
    _, params, model = _models(message, aggregate)
    state = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            params))
    width = 13 if aggregate.startswith("pna") else 2
    assert state["layers.0.linear.weight"].shape == (DIM, width * DIM)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key].numpy())


@pytest.mark.parametrize("message,aggregate", [
    ("distmult", "max"), ("distmult", "mean"), ("distmult", "sum_nobound"),
    ("transe", "pna")])
def test_classic_score_all_matches_jax(datasets, message, aggregate):
    jds, tds = datasets
    jcfg, params, model = _models(message, aggregate, seed=2)
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
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("message,aggregate", [("distmult", "max"),
                                               ("transe", "pna")])
def test_loss_step_matches_jax_pallas(datasets, message, aggregate):
    """One loss step with injected negatives: the loss and every parameter's
    gradient against the JAX task on interpret-mode Pallas (max: the
    argext backward on the interleaved layouts; transe pna: the fused
    max+min pair and two transe sums, whose backward needs the
    relation-sorted layout, built here since the JAX classic task does not
    ask for it)."""
    jds, tds = datasets
    jcfg, params, model = _models(message, aggregate)
    jcfg = dataclasses.replace(jcfg, rspmm_impl="pallas")
    jtask = JTask(jds, jcfg, JTaskConfig(num_negative=5))
    fact = jtask.fact_graph.prepare_join()
    base = aggregate.replace("_nobound", "")
    kw = dict(interleave=8, bwd_block_rows=256) if base == "pna" else dict(
        interleave=8)
    fact_und = fact.undirected_with_inverse().prepare_pallas(
        include_rel_layout=message == "transe", **kw)
    assert fact_und.layouts.fwd_blk is not None
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

    ttask = TTask(tds, classic_nbfnet_config(**_cfg_kw(message, aggregate)),
                  TaskConfig(num_negative=5), device="cpu")
    loss, _ = ttask.loss_step(model, None, batch, neg=_t(neg, np.int64))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOL)
    assert all(p.grad.abs().sum() > 0 for p in got.values())


@pytest.mark.parametrize("message,aggregate", [("distmult", "max"),
                                               ("transe", "pna")])
def test_engine_trains_the_classic_variants(datasets, message, aggregate):
    """Engine takes each variant as it is: Adam at lr 5e-3, strict
    negatives, finite metrics, every parameter moved; then evaluation."""
    _, tds = datasets
    task = TTask(tds, classic_nbfnet_config(**_cfg_kw(message, aggregate)),
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

"""The port's relation-side options against the JAX package on the CPU, at
the sizes of tests/test_multi_rel_models.py (2x8 towers): several relation
towers (one per entity layer plus one), the shared relation model (one
[2R, D] for the batch, with a query relation that the batch repeats) and
the learned query, each alone, under ``micro_batch`` and under
``concat_hidden``; the same options built from a config; several towers
through the inductive and pre-training tasks; and the multi-tower
``.pth`` both ways with the JAX package's importer and exporter.

Tolerances: scores 1e-5 (fp32, sums in another order), the loss 1e-5
relative and every gradient 1e-4 norm-wise (‖a - b‖ / ‖b‖), as in
tests/test_torch_memory.py; the ``.pth`` round trips are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import JointDataset as JJoint
from ultra_torchdrug_tpu.data.datasets import synthetic_inductive as j_ind
from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.engine import build as j_build
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_eval
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.tasks.task import InductiveKGTask as JInductive
from ultra_torchdrug_tpu.tasks.task import MultiGraphPretrainTask as JPretrain
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu.utils import checkpoint as j_checkpoint
from ultra_torchdrug_tpu_torch.data.datasets import (
    JointDataset,
    synthetic_inductive,
    synthetic_transductive,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph
from ultra_torchdrug_tpu_torch.engine import build
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_apply_shared,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import (
    ultra_eval_scores,
    ultra_init as t_ultra_init,
    ultra_train_scores,
)
from ultra_torchdrug_tpu_torch.tasks.task import (
    InductiveKGTask,
    MultiGraphPretrainTask,
    TaskConfig,
)
from ultra_torchdrug_tpu_torch.utils import config
from ultra_torchdrug_tpu_torch.utils.checkpoint import (
    export_torch_checkpoint,
    import_torch_checkpoint,
)
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config/synthetic/smoke.yaml")
DIM, LAYERS, V, E, R = 8, 2, 22, 110, 4
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
VARIANTS = {
    "towers": dict(num_rel_models=LAYERS + 1),
    "shared": dict(rel_shared=True),
    "learn_query": dict(learn_query=True),
}
MODES = {"plain": {}, "micro_batch": dict(micro_batch=2),
         "concat_hidden": dict(concat_hidden=True)}


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _norm_err(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-12)).item()


def _configs(learn_query=False, entity=None, num_relations=R, **ultra):
    entity = entity or {}
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * LAYERS,
                         num_relations=2 * num_relations, **entity),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2,
                           learn_query=learn_query), **ultra)
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * LAYERS,
                         num_relations=2 * num_relations, **entity),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2,
                           learn_query=learn_query), **ultra)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def kg():
    """tests/test_multi_rel_models.py::setup's graph; 4 queries whose first
    two share their relation, 5 negatives each, a cotangent for the train
    scores."""
    rng = np.random.default_rng(0)
    tri = np.unique(np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                              rng.integers(0, R, E)], 1), axis=0)
    tri = tri.astype(np.int32)
    r0 = tri[0, 2]
    same = np.flatnonzero(tri[:, 2] == r0)[1]
    other = np.flatnonzero(tri[:, 2] != r0)[:2]
    pos = tri[[0, same, *other]]
    jg = JGraph.from_triplets(tri, V, R)
    tg = TGraph.from_triplets(tri, V, R)
    return dict(jg=jg, jrg=j_relgraph(jg), tg=tg,
                trg=build_relation_graph(tg), pos=pos,
                neg=rng.integers(0, V, (4, 5)).astype(np.int32),
                cot=rng.normal(size=(4, 6)).astype(np.float32))


def _models(variant, mode):
    jcfg, tcfg = _configs(entity=MODES[mode], **VARIANTS[variant])
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_scores_and_gradients_match_jax(kg, variant, mode):
    jcfg, params, model = _models(variant, mode)
    pos, neg, cot = kg["pos"], kg["neg"], kg["cot"]
    assert pos[0, 2] == pos[1, 2]  # a repeated query relation
    jq = [jnp.asarray(pos[:, i]) for i in range(3)]
    tq = [_t(pos[:, i], np.int64) for i in range(3)]
    want = jax.jit(lambda p, h, t, r: j_eval(p, jcfg, kg["jg"], kg["jrg"],
                                             h, t, r))(params, *jq)
    with torch.inference_mode():
        got = ultra_eval_scores(model, kg["tg"], kg["trg"], *tq)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCORE_TOL)

    def j_loss(p):
        s = j_train(p, jcfg, kg["jg"], kg["jrg"], *jq, jnp.asarray(neg))
        return (s * cot).sum(), s

    (want_loss, want_s), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(params)
    want_grads = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, j_grads))
    scores = ultra_train_scores(model, kg["tg"], kg["trg"], *tq,
                                _t(neg, np.int64))
    loss = (scores * _t(cot)).sum()
    names, ps = zip(*model.named_parameters())
    # a shared tower's learned query takes part in no score (JAX: zeros)
    grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_s),
                               **SCORE_TOL)
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * max(
        1.0, abs(float(want_loss)))
    assert set(names) == set(want_grads)
    for name, g in zip(names, grads):
        assert _norm_err(g, want_grads[name]) <= GRAD_RTOL, name
    if variant == "towers":
        # every tower receives gradient (test_multi_rel_models.py)
        for t in range(LAYERS + 1):
            assert sum(g.abs().sum().item() for n, g in zip(names, grads)
                       if n.startswith(f"rel_models.{t}.")) > 0, t


def test_shared_boundary_sets_repeated_relations_to_one(kg):
    """The shared tower marks the batch's relations with 1, a repeated one
    too: its output equals the output for the distinct relations."""
    _, tcfg = _configs(rel_shared=True)
    model = t_ultra_init(tcfg, seed=0, device="cpu")
    tower = model.rel_models[0].model
    with torch.inference_mode():
        rep = rel_nbfnet_apply_shared(tower, kg["trg"],
                                      torch.tensor([1, 1, 1, 3]))
        once = rel_nbfnet_apply_shared(tower, kg["trg"], torch.tensor([1, 3]))
    assert rep.shape == (2 * R, DIM)
    torch.testing.assert_close(rep, once, rtol=0, atol=0)


@pytest.mark.parametrize("edit", [
    lambda t: t["rel_models"].update(num_rel_models=LAYERS + 1),
    lambda t: t["rel_models"]["rel_model"].update(class_str="CustomNBFNet"),
    lambda t: t["rel_models"]["rel_model"].update(learn_query=True),
], ids=["num_rel_models", "CustomNBFNet", "learn_query"])
def test_options_build_from_a_config_and_train(tmp_path, edit):
    """Each option read from the smoke config as the JAX package reads it,
    then one epoch of training and an evaluation on the CPU."""
    cfg = config.load_config(SMOKE, context={"outdir": str(tmp_path)})[0]
    edit(cfg["task"])
    got = build.build_model_config(cfg["task"], 5)
    want = j_build.build_model_config(cfg["task"], 5)
    assert (got.num_rel_models, got.rel_shared, got.relation.learn_query) == (
        want.num_rel_models, want.rel_shared, want.relation.learn_query)
    dataset = build.build_dataset(cfg["dataset"])
    task = build.build_task(cfg["task"], dataset, device="cpu")
    engine = build.build_engine(cfg, task, work_dir=str(tmp_path))
    model = engine.model
    assert len(model.rel_models) == got.num_rel_models
    assert hasattr(model.rel_models[0].model, "learnable_q") == (
        got.relation.learn_query)
    before = [p.detach().clone() for p in model.parameters()]
    engine.train(batch_per_epoch=2)
    assert all(np.isfinite(m["loss"]) for m in engine.meter.last_window)
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    metrics = engine.evaluate("valid")
    assert 0 < metrics["mrr"] <= 1


@pytest.mark.parametrize("kind", ["inductive", "pretrain"])
def test_task_paths_take_several_towers(kind):
    """Three towers through InductiveKGTask (its train graph) and
    MultiGraphPretrainTask (each of two graphs): one loss step with
    injected negatives against the JAX task's loss on the same graph
    (1e-5 relative), every parameter receiving a finite gradient, and an
    evaluation through the task with finite metrics."""
    if kind == "inductive":
        jds, tds = j_ind(), synthetic_inductive()
        cls, jcls = InductiveKGTask, JInductive
    else:
        graphs = [("g0", 30, 200, 4), ("g1", 25, 150, 3)]
        jds = JJoint("joint", [j_synth(*g, seed=i)
                               for i, g in enumerate(graphs)])
        tds = JointDataset("joint", [synthetic_transductive(*g, seed=i)
                                     for i, g in enumerate(graphs)])
        cls, jcls = MultiGraphPretrainTask, JPretrain
    num_relations = (tds.num_relations if kind == "inductive"
                     else max(d.num_relations for d in tds.datasets))
    jcfg, tcfg = _configs(num_relations=num_relations,
                          num_rel_models=LAYERS + 1)
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    jtask = jcls(jds, jcfg, JTaskConfig(num_negative=5))
    ttask = cls(tds, tcfg, TaskConfig(num_negative=5, eval_batch_size=8),
                device="cpu")
    rng = np.random.default_rng(3)
    if kind == "inductive":
        steps = [((), ttask.train_triples, jds.train_graph,
                  jtask.rel_graphs["train"])]
    else:
        steps = [((gid,), ttask.train_triples[gid], jtask.fact_graphs[gid],
                  jtask.rel_graphs[gid]) for gid in range(2)]
    for gid, train, jfact, jrel in steps:
        batch = train[rng.choice(len(train), 4, replace=False)]
        neg = rng.integers(0, jfact.num_nodes, (4, 5))
        want = float(jax.jit(lambda p, b, n: j_criterion(jtask.cfg, j_train(
            p, jcfg, jfact, jrel.prepare_dense(), b[:, 0], b[:, 1], b[:, 2],
            n)))(params, jnp.asarray(batch), jnp.asarray(neg)))
        model.zero_grad(set_to_none=True)
        loss, _ = ttask.loss_step(model, None, batch, *gid,
                                  neg=torch.from_numpy(neg))
        loss.backward()
        assert abs(loss.item() - want) <= LOSS_RTOL * max(1.0, abs(want))
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    model.zero_grad(set_to_none=True)
    metrics = ttask.evaluate(model, "test", 8, fast_test=8)
    assert 0 < metrics["mrr"] <= 1 and np.isfinite(metrics["mr"])


@pytest.mark.parametrize("learn_query", [False, True])
def test_multi_tower_pth_round_trips_with_jax(tmp_path, learn_query):
    """tests/test_checkpoint.py's multi-tower round trip across the
    packages: the port's export read by the JAX importer, and the JAX
    export read by the port's importer, are the same weights bitwise. Like
    the JAX exporter, the port's writes no learned query, so that tensor
    keeps the template's value; a tower beyond the model's raises."""
    jcfg, tcfg = _configs(learn_query=learn_query,
                          num_rel_models=LAYERS + 1)
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    want = model.state_dict()
    port_pth = str(tmp_path / "port.pth")
    export_torch_checkpoint(port_pth, model)
    assert not any("learnable_q" in k for k in torch.load(port_pth)["model"])
    other = ultra_init(jax.random.PRNGKey(1), jcfg)
    back = jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, j_checkpoint.import_torch_checkpoint(port_pth, other)))
    template = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, other))
    for k, v in want.items():
        ref = template[k] if k.endswith("learnable_q.weight") else v
        assert torch.equal(back[k], ref), k

    jax_pth = str(tmp_path / "jax.pth")
    j_checkpoint.export_torch_checkpoint(jax_pth, params)
    fresh = t_ultra_init(tcfg, seed=1, device="cpu").state_dict()
    got = import_torch_checkpoint(jax_pth, fresh)
    for k, v in want.items():
        ref = fresh[k] if k.endswith("learnable_q.weight") else v
        assert torch.equal(got[k], ref), k

    _, one = _configs(learn_query=learn_query)
    with pytest.raises(ValueError, match="rel_models.1 but the model has 1"):
        import_torch_checkpoint(port_pth, Ultra(one).state_dict())


def test_tower_count_must_feed_every_layer(kg):
    """Several towers are one per entity layer plus one, as the JAX
    package asserts when it scores."""
    _, tcfg = _configs(num_rel_models=LAYERS)
    model = t_ultra_init(tcfg, seed=0, device="cpu")
    q = [_t(kg["pos"][:, i], np.int64) for i in range(3)]
    with pytest.raises(ValueError, match="2 relation representations for "
                       "2 layers: give 1 or 3"):
        ultra_eval_scores(model, kg["tg"], kg["trg"], *q)

"""ULTRA through the port's ring path on the CPU against the JAX package's
single-device ULTRA: a small model (2x8 towers) whose entity tower runs on
an edge mesh of 3 or 4 shards (``rspmm_impl="ring"``, ``ring_exchange=
"rdma"``, the ring's plain versions here) with the JAX weights carried
across by ``load_jax_params``; then the CLI on config/synthetic/smoke.yaml
with the ring keys written into a rendered copy.

The graph has 46 entities, so neither 3 nor 4 shards divide it: the block
domain has pad rows that a misplaced boundary or readout would rank.

Tolerances: tail and head scores 1e-5 absolute and relative; the loss 1e-5
relative; every gradient 1e-4 norm-wise (‖a - b‖ / ‖b‖), the sums of two
stacked layers being taken in another order (ring steps, CSR order,
segment_sum).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_scores
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train_scores
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch import run_full
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.engine import build
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.parallel import ring_rspmm as ring_mod
from ultra_torchdrug_tpu_torch.parallel.mesh import make_mesh, use_mesh
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig as TTaskConfig
from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask as TTask
from ultra_torchdrug_tpu_torch.utils import config
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic/smoke.yaml")
NUM_NODES, NUM_EDGES, NUM_REL, DIM = 46, 320, 5, 8
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
RING = dict(rspmm_impl="ring", edge_axis="edge", ring_exchange="rdma")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests: the ring and the
    partitioned path run many small operations, for which torch's thread
    pool costs more than it saves, and far more on a loaded machine (one
    plain K1 call at these sizes: about 0.1 ms on one thread, 1.5 ms to
    65 ms on eight beside other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jds = j_synth("SynthKG", NUM_NODES, NUM_EDGES, NUM_REL, seed=0)
    tds = t_synth("SynthKG", NUM_NODES, NUM_EDGES, NUM_REL, seed=0)
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM, DIM),
                         num_relations=2 * NUM_REL),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM, DIM),
                         num_relations=2 * NUM_REL, **RING),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    jfact, train = jds.fact_graph(None)
    jrel = j_relgraph(jfact).prepare_dense()
    rng = np.random.default_rng(3)
    batch = train[rng.choice(len(train), 6, replace=False)]
    neg = rng.integers(0, NUM_NODES, (6, 9)).astype(np.int32)
    test = jds.test[:8]
    # the JAX package's single-device scores, loss and gradients, each
    # jitted (one compilation, not one per operation)
    scores = jax.jit(lambda p: j_scores(
        p, jcfg, jfact, jrel, *(jnp.asarray(test[:, i]) for i in range(3))))(
            params)

    def j_loss(params):
        train_scores = j_train_scores(
            params, jcfg, jfact, jrel,
            *(jnp.asarray(batch[:, i]) for i in range(3)), jnp.asarray(neg))
        return j_criterion(JTaskConfig(), train_scores, None)

    loss, grads = jax.jit(jax.value_and_grad(j_loss))(params)
    return dict(tds=tds, tcfg=tcfg, model=model, batch=batch, neg=neg,
                test=test, scores=[np.asarray(a) for a in scores],
                loss=float(loss), grads=jax_params_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture
def ring_calls(monkeypatch):
    """The ring op's calls during the test."""
    calls = []
    real = ring_mod._RingRspmm.apply
    monkeypatch.setattr(ring_mod._RingRspmm, "apply",
                        lambda *a: calls.append(a[0]) or real(*a))
    return calls


def _ring_task(s, n):
    mesh = make_mesh(edge=n, device="cpu")
    with use_mesh(mesh):
        task = TTask(s["tds"], s["tcfg"], TTaskConfig(), device="cpu")
    return task, mesh


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("balanced", [False, True])
def test_ring_ultra_scores_match_jax_single_device(setup, ring_calls,
                                                   monkeypatch, n, balanced):
    """balanced: the relabelling forced on (the task asks for "auto", which
    this near-uniform graph does not need), so that the boundary and the
    readout go through to_new."""
    s = setup
    monkeypatch.setattr(ring_mod, "resolve_balance",
                        lambda *a: balanced)
    task, mesh = _ring_task(s, n)
    jt, jh = s["scores"]
    b = torch.from_numpy(s["test"].astype(np.int64))
    with use_mesh(mesh), torch.inference_mode():
        und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
        tt, th = task._eval_scores(s["model"], task.fact_graph, rel_graph,
                                   b[:, 0], b[:, 1], b[:, 2], und)
    ri = und.ring_inputs
    assert ri.n_shards == n and ri.permuted_io and ri.v_pad > NUM_NODES
    assert (ri.to_new is not None) == balanced
    # 2 layers x (tail + head), every one in the block domain
    assert len(ring_calls) == 4 and all(c is ri for c in ring_calls)
    assert tt.shape == th.shape == (8, NUM_NODES)
    np.testing.assert_allclose(tt.numpy(), jt, **SCORE_TOL)
    np.testing.assert_allclose(th.numpy(), jh, **SCORE_TOL)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("exchange", ["rdma", "ppermute"])
def test_ring_ultra_loss_and_gradients_match_jax(setup, ring_calls, n,
                                                 exchange):
    s = setup
    batch, neg = s["batch"], s["neg"]
    tcfg = s["tcfg"]
    tcfg = dataclasses.replace(tcfg, entity=dataclasses.replace(
        tcfg.entity, ring_exchange=exchange))
    task, mesh = _ring_task(dict(s, tcfg=tcfg), n)
    model = s["model"]
    model.zero_grad(set_to_none=True)
    with use_mesh(mesh):
        loss, _ = task.loss_step(model, None, batch,
                                 neg=torch.from_numpy(neg.astype(np.int64)))
        loss.backward()
    assert len(ring_calls) == 2  # 2 layers over the flipped batch
    np.testing.assert_allclose(loss.item(), s["loss"], rtol=1e-5, atol=0)
    got = dict(model.named_parameters())
    assert set(got) == set(s["grads"])
    for name, p in got.items():
        want = s["grads"][name]
        err = ((p.grad - want).norm() / want.norm().clamp(min=1e-12)).item()
        assert err <= 1e-4, (name, err)
    model.zero_grad(set_to_none=True)


def _ring_yaml(tmp_path, **extra):
    text = open(SMOKE).read().replace("{{ outdir }}", str(tmp_path))
    cfg = yaml.safe_load(text)
    cfg["parallel"] = {"edge": 4}
    cfg["rspmm_impl"] = "ring"
    cfg["task"]["model"]["ring_exchange"] = "rdma"
    cfg["train"]["num_epoch"] = 0
    cfg.update(extra)
    path = str(tmp_path / "smoke_ring.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_run_full_ring_cli_matches_the_single_device_run(tmp_path, ring_calls,
                                                         monkeypatch):
    """The ring keys in a rendered smoke.yaml build the edge mesh, thread
    edge_axis into the entity tower only, and with no training score and
    rank the triples as the port's single-device run on the same weights
    does (the single-device run's weights, saved and read back by
    ``checkpoint``). The untrained model scores some entities exactly alike
    (entities whose in-edges match), and summation order can split such a
    tie by one rounding step: a ring rank may differ from the single-device
    one only where the single-device scores tie the target within 1e-5, and
    only within that tie."""
    from ultra_torchdrug_tpu_torch.tasks import task as task_mod

    ranked = []  # (scores, target, truth mask, ranking) of every batch
    real = task_mod.filtered_ranking

    def spy(scores, target, truth, filtered=True):
        rank = real(scores, target, truth, filtered)
        ranked.append((scores, target, truth, rank))
        return rank

    monkeypatch.setattr(task_mod, "filtered_ranking", spy)
    cfg = config.load_config(SMOKE, context={"outdir": str(tmp_path)})[0]
    cfg["train"]["num_epoch"] = 0
    single = run_full.run(cfg, seed=1024, device="cpu")
    assert single.mesh is None and not ring_calls
    ckpt = str(tmp_path / "single.ckpt")
    single.save(ckpt)
    half = len(ranked)
    engine = run_full.main(["-c", _ring_yaml(tmp_path, checkpoint=ckpt),
                            "--device", "cpu"])
    assert engine.mesh is not None and engine.mesh.shape == {"data": 1,
                                                             "edge": 4}
    cfgm = engine.task.model_cfg
    assert cfgm.entity.edge_axis == "edge"
    assert cfgm.entity.rspmm_impl == "ring"
    assert cfgm.entity.ring_exchange == "rdma"
    assert cfgm.relation.edge_axis == ""
    assert ring_calls and all(c.n_shards == 4 for c in ring_calls)
    assert set(engine.metrics) == set(single.metrics) == {"valid", "test"}
    assert len(ranked) == 2 * half
    for (s0, target, truth, r0), (s1, _, _, r1) in zip(ranked[:half],
                                                       ranked[half:]):
        torch.testing.assert_close(s1, s0, **SCORE_TOL)
        pos = s0.gather(1, target[:, None])
        lo = ((s0 > pos + 1e-5) & ~truth).sum(-1) + 1
        hi = ((s0 >= pos - 1e-5) & ~truth).sum(-1) + 1
        assert torch.all((lo <= r1) & (r1 <= hi))
        assert torch.equal(r1[lo == hi], r0[lo == hi])


@pytest.mark.parametrize("edit,error,match", [
    # a data axis runs over processes: one process cannot hold two rows
    (lambda c: c.update(parallel={"data": 2, "edge": 2}),
     ValueError, "needs 2 processes"),
    # the edge-sharded relation tower, the partitioned path and the ring's
    # pna run: error None, their scores against the single-device task's
    pytest.param(lambda c: c.update(parallel={"edge": 4,
                                              "relation_edge": True}),
                 None, "relation_edge",
                 id="<lambda>-NotImplementedError-item 9_0"),
    pytest.param(lambda c: c.update(rspmm_impl="auto"), None, "partitioned",
                 id="<lambda>-NotImplementedError-partitioned path"),
    pytest.param(lambda c: c["task"]["model"].update(aggregate_func="pna"),
                 None, "pna", id="<lambda>-NotImplementedError-item 9_1"),
    (lambda c: c["task"]["model"].update(ring_exchange="nccl"), ValueError,
     "ring_exchange"),
    (lambda c: c.update(parallel={"edge": 4, "tensor": 2}), KeyError,
     "tensor"),
])
def test_ring_cli_raises_where_the_slice_does_not_reach(tmp_path, edit, error,
                                                        match):
    """The ring CLI's config with one edit: the edits the port does not
    take raise; the edge-sharded relation tower (the ring on the relation
    graph too), ``rspmm_impl: auto`` under the edge mesh (the partitioned
    path) and a pna entity tower on the ring build their task through
    ``mesh_scope`` and score 4 test triples as the single-device task on
    the same weights does (1e-5)."""
    cfg = yaml.safe_load(open(_ring_yaml(tmp_path)))
    edit(cfg)
    dataset = build.build_dataset(cfg["dataset"])

    def edge_task():
        with build.mesh_scope(cfg, "cpu") as (mesh, edge_axis,
                                              rel_edge_axis):
            return mesh, build.build_task(
                cfg["task"], dataset, rspmm_impl=cfg["rspmm_impl"],
                device="cpu", edge_axis=edge_axis,
                rel_edge_axis=rel_edge_axis)

    if error is not None:
        with pytest.raises(error, match=match):
            edge_task()
        return
    mesh, task = edge_task()
    single = build.build_task(cfg["task"], dataset, device="cpu")
    cfgm = task.model_cfg
    assert cfgm.entity.edge_axis == "edge"
    assert cfgm.relation.edge_axis == ("edge" if match == "relation_edge"
                                       else "")
    assert cfgm.entity.rspmm_impl == ("auto" if match == "partitioned"
                                      else "ring")
    single_model = single.init_params(seed=0)
    model = task.init_params(seed=0)
    model.load_state_dict(single_model.state_dict())
    b = torch.from_numpy(dataset.test[:4].astype(np.int64))
    scores = []
    for t, m, scope in ((task, model, use_mesh(mesh)),
                        (single, single_model, use_mesh(None))):
        with scope, torch.inference_mode():
            und, rel = t._prepare_graphs(t.fact_graph, t.rel_graph)
            scores.append(t._eval_scores(m, t.fact_graph, rel, b[:, 0],
                                         b[:, 1], b[:, 2], und))
    assert (und.ring_inputs, und.part_layouts) == (None, None)
    for got, want in zip(*scores):
        torch.testing.assert_close(got, want, **SCORE_TOL)

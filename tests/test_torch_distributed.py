"""The port's data parallelism (parallel/distributed.py, the data axis of
parallel/mesh.py, the engine's step and the eval gather) on the CPU.

In one process: ``shard_eval_triples`` and ``invert_round_robin`` against
the JAX package's (pure numpy; JAX's process count monkeypatched), the
backend rule, and the raises for a data axis that is not the world size and
for a batch that does not divide over it. In 2 gloo processes through
tests/torch_mp_worker.py (each run with a timeout of its own): the
13-triple eval gather; 3 AdamW steps of a 2x8 ULTRA with ``parallel:
{data: 2}`` against one process (losses within 1e-5 relative, the first
update's all-reduced gradients, the gradient norms and the parameters
within 1e-4, test rankings at the initial weights equal); the same on
data 2 x edge 2 (the ring, two edge shards a rank); one rank raising an
out-of-memory error in its first backward, in its first update after the
gradient all-reduce and in an evaluation, after which both ranks end at
demotion level 3 with the single process's parameters and metrics, and
nothing hangs; and one step on 2 ranks against the JAX package's step on
one device with the same weights, batch and negatives (the JAX package's
multi-process step equals its one-device step, tests/mp_worker_train.py).
In one process: a rank's rows
of a batch (``loss_step(..., rows=)``) give losses and gradients whose
mean over the ranks is the whole batch's, for each criterion, with and
without sample weights.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mp_worker as worker
from test_torch_inductive import assert_rankings_match
from ultra_torchdrug_tpu.parallel import distributed as j_dist
from ultra_torchdrug_tpu_torch.parallel import distributed, mesh
from ultra_torchdrug_tpu_torch.engine.engine import Engine

WORKER = os.path.abspath(worker.__file__)
REPO = worker.REPO
TIMEOUT = 120  # seconds, each run of the worker's processes
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 7, 13])
def test_shard_and_invert_match_jax(monkeypatch, P, n):
    rng = np.random.default_rng(n)
    triples = rng.integers(0, 50, (n, 3)).astype(np.int32)
    monkeypatch.setattr(jax, "process_count", lambda: P)
    shards = []
    for p in range(P):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        got = distributed.shard_eval_triples(triples, num_processes=P,
                                             index=p)
        np.testing.assert_array_equal(got, j_dist.shard_eval_triples(triples))
        shards.append(got)
    flat = np.concatenate(shards) if shards else triples
    got = distributed.invert_round_robin(flat, P)
    np.testing.assert_array_equal(got, j_dist.invert_round_robin(flat, P))
    np.testing.assert_array_equal(got[:n], triples)


def test_one_process_is_a_no_op():
    assert not distributed.initialize_distributed(world_size=1)
    assert (distributed.process_count(), distributed.process_index()) == (
        1, 0)
    x = np.arange(5)
    assert distributed.gather_rankings(x, 5) is x
    assert distributed.reduce_metrics_mean({"a": 1.0}) == {"a": 1.0}
    t = [torch.ones(3)]
    assert distributed.all_reduce_mean(t)[0] is t[0]
    assert distributed.any_rank(True) and not distributed.any_rank(False)


@pytest.mark.parametrize("device,local,local_world,count,want", [
    ("cpu", 1, 2, 0, ("gloo", "cpu")),
    ("cuda", 1, 2, 2, ("nccl", "cuda:1")),
    ("cuda", 3, 4, 8, ("nccl", "cuda:3")),
    ("cuda", 1, 2, 1, ("gloo", "cuda:0")),  # two ranks share the one card
    ("cuda", 3, 4, 2, ("gloo", "cuda:1")),
    ("cuda:0", 1, 4, 4, ("gloo", "cuda:0")),  # every rank names card 0
])
def test_backend_rule(device, local, local_world, count, want):
    backend, dev = distributed.backend_rule(device, local, local_world,
                                            cuda_count=count)
    assert (backend, str(dev)) == want


def test_a_data_axis_must_be_the_world_size():
    with pytest.raises(ValueError, match="a data axis of 2 needs 2 "
                       "processes.*group has 1: launch `torchrun "
                       "--nproc_per_node 2 -m ultra_torchdrug_tpu_torch"):
        mesh.make_mesh(data=2, device="cpu")


def test_a_batch_must_divide_over_the_data_axis(tmp_path):
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_task,
    )

    cfg = worker.train_config()
    task = build_task(cfg["task"], build_dataset(cfg["dataset"]),
                      device="cpu")
    two_rows = mesh.Mesh(data=2, edge=1, devices=(torch.device("cpu"),))
    with pytest.raises(ValueError, match="batch_size 7 does not divide over "
                       "the data axis of 2"):
        Engine(task, batch_size=7, work_dir=str(tmp_path), mesh=two_rows)


@pytest.mark.parametrize("model,criterion,sample_weight", [
    ("ultra", "bce", True), ("ultra", "ce", False),
    ("ultra", "ranking", True), ("classic pna", "bce", False)])
def test_rank_rows_average_to_the_batch(model, criterion, sample_weight):
    """The loss and gradients of P = 2 ranks' rows, averaged, are the whole
    batch's (the engine's all-reduce mean), with the same negatives; for
    ULTRA and for classic NBFNet (pna, K6 and K7 on the card)."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_task,
        build_task_config,
    )
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.tasks.task import ClassicNBFNetTask

    cfg = worker.train_config()
    cfg["task"].update(criterion=criterion, sample_weight=sample_weight)
    dataset = build_dataset(cfg["dataset"])
    if model == "ultra":
        task = build_task(cfg["task"], dataset, device="cpu")
    else:
        task = ClassicNBFNetTask(
            dataset, classic_nbfnet_config(
                input_dim=8, hidden_dims=(8, 8),
                num_relations=dataset.num_relations),
            build_task_config(cfg["task"]), device="cpu")
    model = task.init_params(seed=0)
    batch = task.train_triples[:8]
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_grads(rows):
        g = torch.Generator().manual_seed(3)
        loss, _ = task.loss_step(model, g, batch, rows=rows)
        return loss, torch.autograd.grad(loss, params, allow_unused=True,
                                         materialize_grads=True)

    want_loss, want = loss_grads(None)
    parts = [loss_grads(slice(0, 4)), loss_grads(slice(4, 8))]
    torch.testing.assert_close((parts[0][0] + parts[1][0]) / 2, want_loss,
                               rtol=1e-6, atol=0)
    for a, b, w in zip(parts[0][1], parts[1][1], want):
        torch.testing.assert_close((a + b) / 2, w, rtol=1e-5, atol=1e-7)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(case, tmp_path, world=2):
    """Run ``case`` on ``world`` ranks; returns what each rank wrote."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"MP_OK {r}" in out, \
            f"rank {r} failed:\n{out}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_two_rank_eval_gather(tmp_path):
    ranks = run_ranks("gather", tmp_path)
    np.testing.assert_array_equal(ranks[0]["gathered"], ranks[1]["gathered"])


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """One process's run of the worker's config."""
    return worker.run_training(worker.train_config(),
                               str(tmp_path_factory.mktemp("single")))


def _norm_close(got, want, what):
    diff = (got - want).norm()
    assert diff <= PARAM_RTOL * max(want.norm(), 1e-12), (what, diff)


def _close_to_single(got, single, loss_rtol=LOSS_RTOL):
    np.testing.assert_allclose(got["losses"], single["losses"],
                               rtol=loss_rtol)
    assert len(got["losses"]) == worker.STEPS
    # the mean over the ranks, not their sum: one process's gradients
    _norm_close(got["grads"], single["grads"], "first update's gradients")
    np.testing.assert_allclose(got["grad_norms"], single["grad_norms"],
                               rtol=PARAM_RTOL)
    assert got["params"].keys() == single["params"].keys()
    for k, want in single["params"].items():
        diff = (got["params"][k] - want).norm()
        assert diff <= PARAM_RTOL * max(want.norm(), 1e-12), (k, diff)


def _ring_scores(work_dir):
    """A ``scores`` function for ``assert_rankings_match``: the initial
    weights' (tail, head) scores on one device and on a 2-shard ring in
    this process (the ring sums in another order, so near-ties may
    rank apart)."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
        mesh_scope,
    )

    runs = []
    for cfg in (worker.train_config(), worker.train_config(edge=2)):
        dataset = build_dataset(cfg["dataset"])
        with mesh_scope(cfg, "cpu") as (m, edge_axis, _):
            task = build_task(cfg["task"], dataset,
                              rspmm_impl=cfg.get("rspmm_impl", "auto"),
                              seed=0, device="cpu", edge_axis=edge_axis)
            model = build_engine(cfg, task, work_dir=str(work_dir), seed=0,
                                 mesh=m).model
            und, rel = task._prepare_graphs(task.fact_graph, task.rel_graph)
        runs.append((task, model, und, rel, m))

    def scores(chunk):
        out = []
        b = torch.from_numpy(chunk.astype(np.int64))
        for task, model, und, rel, m in runs:
            with mesh.use_mesh(m), torch.inference_mode():
                out.append(tuple(s.numpy() for s in task._eval_scores(
                    model, task.fact_graph, rel, b[:, 0], b[:, 1], b[:, 2],
                    und)))
        return out

    task = runs[0][0]
    return task, scores


@pytest.mark.parametrize("case", ["train", "composed", "oom"])
def test_two_ranks_take_one_process_steps(tmp_path, single, case):
    """Every rank ends with the parameters one process ends with; the
    rankings at the initial weights are one process's (the same weights:
    every tie resolves alike, so equal; on the ring equal but where
    candidates tie the target within 1e-5 on both routes)."""
    ranks = run_ranks(case, tmp_path)
    for r, got in enumerate(ranks):
        _close_to_single(got, single)
        if case == "composed":
            task, scores = _ring_scores(tmp_path)
            assert_rankings_match(
                single["ranking"].numpy(), got["ranking"].numpy(),
                task.dataset.test, scores, task.graph.edge_list,
                task.dataset.num_entities)
        else:
            torch.testing.assert_close(got["ranking"], single["ranking"],
                                       rtol=0, atol=0)
        torch.testing.assert_close(got["num_candidates"],
                                   single["num_candidates"], rtol=0, atol=0)
        assert got["demotion"] == (3 if case == "oom" else 0), (r, got)
        if case != "composed":  # the ring's near-ties may flip a rank
            assert got["mrr"] == pytest.approx(single["mrr"], rel=1e-4)
    # every rank computes the metrics from the whole gathered ranking
    assert ranks[0]["mrr"] == ranks[1]["mrr"] and 0 < ranks[0]["mrr"] <= 1
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k


def test_two_rank_step_matches_jax(tmp_path):
    """One engine step on 2 ranks against the JAX package's single-device
    step (jax.grad of its ULTRA loss, optax.adamw) on the same weights,
    batch and strict-negative draws: the reduced gradients and the
    parameters after the step within 1e-4 norm-wise, the logged loss within
    1e-5 and the gradient norm within 1e-4 relative."""
    import jax.numpy as jnp
    import optax

    from test_torch_train import NUM_REL, _configs
    from ultra_torchdrug_tpu.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu.data.relgraph import build_relation_graph
    from ultra_torchdrug_tpu.models.ultra import ultra_init
    from ultra_torchdrug_tpu.models.ultra import ultra_train_scores
    from ultra_torchdrug_tpu.tasks.task import TaskConfig, _criterion_loss
    from ultra_torchdrug_tpu_torch.utils.convert import (
        jax_params_to_state_dict,
    )

    cfg = worker.train_config()
    jcfg, _ = _configs()
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    fact, train = synthetic_transductive(
        "SynthKG", 40, 300, NUM_REL, seed=0).fact_graph(None)
    rng = np.random.default_rng(3)
    batch = train[rng.choice(len(train), worker.BATCH, replace=False)]
    neg = rng.integers(0, 40, (worker.BATCH, cfg["task"]["num_negative"]))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    torch.save({"state_dict": jax_params_to_state_dict(to_np(params)),
                "batch": torch.from_numpy(np.asarray(batch)),
                "neg": torch.from_numpy(neg)}, tmp_path / "inputs.pt")
    ranks = run_ranks("step", tmp_path)

    task_cfg = TaskConfig(num_negative=cfg["task"]["num_negative"],
                          adversarial_temperature=0.0)
    rel = build_relation_graph(fact).prepare_dense()

    def loss_fn(p):
        scores = ultra_train_scores(p, jcfg, fact, rel,
                                    *(jnp.asarray(batch[:, i])
                                      for i in range(3)), jnp.asarray(neg))
        return _criterion_loss(task_cfg, scores)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adamw(cfg["optimizer"]["lr"], weight_decay=0.01)
    updates, _ = tx.update(grads, tx.init(params), params)
    want_grads = jax_params_to_state_dict(to_np(grads))
    want_params = jax_params_to_state_dict(
        to_np(optax.apply_updates(params, updates)))
    for got in ranks:
        assert got["grads"].keys() == want_grads.keys()
        for k, want in want_grads.items():
            _norm_close(got["grads"][k], torch.as_tensor(want), k)
            _norm_close(got["params"][k], torch.as_tensor(want_params[k]), k)
        assert got["loss"] == pytest.approx(float(loss), rel=LOSS_RTOL)
        assert got["grad_norm"] == pytest.approx(
            float(optax.global_norm(grads)), rel=PARAM_RTOL)

"""One rank of the port's data-parallel tests
(tests/test_torch_distributed.py), a gloo process group on the CPU:

    python tests/torch_mp_worker.py CASE RANK WORLD PORT OUT

CASE is one of
  * gather: the eval choreography on 13 triples (shard_eval_triples, a
    ranking computed per shard, gather_rankings restoring the order and
    dropping the padding, reduce_metrics_mean), as tests/mp_worker.py runs
    the JAX package's;
  * train: a 2x8 ULTRA built from a config with ``parallel: {data: WORLD}``
    through the port's builders: the test rankings at the initial weights
    (round-robin shards, gathered), then STEPS AdamW steps;
  * composed: the same with ``parallel: {data: WORLD, edge: 2}`` and
    ``rspmm_impl: ring`` (each rank's two edge shards on its CPU);
  * oom: ``train`` with rank 1's first backward, then its first update
    after the gradient all-reduce, then its first scoring of the final
    evaluation, raising an out-of-memory error once each;
  * step: one step of the engine on the weights, batch and negatives of
    OUT/inputs.pt, which the test also takes through the JAX package.
The rank writes what it got to OUT/rank{RANK}.pt and prints "MP_OK RANK".
The module's config and ``run_training`` also give the test its
single-process reference.
"""

import contextlib
import functools
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

STEPS = 3
BATCH = 8
EVAL_BATCH = 4
FAKE_OOM = RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                        "allocate 1.00GiB (injected)")


def train_config(data: int = 1, edge: int = 1) -> dict:
    """SynthKG and a 2x8 ULTRA at batch BATCH x 8 strict negatives."""
    cfg = {
        "dataset": {"class": "SynthKG", "num_nodes": 40, "num_edges": 300,
                    "num_relations": 5},
        "task": {
            "class": "KnowledgeGraphCompletion",
            "model": {"input_dim": 8, "hidden_dims": [8, 8],
                      "ring_exchange": "rdma"},
            "rel_models": {"rel_model": {"input_dim": 8, "hidden": 8,
                                         "num_layers": 2}},
            "num_negative": 8,
            "strict_negative": True,
            "eval_batch_size": EVAL_BATCH,
        },
        "optimizer": {"class": "AdamW", "lr": 5e-3},
        "engine": {"batch_size": BATCH, "log_interval": 10**9},
    }
    if data > 1 or edge > 1:
        cfg["parallel"] = {"data": data, "edge": edge}
    if edge > 1:
        cfg["rspmm_impl"] = "ring"
    return cfg


def run_training(cfg: dict, work_dir: str, fail_rank=None) -> dict:
    """Build the run of ``cfg`` on the CPU, rank the test triples at the
    initial weights, train STEPS steps; returns the rankings, the logged
    losses and gradient norms, the first update's gradients (mean-reduced
    over the ranks), the parameters and the demotion level."""
    import torch

    from ultra_torchdrug_tpu_torch.engine import engine as engine_mod
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
        mesh_scope,
    )
    from ultra_torchdrug_tpu_torch.parallel import distributed

    os.makedirs(work_dir, exist_ok=True)
    dataset = build_dataset(cfg["dataset"])
    with mesh_scope(cfg, "cpu") as (mesh, edge_axis, rel_edge_axis):
        task = build_task(cfg["task"], dataset,
                          rspmm_impl=cfg.get("rspmm_impl", "auto"), seed=0,
                          device="cpu", edge_axis=edge_axis,
                          rel_edge_axis=rel_edge_axis)
        engine = build_engine(cfg, task, work_dir=work_dir, seed=0,
                              mesh=mesh)
        ranking, cand = task._run_eval(task._eval_fn, engine.model,
                                       dataset.test, EVAL_BATCH)
        if fail_rank is not None and distributed.process_index() == fail_rank:
            real, inner = engine_mod.Engine._grads, engine.optimizer.inner.step
            state = {"grads": False, "update": False}

            def failing(self, graph_id, batch):
                if not state["grads"]:
                    state["grads"] = True
                    raise FAKE_OOM
                return real(self, graph_id, batch)

            def failing_update(*args, **kwargs):
                if not state["update"]:
                    state["update"] = True
                    raise FAKE_OOM
                return inner(*args, **kwargs)

            engine._grads = failing.__get__(engine)
            engine.optimizer.inner.step = failing_update
        with record_reduced() as reduced:
            engine.train(num_epoch=1, batch_per_epoch=STEPS)
        if fail_rank is not None and distributed.process_index() == fail_rank:
            # and once in the evaluation: every rank demotes again
            score, state = task._score_triples, {"failed": False}

            def failing_eval(*args):
                if not state["failed"]:
                    state["failed"] = True
                    raise FAKE_OOM
                return score(*args)

            task._score_triples = failing_eval
        metrics = engine.evaluate("test")
    return {"ranking": torch.from_numpy(ranking),
            "num_candidates": torch.from_numpy(cand),
            "losses": [m["loss"] for m in engine.meter.last_window],
            "grad_norms": [m["grad_norm"]
                           for m in engine.meter.last_window],
            "grads": reduced[0],
            "params": {k: v.detach().clone()
                       for k, v in engine.model.state_dict().items()},
            "demotion": task._policy_demotion,
            "mrr": metrics["mrr"]}


@contextlib.contextmanager
def record_reduced():
    """Yield a list that collects every flat gradient buffer the optimizer
    applies, as ``distributed.all_reduce_mean`` returns it."""
    from ultra_torchdrug_tpu_torch.parallel import distributed

    real, got = distributed.all_reduce_mean, []

    def recording(flat):
        flat = real(flat)
        got.append(flat.detach().clone())
        return flat

    distributed.all_reduce_mean = recording
    try:
        yield got
    finally:
        distributed.all_reduce_mean = real


def step_case(out_dir: str, world: int) -> dict:
    """One engine step of ``train_config(data=world)`` on the weights, the
    batch and the negatives of OUT/inputs.pt; returns the update's reduced
    gradients, the logged loss and gradient norm, and the parameters."""
    import torch

    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
        mesh_scope,
    )

    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    cfg = train_config(data=world)
    dataset = build_dataset(cfg["dataset"])
    with mesh_scope(cfg, "cpu") as (mesh, edge_axis, rel_edge_axis):
        task = build_task(cfg["task"], dataset, seed=0, device="cpu",
                          edge_axis=edge_axis, rel_edge_axis=rel_edge_axis)
        engine = build_engine(cfg, task, work_dir=out_dir, seed=0,
                              mesh=mesh)
        engine.model.load_state_dict(inputs["state_dict"])
        task.loss_step = functools.partial(task.loss_step,
                                           neg=inputs["neg"])
        with record_reduced() as reduced:
            engine.meter.update(engine._run_step(0, inputs["batch"].numpy()))
        engine.meter.log_window()
    names = [n for n, p in engine.model.named_parameters()
             if p.requires_grad]
    grads, lo = {}, 0
    for n in names:
        p = engine.model.get_parameter(n)
        grads[n] = reduced[0][lo:lo + p.numel()].view_as(p)
        lo += p.numel()
    window = engine.meter.last_window[0]
    return {"grads": grads, "loss": window["loss"],
            "grad_norm": window["grad_norm"],
            "params": {n: p.detach().clone()
                       for n, p in engine.model.named_parameters()}}


def gather_case(out: dict) -> None:
    import numpy as np

    from ultra_torchdrug_tpu_torch.parallel import distributed as dist

    P, pid = dist.process_count(), dist.process_index()
    N = 13  # odd on purpose: the pad-to-multiple path
    rng = np.random.default_rng(0)  # the same on every rank
    triples = np.stack([rng.integers(0, 50, N), rng.integers(0, 50, N),
                        rng.integers(0, 7, N)], 1).astype(np.int32)
    shard = dist.shard_eval_triples(triples)
    assert len(shard) == -(-N // P)

    def rank_of(t):
        return (t[:, 0] * 1000 + t[:, 1] * 10 + t[:, 2]).astype(np.float32)

    gathered = dist.gather_rankings(rank_of(shard), total=N)
    assert np.array_equal(gathered, rank_of(triples)), gathered
    metrics = dist.reduce_metrics_mean({"mrr": float(pid), "hits": 2.0 * pid})
    assert abs(metrics["mrr"] - (P - 1) / 2) < 1e-12, metrics
    assert abs(metrics["hits"] - (P - 1)) < 1e-12, metrics
    assert dist.any_rank(pid == P - 1) and not dist.any_rank(False)
    out.update(gathered=gathered, metrics=metrics)


def main():
    case, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(2)
    from ultra_torchdrug_tpu_torch.parallel import distributed

    assert distributed.initialize_distributed(
        world_size=world, rank=rank, init_method=f"tcp://localhost:{port}",
        device="cpu")
    out = {}
    if case == "gather":
        gather_case(out)
    elif case == "step":
        out = step_case(out_dir, world)
    else:
        cfg = train_config(data=world, edge=2 if case == "composed" else 1)
        out = run_training(cfg, os.path.join(out_dir, "work"),
                           fail_rank=1 if case == "oom" else None)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()
    print(f"MP_OK {rank}", flush=True)


if __name__ == "__main__":
    main()

"""Training through ``Engine.train``: the engine, its model and optimizer
built once; its first ``checked_steps`` steps taken in set-up through the
window's own call on rows that all differ (one epoch of a permutation), and
the same engine then trained in calls of ``steps_per_call`` steps until the
window has closed. A multi-graph mix draws each call's graphs from the
task's mixture; set-up also steps until every graph has had its first
(fail-soft) step.

The first steps' batches, negatives and losses are kept as the program
made them (the negatives as its sampler drew them), with the optimizer's
first moments after step 1 (the first gradient as the optimizer got it)
and the parameters after the checked steps. Once the window has closed
and the program is freed, the reference follows the checked steps from
the same weights with its own optimizer and judges them.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from ..lib import check, kg, program, runtime, seeds, trace, weights
from ..lib.work import Work, kg_shapes
from ..reference import common
from ..reference.train import follow_steps


class FirstSteps:
    """Keeps what the engine's first ``n`` steps used and produced, by
    wrapping the task's ``loss_step`` and the sampler it calls."""

    def __init__(self, engine, task_module, n: int):
        self.engine, self.n = engine, n
        self.batches, self.graph_ids, self.negs, self.losses = [], [], [], []
        self.first_moments = None
        task, opt = engine.task, engine.optimizer
        inner_loss, inner_neg = task.loss_step, task_module.strict_negatives
        self._restore = [(task_module, "strict_negatives", inner_neg)]
        self._task = task

        def sampler(*args, **kwargs):
            neg = inner_neg(*args, **kwargs)
            if len(self.negs) < len(self.batches) <= self.n:
                self.negs.append(neg)
            return neg

        def loss_step(model, generator, batch, *args, **kwargs):
            if len(self.batches) == 1 and self.first_moments is None:
                # the start of step 2: the optimizer's state after step 1
                # (an optimizer that holds none got a gradient of 0)
                self.first_moments = [
                    opt.inner.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)).clone()
                    for p in opt.params]
            if len(self.batches) < self.n:
                self.batches.append(np.array(batch))
                self.graph_ids.append(args[0] if args else 0)
                loss, metrics = inner_loss(model, generator, batch, *args,
                                           **kwargs)
                self.losses.append(loss.detach())
                return loss, metrics
            return inner_loss(model, generator, batch, *args, **kwargs)

        task.loss_step = loss_step
        task_module.strict_negatives = sampler

    def close(self):
        del self._task.loss_step
        for owner, attr, original in self._restore:
            setattr(owner, attr, original)


def build(cell, run, graphs):
    """(task, engine) of the cell on ``graphs``; several graphs make the
    pre-training mixture (``MultiGraphPretrainTask``)."""
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.parallel import mesh
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    cfg, fam, tr = cell.config, cell.family, cell.traffic
    # a mix that names a ``mixture_seed`` draws the engine's graphs and
    # batch rows from it, whatever the run's seed: every seed then trains
    # the same sequence of graphs (the same work), on its own graphs
    task = fam.build_task(cfg, [program.dataset(g, f"g{i}")
                                for i, g in enumerate(graphs)], run.device)
    grid = mesh.make_mesh(data=run.world, device=run.device) \
        if run.world > 1 else None
    # the configuration's batch a chip: a cell on several chips takes it on
    # each (one process of such a cell, as the control runs it, takes all)
    seed = seeds.derive(tr.get("mixture_seed", run.seed), "engine")
    engine = Engine(task, batch_size=cfg["engine"]["batch_size"] * cell.chips,
                    optimizer=cfg["optimizer"]["class"],
                    lr=cfg["optimizer"]["lr"], seed=seed,
                    log_interval=10 ** 9, logger=get_root_logger(None),
                    mesh=grid)
    return task, engine


def checked_steps(cell: runtime.Cell, run: runtime.Run, stages=None):
    """Set-up up to the window: the graphs, the engine with the run's
    weights, and its first ``checked_steps`` steps kept. Returns (graphs,
    weights, engine, kept)."""
    from ultra_torchdrug_tpu_torch.tasks import task as task_mod

    cfg, tr, fam, dev = cell.config, cell.traffic, cell.family, run.device
    stages = stages or runtime.Stages(run.t_start)
    graphs = [kg.skewed_kg(g, run.seed, i) for i, g in enumerate(tr["graphs"])]
    stages.mark("graphs")
    _, engine = build(cell, run, graphs)
    stages.mark("task and engine", dev)
    R = max(g["relations"] for g in graphs)
    params = weights.draw(fam.param_specs(fam.model_dims(cfg), R), run.seed,
                          dev)
    engine.model.load_state_dict(params, strict=True)
    stages.mark("weights", dev)
    names = [n for n, p in engine.model.named_parameters() if p.requires_grad]
    first = FirstSteps(engine, task_mod, tr["checked_steps"])
    engine.train(1, batch_per_epoch=tr["checked_steps"])
    first.close()
    losses = torch.stack(first.losses)
    if run.world > 1:  # each rank's loss is its rows'; the batch's is the mean
        from ultra_torchdrug_tpu_torch.parallel import distributed

        losses = distributed.mean_over_ranks(losses)
    kept = {
        "batches": first.batches, "graph_ids": first.graph_ids,
        "negs": [n.detach() for n in first.negs],
        "losses": losses.tolist(),
        "grads": {n: m / (1 - 0.9)
                  for n, m in zip(names, first.first_moments)},
        "after": {n: p.detach().clone() for n, p in
                  zip(names, engine.optimizer.params)},
    }
    stages.mark("checked steps", dev)
    return graphs, params, engine, kept


def run(cell: runtime.Cell, run: runtime.Run) -> dict:
    tr, dev = cell.traffic, run.device
    stages = runtime.Stages(run.t_start)
    import ultra_torchdrug_tpu_torch  # noqa: F401
    stages.mark("imports")
    graphs, params, engine, kept = checked_steps(cell, run, stages)
    warm = 0
    while len(engine._warmed) < len(graphs) and warm < tr["warm_calls_max"]:
        engine.train(1, batch_per_epoch=1)
        warm += 1
    stages.mark(f"{warm} warm steps", dev)
    setup_s = runtime.since(run.t_start)
    print(stages.line(), file=sys.stderr)

    K, B = tr["steps_per_call"], engine.batch_size
    setup_peak = runtime.peak_bytes(dev)
    runtime.reset_peak(dev)
    steps, losses = 0, []
    t0 = time.perf_counter()
    while True:
        engine.train(1, batch_per_epoch=K)
        steps += K
        losses += [row["loss"] for row in engine.meter.last_window]
        if _all_done(time.perf_counter() - t0 >= run.seconds, run):
            break
    elapsed = time.perf_counter() - t0
    window_peak = runtime.peak_bytes(dev)
    out = {
        "attempted": steps, "failed": 0, "setup_s": setup_s,
        "peak_bytes": max(setup_peak, window_peak),
        "metrics": {"train_triples_per_s": steps * B / elapsed,
                    "peak_mem_gib": window_peak / 2**30},
    }
    if run.trace:
        out["layers"] = _traced(cell, run, engine, graphs, elapsed / steps)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge(cell, graphs, params, kept, dev) if run.rank == 0 else {}
    out["reference_s"] = time.perf_counter() - t_ref
    numbers["loss_nonfinite"] = sum(not math.isfinite(x) for x in losses)
    out["numbers"] = numbers
    return out


def _all_done(done: bool, run: runtime.Run) -> bool:
    """Whether the window has closed, on every rank alike (any rank's clock
    closes it for all, so that no rank waits alone in a collective)."""
    if run.world == 1:
        return done
    from ultra_torchdrug_tpu_torch.parallel import distributed

    return distributed.any_rank(done, run.device)


def _traced(cell, run, engine, graphs, item_s):
    """The per-layer context of a profiled sub-window of steps."""
    from ultra_torchdrug_tpu_torch.tasks import task as task_mod

    patches = [(engine.task, "loss_step", "task.loss"),
               (task_mod, "strict_negatives", "task.negatives"),
               (engine, "_grads", "engine.forward_backward"),
               (engine.optimizer, "update", "engine.optimizer"),
               (engine.meter, "log_window", "engine.log_window")]
    patches += cell.family.spans()
    n = cell.traffic["traced_steps"]

    def window():
        with torch.profiler.record_function(trace.SPAN_PREFIX
                                            + "engine.train"):
            engine.train(1, batch_per_epoch=n)

    with trace.spans(patches):
        _, tr = trace.profiled(
            window, lambda: engine.train(1, batch_per_epoch=1))
    if tr is None:
        return None
    # the mixture's work a step: each graph's, weighted by its draws
    fam, B = cell.family, engine.batch_size // run.world
    probs = np.array([len(g["train"]) for g in graphs], np.float64)
    probs /= probs.sum()
    work = Work()
    for p, g in zip(probs, graphs):
        shapes = kg_shapes(g, kg.relation_edges(g, run.device))
        work.extend(fam.step_work(cell.config, shapes, B).scaled(p))
    return runtime.LayerContext(tr, n, item_s, work, runtime.power_limit_w())


def reference_facts(graphs, device):
    """Each graph's fact triples (h, t, r, V, R) and relation adjacency, on
    the device."""
    out = []
    for g in graphs:
        t = torch.as_tensor(g["train"], device=device)
        fact = (t[:, 0], t[:, 1], t[:, 2], g["entities"], g["relations"])
        out.append((fact, common.relation_adjacency(*fact)))
    return out


def follow(cell, graphs, params, kept, device, prec, scored_rows=None):
    """The reference's own trajectory over the kept steps' batches and
    negatives (``reference.train.follow_steps``), in ``kept``'s form."""
    facts = reference_facts(graphs, device)
    ref = follow_steps(
        cell.family.REFERENCE, params, cell.family.model_dims(cell.config),
        [facts[i] for i in kept["graph_ids"]],
        [torch.as_tensor(b, device=device) for b in kept["batches"]],
        [n.to(device) for n in kept["negs"]], cell.traffic["reference_block"],
        prec, cell.config["optimizer"],
        cell.config["task"]["adversarial_temperature"], scored_rows)
    return dict(kept, losses=ref["losses"], grads=ref["grads"],
                after=ref["params"])


def judge(cell, graphs, params, kept, device) -> dict:
    """The reference's checked steps from ``params`` over the program's
    batches and negatives, against the program's losses, first gradient
    and change of the parameters; and the negatives' strictness."""
    facts = reference_facts(graphs, device)
    neg_bad = 0
    for gid, b, n in zip(kept["graph_ids"], kept["batches"], kept["negs"]):
        (h_f, t_f, r_f, V, R), _ = facts[gid]
        h, t, r = common.candidates(torch.as_tensor(b, device=device),
                                    n.to(device))
        keys = common.triple_keys(h[:, 1:], t[:, 1:], r[:, 1:], V, R)
        neg_bad += int(torch.isin(keys, common.triple_keys(h_f, t_f, r_f, V,
                                                           R)).sum()
                       + ((n < 0) | (n >= V)).sum())
    ref = follow(cell, graphs, params, kept, device, common.Precision())
    return dict(compare(params, kept, ref), neg_bad=neg_bad)


def compare(params, prog, ref) -> dict:
    """The training numbers of ``prog``'s checked steps against ``ref``'s
    (each a ``kept`` dict), lib/check.py's."""
    moving = check.moving_leaves(ref["grads"])
    prog_change = {n: prog["after"][n] - params[n] for n in params}
    ref_change = {n: ref["after"][n] - params[n] for n in params}
    grad, grad_leaf, grad_median = check.worst_and_median(
        check.leaf_gaps(prog["grads"], ref["grads"]))
    update, update_leaf, update_median = check.worst_and_median(
        check.leaf_gaps(prog_change, ref_change, moving))
    losses = [abs(p - q) / abs(q) for p, q in zip(prog["losses"],
                                                  ref["losses"])]
    print(f"losses {prog['losses']} reference {ref['losses']}; worst "
          f"leaves: gradient {grad_leaf}, change {update_leaf}; "
          f"{len(params) - len(moving)} leaves still", file=sys.stderr)
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": grad, "grad_gap_median": grad_median,
            "update_gap": update, "update_gap_median": update_median}

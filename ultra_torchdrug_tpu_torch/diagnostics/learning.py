"""Learning check on compositional-structure data: ULTRA must lift valid MRR
far above its start within a few hundred steps (the counterpart of the JAX
repo's script/diagnostics/convergence_check.py).

The "offsets" KG: 1,000 entities and 8 relations, relation r maps h to
(h + offset_r) mod 1000 for the offsets 1, 2, 3, 5, 8, 13, 21, 34, so that
every held-out triple follows from multi-hop paths over the train triples.
For each offset 2,200 heads are drawn from numpy's generator at seed 0 (the
reference draws them twice and keeps the second draw; so does this one),
the triples are made unique, shuffled and split 10 / 10 / 80 into valid,
test and train (7,083 triples, 5,667 of them train).

ULTRA at the shipped width (``UltraConfig.default``: 6x64 towers, distmult,
sum) with ``remat: auto`` on both towers, 64 strict negatives, an ``Engine``
at batch 64 with AdamW at lr 5e-4 and seed 1024. Valid MRR on 200 valid
triples, then ``--steps`` steps, then valid MRR again; the check passes when
the second exceeds max(10 x the first, 0.05), the reference's criterion.
The steps run in windows of 50 (one engine epoch of 50 batches each, a fresh
permutation of the train triples a window; the reference's single epoch of
"400" batches stops at the epoch's 88 whole batches).

Printed: the mean loss of every window, ms a step (wall clock, the card
synchronised at each window's end), the launches a step of K1, K2, K1h,
K2h and K9 (the kernel wrappers' counts over the training steps alone),
``torch.cuda.max_memory_allocated`` over the run, and
``MRR a -> b [LEARNING OK|SUSPECT]``. The exit code is 1 when the check
fails.

    python -m ultra_torchdrug_tpu_torch.diagnostics.learning
    python -m ultra_torchdrug_tpu_torch.diagnostics.learning \\
        --compute-dtype bfloat16
    python -m ultra_torchdrug_tpu_torch.diagnostics.learning --ring \\
        --out output/learning_ring.json
    python -m ultra_torchdrug_tpu_torch.diagnostics.learning --device cpu \\
        --rehearsal --steps 4

``--ring`` puts the entity tower on an edge mesh of 4 shards, all on one
card (``parallel: {edge: 4}``, ``rspmm_impl: ring``, ``ring_exchange:
rdma``). ``--rehearsal`` (for the CPU) takes batch 8, 16 negatives and 16
valid triples in one eval batch of 16, to check that the tool runs; its
verdict sets the exit code as a full run's does. ``--trajectory``
measures ``trajectory`` instead (``--witness`` adds the readings that back
its whole-run limit) and exits 1 past TRAJECTORY_LIMITS.

``injected_draws`` and ``injected_trajectory`` run a fixed sequence of
batches and negatives through ``task.loss_step`` and the engine's
``Optimizer``, to hold one device's or package's trajectory against
another's, also in fp64 (``fp64_loss``) and step by step from the other
trajectory's states (``resumed_steps``).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device
from ..data.datasets import TransductiveDataset
from ..data.graph import Graph
from ..engine.engine import Engine, Optimizer
from ..models.ultra import UltraConfig
from ..parallel.mesh import make_mesh, use_mesh
from ..tasks.task import TaskConfig, TransductiveKGTask
from ..utils.logging import get_root_logger
from .policy_memory import card_line

NUM_NODES = 1000
OFFSETS = (1, 2, 3, 5, 8, 13, 21, 34)
HEADS_PER_OFFSET = 2200
RING_SHARDS = 4
WINDOW = 50
LR = 5e-4
# the reference's criterion: the MRR after training > max(10 x before, 0.05)
MRR_GAIN = 10.0
MRR_FLOOR = 0.05
# eval_batch None: the task's auto eval batch, as in the reference
FULL = dict(batch=64, negatives=64, fast_test=200, eval_batch=None)
REHEARSAL = dict(batch=8, negatives=16, fast_test=16, eval_batch=16)
KERNELS = ("K1", "K2", "K1h", "K2h", "K9")
TRAJECTORY_STEPS = 20
# (loss relative, parameters norm-wise) limits of ``trajectory``'s readings;
# the whole run's are the looser because at this config a start one
# rounding step away parts by about 2e-3 and 4e-2 in 20 steps on the CPU
# alone (the ``perturbed`` witness)
TRAJECTORY_LIMITS = {"step_by_step": (1e-4, 1e-3), "free": (1e-2, 1e-1),
                     "fp64": (1e-9, 1e-8)}
# the relative change of each weight in ``trajectory``'s perturbed witness,
# about one fp32 rounding step
PERTURBATION = 1e-7


def offsets_dataset(seed: int = 0) -> TransductiveDataset:
    """The offsets KG of the module docstring, from numpy's generator at
    ``seed`` in the reference's order of draws."""
    rng = np.random.default_rng(seed)
    parts = []
    for r, offset in enumerate(OFFSETS):
        rng.integers(0, NUM_NODES, HEADS_PER_OFFSET)  # the reference's 1st
        heads = rng.integers(0, NUM_NODES, HEADS_PER_OFFSET)
        parts.append(np.stack([heads, (heads + offset) % NUM_NODES,
                               np.full_like(heads, r)], 1))
    tri = np.unique(np.concatenate(parts).astype(np.int32), axis=0)
    rng.shuffle(tri)
    n = len(tri)
    valid, test, train = tri[: n // 10], tri[n // 10: n // 5], tri[n // 5:]
    graph = Graph.from_triplets(tri, NUM_NODES, len(OFFSETS))
    return TransductiveDataset("offsets", graph, train, valid, test)


def model_config(num_relations: int, compute_dtype: str = "float32",
                 ring: bool = False) -> UltraConfig:
    """``UltraConfig.default`` with remat auto and ``compute_dtype`` on both
    towers; ``ring`` puts the entity tower's sums on the ring with K9."""
    cfg = UltraConfig.default(num_relations)
    entity = dataclasses.replace(cfg.entity, remat="auto",
                                 compute_dtype=compute_dtype)
    if ring:
        entity = dataclasses.replace(entity, rspmm_impl="ring",
                                     edge_axis="edge", ring_exchange="rdma")
    relation = dataclasses.replace(cfg.relation, remat="auto",
                                   compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, entity=entity, relation=relation)


def kernel_launches() -> dict:
    """The launch counts of the kernels a ULTRA training step can run, as
    their wrappers keep them."""
    from ..ops import rspmm_bwd_cuda, rspmm_cuda
    from ..parallel import rdma

    return {"K1": rspmm_cuda.launches, "K2": rspmm_bwd_cuda.launches["K2"],
            "K1h": rspmm_cuda.bf16_launches,
            "K2h": rspmm_bwd_cuda.launches["K2h"], "K9": rdma.launches}


def launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in KERNELS}


def one_card(device: torch.device) -> torch.device:
    """The device with an index that pins every edge shard to one card (the
    current one), or the CPU."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def entity_policy(task, fact_graph, batch: int) -> dict:
    """The entity tower's memory policies that a train step of ``batch``
    queries resolves to on ``fact_graph``."""
    from ..models.nbfnet import remat_mode

    ent = task._train_model_cfg(fact_graph, batch).entity
    return {"remat": remat_mode(ent.remat), "micro_batch": ent.micro_batch}


def run(compute_dtype: str = "float32", ring: bool = False, steps: int = 400,
        seed: int = 1024, device=None, batch: int = FULL["batch"],
        negatives: int = FULL["negatives"],
        fast_test: int = FULL["fast_test"], eval_batch: Optional[int] = None,
        window: int = WINDOW, log: Callable = print) -> dict:
    """The learning check; returns its readings (the module docstring),
    ``ok`` the criterion's verdict. Raises nothing for a failed check: the
    caller decides (``main`` exits 1)."""
    device = default_device(device)
    cuda = device.type == "cuda"
    label = "ring" if ring else compute_dtype
    dataset = offsets_dataset()
    mesh = make_mesh(edge=RING_SHARDS, device=one_card(device)) if ring \
        else None
    t0 = time.perf_counter()
    with use_mesh(mesh):
        task = TransductiveKGTask(
            dataset, model_config(dataset.num_relations, compute_dtype, ring),
            TaskConfig(num_negative=negatives, eval_batch_size=eval_batch),
            device=device)
    engine = Engine(task, batch_size=batch, lr=LR, seed=seed,
                    log_interval=10**9, logger=get_root_logger(None),
                    mesh=mesh)
    setup_s = time.perf_counter() - t0
    policy = entity_policy(task, task.fact_graph, batch)
    log(f"[learning {label}] offsets KG: {dataset.num_entities} entities, "
        f"{dataset.num_relations} relations, {len(dataset.train)} / "
        f"{len(dataset.valid)} / {len(dataset.test)} triples; batch {batch}, "
        f"{negatives} negatives, AdamW {LR:g}, seed {seed}; entity policy "
        f"{policy}; mesh {None if mesh is None else mesh.shape}; set-up "
        f"{setup_s:.2f} s on {device}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    m0 = engine.evaluate("valid", fast_test=fast_test)["mrr"]
    log(f"[learning {label}] initial valid mrr {m0:.6f} "
        f"(fast_test {fast_test})")
    windows, train_s = [], 0.0
    launches = {k: 0 for k in KERNELS}
    for start in range(0, steps, window):
        n = min(window, steps - start)
        before = kernel_launches()
        synchronize(device)
        t = time.perf_counter()
        engine.train(num_epoch=1, batch_per_epoch=n)
        synchronize(device)
        seconds = time.perf_counter() - t
        train_s += seconds
        for k, v in launches_since(before).items():
            launches[k] += v
        losses = [m["loss"] for m in engine.meter.last_window]
        windows.append({"step": start + n, "loss": float(np.mean(losses)),
                        "ms_per_step": seconds * 1e3 / n,
                        "finite": all(math.isfinite(x) for x in losses)})
        log(f"[learning {label}] steps {start + 1}-{start + n}: mean loss "
            f"{windows[-1]['loss']:.6f}, {windows[-1]['ms_per_step']:.2f} "
            f"ms a step")
    m1 = engine.evaluate("valid", fast_test=fast_test)["mrr"]
    ok = bool(m1 > max(MRR_GAIN * m0, MRR_FLOOR))
    per_step = {k: v / steps for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    readings = {
        "label": label, "compute_dtype": compute_dtype, "ring": ring,
        "device": str(device), "card": card_line(device),
        "steps": steps, "batch": batch, "negatives": negatives,
        "fast_test": fast_test, "seed": seed, "setup_s": setup_s,
        "policy": policy, "mrr_before": m0, "mrr_after": m1,
        "criterion": f"mrr_after > max({MRR_GAIN:g} * mrr_before, "
                     f"{MRR_FLOOR:g})",
        "ok": ok, "verdict": "LEARNING OK" if ok else "SUSPECT",
        "ms_per_step": train_s * 1e3 / steps, "launches": launches,
        "launches_per_step": per_step, "max_memory_allocated": peak,
        "windows": windows,
    }
    log(f"[learning {label}] {steps} steps in {train_s:.2f} s: "
        f"{readings['ms_per_step']:.2f} ms a step; launches a step "
        f"{per_step}; max_memory_allocated "
        f"{'not measured' if peak is None else f'{peak / 2**20:.1f} MiB'} "
        f"({readings['card']})")
    log(f"MRR {m0:.4f} -> {m1:.4f}  [{readings['verdict']}]")
    return readings


def injected_draws(triples: np.ndarray, num_nodes: int, steps: int,
                   batch: int, negatives: int, seed: int = 0
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` (batch [B, 3], negatives [B, N] int64) pairs drawn with
    numpy at ``seed``: B train triples without replacement, N uniform
    entities a triple."""
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(steps):
        b = triples[rng.choice(len(triples), batch, replace=False)]
        draws.append((b, rng.integers(0, num_nodes, (batch, negatives))))
    return draws


def fp64_loss(task) -> Callable:
    """``task``'s train loss in fp64 on its device, for a double copy of a
    model: (model, batch [B, 3], neg [B, N]) -> loss. The task's fact and
    relation graphs are copied with double edge weights (and dense
    adjacency) and prepared as its loss function prepares them; the
    scores and the criterion are the task's. The kernels are fp32: on the
    card the task's entity tower must take ``rspmm_impl: xla``."""
    from ..tasks.task import _criterion_loss

    fact = task.fact_graph.prepare_join(
        one_hop=task.model_cfg.remove_one_hop).to(task.device)
    fact = fact.with_edge_weight(fact.edge_weight.double())
    rel = task.rel_graph.with_edge_weight(task.rel_graph.edge_weight.double())
    und, rel = task._prepare_graphs(fact, rel, backward=True)
    if rel.dense_adj is not None:
        rel = dataclasses.replace(rel, dense_adj=rel.dense_adj.double())

    def loss(model, batch, neg):
        b = torch.from_numpy(np.asarray(batch, np.int64)).to(task.device)
        scores = task._train_scores(
            model, fact, rel, b[:, 0], b[:, 1], b[:, 2], neg, und,
            model_cfg=task._train_model_cfg(fact, len(batch)))
        return _criterion_loss(task.cfg, scores,
                               task.sample_weight_for(batch))

    return loss


def injected_step(task, model, opt: Optimizer, draw, loss_fn=None) -> float:
    """One step of ``draw`` (batch, negatives): ``task.loss_step`` (or
    ``loss_fn``) with the draw's negatives, the gradients, ``opt``'s
    update of ``model``; returns the loss."""
    batch, neg = draw
    neg = torch.from_numpy(neg).to(task.device)
    if loss_fn is None:
        loss, _ = task.loss_step(model, None, batch, neg=neg)
    else:
        loss = loss_fn(model, batch, neg)
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True,
                                materialize_grads=True)
    opt.step(grads)
    return float(loss.detach())


def injected_trajectory(task, model, draws: Sequence, lr: float,
                        fp64: bool = False,
                        states: Optional[list] = None) -> List[float]:
    """Train ``model`` in place on ``draws`` (``injected_draws``) with the
    engine's AdamW (``injected_step``); returns each step's loss. With
    ``fp64`` the model is made double and the loss is ``fp64_loss``'s.
    ``states``, a list, receives a copy of the model's and the optimizer's
    state dicts before each step and after the last."""
    if fp64:
        model.double()
    opt = Optimizer(model.parameters(), "AdamW", lr)
    loss_fn = fp64_loss(task) if fp64 else None
    losses = []
    for draw in draws:
        if states is not None:
            states.append(_state(model, opt))
        losses.append(injected_step(task, model, opt, draw, loss_fn))
    if states is not None:
        states.append(_state(model, opt))
    return losses


def _state(model, opt: Optimizer) -> tuple:
    return copy.deepcopy((model.state_dict(), opt.state_dict()))


def resumed_steps(task, model, states: Sequence, draws: Sequence,
                  lr: float) -> List[tuple]:
    """Each step of a trajectory taken again from the state before it
    (``injected_trajectory``'s ``states``): per step, ``model`` and a fresh
    AdamW load that state, take the step's draw, and the loss and the
    parameters after it are returned, (loss, {name: tensor}) a step."""
    out = []
    for (model_state, opt_state), draw in zip(states, draws):
        model.load_state_dict(model_state)
        opt = Optimizer(model.parameters(), "AdamW", lr)
        opt.load_state_dict(opt_state)
        loss = injected_step(task, model, opt, draw)
        out.append((loss, {k: p.detach().clone()
                           for k, p in model.named_parameters()}))
    return out


def _param_gaps(got: dict, want: dict) -> dict:
    """Each parameter's norm-wise relative difference, in fp64 on the CPU."""
    out = {}
    for k, w in want.items():
        w = w.detach().cpu().double()
        g = got[k].detach().cpu().double()
        out[k] = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
    return out


def _gaps(losses, want_losses, params, want_params) -> dict:
    """The losses' relative differences step by step and the parameters'
    norm-wise ones, with the worst of each."""
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    param = _param_gaps(params, want_params)
    worst = max(param, key=param.get)
    return {"loss_gaps": loss, "max_loss_gap": max(loss),
            "max_param_gap": param[worst], "worst_param": worst}


def perturbed(model: torch.nn.Module, scale: float = PERTURBATION,
              seed: int = 0) -> torch.nn.Module:
    """A copy of ``model`` with each weight times 1 + ``scale`` or
    1 - ``scale``, the signs drawn at ``seed``."""
    model = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
            p.mul_(1 + scale * sign.to(p))
    return model


def trajectory(device=None, steps: int = TRAJECTORY_STEPS,
               batch: int = FULL["batch"], negatives: int = FULL["negatives"],
               witness: bool = False, log: Callable = print) -> dict:
    """The fp32 learning model's first ``steps`` steps on ``device``
    against the port's CPU run from the same weights (``UltraConfig``'s
    seeded init, seed 0), batches and negatives (``injected_draws``, seed
    0; the card's generator draws differently from the CPU's, so nothing
    is drawn by either):

      * ``free``: each device runs the whole trajectory; each step's loss
        (relative) and every parameter at the end (norm-wise) against the
        CPU's;
      * ``step_by_step``: each step taken on ``device`` from the CPU run's
        model and optimizer state before it (``resumed_steps``); its loss
        and the parameters after it against the CPU's;

    and with ``witness`` two readings that back ``free``'s looser limit
    (nothing on the main path reads them):

      * ``fp64``: ``free`` with both runs in fp64, the entity tower on
        ``rspmm_impl: xla`` (the kernels are fp32), which measures how far
        the two devices' arithmetic differs apart from fp32 rounding;
      * ``perturbed``: the CPU run again in fp32 from the weights changed
        by about one rounding step (``perturbed``), against the CPU run:
        how far a rounding-sized difference grows over the steps on one
        device, with no card involved.

    Returns the gaps, each reading's worst, and the seconds of each run."""
    device = default_device(device)
    cpu = torch.device("cpu")
    dataset = offsets_dataset()
    cfg = model_config(dataset.num_relations)
    task_cfg = TaskConfig(num_negative=negatives)
    tasks = [TransductiveKGTask(dataset, cfg, task_cfg, device=d)
             for d in (device, cpu)]
    ref = tasks[1].init_params(seed=0)
    draws = injected_draws(tasks[1].train_triples, dataset.num_entities,
                           steps, batch, negatives)
    out = {"device": str(device), "card": card_line(device), "steps": steps,
           "batch": batch, "negatives": negatives, "seconds": {}}
    models, losses, states = [], [], []
    for label, task in zip((str(device), "cpu"), tasks):
        model = copy.deepcopy(ref).to(task.device)
        t0 = time.perf_counter()
        losses.append(injected_trajectory(
            task, model, draws, LR, states=states if task is tasks[1]
            else None))
        out["seconds"][label] = time.perf_counter() - t0
        models.append(dict(model.named_parameters()))
    out["free"] = _gaps(losses[0], losses[1], models[0], models[1])
    resumed = resumed_steps(tasks[0], copy.deepcopy(ref).to(device),
                            states[:-1], draws, LR)
    param_gaps = []
    for (_, params), (state, _) in zip(resumed, states[1:]):
        param_gaps.append(max(_param_gaps(
            params, {k: state[k] for k in params}).values()))
    loss_gaps = [abs(a - b) / abs(b)
                 for (a, _), b in zip(resumed, losses[1])]
    out["step_by_step"] = {"loss_gaps": loss_gaps, "param_gaps": param_gaps,
                           "max_loss_gap": max(loss_gaps),
                           "max_param_gap": max(param_gaps)}
    out["fp64"] = out["perturbed"] = None
    if witness:
        model = perturbed(ref)
        t0 = time.perf_counter()
        out["perturbed"] = _gaps(
            injected_trajectory(tasks[1], model, draws, LR), losses[1],
            dict(model.named_parameters()), models[1])
        out["seconds"]["cpu perturbed"] = time.perf_counter() - t0
        xla = dataclasses.replace(cfg, entity=dataclasses.replace(
            cfg.entity, rspmm_impl="xla"))
        runs = []
        for task in (TransductiveKGTask(dataset, xla, task_cfg, device=d)
                     for d in (device, cpu)):
            model = task.init_params(seed=0)
            model.load_state_dict(ref.state_dict())
            t0 = time.perf_counter()
            runs.append((injected_trajectory(task, model, draws, LR,
                                             fp64=True),
                         dict(model.named_parameters())))
            out["seconds"][f"{task.device.type} fp64"] = (
                time.perf_counter() - t0)
        out["fp64"] = _gaps(runs[0][0], runs[1][0], runs[0][1], runs[1][1])
    for key in ("free", "step_by_step", "fp64", "perturbed"):
        if out[key] is not None:
            pair = ("cpu perturbed vs cpu" if key == "perturbed"
                    else f"{device} vs cpu")
            log(f"[learning trajectory] {key}: {steps} steps of {batch} "
                f"triples x {negatives} negatives, {pair}: worst "
                f"loss gap {out[key]['max_loss_gap']:.3g}, worst parameter "
                f"gap {out[key]['max_param_gap']:.3g}"
                + (f" ({out[key]['worst_param']})"
                   if "worst_param" in out[key] else "")
                + "; loss gaps by step "
                + " ".join(f"{g:.2g}" for g in out[key]["loss_gaps"]))
    log(f"[learning trajectory] seconds {out['seconds']} ({out['card']})")
    return out


def trajectory_failures(out: dict) -> list:
    """``trajectory``'s readings past TRAJECTORY_LIMITS, in words."""
    failed = []
    for key, (loss_limit, param_limit) in TRAJECTORY_LIMITS.items():
        got = out.get(key)
        if got is None:
            continue
        if not got["max_loss_gap"] <= loss_limit:
            failed.append(f"{key}: loss gap {got['max_loss_gap']:.3g} > "
                          f"{loss_limit:g}")
        if not got["max_param_gap"] <= param_limit:
            failed.append(f"{key}: parameter gap {got['max_param_gap']:.3g}"
                          f" > {param_limit:g}")
    return failed


def write_json(path: Optional[str], obj: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        print(f"wrote {path}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compute-dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--ring", action="store_true",
                        help="the entity tower on a 4-shard ring on one card")
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--seed", type=int, default=1024,
                        help="the engine's seed (the data's is 0)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--rehearsal", action="store_true",
                        help="batch 8, 16 negatives, 16 valid triples in "
                        "one eval batch")
    parser.add_argument("--trajectory", action="store_true",
                        help="instead: the first 20 steps on the device "
                             "against the CPU (``trajectory``)")
    parser.add_argument("--witness", action="store_true",
                        help="with --trajectory: also both runs in fp64 "
                             "and the CPU run from perturbed weights")
    parser.add_argument("--out", default=None, help="a JSON of the readings")
    args = parser.parse_args(argv)
    size = REHEARSAL if args.rehearsal else FULL
    if args.trajectory:
        out = trajectory(args.device, batch=size["batch"],
                         negatives=size["negatives"],
                         witness=args.witness)
        write_json(args.out, out)
        failed = trajectory_failures(out)
        for line in failed:
            print(f"[learning trajectory] FAILED: {line}", flush=True)
        return 1 if failed else 0
    readings = run(args.compute_dtype, args.ring, args.steps, args.seed,
                   args.device, **size)
    write_json(args.out, readings)
    return 0 if readings["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

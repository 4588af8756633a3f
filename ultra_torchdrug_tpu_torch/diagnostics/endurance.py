"""Endurance run: ULTRA pre-training on a three-graph mixture for thousands
of steps with checkpoint and evaluation interleaves (the counterpart of the
JAX repo's script/diagnostics/endurance.py; the schedule of
config/transductive/pretrain_3g.yaml, 10 epochs x 20,000 batches).

The mixture: three generated graphs with the counts of FB15k-237 (14,541
entities, 272,115 triples, 237 relations), WN18RR (40,943; 86,835; 11) and
CoDEx-M (17,050; 185,584; 51), each from ``synthetic_transductive`` at seeds
0, 1 and 2 with its default 10 / 10 / 80 split. ``MultiGraphPretrainTask``
with 128 strict negatives, ULTRA 6x64 (``UltraConfig.default``) with
``remat: auto`` on both towers, an ``Engine`` at batch 64 with AdamW 5e-4
and seed 1024.

The run trains in windows (one ``Engine.train`` call of ``--window`` steps
each). For each window: ms a step (wall clock, the card synchronised at its
end), host RSS now (``VmRSS`` of /proc/self/status; ``ru_maxrss`` never
falls), ``torch.cuda.memory_allocated`` at its end,
``torch.cuda.max_memory_allocated`` within it (reset at its start), the
graphs its steps drew, its losses (all finite?) and its kernel launches
(K1, K2, K1h, K2h, K9); the entity tower's resolved memory policies a
graph are logged and kept. Every ``--ckpt-every`` steps a checkpoint
(``Engine.save``, its seconds) and every ``--eval-every`` steps a valid
evaluation (``fast_test`` 64 a graph; its seconds and mean MRR). The
summary: set-up seconds, steady ms a step (the mean of the second half of
the windows), the drift of the second half against the first, RSS and
allocated bytes at the first and the last window, each one's largest
departure from the second window's reading from the second window on (the
creep), and the hours that pretrain_3g.yaml's 200,000 steps would take at
the steady rate.

``--resume-check N`` (a multiple of the window): after the checkpoint at
step N the tool keeps the engine's negatives generator state and its numpy
batch generator state, the running engine takes 5 more steps, then a fresh
engine loads the checkpoint with ``Engine.load(..., drop_optimizer=False)``,
is given the kept states and takes the same 5 steps. Their losses must agree
within 1e-5 relative and every parameter within 1e-5 norm-wise (AdamW's
moments and step count survive ``save`` and ``load``). The random states
are carried by the tool, not by the checkpoint (the JAX checkpoint holds
none either). The running engine's 5 steps add to the run's.

The exit code is 1 when a loss is not finite, the resume check fails, or
the creep exceeds 64 MiB on the device or 256 MiB on the host.

    python -m ultra_torchdrug_tpu_torch.diagnostics.endurance --steps 2000 \\
        --out output/endurance.json
    python -m ultra_torchdrug_tpu_torch.diagnostics.endurance --device cpu \\
        --rehearsal --steps 8 --window 2 --eval-every 4 --ckpt-every 4 \\
        --resume-check 4

``--rehearsal`` (for the CPU) generates the graphs at 1,500 / 3,000 / 1,200
entities, and trains at batch 8 with 16 negatives and 16 valid triples a
graph in eval batches of 16.
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import gc
import math
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .. import default_device
from ..data.datasets import JointDataset, synthetic_transductive
from ..engine.engine import Engine
from ..models.ultra import UltraConfig
from ..tasks.task import MultiGraphPretrainTask, TaskConfig
from ..utils.logging import get_root_logger
from .learning import (
    KERNELS,
    LR,
    entity_policy,
    kernel_launches,
    launches_since,
    synchronize,
    write_json,
)
from .policy_memory import card_line

# (name, entities, triples, relations): the public graphs' counts
GRAPHS = (("fb", 14541, 272115, 237), ("wn", 40943, 86835, 11),
          ("codex", 17050, 185584, 51))
FULL = dict(graphs=GRAPHS, batch=64, negatives=128, fast_test=64,
            eval_batch=None)
REHEARSAL = dict(graphs=(("fb", 1500, 13000, 40), ("wn", 3000, 5600, 11),
                         ("codex", 1200, 9800, 20)),
                 batch=8, negatives=16, fast_test=16, eval_batch=16)
PRETRAIN_STEPS = 200_000  # pretrain_3g.yaml: 10 epochs x 20,000 batches
RESUME_STEPS = 5
RESUME_LOSS_RTOL = 1e-5
RESUME_PARAM_RTOL = 1e-5
MAX_DEVICE_CREEP_MIB = 64
MAX_HOST_CREEP_MIB = 256
SEED = 1024


class CountingEngine(Engine):
    """An engine that counts the steps each graph takes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.drawn = collections.Counter()

    def _run_step(self, graph_id, batch):
        self.drawn[graph_id] += 1
        return super()._run_step(graph_id, batch)


def vmrss_bytes() -> int:
    """This process's resident set now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS line in /proc/self/status")


def mixture(graphs) -> JointDataset:
    return JointDataset("3g", [synthetic_transductive(name, V, E, R, seed=i)
                               for i, (name, V, E, R) in enumerate(graphs)])


def model_config(num_relations: int) -> UltraConfig:
    cfg = UltraConfig.default(num_relations)
    return dataclasses.replace(
        cfg, entity=dataclasses.replace(cfg.entity, remat="auto"),
        relation=dataclasses.replace(cfg.relation, remat="auto"))


def parameters(engine) -> dict:
    return {k: p.detach().clone() for k, p in engine.model.named_parameters()}


def resume_check(engine, fresh_engine: Callable, path: str,
                 steps: int = RESUME_STEPS) -> dict:
    """The running engine's next ``steps`` steps against a fresh engine's
    from the checkpoint at ``path`` with the same random states (the module
    docstring)."""
    generator = engine.generator.get_state()
    rng = copy.deepcopy(engine.rng.bit_generator.state)
    engine.train(num_epoch=1, batch_per_epoch=steps)
    want = [m["loss"] for m in engine.meter.last_window]
    want_params = parameters(engine)
    fresh = fresh_engine()
    fresh.load(path, drop_optimizer=False)
    fresh.generator.set_state(generator)
    fresh.rng.bit_generator.state = rng
    fresh.train(num_epoch=1, batch_per_epoch=steps)
    got = [m["loss"] for m in fresh.meter.last_window]
    got_params = parameters(fresh)
    del fresh
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got, want))
    param_gap = max(((got_params[k] - w).norm()
                     / w.norm().clamp(min=1e-30)).item()
                    for k, w in want_params.items())
    ok = (len(got) == len(want) == steps and loss_gap <= RESUME_LOSS_RTOL
          and param_gap <= RESUME_PARAM_RTOL)
    return {"steps": steps, "losses": want, "resumed_losses": got,
            "loss_rel_gap": loss_gap, "param_rel_gap": param_gap,
            "bitwise": loss_gap == 0 and param_gap == 0, "ok": ok}


def creep(windows: list, key: str) -> Optional[int]:
    """The largest |reading - the second window's| from the second window
    on; None where the reading was not taken."""
    if windows[1][key] is None:
        return None
    return max(abs(w[key] - windows[1][key]) for w in windows[1:])


def run(steps: int = 2000, window: int = 100, eval_every: int = 500,
        ckpt_every: int = 500, steps_per_call: int = 1,
        resume_check_at: int = 0, device=None, graphs=GRAPHS, batch: int = FULL["batch"],
        negatives: int = FULL["negatives"],
        fast_test: int = FULL["fast_test"], eval_batch: Optional[int] = None,
        log: Callable = print) -> dict:
    """The endurance run; returns its summary (the module docstring)."""
    if steps < 2 * window:
        raise ValueError(f"{steps} steps make fewer than two windows of "
                         f"{window}")
    if resume_check_at and (resume_check_at % window
                            or resume_check_at > steps):
        raise ValueError(f"--resume-check {resume_check_at} is not a window "
                         f"boundary of the run")
    device = default_device(device)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    dataset = mixture(graphs)
    names = [d.name for d in dataset.datasets]
    task = MultiGraphPretrainTask(
        dataset, model_config(max(d.num_relations for d in dataset.datasets)),
        TaskConfig(num_negative=negatives, eval_batch_size=eval_batch),
        device=device)

    def new_engine(engine_seed: int):
        return CountingEngine(task, batch_size=batch, lr=LR,
                              seed=engine_seed, log_interval=10**9,
                              logger=get_root_logger(None),
                              steps_per_call=steps_per_call)

    engine = new_engine(SEED)
    setup_s = time.perf_counter() - t0
    card = card_line(device)
    policies = {name: entity_policy(task, fact, batch)
                for name, fact in zip(names, task.fact_graphs)}
    log(f"[endurance] " + "; ".join(
        f"{d.name}: {d.num_entities} entities, {d.num_relations} relations, "
        f"{len(d.train)} train triples" for d in dataset.datasets)
        + f"; mixture {np.round(task._graph_probs, 4).tolist()}; batch "
        f"{batch}, {negatives} negatives, steps_per_call {steps_per_call}; "
        f"entity policies {policies}; set-up {setup_s:.1f} s on {device} "
        f"({card})")
    windows, events, resume = [], [], None
    done = 0
    with tempfile.TemporaryDirectory(prefix="endurance_") as work_dir:
        ckpt = str(Path(work_dir) / "ckpt.pt")
        t_run = time.perf_counter()
        while done < steps:
            n = min(window, steps - done)
            drawn = collections.Counter(engine.drawn)
            before = kernel_launches()
            synchronize(device)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            engine.train(num_epoch=1, batch_per_epoch=n)
            synchronize(device)
            seconds = time.perf_counter() - t
            done += n
            losses = [m["loss"] for m in engine.meter.last_window]
            w = {"step": done, "ms_per_step": seconds * 1e3 / n,
                 "rss_bytes": vmrss_bytes(),
                 "allocated_bytes": (torch.cuda.memory_allocated(device)
                                     if cuda else None),
                 "peak_allocated_bytes": (
                     torch.cuda.max_memory_allocated(device) if cuda
                     else None),
                 "graphs": {names[g]: engine.drawn[g] - drawn[g]
                            for g in sorted(engine.drawn)
                            if engine.drawn[g] > drawn[g]},
                 "loss": float(np.mean(losses)),
                 "losses_finite": len(losses) == n and all(
                     math.isfinite(x) for x in losses),
                 "launches": launches_since(before)}
            windows.append(w)
            log(f"[endurance] step {done}: {w['ms_per_step']:.2f} ms a "
                f"step, loss {w['loss']:.6f}, rss "
                f"{w['rss_bytes'] / 2**20:.1f} MiB, allocated "
                + ("not measured" if w["allocated_bytes"] is None else
                   f"{w['allocated_bytes'] / 2**20:.1f} MiB (peak "
                   f"{w['peak_allocated_bytes'] / 2**20:.1f} MiB)")
                + f", graphs {w['graphs']}, launches "
                f"{ {k: v for k, v in w['launches'].items() if v} }")
            if (ckpt_every and done % ckpt_every == 0) or \
                    done == resume_check_at:
                t = time.perf_counter()
                engine.save(ckpt)
                events.append({"step": done,
                               "ckpt_s": time.perf_counter() - t})
                log(f"[endurance] checkpoint at {done}: "
                    f"{events[-1]['ckpt_s']:.3f} s")
            if eval_every and done % eval_every == 0:
                t = time.perf_counter()
                m = engine.evaluate("valid", fast_test=fast_test)
                events.append({"step": done,
                               "eval_s": time.perf_counter() - t,
                               "mrr": m["mrr"],
                               "per_graph": {k: v["mrr"] for k, v in
                                             m["per_graph"].items()}})
                log(f"[endurance] eval at {done}: mrr {m['mrr']:.6f} "
                    f"{events[-1]['per_graph']} "
                    f"({events[-1]['eval_s']:.2f} s)")
            if done == resume_check_at:
                resume = resume_check(engine, lambda: new_engine(SEED + 1),
                                      ckpt)
                events.append({"step": done, "resume_check": resume})
                gc.collect()
                log(f"[endurance] resume check at {done}: losses "
                    f"{resume['loss_rel_gap']:.3g} relative, parameters "
                    f"{resume['param_rel_gap']:.3g} norm-wise (limits "
                    f"{RESUME_LOSS_RTOL:g}, {RESUME_PARAM_RTOL:g}), bitwise "
                    f"{resume['bitwise']}")
        total_s = time.perf_counter() - t_run
    half = len(windows) // 2
    first = float(np.mean([w["ms_per_step"] for w in windows[:half]]))
    steady = float(np.mean([w["ms_per_step"] for w in windows[half:]]))
    summary = {
        "device": str(device), "card": card, "steps": steps,
        "window": window, "steps_per_call": steps_per_call,
        "batch": batch, "negatives": negatives,
        "graphs": [list(g) for g in graphs], "policies": policies,
        "setup_s": setup_s,
        "total_s": total_s, "steady_ms_per_step": steady,
        "drift_second_half_vs_first": steady / first - 1,
        "rss_start_bytes": windows[0]["rss_bytes"],
        "rss_end_bytes": windows[-1]["rss_bytes"],
        "allocated_start_bytes": windows[0]["allocated_bytes"],
        "allocated_end_bytes": windows[-1]["allocated_bytes"],
        "host_creep_bytes": creep(windows, "rss_bytes"),
        "device_creep_bytes": creep(windows, "allocated_bytes"),
        "projected_200k_steps_hours": steady * PRETRAIN_STEPS / 3.6e6,
        "losses_finite": all(w["losses_finite"] for w in windows),
        "launches": {k: sum(w["launches"][k] for w in windows)
                     for k in KERNELS},
        "resume_check": resume, "windows": windows, "events": events,
    }
    log("[endurance] " + ", ".join(
        f"{k} {v}" for k, v in summary.items()
        if k not in ("windows", "events", "resume_check", "graphs",
                     "policies")))
    return summary


def failures(summary: dict) -> list:
    """What the run failed, in words; empty when it passed."""
    out = []
    if not summary["losses_finite"]:
        out.append("a loss is not finite")
    resume = summary["resume_check"]
    if resume is not None and not resume["ok"]:
        out.append(f"resume check: {resume}")
    for key, limit in (("device_creep_bytes", MAX_DEVICE_CREEP_MIB),
                       ("host_creep_bytes", MAX_HOST_CREEP_MIB)):
        if summary[key] is not None and summary[key] > limit * 2**20:
            out.append(f"{key} {summary[key]} > {limit} MiB")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--window", type=int, default=100)
    parser.add_argument("--eval-every", type=int, default=500)
    parser.add_argument("--ckpt-every", type=int, default=500)
    parser.add_argument("--steps-per-call", type=int, default=1)
    parser.add_argument("--resume-check", type=int, default=0, metavar="N")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--rehearsal", action="store_true",
                        help="small graphs, batch 8, 16 negatives")
    parser.add_argument("--out", default=None, help="a JSON of the summary")
    args = parser.parse_args(argv)
    size = REHEARSAL if args.rehearsal else FULL
    summary = run(args.steps, args.window, args.eval_every, args.ckpt_every,
                  args.steps_per_call, args.resume_check, args.device,
                  **size)
    write_json(args.out, summary)
    failed = failures(summary)
    for line in failed:
        print(f"[endurance] FAILED: {line}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The peak device memory of ULTRA's train step under each remat policy and
of its eval batches, the readings that the auto policies of tasks/task.py
are fitted to.

For each graph (generated with the public counts of FB15k-237, WN18RR and
ATOMIC, the last the JAX package's calibration point,
script/diagnostics/train_memory.py), ULTRA at the shipped width (6x64
towers, distmult, sum, layer norm) runs one loss step and its gradients
(batch 64, 128 strict negatives) with the entity tower's remat pinned to
none, save_rspmm and full (micro-batching off), and eval batches of two
sizes. Each reading is ``torch.cuda.max_memory_allocated`` above what was
allocated before it (graphs, layouts and weights), also in units of one flat
[V, B*D] fp32 state (V the graph's entities); an out-of-memory error is
recorded as such. The JSON (``--out``) holds the card's name and power
limit, the readings, and the constants they give:

  * _FULL_SAVE_PEAK_FACTOR: the largest keep-everything peak, in units, a
    layer;
  * _SAVE_RSPMM_UNITS_BASE: the largest save_rspmm peak less two units a
    layer (each layer keeps its input and its aggregation's output);
  * _MB_BUDGET_FRACTION: 0.7 * L / the largest full-recomputation peak in
    units, so that the saved inputs' share of the budget stands for a peak
    of 0.7 of it, as the other tiers' limit;
  * _EVAL_STATE_COPIES: the largest growth of the eval peak a query, in
    [V, D] fp32 units.

    python -m ultra_torchdrug_tpu_torch.diagnostics.policy_memory \\
        --out output/policy_memory.json
    python -m ultra_torchdrug_tpu_torch.diagnostics.policy_memory \\
        --device cpu --graphs tiny --out output/policy_memory_cpu.json

On the CPU it runs the steps (to check the script) and measures nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from .. import default_device
from ..data.datasets import synthetic_transductive
from ..models.ultra import UltraConfig
from ..tasks.task import TaskConfig, TransductiveKGTask

# (entities, relations, train triples): the public counts
GRAPHS = {
    "FB15k-237": (14541, 237, 272115),
    "WN18RR": (40943, 11, 86835),
    "ATOMIC": (304388, 9, 610536),
    "tiny": (300, 7, 3000),
}
MODES = {"none": False, "save_rspmm": "save_rspmm", "full": True}
EVAL_QUERIES = 128  # held-out triples generated beside the train ones


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {exc})"


def _measure(fn, device) -> dict:
    """Run fn; its peak allocation above the memory allocated before it, and
    its seconds (host clock around a synchronised call). An out-of-memory
    error is recorded; the memory is freed after the handler ends."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    oom = None
    try:
        fn()
        if cuda:
            torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        oom = str(exc).splitlines()[0][:160]
    seconds = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
    if oom is not None:
        return {"oom": oom}
    if not cuda:
        return {"seconds": seconds, "peak_bytes": None}
    return {"seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated() - base,
            "base_bytes": base}


def run_graph(name: str, modes, eval_batches, batch: int, negatives: int,
              device) -> dict:
    V, R, train = GRAPHS[name]
    total = train + 2 * EVAL_QUERIES
    dataset = synthetic_transductive(
        name, V, total, R, seed=0, valid_frac=EVAL_QUERIES / total,
        test_frac=EVAL_QUERIES / total)
    base_cfg = UltraConfig.default(R)
    task = TransductiveKGTask(dataset, base_cfg, TaskConfig(
        num_negative=negatives, eval_batch_size=max(eval_batches)),
        device=device)
    model = task.init_params(seed=0)
    params = [p for p in model.parameters() if p.requires_grad]
    layers, dim = len(base_cfg.entity.hidden_dims), base_cfg.entity.input_dim
    unit = V * batch * dim * 4
    out = {"entities": V, "relations": R, "train_triples": len(dataset.train),
           "layers": layers, "dim": dim, "batch": batch,
           "negatives": negatives, "unit_bytes": unit, "train": {},
           "eval": {}}
    triples = task.train_triples[:batch]
    generator = torch.Generator(device=device)
    for mode in modes:
        # micro_batch = batch: no chunking, and auto_micro_batch keeps it
        task.model_cfg = dataclasses.replace(
            base_cfg, entity=dataclasses.replace(
                base_cfg.entity, remat=MODES[mode], micro_batch=batch))

        def step():
            generator.manual_seed(0)
            loss, _ = task.loss_step(model, generator, triples)
            torch.autograd.grad(loss, params)

        # the first run sets up allocator pools and handles
        reading = _measure(step, device)
        if "oom" not in reading:
            reading = _measure(step, device)
        if reading.get("peak_bytes") is not None:
            reading["units"] = reading["peak_bytes"] / unit
        out["train"][mode] = reading
        print(f"[policy memory] {name} train {mode}: {reading}", flush=True)
    task.model_cfg = base_cfg
    eval_fn = task._eval_fn
    for b in eval_batches:
        queries = torch.from_numpy(
            dataset.test[:b].astype(np.int64)).to(device)

        def evaluate():
            with torch.inference_mode():
                eval_fn(model, queries)

        reading = _measure(evaluate, device)
        if "oom" not in reading:
            reading = _measure(evaluate, device)
        out["eval"][str(b)] = reading
        print(f"[policy memory] {name} eval batch {b}: {reading}", flush=True)
    return out


def fit(readings: dict) -> dict:
    """The constants of the module docstring from the readings (None where
    no graph gave the reading)."""
    full_save, save_rspmm, full, copies = [], [], [], []
    for r in readings.values():
        L, unit = r["layers"], r["unit_bytes"]
        train = r["train"]
        if "units" in train.get("none", {}):
            full_save.append(train["none"]["units"] / L)
        if "units" in train.get("save_rspmm", {}):
            save_rspmm.append(train["save_rspmm"]["units"] - 2 * L)
        if "units" in train.get("full", {}):
            full.append(train["full"]["units"] / L)
        ev = {int(b): v.get("peak_bytes") for b, v in r["eval"].items()}
        ev = {b: v for b, v in ev.items() if v is not None}
        if len(ev) >= 2:
            lo, hi = min(ev), max(ev)
            per_query = unit / r["batch"]
            copies.append((ev[hi] - ev[lo]) / ((hi - lo) * per_query))
    return {
        "_FULL_SAVE_PEAK_FACTOR": max(full_save, default=None),
        "_SAVE_RSPMM_UNITS_BASE": max(save_rspmm, default=None),
        "_MB_BUDGET_FRACTION": (0.7 / max(full) if full else None),
        "_EVAL_STATE_COPIES": max(copies, default=None),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (checks the script)")
    parser.add_argument("--graphs", nargs="+",
                        default=["FB15k-237", "WN18RR", "ATOMIC"],
                        choices=sorted(GRAPHS))
    parser.add_argument("--modes", nargs="+", default=list(MODES),
                        choices=list(MODES))
    parser.add_argument("--eval-batches", nargs="+", type=int,
                        default=[16, 64])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--negatives", type=int, default=128)
    parser.add_argument("--out", default="output/policy_memory.json")
    args = parser.parse_args(argv)
    device = default_device(args.device)
    result = {"card": card_line(device), "device": str(device),
              "torch": torch.__version__, "graphs": {}}
    for name in args.graphs:
        result["graphs"][name] = run_graph(
            name, args.modes, args.eval_batches, args.batch, args.negatives,
            device)
    result["fit"] = fit(result["graphs"])
    print(f"[policy memory] {result['card']}: fit {result['fit']}",
          flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

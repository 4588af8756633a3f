"""Readings behind a cell's limits, on the chip at the cell's own size:

    python3 kgbench/control.py --workload <name> --seeds <n> [<n> ...] \
        [--modes program tf32 witness half] [--out <file.jsonl>]

For each seed the cell's inputs are made as a run makes them, and each
mode puts something in the program's place before the run's comparison
judges it against the fp32 reference:

  * ``program``: the program's own timed path (eval: the first
    ``checked_requests`` requests; training: its checked steps, as a run's
    set-up takes them), without a measured window;
  * ``tf32``: the control, the reference with its matrix products on
    TF32-rounded operands (the precision below the configurations' fp32
    with TF32 off);
  * ``witness``: the reference in fp32, the configurations' precision: a
    second sound fp32 implementation, whose distance from the float64
    judge is the precision's own;
  * ``order``: the same with every sum over the graph's edges in the
    reverse order, another sound order of the same fp32 sums;
  * ``half``: a fault, the reference with half of each batch left out
    (eval: the second half of a request's queries answered as the first
    half's; training: the loss the mean over the first half of the rows);
  * ``altered``: a fault (eval), the reference's answers with one rank a
    request moved by one;
  * ``exchange``: a fault (a cell on several chips), the gradient
    all-reduce left out: the step of rank 0's rows alone.

A state left unchanged reads 1 by the training comparison's measure and
needs no run. The benchmark's own runs never run this. One JSON line a
seed and mode: {"seed", "mode", "numbers"}.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from kgbench import run as bench  # noqa: E402
from kgbench.lib import runtime  # noqa: E402
from kgbench.reference import common  # noqa: E402

FP32 = common.Precision(torch.float32)
PRECISIONS = {"tf32": common.Precision(torch.float32, tf32=True),
              "witness": FP32,
              "order": common.Precision(torch.float32, reverse_edges=True),
              "half": FP32, "altered": FP32, "exchange": FP32}


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def eval_readings(cell, seed, modes, device) -> dict:
    from kgbench.drivers import rank

    run = runtime.Run(seed, 0.0, False, device, time.perf_counter())
    stages = runtime.Stages(run.t_start)
    graph, params, task, request, serve = rank.prepare(cell, run, stages)
    requests = [request() for _ in range(cell.traffic["checked_requests"])]
    out = {}
    if "program" in modes:
        keeper = rank.ScoreKeeper(task, len(requests), None,
                                  (len(requests[0]), graph["entities"]),
                                  device)
        served = []
        for i, q in enumerate(requests):
            keeper.begin(i)
            served.append((q,) + tuple(serve(q)))
        kept = keeper.scores()
        del keeper
    del task, serve
    _free(device)
    if "program" in modes:
        out["program"] = rank.judge(cell, graph, params, served, kept, device)
    half = len(requests[0]) // 2
    for mode in modes:
        if mode == "program":
            continue
        asked = requests
        if mode == "half":
            asked = [q.copy() for q in requests]
            for q in asked:
                q[half:] = q[:half]
        served, kept = rank.reference_served(cell, graph, params, asked,
                                             device, PRECISIONS[mode])
        if mode in ("half", "altered"):
            served = [(q, r.copy(), c) for (_, r, c), q in
                      zip(served, requests)]
        if mode == "altered":
            for _, ranking, _ in served:
                ranking[0, 0] += 1
        out[mode] = rank.judge(cell, graph, params, served, kept, device)
        _free(device)
    return out


def train_readings(cell, seed, modes, device) -> dict:
    from kgbench.drivers import train

    run = runtime.Run(seed, 0.0, False, device, time.perf_counter())
    graphs, params, engine, kept = train.checked_steps(cell, run)
    batch = engine.batch_size
    del engine
    _free(device)
    ref = train.follow(cell, graphs, params, kept, device, common.Precision())
    out = {}
    for mode in modes:
        if mode == "program":
            out[mode] = train.compare(params, kept, ref)
            continue
        rows = {"half": batch // 2, "exchange": batch // cell.chips}
        other = train.follow(cell, graphs, params, kept, device,
                             PRECISIONS[mode], rows.get(mode))
        out[mode] = train.compare(params, other, ref)
        _free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program", "tf32"],
                   choices=list(PRECISIONS) + ["program"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    readings = (eval_readings if cell.traffic["driver"] == "rank"
                else train_readings)
    device = torch.device("cuda")
    lines = []
    for seed in args.seeds:
        for mode, numbers in readings(cell, seed, args.modes, device).items():
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "mode": mode, "numbers": numbers})
            print(line, flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of BENCHMARK.json once and print its result as the last line.

    python3 kgbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``kgbench/configs/<name>.json``: the
model's published settings and its ``family``, ``kgbench/families/``) and a
traffic mix (``kgbench/traffic/<name>.json``: the graph generator's
parameters and the ``driver``, ``kgbench/drivers/``); its limits are
``kgbench/limits/<cell>.json`` and each per-layer metric's reader is
``kgbench/metrics/<metric>.py``. A cell on several chips starts one process
a chip itself (NCCL over a TCP store on localhost).

With ``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled sub-window after
an unprofiled one, with the device's busy and window seconds and the
breakdown. Every run checks the timed path against the plain reference
(kgbench/reference/) once the window has closed and prints each compared
number beside its limit, last on stderr and last in the result line.
Exits 3 without a result when the chips are missing, 4 when the process
holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()
T_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KGBENCH = ROOT / "kgbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# caches of the program's toolchains stay inside the checkout, at fixed
# paths (the program builds its own kernels into its package's build/)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" /
                                                  "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from kgbench.lib import check, runtime  # noqa: E402


def load_cell(name: str) -> runtime.Cell:
    """The cell ``name`` of BENCHMARK.json with its files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return cell_from(bench, entry)


def cell_from(bench: dict, entry: dict) -> runtime.Cell:
    """The cell of workload entry ``entry`` (name, config, traffic, chips)
    with its files: the configuration, the traffic mix, the limits, the
    family and the readers of the per-layer metrics that list it."""
    name = entry["name"]
    cfg = json.loads((KGBENCH / "configs" / f"{entry['config']}.json")
                     .read_text())
    traffic = json.loads((KGBENCH / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    limits = json.loads((KGBENCH / "limits" / f"{name}.json").read_text())
    family = runtime.load_module(KGBENCH / "families" / f"{cfg['family']}.py",
                                 f"kgbench.families.{cfg['family']}")
    per_layer = {}
    for metric in bench["per_layer"]:
        if name in metric.get("workloads", [name]):
            reader = runtime.load_module(
                KGBENCH / "metrics" / f"{metric['name']}.py",
                f"kgbench.metrics.{metric['name']}")
            per_layer[metric["name"]] = (reader, metric["unit"])
    ends = {m["name"]: m["unit"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    return runtime.Cell(name, cfg, traffic, family, limits["limits"],
                        entry["chips"], per_layer, ends)


def driver(cell: runtime.Cell):
    return runtime.load_module(KGBENCH / "drivers" /
                               f"{cell.traffic['driver']}.py",
                               f"kgbench.drivers.{cell.traffic['driver']}")


def layer_values(cell, ctx) -> dict:
    """The per-layer metrics, busy and window seconds and breakdown of a
    traced run's context (None: the profiler recorded no device time)."""
    if ctx is None:
        return {"metrics": {}, "busy_s": None, "window_s": None,
                "breakdown": None}
    return {"metrics": runtime.read_layers(cell, ctx),
            "busy_s": ctx.trace.busy_s, "window_s": ctx.trace.window_s,
            "power_limit_w": ctx.power_limit_w,
            "breakdown": {"device_ops": ctx.trace.top_ops(),
                          "idle_gaps": ctx.trace.idle_gaps()}}


def one_process(cell, args, rank: int = 0, world: int = 1) -> dict:
    """This process's part of the run: the driver's outcome with its traced
    metrics read."""
    if world > 1:
        from ultra_torchdrug_tpu_torch.parallel import distributed

        distributed.initialize_distributed(
            world_size=world, rank=rank, local_rank=rank,
            local_world_size=world,
            init_method=f"tcp://localhost:{args.port}", device=args.device)
        device = distributed.rank_device()
    else:
        device = torch.device(args.device)
    run = runtime.Run(args.seed, args.seconds, bool(args.trace), device,
                      T_START, rank, world)
    out = driver(cell).run(cell, run)
    out["setup_wall"] = T_WALL + out["setup_s"]  # when set-up ended
    if args.trace:
        out["layers"] = layer_values(cell, out.get("layers"))
    out["forbidden"] = runtime.forbidden_modules()
    if world > 1:
        from ultra_torchdrug_tpu_torch.parallel import distributed

        distributed.shutdown()
    return out


def spawn(cell, args) -> list:
    """One process a chip, each running its rank of the cell; their
    outcomes, rank 0 first."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    world = cell.chips
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        procs = []
        for rank in range(world):
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--rank", str(rank), "--world", str(world),
                   "--port", str(port), "--out", f"{tmp}/{rank}.json"]
            procs.append(subprocess.Popen(cmd))
        codes = [p.wait() for p in procs]
        if any(codes):
            raise SystemExit(f"ranks exited {codes}")
        return [json.loads(Path(f"{tmp}/{r}.json").read_text())
                for r in range(world)]


def merge(parts: list) -> dict:
    """The run's outcome from its ranks': rank 0's rate and checks, each
    rank's non-finite losses, the fullest chip's memory, the slowest rank's
    set-up, and the chips' mean busy share."""
    out = dict(parts[0])
    out["peak_bytes"] = max(p["peak_bytes"] for p in parts)
    out["setup_wall"] = max(p["setup_wall"] for p in parts)
    out["metrics"] = dict(out["metrics"],
                          peak_mem_gib=max(p["metrics"]["peak_mem_gib"]
                                           for p in parts))
    out["numbers"] = dict(out["numbers"], loss_nonfinite=sum(
        p["numbers"]["loss_nonfinite"] for p in parts))
    out["forbidden"] = sorted({m for p in parts for m in p["forbidden"]})
    if "layers" in out and out["layers"]["busy_s"] is not None:
        layers = dict(out["layers"])
        for key in ("busy_s", "window_s"):
            layers[key] = sum(p["layers"][key] for p in parts) / len(parts)
        for name in ("idle_pct.train",):
            if name in layers["metrics"]:
                layers["metrics"][name] = dict(layers["metrics"][name], value=(
                    sum(p["layers"]["metrics"][name]["value"] for p in parts)
                    / len(parts)))
        out["layers"] = layers
    return out


def result(cell, args, out) -> dict:
    """The contract's result line, the compared numbers last."""
    correct, rows = check.judge(out["numbers"], cell.limits)
    if args.trace:
        layers = out["layers"]
        metrics = layers["metrics"]
    else:
        setup_s = out["setup_wall"] - T_WALL
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {k: {"value": values[k], "unit": unit}
                   for k, unit in cell.end_to_end.items()}
    device = runtime.device_info(args.device, cell.chips, out["peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = layers["busy_s"]
        device["window_s"] = layers["window_s"]
        line["card"] = {"power_limit_w": layers.get("power_limit_w")}
        if layers["breakdown"] is not None:
            line["breakdown"] = layers["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in rows}
    return line, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.device = "cuda"
    if args.seed < 0:
        p.error("--seed is a whole number >= 0")
    cell = load_cell(args.workload)

    if args.rank is not None:  # one rank of a cell on several chips
        out = one_process(cell, args, args.rank, args.world)
        Path(args.out).write_text(json.dumps(out))
        return 0
    if not (torch.cuda.is_available()
            and torch.cuda.device_count() >= cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if cell.chips > 1:
        out = merge(spawn(cell, args))
    else:
        out = one_process(cell, args)
    forbidden = sorted(set(out["forbidden"]) | set(runtime.forbidden_modules()))
    if forbidden:
        print(f"the run loaded {forbidden}: the benchmark may not",
              file=sys.stderr)
        return 4
    line, rows = result(cell, args, out)
    print(f"{args.workload} seed {args.seed}: {out['attempted']} in the "
          f"window, reference {out['reference_s']:.2f} s", file=sys.stderr)
    check.report(rows)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

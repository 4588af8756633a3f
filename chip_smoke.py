#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (ultra_torchdrug_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py                # on a machine with the card
    python3 chip_smoke.py --device cpu   # rehearsal of phases 2-3, reduced size

Phases, each of which raises on failure (the script then exits nonzero):

  0. build    every kernel source in ultra_torchdrug_tpu_torch/csrc/ with nvcc,
              all at once, and print the build time and ptxas' resource lines;
  1. kernels  hold K1 (the rspmm forward, csrc/rspmm_fwd.cu) against its plain
              PyTorch version in modes mul_rel and add_rel, at small and ragged
              shapes and at the slice's full-width shape, and time it;
  2. slice    zero-shot evaluation of ULTRA (6x64 towers, seeded weights) on a
              synthetic KG of FB15k-237's size: 64 test triples in batches of
              16, through TransductiveKGTask.evaluate; K1 must launch 12 times
              per batch, the metrics must be finite; then one more batch under
              torch.profiler for device time by kernel;
  3. parity   the card's tail and head scores for 2 test queries against the
              port's own CPU run (plain versions) on the same graph and weights.

The last lines are a JSON object with one entry per kernel, then
{"ok": true, "device": {...}}. With no card the script prints no result and
exits nonzero; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PACKAGE = "ultra_torchdrug_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# slice shape: FB15k-237's entity, triple and relation counts
FULL = dict(num_nodes=14541, num_edges=310116, num_relations=237)
REHEARSAL = dict(num_nodes=1500, num_edges=20000, num_relations=40)
EVAL_BATCH = 16
FAST_TEST = 64
K1_LAUNCHES_PER_BATCH = 12  # 6 entity layers x (tail + head scoring)


def log(*args):
    print(*args, flush=True)


def import_port():
    """Import the port from this checkout, and only from it."""
    if not (REPO / PACKAGE / "__init__.py").exists():
        raise SystemExit(f"{PACKAGE}/ is not beside {Path(__file__).name}: "
                         "run the script from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import ultra_torchdrug_tpu_torch as port

    if Path(port.__file__).resolve().parent != REPO / PACKAGE:
        raise SystemExit(f"imported {port.__file__}, not this checkout's")
    return port


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from ultra_torchdrug_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.sources())
    seconds = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel source(s) in {seconds:.1f} s: "
        f"{sorted(libs)}")
    for name, lib in sorted(libs.items()):
        logfile = lib.with_suffix(".so.log")
        lines = logfile.read_text().splitlines() if logfile.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def k1_operands(graph, feat: int, seed: int, device):
    """K1's operands on ``graph`` (with its CSR): x [V, F], rel [R, F]
    ~ N(0, 1) from a seeded generator, and edge weights in [0.5, 1.5] with a
    fifth of the edges masked to 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    V, R, E = graph.num_nodes, graph.num_relations, graph.num_edges
    x = torch.randn((V, feat), generator=gen, device=device)
    rel = torch.randn((R, feat), generator=gen, device=device)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    csr = graph.csr.to(device)
    return (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)


def k1_bound_ms(operands) -> tuple:
    """Least time for K1's work on this card: each input read once and the
    output written once over the memory rate, against 3 fp32 operations per
    edge and feature (message, weight, sum) over the fp32 peak."""
    rowptr, src, etype, eid, w, rel, x = operands
    E, F = src.numel(), x.shape[1]
    V = rowptr.numel() - 1
    nbytes = sum(t.numel() * t.element_size() for t in operands) + V * F * 4
    flops = 3 * E * F
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(dataset, device):
    """K1 against its plain version; returns its kernels-line entry (without
    the main path's launch count)."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    tol = dict(rtol=1e-5, atol=1e-5)
    # (a) small and ragged shapes: F = 10 and 12 take the scalar path, 64 the
    # float4 path, 1028 two feature tiles; rows 32.. of the first graph and
    # 45.. of the second receive no edge
    rng = np.random.default_rng(0)
    for V, E, R, F, empty in ((37, 300, 6, 10, 5), (37, 300, 6, 64, 5),
                              (37, 300, 6, 1028, 5), (50, 20, 3, 12, 5)):
        tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - empty, E),
                        rng.integers(0, R, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr()
        ops = k1_operands(g, F, seed=V + F, device=device)
        for mode in ("mul_rel", "add_rel"):
            got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode)
            want = rspmm_cuda.rspmm_fwd_plain(*ops, mode)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            if not torch.all(got[V - empty:] == 0):
                raise AssertionError("K1 wrote nonzero rows without edges")
            err = (got - want).abs().max().item()
            log(f"[kernels] K1 {mode} V={V} E={E} R={R} F={F}: "
                f"max_abs_err {err:.3g}")

    # (b) the full-width shape of the slice: the undirected FB-sized fact
    # graph, F = 16 queries x 64 features
    fact, _ = dataset.fact_graph(None)
    und = fact.undirected_with_inverse().prepare_csr()
    F = EVAL_BATCH * 64
    ops = k1_operands(und, F, seed=1, device=device)
    log(f"[kernels] full-width shape V={und.num_nodes} E={und.num_edges} "
        f"R={und.num_relations} F={F}")
    entry = None
    for mode in ("mul_rel", "add_rel"):
        got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode)
        want = rspmm_cuda.rspmm_fwd_plain(*ops, mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        del got, want
        ms = cuda_time_ms(lambda: rspmm_cuda.rspmm_fwd_cuda(*ops, mode), 50)
        plain_ms = cuda_time_ms(
            lambda: rspmm_cuda.rspmm_fwd_plain(*ops, mode), 5, warmup=1)
        bound_ms, bound_by = k1_bound_ms(ops)
        log(f"[kernels] K1 {mode}: max_abs_err {err:.3g}, {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), library_ms: null "
            "(no single PyTorch call computes this function)")
        if mode == "mul_rel":  # the main path's mode
            entry = dict(
                name="K1", route="cuda",
                source=f"{PACKAGE}/csrc/rspmm_fwd.cu",
                replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:1681",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    log('[kernels] kernels ["K1"]')
    return entry


def phase_slice(task, model, device):
    """Zero-shot evaluation through the task's entry point; returns K1's
    launches in the measured run."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    # one batch first: cuBLAS handles, allocator pools and the kernel library
    # load are set-up, not evaluation
    task.evaluate(model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    batches = math.ceil(FAST_TEST / EVAL_BATCH)
    rspmm_cuda.launches = 0
    t0 = time.perf_counter()
    metrics = task.evaluate(model, "test", batch_size=EVAL_BATCH,
                            fast_test=FAST_TEST)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rspmm_cuda.launches
    want = K1_LAUNCHES_PER_BATCH * batches if device.type == "cuda" else 0
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times in {batches} "
                             f"eval batches, expected {want}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[slice] {FAST_TEST} test triples in {batches} batches of "
        f"{EVAL_BATCH}: {seconds * 1e3 / batches:.2f} ms per eval batch, "
        f"{FAST_TEST / seconds:.1f} triples/s, peak device memory "
        f"{peak:.3f} GiB ({device})")
    log(f"[slice] K1 launches {launches} ({launches / batches:.0f} per batch)")
    log(f"[slice] metrics {json.dumps(metrics)}")
    return launches


def phase_profile(task, model):
    """Device time by kernel over one eval batch (torch.profiler), and the
    device's busy share of that batch's wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.evaluate(model, "test", batch_size=EVAL_BATCH,
                      fast_test=EVAL_BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log("[profile] the profiler recorded no device time: not measured")
        return
    log(f"[profile] one eval batch: device busy {device_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall under the profiler "
        f"({device_ms / wall_ms:.1%} busy)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile] {ms:9.3f} ms {ms / device_ms:6.1%} x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_parity(task, model, device):
    """Card scores for 2 test queries against the port's CPU run."""
    from ultra_torchdrug_tpu_torch.models.ultra import ultra_eval_scores

    batch = torch.from_numpy(task.dataset.test[:2].astype(np.int64))
    und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
    cpu = torch.device("cpu")
    cpu_model = copy.deepcopy(model).to(cpu)
    results = []
    with torch.inference_mode():
        for m, dev, g_und, g_rel in ((model, device, und, rel_graph),
                                     (cpu_model, cpu, und.to(cpu),
                                      rel_graph.to(cpu))):
            b = batch.to(dev)
            t, h = ultra_eval_scores(m, task.fact_graph, g_rel, b[:, 0],
                                     b[:, 1], b[:, 2], fact_graph_und=g_und)
            results.append((t.cpu(), h.cpu()))
    (t_dev, h_dev), (t_cpu, h_cpu) = results
    for name, a, b in (("tail", t_dev, t_cpu), ("head", h_dev, h_cpu)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} scores on {device}")
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        log(f"[parity] {name} scores {tuple(a.shape)} {device} vs cpu: "
            f"max_abs_err {(a - b).abs().max().item():.3g}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cpu rehearses phases 2-3 at a reduced size with the plain "
             "versions and reports no result")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on "
              "the card (--device cpu rehearses without one)",
              file=sys.stderr)
        return 1
    import_port()
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask

    device = torch.device(args.device)
    size = FULL if device.type == "cuda" else REHEARSAL
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    entry = None
    if device.type == "cuda":
        log(nvidia_smi_line())
        log(f"[env] device {torch.cuda.get_device_name(0)}, "
            f"count {torch.cuda.device_count()}")
        phase_build()

    t0 = time.perf_counter()
    dataset = synthetic_transductive("SynthFB15k237", seed=0, **size)
    log(f"[data] synthetic KG {size}: {len(dataset.train)} train / "
        f"{len(dataset.valid)} valid / {len(dataset.test)} test triples "
        f"({time.perf_counter() - t0:.1f} s)")
    if device.type == "cuda":
        entry = phase_kernels(dataset, device)

    t0 = time.perf_counter()
    task = TransductiveKGTask(dataset, UltraConfig.default(
        dataset.num_relations), device=device)
    model = task.init_params(seed=0)
    log(f"[slice] task set-up (relation graph {task.rel_graph.num_nodes} "
        f"nodes / {task.rel_graph.num_edges} edges, CSR, dense adjacency) "
        f"{time.perf_counter() - t0:.1f} s")
    launches = phase_slice(task, model, device)
    if device.type == "cuda":
        phase_profile(task, model)
    phase_parity(task, model, device)

    if device.type != "cuda":
        log("[rehearsal] phases 2-3 ran on the CPU; no kernel ran and no "
            "result is reported")
        return 1
    entry["launches"] = launches
    log(nvidia_smi_line())
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

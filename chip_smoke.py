#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (ultra_torchdrug_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py                # on a machine with the card
    python3 chip_smoke.py --device cpu   # rehearsal of phases 2-25, reduced size

Phases, each of which raises on failure (the script then exits nonzero):

  0. build    every kernel source in ultra_torchdrug_tpu_torch/csrc/ with nvcc,
              all at once, and print the build time and ptxas' resource lines;
  1. kernels  hold K1 (the rspmm forward, csrc/rspmm_fwd.cu) against its plain
              PyTorch version in modes mul_rel and add_rel, at small and ragged
              shapes and at the eval and training shapes, and time it; hold K2
              (the rspmm backward, csrc/rspmm_bwd.cu) against its plain
              version at small and ragged shapes and at the training shape,
              check that two calls agree bitwise, and time it; hold K6 (the
              fused max+min, both modes) and K7 (the fused moments,
              csrc/rspmm_pna_fwd.cu) and K6b and K7b (their backward,
              csrc/rspmm_pna_bwd.cu, bitwise across two calls) against their
              plain versions at ragged shapes and at F=512 and F=2048, and
              time each; hold K4 (one extremum, max and min, both modes,
              csrc/rspmm_pna_fwd.cu) exactly, K5 (its argext backward,
              csrc/rspmm_pna_bwd.cu, on K4's own output) and K3 (the transe
              backward, csrc/rspmm_bwd.cu), both bitwise across two calls,
              against their plain versions at ragged shapes and at F=2048
              (K4 also F=512), time each, and time K3's function as two
              torch.sparse.mm calls; hold K8f and K8b (the rotate forward
              and backward, csrc/rspmm_rotate.cu; K8b bitwise across two
              calls) against their plain versions at ragged shapes (D/2 = 3,
              5 and 6 take the scalar path, 4 and 16 the float4 path) and
              at F=512 and F=2048 with D=32, shared and per-batch
              relations, and time each; hold K1h and K2h (the bf16 operand
              mode, csrc/rspmm_fwd.cu and csrc/rspmm_bwd.cu; K2h bitwise
              across two calls) against their plain versions at ragged
              shapes (F not a multiple of 8 takes the scalar path), shared
              and per-batch relations, and at F=1024 (K1h) and F=4096
              (both), and time each beside K1 and K2 on the same values;
  2. slice    zero-shot evaluation of ULTRA (6x64 towers, seeded weights) on a
              synthetic KG of FB15k-237's size: 64 test triples in batches of
              16, through TransductiveKGTask.evaluate; K1 must launch 12 times
              per batch, the metrics must be finite; then one more batch under
              torch.profiler for device time by kernel;
  3. parity   the card's tail and head scores for 2 test queries against the
              port's own CPU run (plain versions) on the same graph and weights;
  4. train    training steps of the same model through Engine.train (batch 64,
              128 strict negatives, AdamW): one warm-up step, then timed steps;
              K1 and K2 must each launch 6 times per step, every loss and
              gradient norm must be finite; then one step under torch.profiler;
  5. train parity  one loss step (2 queries, 8 injected negatives, the full
              graph) on the card against the port's CPU run: the loss and
              every parameter's gradient;
  6. classic  evaluation of classic NBFNet (6x32, PNA aggregation, distmult,
              dependent relations, layer norm; seeded weights) on the same KG
              through ClassicNBFNetTask.evaluate, 64 test triples in batches of
              16: K6 and K7 must launch 12 times per batch and no other
              kernel; then one batch under torch.profiler;
  7. classic parity  as phase 3, for classic NBFNet, and a count of the PNA
              variances clipped on one device and not the other;
  8. classic train  Engine.train of classic NBFNet at batch 64, 32 strict
              negatives, Adam at lr 5e-3: one warm-up step, then timed steps;
              K6, K7, K6b and K7b must each launch 6 times per step and no
              other kernel; then one step under torch.profiler;
  9. classic train parity  as phase 5, for classic NBFNet.
 10-12. classic max  phases 6, 7 and 8-9 for classic NBFNet with
              aggregate_func="max" (distmult): K4 must launch 12 times per
              eval batch, K4 and K5 6 times each per step, and no other
              kernel;
 13-15. classic transe-pna  the same for message_func="transe" (pna): K1 24
              and K6 12 times per eval batch; K1 12, K6 6, K3 12 and K6b 6
              times per step, and no other kernel (K7 and K7b never: transe's
              moments are two sums).
 16-18. classic rotate  the same for message_func="rotate" with
              aggregate_func="sum": K8f 12 times per eval batch, K8f and K8b
              6 times each per step, and no other kernel;
 19-20. classic rotate-pna  phases 6 and 7 for message_func="rotate" (pna):
              K8f 12 times per eval batch (PNA's first moment) and no other
              kernel (max, min and the second moment take the O(E) route in
              plain PyTorch, as in the JAX package); no training phase: at
              F=2048 the O(E) route would keep about 220 GB for autograd.
 21-24. ultra bf16  ULTRA with config/transductive/inference.yaml's model and
              task sections and compute_dtype: bfloat16, built through
              build_dataset, build_task and build_engine on the same KG:
              evaluation (K1h 12 times per batch and no other kernel), its
              profile, card vs CPU scores (BF16_* limits), the bf16 - fp32
              score difference and both MRRs on the same weights; then
              Engine.train at batch 64, 128 strict negatives, AdamW (K1h and
              K2h 6 times each per step), its profile, and one loss step's
              gradients against the CPU.
    25. cli   run_full.main on config/synthetic/smoke.yaml (one epoch, its
              checkpoint and log) and on config/transductive/inference.yaml
              with --dataset SynthKG --epochs 0 --bpe 0 --gpus [0] --ckpt null.

The last lines are a JSON object with one entry per kernel (K1, K2, K6,
K7, K6b, K7b, K3, K4, K5, K8f, K8b, K1h, K2h; launches summed over the
measured runs of phases 2-25, by path in ``launches_by_path``), then
{"ok": true,
"device": {...}}. With no card the script prints no result and exits
nonzero; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import tempfile
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
# training: config/transductive/pretrain_3g.yaml's engine batch and negatives
TRAIN = dict(batch=64, negatives=128, steps=5)
TRAIN_REHEARSAL = dict(batch=8, negatives=16, steps=2)
K_LAUNCHES_PER_STEP = 6  # 6 entity layers, one pass over the flipped batch
FEAT = 64  # the model's feature width
# classic NBFNet: the NBFNet paper's FB15k-237 setting (config/knowledge_graph/
# fb15k237.yaml of DeepGraphLearning/NBFNet): 6x32, pna, distmult, dependent
# relations, layer norm; training at batch 64 with 32 strict negatives and
# Adam at lr 5e-3
CLASSIC_FEAT = 32
CLASSIC_TRAIN = dict(batch=64, negatives=32, steps=5)
CLASSIC_TRAIN_REHEARSAL = dict(batch=8, negatives=8, steps=2)
# every kernel of the port, in the order of the kernels line
KERNEL_IDS = ("K1", "K2", "K6", "K7", "K6b", "K7b", "K3", "K4", "K5", "K8f",
              "K8b", "K1h", "K2h")
# card vs CPU for classic NBFNet: about 10x the largest reading of five H100
# runs (scores 4.5e-7, gradients 5.8e-6 norm-wise); the CPU's plain K7 sums in
# another order, and std = sqrt(clip(sq_mean - mean², 1e-6)) amplifies that
# rounding up to 500x near the clip (phase 7 counts the entries clipped on
# one device only); the loss is held to ULTRA's 1e-5
CLASSIC_SCORE_ATOL = 1e-5
CLASSIC_GRAD_RTOL = 1e-4
# card vs CPU for ULTRA in bf16 operand mode: both round the same fp32
# operands to bf16, but a layer's fp32 output differs in its last bits
# between the two devices (sums in another order, ~1e-7 relative), and
# where that straddles a bf16 rounding boundary (a share of about
# 1e-7 / 2^-8 of the operands) the next layer's operand moves by 2^-8 of
# itself. The limits leave room for such moves and stay well below the
# bf16 - fp32 difference on the same weights, which is printed beside them
BF16_SCORE_ATOL = 5e-4
BF16_LOSS_RTOL = 2e-5
BF16_GRAD_RTOL = 5e-3


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


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel id."""
    from ultra_torchdrug_tpu_torch.ops import (
        rspmm_bwd_cuda,
        rspmm_cuda,
        rspmm_pna_cuda,
    )

    counts = {"K1": rspmm_cuda.launches, "K8f": rspmm_cuda.rotate_launches,
              "K1h": rspmm_cuda.bf16_launches, **rspmm_bwd_cuda.launches,
              **rspmm_pna_cuda.launches}
    return {k: counts[k] for k in KERNEL_IDS}


def reset_launch_counts():
    from ultra_torchdrug_tpu_torch.ops import (
        rspmm_bwd_cuda,
        rspmm_cuda,
        rspmm_pna_cuda,
    )

    rspmm_cuda.launches = rspmm_cuda.rotate_launches = 0
    rspmm_cuda.bf16_launches = 0
    for counts in (rspmm_bwd_cuda.launches, rspmm_pna_cuda.launches):
        for key in counts:
            counts[key] = 0


def check_launches(label: str, counts: dict, per_unit: dict, units: int,
                   device):
    """Each kernel in ``per_unit`` launched that many times per unit (eval
    batch or train step) and every other kernel never; on the CPU none."""
    want = {k: per_unit.get(k, 0) * units if device.type == "cuda" else 0
            for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} in {units} units, "
                             f"expected {want}")


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


def roofline_ms(nbytes: int, flops: int) -> tuple:
    """(the larger of nbytes over the memory rate and flops over the fp32
    peak, in ms; which of the two it is)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def edge_bytes(num_edges: int) -> int:
    """The compulsory bytes of a graph's edges: one int32 edge list (source,
    destination, type) and one fp32 weight per edge, read once. The kernels'
    own layouts (CSRs, eid arrays, chunks) are a design's cost, not the
    function's."""
    return num_edges * (3 * 4 + 4)


def k1_bound_ms(operands) -> tuple:
    """Least time for K1's (or K1h's) work on this card: the edges, rel and
    x read once (4 B a feature, 2 B for bf16 operands) and the fp32 output
    written once over the memory rate, against 3 fp32 operations per edge
    and feature (message, weight, sum) over the fp32 peak."""
    rowptr, src, etype, eid, w, rel, x = operands
    E = src.numel()
    V, F = rowptr.numel() - 1, x.shape[1]
    nbytes = (edge_bytes(E) + (rel.numel() + x.numel()) * x.element_size()
              + V * F * 4)
    return roofline_ms(nbytes, 3 * E * F)


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


def k2_bound_ms(csr, w, rel, x, g) -> tuple:
    """Least time for K2's (or K2h's) work on this card: the edges, x, g and
    rel read once (4 B a feature, 2 B for bf16 operands) and the fp32 dx and
    dr written once over the memory rate, against 6 fp32 operations per
    edge and feature (3 for dx, 3 for dr) over the fp32 peak."""
    E, F = w.numel(), x.shape[1]
    nbytes = edge_bytes(E) + (x.numel() + g.numel() + rel.numel()) * (
        x.element_size())
    nbytes += (x.numel() + rel.numel()) * 4  # dx, dr
    return roofline_ms(nbytes, 6 * E * F)


def k2_operands(graph, feat: int, seed: int, device):
    """K2's operands on ``graph``: the layouts, masked weights (a fifth 0),
    rel [R, F], x and g [V, F] ~ N(0, 1)."""
    _, _, _, _, w, rel, x = k1_operands(graph, feat, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g = torch.randn(x.shape, generator=gen, device=device)
    return graph.csr.to(device), w, rel, x, g


def phase_kernels_k2(und, device):
    """K2 against its plain version; returns its kernels-line entry."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda

    # dr rows sum up to ~1000 products of N(0, 1) values per relation in
    # another order than the plain version: 1e-4 absolute
    tol = dict(rtol=1e-5, atol=1e-4)

    def check(ops, label):
        dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*ops)
        torch.cuda.synchronize()
        dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*ops)
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
            raise AssertionError(f"K2 {label}: two calls differ")
        want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_plain(*ops)
        torch.testing.assert_close(dx, want_dx, **tol)
        torch.testing.assert_close(dr, want_dr, **tol)
        err = max((dx - want_dx).abs().max().item(),
                  (dr - want_dr).abs().max().item())
        log(f"[kernels] K2 {label}: max_abs_err {err:.3g}, bitwise equal "
            "across two calls")
        return dx, dr, err

    # (a) small and ragged shapes: F = 10 and 12 scalar, 64 float4, 1028 two
    # feature tiles; the last 5 rows send no edge and the last relation has
    # none; the (60, 1400, 3) graph spreads ~700 edges over each of two
    # relations, three chunks each
    rng = np.random.default_rng(1)
    for V, E, R, F in ((37, 300, 6, 10), (37, 300, 6, 64), (37, 300, 6, 1028),
                       (50, 20, 3, 12), (60, 1400, 3, 64)):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        dx, dr, _ = check(k2_operands(g, F, seed=V + F, device=device),
                          f"V={V} E={E} R={R} F={F}")
        if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K2 wrote nonzero rows without edges")

    # (b) the training shape: F = 64 queries x 64 features
    F = TRAIN["batch"] * FEAT
    ops = k2_operands(und, F, seed=2, device=device)
    label = (f"training shape V={und.num_nodes} E={und.num_edges} "
             f"R={und.num_relations} F={F}")
    _, _, err = check(ops, label)
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*ops), 20)
    plain_ms = cuda_time_ms(lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*ops), 3,
                            warmup=1)
    bound_ms, bound_by = k2_bound_ms(*ops)
    log(f"[kernels] K2 {label}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of it), "
        "library_ms: null (no single PyTorch call computes this function)")
    log('[kernels] kernels ["K2"]')
    return dict(name="K2", route="cuda",
                source=f"{PACKAGE}/csrc/rspmm_bwd.cu",
                replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:2110",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def time_k1_train_shape(und, device) -> dict:
    """K1 (mul_rel) at the training shape, F = 64 x 64: time, plain time and
    bound, as extra keys of K1's kernels-line entry."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda

    ops = k1_operands(und, TRAIN["batch"] * FEAT, seed=3, device=device)
    got = rspmm_cuda.rspmm_fwd_cuda(*ops, "mul_rel")
    want = rspmm_cuda.rspmm_fwd_plain(*ops, "mul_rel")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: rspmm_cuda.rspmm_fwd_cuda(*ops, "mul_rel"), 20)
    plain_ms = cuda_time_ms(
        lambda: rspmm_cuda.rspmm_fwd_plain(*ops, "mul_rel"), 3, warmup=1)
    bound_ms, bound_by = k1_bound_ms(ops)
    log(f"[kernels] K1 mul_rel training shape F={ops[-1].shape[1]}: "
        f"max_abs_err {err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of it)")
    return dict(max_abs_err_train=err, ms_train=ms, plain_ms_train=plain_ms,
                bound_ms_train=bound_ms, bound_by_train=bound_by)


def pna_operands(graph, feat: int, seed: int, device):
    """K6/K7's operands on ``graph`` (with its CSR): x [V, F] as post-ReLU
    node states (about half the entries exactly 0, so messages tie), rel
    [R, F] ~ N(0, 1), and edge weights in [0.5, 1.5] with a fifth masked to
    0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    V, R, E = graph.num_nodes, graph.num_relations, graph.num_edges
    x = torch.randn((V, feat), generator=gen, device=device).clamp_(min=0)
    rel = torch.randn((R, feat), generator=gen, device=device)
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    return graph.csr.to(device), w, rel, x


# per kernel: (node rows read, relation rows read, node rows written,
# relation rows written, fp32 operations per edge and feature). K4: message
# 2, extremum; K6: message 2, max, min; K7: message, weight, two sums,
# square; K6b: message 2, two gates, the gated sum g_mx + g_mn, one
# weighting, then dx and dr 2 each; K5: message 2, one gate, one weighting,
# dx and dr 2 each; K7b with w factored out and 2·g_sq formed once per
# node, c = w·(g_s + m·(2·g_sq)): message, product, sum, weighting, dx and
# dr 2 each; K3: the weighting g·w, shared by the dx and dr sums; K8f: the
# complex product (3 per real lane), the weight, the sum; K8b: the same for
# dx and for dr
GATHER_WORK = {"K4": (1, 1, 1, 0, 3), "K6": (1, 1, 2, 0, 4),
               "K7": (1, 1, 2, 0, 5), "K6b": (5, 1, 1, 1, 10),
               "K5": (3, 1, 1, 1, 8), "K7b": (3, 1, 1, 1, 8),
               "K3": (1, 0, 1, 1, 3), "K8f": (1, 1, 1, 0, 5),
               "K8b": (2, 1, 1, 1, 10)}


def gather_bound_ms(name: str, w, rel, x) -> tuple:
    """Least time for a gather kernel's work on this card (GATHER_WORK):
    its dense inputs read once and outputs written once, plus the edges,
    over the memory rate, against its fp32 operations over the fp32
    peak."""
    E, V, F = w.numel(), x.shape[0], x.shape[1]
    R = rel.shape[0]
    node_in, rel_in, node_out, rel_out, ops = GATHER_WORK[name]
    rows = (node_in + node_out) * V + (rel_in + rel_out) * R
    return roofline_ms(edge_bytes(E) + rows * F * 4, ops * E * F)


def assert_bwd_close(got, want):
    """A two-pass backward kernel (K3, K5, K6b, K7b) against its plain
    version: K2's tolerance, with the absolute one widened to 1e-5 of the
    result's largest entry: a dr row sums a thousand or more terms (K7b's
    carry x² and reach ~1e2), whose partial sums grow to that size, in
    another order than the plain version."""
    atol = max(1e-4, 1e-5 * want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def check_bwd_kernel(kid: str, run, plain, label: str,
                     dx_close=assert_bwd_close) -> tuple:
    """``run`` (a backward kernel's call) twice, bitwise equal, and within
    assert_bwd_close of ``plain`` (dx within ``dx_close``); returns (dx, dr,
    max_abs_err)."""
    dx, dr = run()
    torch.cuda.synchronize()
    dx2, dr2 = run()
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dr, dr2)):
        raise AssertionError(f"{kid} {label}: two calls differ")
    want_dx, want_dr = plain()
    dx_close(dx, want_dx)
    assert_bwd_close(dr, want_dr)
    err = max((dx - want_dx).abs().max().item(),
              (dr - want_dr).abs().max().item())
    log(f"[kernels] {kid} {label}: max_abs_err {err:.3g}, bitwise equal "
        "across two calls")
    return dx, dr, err


def ragged_gather_cases(seed: int, device):
    """Small and ragged shapes for the gather kernels, as (label, V, R,
    seed, operands), the operands made from ``seed``: F = 10 and 12 scalar, 64 float4, 1028 two feature tiles; the
    last 5 rows neither send nor receive an edge and the last relation has
    none; 40 duplicated edges tie exactly."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph

    rng = np.random.default_rng(seed)
    for V, E, R, F in ((37, 300, 6, 10), (37, 300, 6, 64), (37, 300, 6, 1028),
                       (50, 20, 3, 12), (60, 1400, 3, 64)):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        tri[-min(40, E // 2):] = tri[:min(40, E // 2)]
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        yield (f"V={V} E={E} R={R} F={F}", V, R, V + F,
               pna_operands(g, F, seed=V + F, device=device))


def phase_kernels_pna(und, device) -> dict:
    """K6, K7, K6b and K7b against their plain versions; returns their
    kernels-line entries by id (without the main path's launch counts)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    # K6 exactly (an extremum of the same fp32 products); K7 as K1; the
    # backward as assert_bwd_close says
    tol = dict(rtol=1e-5, atol=1e-5)

    fwd_kinds = (("K6", "maxmin", "mul_rel"), ("K6", "maxmin", "add_rel"),
                 ("K7", "addsq", "mul_rel"))
    bwd_kinds = (("K6b", "argext_pair", "mul_rel"),
                 ("K6b", "argext_pair", "add_rel"),
                 ("K7b", "moments", "mul_rel"))

    def planes(kind, mode, ops, seed):
        """The backward's planes: K6's own outputs (so the gates fire on
        the card's bits) and seeded gradients."""
        csr, w, rel, x = ops
        gen = torch.Generator(device=device).manual_seed(seed)
        g = [torch.randn(x.shape, generator=gen, device=device)
             for _ in range(2)]
        if kind == "moments":
            return tuple(g)
        mx, mn = pna.pna_fwd_cuda("maxmin", csr, w, rel, x, mode)
        return g[0], mx, g[1], mn

    def check_fwd(kid, kind, mode, ops, label):
        got = pna.pna_fwd_cuda(kind, *ops, mode)
        want = pna.pna_fwd_plain(kind, *ops, mode)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if kid == "K6":
                if not torch.equal(a, b):
                    raise AssertionError(f"{kid} {mode} {label}: differs from "
                                         "its plain version")
            else:
                torch.testing.assert_close(a, b, **tol)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        log(f"[kernels] {kid} {mode} {label}: max_abs_err {err:.3g}")
        return got, err

    def check_bwd(kid, kind, mode, ops, q, label):
        return check_bwd_kernel(
            kid, lambda: pna.pna_bwd_cuda(kind, *ops, q, mode),
            lambda: pna.pna_bwd_plain(kind, *ops, q, mode),
            f"{mode} {label}")

    # (a) small and ragged shapes
    for label, V, R, seed, ops in ragged_gather_cases(2, device):
        for kid, kind, mode in fwd_kinds:
            out, _ = check_fwd(kid, kind, mode, ops, label)
            if not all(torch.all(o[V - 5:] == 0) for o in out):
                raise AssertionError(f"{kid} wrote nonzero rows without "
                                     "edges")
        for i, (kid, kind, mode) in enumerate(bwd_kinds):
            q = planes(kind, mode, ops, seed=seed + i)
            dx, dr, _ = check_bwd(kid, kind, mode, ops, q, label)
            if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
                raise AssertionError(f"{kid} wrote nonzero rows without "
                                     "edges")

    # (b) the main path's shapes on the FB-sized graph: F = 16 x 32 (eval)
    # for the forwards, F = 64 x 32 (training) for all four
    entries = {}
    for F, which in ((EVAL_BATCH * CLASSIC_FEAT, "eval"),
                     (CLASSIC_TRAIN["batch"] * CLASSIC_FEAT, "train")):
        ops = pna_operands(und, F, seed=F, device=device)
        label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                 f"R={und.num_relations} F={F}")
        timed = []
        for kid, kind, mode in fwd_kinds:
            out, err = check_fwd(kid, kind, mode, ops, label)
            del out
            timed.append((kid, mode, err,
                          lambda kind=kind, mode=mode: pna.pna_fwd_cuda(
                              kind, *ops, mode),
                          lambda kind=kind, mode=mode: pna.pna_fwd_plain(
                              kind, *ops, mode)))
        if which == "train":
            for i, (kid, kind, mode) in enumerate(bwd_kinds):
                q = planes(kind, mode, ops, seed=F + i)
                dx, dr, err = check_bwd(kid, kind, mode, ops, q, label)
                del dx, dr
                timed.append((kid, mode, err,
                              lambda kind=kind, mode=mode, q=q:
                              pna.pna_bwd_cuda(kind, *ops, q, mode),
                              lambda kind=kind, mode=mode, q=q:
                              pna.pna_bwd_plain(kind, *ops, q, mode)))
        torch.cuda.empty_cache()
        for kid, mode, err, kernel, plain in timed:
            ms = cuda_time_ms(kernel, 20)
            plain_ms = cuda_time_ms(plain, 3, warmup=1)
            bound_ms, bound_by = gather_bound_ms(kid, *ops[1:])
            log(f"[kernels] {kid} {mode} {label}: {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                f"{bound_ms / ms:.1%} of it), library_ms: null (no single "
                "PyTorch call computes this function)")
            keys = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            if mode != "mul_rel":  # the main path is distmult
                entries[kid].update({f"ms_{mode}_{which}": ms,
                                     f"max_abs_err_{mode}_{which}": err})
                continue
            if kid not in entries:
                source = ("rspmm_pna_fwd.cu" if kid in ("K6", "K7")
                          else "rspmm_pna_bwd.cu")
                entries[kid] = dict(
                    name=kid, route="cuda",
                    source=f"{PACKAGE}/csrc/{source}",
                    replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:" + {
                        "K6": "1869", "K7": "1990", "K6b": "2453",
                        "K7b": "2453"}[kid],
                    launches=None, library_ms=None, **keys)
            elif which == "train":  # the forwards' second shape
                entries[kid].update({f"{k}_train": v for k, v in keys.items()})
        del ops
        torch.cuda.empty_cache()
    log('[kernels] kernels ["K6", "K7", "K6b", "K7b"]')
    return entries


def sparse_mm_halves(csr, w):
    """K3's function as two library calls (timed beside K3, never used by
    the port): dx = Aᵀ g and dr = T g, with Aᵀ[s, v] and T[r, v] the summed
    weights of the edges s → v and of the type-r edges into v, as coalesced
    CSR tensors. Returns (Aᵀ, T)."""
    from ultra_torchdrug_tpu_torch.ops.rspmm_cuda import csr_rows

    src = csr_rows(csr.src_rowptr)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    weight = w.index_select(0, csr.src_eid.long())
    V, R = csr.src_rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    return tuple(
        torch.sparse_coo_tensor(torch.stack([rows, dst]), weight,
                                (n, V)).coalesce().to_sparse_csr()
        for rows, n in ((src, V), (etype, R)))


def phase_kernels_ext(und, device) -> dict:
    """K4 (one extremum), K5 (its argext backward) and K3 (the transe
    backward) against their plain versions; returns their kernels-line
    entries by id (without the main path's launch counts)."""
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna

    def check_k4(agg, mode, ops, label):
        (got,) = pna.pna_fwd_cuda(agg, *ops, mode)
        (want,) = pna.pna_fwd_plain(agg, *ops, mode)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {agg} {mode} {label}: differs from its "
                                 "plain version")
        err = (got - want).abs().max().item()
        log(f"[kernels] K4 {agg} {mode} {label}: equal to its plain version "
            f"(max_abs_err {err:.3g})")
        return got, err

    def k5_planes(agg, mode, ops, seed):
        """K5's planes: the card's own K4 output (so the gates fire on the
        card's bits, ties included) and a seeded gradient."""
        gen = torch.Generator(device=device).manual_seed(seed)
        g = torch.randn(ops[3].shape, generator=gen, device=device)
        return g, pna.pna_fwd_cuda(agg, *ops, mode)[0]

    def k3_args(ops, seed):
        csr, w, rel, x = ops
        gen = torch.Generator(device=device).manual_seed(seed)
        return csr, w, rel, None, torch.randn(x.shape, generator=gen,
                                              device=device)

    # (a) small and ragged shapes, as for the PNA kernels
    for label, V, R, seed, ops in ragged_gather_cases(3, device):
        for i, (agg, mode) in enumerate(
                (a, m) for a in ("max", "min") for m in ("mul_rel", "add_rel")):
            out, _ = check_k4(agg, mode, ops, label)
            q = k5_planes(agg, mode, ops, seed=seed + i)
            dx, dr, _ = check_bwd_kernel(
                "K5", lambda: pna.pna_bwd_cuda("argext", *ops, q, mode),
                lambda: pna.pna_bwd_plain("argext", *ops, q, mode),
                f"{agg} {mode} {label}")
            if not (torch.all(out[V - 5:] == 0) and torch.all(dx[V - 5:] == 0)
                    and torch.all(dr[R - 1] == 0)):
                raise AssertionError("K4/K5 wrote nonzero rows without edges")
        args = k3_args(ops, seed=seed)
        dx, dr, _ = check_bwd_kernel(
            "K3",
            lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"),
            label)
        if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K3 wrote nonzero rows without edges")

    # (b) the main path's shapes on the FB-sized graph: K4 at F = 16 x 32
    # (eval) and 64 x 32 (training), K5 and K3 at the training width
    entries = {}

    def entry(kid, source, replaces, err, ms, plain_ms, bound, library_ms,
              **extra):
        entries[kid] = dict(
            name=kid, route="cuda", source=f"{PACKAGE}/csrc/{source}",
            replaces=f"ultra_torchdrug_tpu/ops/rspmm_pallas.py:{replaces}",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
            **extra)

    def timed(kid, label, kernel, plain, ops, iters=20):
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, 3, warmup=1)
        bound = gather_bound_ms(kid, *ops[1:])
        log(f"[kernels] {kid} {label}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms by {bound[1]}, {bound[0] / ms:.1%} of "
            "it)")
        return ms, plain_ms, bound

    for F, which in ((EVAL_BATCH * CLASSIC_FEAT, "eval"),
                     (CLASSIC_TRAIN["batch"] * CLASSIC_FEAT, "train")):
        ops = pna_operands(und, F, seed=F + 7, device=device)
        label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                 f"R={und.num_relations} F={F}")
        errs = {}
        for agg in ("max", "min"):
            for mode in ("mul_rel", "add_rel"):
                out, errs[agg, mode] = check_k4(agg, mode, ops, label)
                del out
        torch.cuda.empty_cache()
        for mode in ("mul_rel", "add_rel"):
            ms, plain_ms, bound = timed(
                "K4", f"max {mode} {label}",
                lambda mode=mode: pna.pna_fwd_cuda("max", *ops, mode),
                lambda mode=mode: pna.pna_fwd_plain("max", *ops, mode), ops)
            if mode != "mul_rel":  # the main path is distmult max
                entries["K4"][f"ms_{mode}_{which}"] = ms
            elif which == "eval":
                entry("K4", "rspmm_pna_fwd.cu", 1681, max(errs.values()), ms,
                      plain_ms, bound, None)
            else:
                entries["K4"].update(
                    max_abs_err_train=max(errs.values()), ms_train=ms,
                    plain_ms_train=plain_ms, bound_ms_train=bound[0],
                    bound_by_train=bound[1])
        if which == "eval":
            del ops
            torch.cuda.empty_cache()
            continue
        # K5 on the card's own K4 output, both modes
        for i, mode in enumerate(("mul_rel", "add_rel")):
            q = k5_planes("max", mode, ops, seed=F + i)
            dx, dr, err = check_bwd_kernel(
                "K5", lambda: pna.pna_bwd_cuda("argext", *ops, q, mode),
                lambda: pna.pna_bwd_plain("argext", *ops, q, mode),
                f"max {mode} {label}")
            del dx, dr
            torch.cuda.empty_cache()
            ms, plain_ms, bound = timed(
                "K5", f"max {mode} {label}",
                lambda: pna.pna_bwd_cuda("argext", *ops, q, mode),
                lambda: pna.pna_bwd_plain("argext", *ops, q, mode), ops)
            if mode == "mul_rel":
                entry("K5", "rspmm_pna_bwd.cu", 2316, err, ms, plain_ms,
                      bound, None, replaces_k5b="ultra_torchdrug_tpu/ops/"
                                                "rspmm_pallas.py:2453")
            else:
                entries["K5"].update({f"ms_{mode}": ms,
                                      f"max_abs_err_{mode}": err})
            del q
        # K3, and its function as two torch.sparse.mm calls
        args = k3_args(ops, seed=F + 5)
        dx, dr, err = check_bwd_kernel(
            "K3", lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"),
            label)
        at, t = sparse_mm_halves(ops[0], ops[1])
        grad = args[4]
        assert_bwd_close(torch.sparse.mm(at, grad), dx)
        assert_bwd_close(torch.sparse.mm(t, grad), dr)
        del dx, dr
        torch.cuda.empty_cache()
        ms, plain_ms, bound = timed(
            "K3", label,
            lambda: rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel"),
            lambda: rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel"), ops)
        lib_dx = cuda_time_ms(lambda: torch.sparse.mm(at, grad), 20)
        lib_dr = cuda_time_ms(lambda: torch.sparse.mm(t, grad), 20)
        log(f"[kernels] K3 {label}: library torch.sparse.mm (coalesced CSR) "
            f"dx half {lib_dx:.4f} ms + dr half {lib_dr:.4f} ms = "
            f"{lib_dx + lib_dr:.4f} ms against K3's {ms:.4f} ms")
        entry("K3", "rspmm_bwd.cu", 1681, err, ms, plain_ms, bound,
              lib_dx + lib_dr, library_ms_dx=lib_dx, library_ms_dr=lib_dr,
              library_call="torch.sparse.mm twice: dx = A^T g, dr = T g",
              mode="none, called by rspmm_bwd_pallas at :2816-2834")
        del ops, args, at, t, grad
        torch.cuda.empty_cache()
    log('[kernels] kernels ["K4", "K5", "K3"]')
    return entries


def rotate_operands(graph, batch: int, dim: int, shared: bool, seed: int,
                    device):
    """K8f's and K8b's operands on ``graph`` (with its backward layouts):
    x and g [V, batch·dim] ~ N(0, 1), rel [R, batch·dim] per batch or a
    shared [R, dim] broadcast to every query (broadcast_rel_flat), and edge
    weights in [0.5, 1.5] with a fifth masked to 0. Returns (csr, w, rel, x,
    g)."""
    from ultra_torchdrug_tpu_torch.ops.rspmm import broadcast_rel_flat

    gen = torch.Generator(device=device).manual_seed(seed)
    V, R, E = graph.num_nodes, graph.num_relations, graph.num_edges
    F = batch * dim
    x = torch.randn((V, F), generator=gen, device=device)
    rel = torch.randn((R, dim) if shared else (R, F), generator=gen,
                      device=device)
    rel = broadcast_rel_flat(rel, batch).contiguous() if shared else rel
    w = torch.rand((E,), generator=gen, device=device) + 0.5
    w = w * (torch.rand((E,), generator=gen, device=device) >= 0.2)
    g = torch.randn((V, F), generator=gen, device=device)
    return graph.csr.to(device), w, rel, x, g


def assert_fwd_close(got, want):
    """K1's tolerance, the absolute one 1e-5 of the result's largest entry:
    nvcc contracts the complex product's a·b − c·d into an FMA, which the
    plain version rounds twice."""
    atol = 1e-5 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def phase_kernels_rotate(und, device) -> dict:
    """K8f (the rotate forward) and K8b (its backward) against their plain
    versions; returns their kernels-line entries by id (without the main
    path's launch counts)."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    def k8f(ops, dim):
        csr, w, rel, x, _ = ops
        return (lambda: fwd.rotate_fwd_cuda(csr.rowptr, csr.src, csr.etype,
                                            csr.eid, w, rel, x, dim),
                lambda: fwd.rspmm_fwd_plain(csr.rowptr, csr.src, csr.etype,
                                            csr.eid, w, rel, x, "rot_rel",
                                            dim))

    def k8b(ops, dim):
        return (lambda: bwd.rotate_bwd_cuda(*ops, dim),
                lambda: bwd.rotate_bwd_plain(*ops, dim))

    def check_fwd(ops, dim, label):
        kernel, plain = k8f(ops, dim)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert_fwd_close(got, want)
        err = (got - want).abs().max().item()
        log(f"[kernels] K8f {label}: max_abs_err {err:.3g}")
        return got, err

    def check_bwd(ops, dim, label):
        kernel, plain = k8b(ops, dim)
        return check_bwd_kernel(
            "K8b", kernel, plain, label,
            dx_close=lambda a, b: torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-4))

    # (a) small and ragged shapes, (V, E, R, B, D): D/2 = 3, 5 and 6 take
    # the scalar path, 4 and 16 the float4 path; B·D = 600 and 2080 need two
    # feature tiles; the last 5 rows neither send nor receive an edge, the
    # last relation has none; the (60, 1400, 3) graph has three chunks per
    # relation; odd cases share one relation across the batch
    rng = np.random.default_rng(5)
    for i, (V, E, R, B, D) in enumerate(
            ((37, 300, 6, 3, 6), (37, 300, 6, 2, 32), (37, 300, 6, 60, 10),
             (37, 300, 6, 65, 32), (50, 20, 3, 2, 12), (60, 1400, 3, 4, 8))):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        shared = i % 2 == 1
        ops = rotate_operands(g, B, D, shared, seed=V + B * D, device=device)
        label = (f"V={V} E={E} R={R} B={B} D={D} "
                 f"{'shared' if shared else 'per-batch'} relation")
        out, _ = check_fwd(ops, D, label)
        dx, dr, _ = check_bwd(ops, D, label)
        if not (torch.all(out[V - 5:] == 0) and torch.all(dx[V - 5:] == 0)
                and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K8f/K8b wrote nonzero rows without edges")

    # (b) the main path's shapes on the FB-sized graph, D = 32: F = 16 x 32
    # (eval) for K8f, F = 64 x 32 (training) for both; per-batch relations
    # (classic NBFNet's dependent mode) are timed, shared ones checked
    entries = {}
    for B, which in ((EVAL_BATCH, "eval"), (CLASSIC_TRAIN["batch"], "train")):
        for shared in (True, False):
            ops = rotate_operands(und, B, CLASSIC_FEAT, shared, seed=B + shared,
                                  device=device)
            label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                     f"R={und.num_relations} F={B * CLASSIC_FEAT} "
                     f"{'shared' if shared else 'per-batch'} relation")
            out, err_f = check_fwd(ops, CLASSIC_FEAT, label)
            del out
            if which == "train":
                dx, dr, err_b = check_bwd(ops, CLASSIC_FEAT, label)
                del dx, dr
            torch.cuda.empty_cache()
            if shared:
                continue
            timed = [("K8f", err_f, *k8f(ops, CLASSIC_FEAT))]
            if which == "train":
                timed.append(("K8b", err_b, *k8b(ops, CLASSIC_FEAT)))
            for kid, err, kernel, plain in timed:
                ms = cuda_time_ms(kernel, 20)
                plain_ms = cuda_time_ms(plain, 3, warmup=1)
                bound_ms, bound_by = gather_bound_ms(kid, *ops[1:4])
                log(f"[kernels] {kid} {label}: {ms:.4f} ms (plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                    f"{bound_by}, {bound_ms / ms:.1%} of it), library_ms: "
                    "null (no single PyTorch call computes this function)")
                keys = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
                if kid in entries:  # K8f's second shape
                    entries[kid].update(
                        {f"{k}_train": v for k, v in keys.items()})
                    continue
                entries[kid] = dict(
                    name=kid, route="cuda",
                    source=f"{PACKAGE}/csrc/rspmm_rotate.cu",
                    replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:"
                             + {"K8f": "1681", "K8b": "2110"}[kid],
                    mode={"K8f": "rot_rel", "K8b": "rotate"}[kid],
                    launches=None, library_ms=None, **keys)
            del ops, timed
            torch.cuda.empty_cache()
    log('[kernels] kernels ["K8f", "K8b"]')
    return entries


def bf16_operands(graph, batch: int, dim: int, shared: bool, seed: int,
                  device):
    """K1h's and K2h's operands on ``graph`` (with its backward layouts), as
    the wrappers receive them after their cast: rotate_operands' x, g and
    rel (shared [R, dim] broadcast to every query, or per batch) in bf16,
    and its masked fp32 weights. Returns (csr, w, rel, x, g)."""
    csr, w, rel, x, g = rotate_operands(graph, batch, dim, shared, seed,
                                        device)
    return (csr, w, *(t.to(torch.bfloat16) for t in (rel, x, g)))


def phase_kernels_bf16(und, device) -> dict:
    """K1h (the bf16 forward, csrc/rspmm_fwd.cu) and K2h (its backward,
    csrc/rspmm_bwd.cu) against their plain versions; returns their
    kernels-line entries by id (without the main path's launch counts).
    Both get bf16 operands, so the wrappers' casts are no-ops and the
    times are the kernels'. K1 and K2 run beside them on the same operands
    in fp32, for the ratio the prediction names."""
    from ultra_torchdrug_tpu_torch.data.graph import Graph
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd

    # K1h as K1: both round each message to bf16 from the same bits (the
    # product of two bf16 values is exact in fp32), so only the order of
    # the fp32 sums differs; K2h as assert_bwd_close says
    tol = dict(rtol=1e-5, atol=1e-5)

    def k1h(ops, mode):
        csr, w, rel, x, _ = ops
        args = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x, mode)
        f32 = (*args[:5], rel.float(), x.float(), mode)
        return (lambda: fwd.rspmm_fwd_bf16_cuda(*args),
                lambda: fwd.rspmm_fwd_bf16_plain(*args),
                lambda: fwd.rspmm_fwd_cuda(*f32))

    def k2h(ops):
        return (lambda: bwd.rspmm_bwd_bf16_cuda(*ops),
                lambda: bwd.rspmm_bwd_bf16_plain(*ops))

    def check_fwd(ops, mode, label):
        kernel, plain, _ = k1h(ops, mode)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        log(f"[kernels] K1h {mode} {label}: max_abs_err {err:.3g}")
        return got, err

    # (a) small and ragged shapes, (V, E, R, B, D): B·D = 18, 20, 12 and
    # 1028 are not multiples of 8 and take the scalar path, 64 and 2056 the
    # 16-byte path (2056 in two feature tiles); the last 5 rows neither send
    # nor receive an edge, the last relation has none; the (60, 1400, 3)
    # graph has three chunks per relation; odd cases share one relation
    # across the batch
    rng = np.random.default_rng(6)
    for i, (V, E, R, B, D) in enumerate(
            ((37, 300, 6, 3, 6), (37, 300, 6, 2, 10), (37, 300, 6, 2, 32),
             (37, 300, 6, 4, 257), (37, 300, 6, 8, 257), (50, 20, 3, 2, 6),
             (60, 1400, 3, 4, 16))):
        tri = np.stack([rng.integers(0, V - 5, E), rng.integers(0, V - 5, E),
                        rng.integers(0, R - 1, E)], 1)
        g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
        shared = i % 2 == 1
        ops = bf16_operands(g, B, D, shared, seed=V + B * D, device=device)
        label = (f"V={V} E={E} R={R} F={B * D} "
                 f"{'shared' if shared else 'per-batch'} relation")
        for mode in ("mul_rel", "add_rel"):
            out, _ = check_fwd(ops, mode, label)
            if not torch.all(out[V - 5:] == 0):
                raise AssertionError("K1h wrote nonzero rows without edges")
        dx, dr, _ = check_bwd_kernel("K2h", *k2h(ops), label)
        if not (torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)):
            raise AssertionError("K2h wrote nonzero rows without edges")

    # (b) the main path's shapes on the FB-sized graph: F = 16 x 64 (eval)
    # for K1h, F = 64 x 64 (training) for both; ULTRA's injected relations
    # are per query; shared ones are checked too
    entries = {}
    for B, which in ((EVAL_BATCH, "eval"), (TRAIN["batch"], "train")):
        for shared in (True, False):
            ops = bf16_operands(und, B, FEAT, shared, seed=B + 2 * shared,
                                device=device)
            label = (f"{which} shape V={und.num_nodes} E={und.num_edges} "
                     f"R={und.num_relations} F={B * FEAT} "
                     f"{'shared' if shared else 'per-batch'} relation")
            out, err_f = check_fwd(ops, "mul_rel", label)
            del out
            if which == "train":
                dx, dr, err_b = check_bwd_kernel("K2h", *k2h(ops), label)
                del dx, dr
            torch.cuda.empty_cache()
            if shared:
                continue
            kernel, plain, fp32 = k1h(ops, "mul_rel")
            timed = [("K1h", err_f, kernel, plain, fp32,
                      k1_bound_ms((*k1_operands_of(ops), ops[2], ops[3])))]
            if which == "train":
                csr, w, rel, x, g = ops
                f32 = (csr, w, rel.float(), x.float(), g.float())
                timed.append(("K2h", err_b, *k2h(ops),
                              lambda: bwd.rspmm_bwd_cuda(*f32),
                              k2_bound_ms(*ops)))
            for kid, err, kernel, plain, fp32, (bound_ms, bound_by) in timed:
                ms = cuda_time_ms(kernel, 50 if which == "eval" else 20)
                fp32_ms = cuda_time_ms(fp32, 50 if which == "eval" else 20)
                plain_ms = cuda_time_ms(plain, 3, warmup=1)
                log(f"[kernels] {kid} {label}: {ms:.4f} ms (fp32 "
                    f"{'K1' if kid == 'K1h' else 'K2'} on the same values "
                    f"{fp32_ms:.4f} ms, ratio {ms / fp32_ms:.3f}; plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                    f"{bound_by}, {bound_ms / ms:.1%} of it), library_ms: "
                    "null (no single PyTorch call computes this function)")
                keys = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            fp32_kernel_ms=fp32_ms)
                if kid in entries:  # K1h's second shape
                    entries[kid].update(
                        {f"{k}_train": v for k, v in keys.items()})
                    continue
                entries[kid] = dict(
                    name=kid, route="cuda",
                    source=f"{PACKAGE}/csrc/"
                           + {"K1h": "rspmm_fwd.cu", "K2h": "rspmm_bwd.cu"}[kid],
                    replaces="ultra_torchdrug_tpu/ops/rspmm_pallas.py:"
                             + {"K1h": "1681", "K2h": "2110"}[kid],
                    mode="compute_dtype=bfloat16",
                    launches=None, library_ms=None, **keys)
            del ops, timed
            torch.cuda.empty_cache()
    log('[kernels] kernels ["K1h", "K2h"]')
    return entries


def k1_operands_of(ops) -> tuple:
    """K1's CSR arrays and weights from a (csr, w, ...) operand tuple."""
    csr, w = ops[:2]
    return csr.rowptr, csr.src, csr.etype, csr.eid, w


def phase_slice(task, model, device, per_batch: dict, label: str = "slice"):
    """Evaluation through the task's entry point; returns the launch counts
    of the measured run, which must be ``per_batch`` per eval batch."""
    # one batch first: cuBLAS handles, allocator pools and the kernel library
    # load are set-up, not evaluation
    task.evaluate(model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    batches = math.ceil(FAST_TEST / EVAL_BATCH)
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = task.evaluate(model, "test", batch_size=EVAL_BATCH,
                            fast_test=FAST_TEST)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, per_batch, batches, device)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[{label}] {FAST_TEST} test triples in {batches} batches of "
        f"{EVAL_BATCH}: {seconds * 1e3 / batches:.2f} ms per eval batch, "
        f"{FAST_TEST / seconds:.1f} triples/s, peak device memory "
        f"{peak:.3f} GiB ({device})")
    log(f"[{label}] launches {counts} ({batches} batches)")
    log(f"[{label}] metrics {json.dumps(metrics)}")
    return counts


def profile_device_time(label: str, fn):
    """Device time by kernel over one call of fn (torch.profiler), and the
    device's busy share of that call's wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log(f"[profile] {label}: the profiler recorded no device time: not "
            "measured")
        return
    log(f"[profile] {label}: device busy {device_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall under the profiler "
        f"({device_ms / wall_ms:.1%} busy)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile] {ms:9.3f} ms {ms / device_ms:6.1%} x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_parity(task, model, device, atol: float = 1e-4,
                 label: str = "parity"):
    """Card scores for 2 test queries against the port's CPU run, through
    the task's scoring hook on the graphs its eval path uses."""
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
            t, h = task._eval_scores(m, task.fact_graph, g_rel, b[:, 0],
                                     b[:, 1], b[:, 2], g_und)
            results.append((t.cpu(), h.cpu()))
    (t_dev, h_dev), (t_cpu, h_cpu) = results
    for name, a, b in (("tail", t_dev, t_cpu), ("head", h_dev, h_cpu)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} scores on {device}")
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
        log(f"[{label}] {name} scores {tuple(a.shape)} {device} vs cpu: "
            f"max_abs_err {(a - b).abs().max().item():.3g} (limit {atol:g})")


def phase_clip_crossings(task, model, device, label: str):
    """PNA's std = sqrt(clip(sq_mean - mean², EPS)) on the card and on the
    CPU for 2 test queries, tail and head scoring: per layer, the entries
    clipped on each device and those clipped on one and not the other,
    where the two runs' gradients and scores can part by more than
    rounding."""
    from ultra_torchdrug_tpu_torch.models.layers import (
        _MESSAGES,
        EPS,
        _relation_input,
        pna_moments,
    )
    from ultra_torchdrug_tpu_torch.ops.rspmm import broadcast_rel_flat

    def clipped(m, dev):
        masks = []

        def hook(layer, args, kwargs):
            graph, x, boundary = args
            B = x.shape[1] // layer.cfg.input_dim
            rel = broadcast_rel_flat(
                _relation_input(layer, kwargs.get("query"), None), B)
            mean, sq_mean, _ = pna_moments(layer.cfg, graph, rel, x, boundary,
                                           _MESSAGES[layer.cfg.message_func])
            masks.append((sq_mean - mean ** 2 <= EPS).cpu())

        handles = [layer.register_forward_pre_hook(hook, with_kwargs=True)
                   for layer in m.layers]
        und, _ = task._prepare_graphs(task.fact_graph, task.rel_graph)
        b = torch.from_numpy(task.dataset.test[:2].astype(np.int64)).to(dev)
        try:
            with torch.inference_mode():
                task._eval_scores(m, task.fact_graph, None, b[:, 0], b[:, 1],
                                  b[:, 2], und.to(dev))
        finally:
            for h in handles:
                h.remove()
        return masks

    cpu = torch.device("cpu")
    layers = len(model.layers)
    for i, (a, b) in enumerate(zip(clipped(model, device),
                                   clipped(copy.deepcopy(model).to(cpu), cpu))):
        log(f"[{label}] {('tail', 'head')[i // layers]} layer "
            f"{i % layers}: {int(a.sum())} of {a.numel()} "
            f"(node, query, feature) variances clipped on {device}, "
            f"{int(b.sum())} on cpu, {int((a != b).sum())} on one only")


def make_engine(task, size: dict, label: str, **opt):
    """An Engine over ``task`` at ``size``'s batch, logging nowhere."""
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    engine = Engine(task, batch_size=size["batch"], seed=0,
                    log_interval=10**9, logger=get_root_logger(None), **opt)
    log(f"[{label}] batch {size['batch']}, {size['negatives']} negatives, "
        f"{opt}")
    return engine


def phase_train(engine, size: dict, device, per_step: dict,
                label: str = "train"):
    """Training steps through Engine.train; returns the launch counts of
    the timed run, which must be ``per_step`` per step."""
    # one step first: allocator pools and cuBLAS handles are set-up
    engine.train(batch_per_epoch=1)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps = size["steps"]
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.train(batch_per_epoch=steps)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_launches(label, counts, per_step, steps, device)
    window = engine.meter.last_window
    if len(window) != steps or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in window):
        raise AssertionError(f"non-finite or missing step metrics {window}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[{label}] {steps} steps of {size['batch']} triples: "
        f"{seconds * 1e3 / steps:.2f} ms per step, "
        f"{steps * size['batch'] / seconds:.1f} triples/s, peak device "
        f"memory {peak:.3f} GiB ({device})")
    log(f"[{label}] launches {counts} ({steps} steps)")
    for i, m in enumerate(window):
        log(f"[{label}] step {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in sorted(m.items())))
    return counts


def phase_train_parity(engine, cpu_task, device, grad_rtol: float = 1e-4,
                       loss_rtol: float = 1e-5, label: str = "train parity"):
    """One loss step on the card against the port's CPU run (``cpu_task``,
    the same task on the CPU): the same weights, the same 2 train triples
    and 8 injected negatives, on the full graph. Gradients are compared
    norm-wise per parameter: each is a sum over ~500k edges and V*B rows,
    taken in another order on the card, so single small entries may differ
    in relative terms where the tensor as a whole agrees to fp32 rounding."""
    task = engine.task
    batch = task.train_triples[:2]
    neg = torch.from_numpy(np.random.default_rng(5).integers(
        0, task.dataset.num_entities, (2, 8)))
    cpu = torch.device("cpu")
    results = []
    for t, m, dev in ((task, engine.model, device),
                      (cpu_task, copy.deepcopy(engine.model).to(cpu), cpu)):
        m.zero_grad(set_to_none=True)
        loss, _ = t.loss_step(m, None, batch, neg=neg.to(dev))
        loss.backward()
        results.append((loss.item(), {k: p.grad.detach().cpu()
                                      for k, p in m.named_parameters()}))
        m.zero_grad(set_to_none=True)
    (loss_dev, g_dev), (loss_cpu, g_cpu) = results
    if not math.isfinite(loss_dev) or abs(loss_dev - loss_cpu) > loss_rtol * max(
            1.0, abs(loss_cpu)):
        raise AssertionError(f"loss {device} {loss_dev} vs cpu {loss_cpu}")
    worst, worst_abs = 0.0, 0.0
    for k in g_cpu:
        a, b = g_dev[k], g_cpu[k]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite gradient {k} on {device}")
        rel = ((a - b).norm() / b.norm().clamp(min=1e-12)).item()
        if rel > grad_rtol:
            raise AssertionError(f"gradient {k}: relative error {rel:.3g}")
        worst = max(worst, rel)
        worst_abs = max(worst_abs, (a - b).abs().max().item())
    log(f"[{label}] loss {device} {loss_dev:.8g} vs cpu {loss_cpu:.8g}; "
        f"{len(g_cpu)} gradients: worst norm-wise relative error "
        f"{worst:.3g} (limit {grad_rtol:g}), max_abs_err {worst_abs:.3g}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cpu rehearses phases 2-25 at a reduced size with the plain "
             "versions and reports no result")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on "
              "the card (--device cpu rehearses without one)",
              file=sys.stderr)
        return 1
    import_port()
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig
    from ultra_torchdrug_tpu_torch.tasks.task import (
        TaskConfig,
        TransductiveKGTask,
    )

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    size = FULL if cuda else REHEARSAL
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    entries, runs = {}, {}  # kernels-line entries; launch counts by path
    if cuda:
        log(nvidia_smi_line())
        log(f"[env] device {torch.cuda.get_device_name(0)}, "
            f"count {torch.cuda.device_count()}")
        phase_build()

    t0 = time.perf_counter()
    dataset = synthetic_transductive("SynthFB15k237", seed=0, **size)
    log(f"[data] synthetic KG {size}: {len(dataset.train)} train / "
        f"{len(dataset.valid)} valid / {len(dataset.test)} test triples "
        f"({time.perf_counter() - t0:.1f} s)")
    if cuda:
        entries["K1"] = phase_kernels(dataset, device)
        und = dataset.fact_graph(None)[0].undirected_with_inverse()
        und = und.prepare_csr(backward=True)
        entries["K1"].update(time_k1_train_shape(und, device))
        entries["K2"] = phase_kernels_k2(und, device)
        entries.update(phase_kernels_pna(und, device))
        entries.update(phase_kernels_ext(und, device))
        entries.update(phase_kernels_rotate(und, device))
        entries.update(phase_kernels_bf16(und, device))
        del und
        torch.cuda.empty_cache()

    # ULTRA: zero-shot evaluation and training (K1, K2)
    t0 = time.perf_counter()
    task = TransductiveKGTask(dataset, UltraConfig.default(
        dataset.num_relations), device=device)
    model = task.init_params(seed=0)
    log(f"[slice] task set-up (relation graph {task.rel_graph.num_nodes} "
        f"nodes / {task.rel_graph.num_edges} edges, CSR, dense adjacency) "
        f"{time.perf_counter() - t0:.1f} s")
    ultra_eval = phase_slice(task, model, device,
                             {"K1": K1_LAUNCHES_PER_BATCH}, label="ultra")
    if cuda:
        profile_device_time("one ultra eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, label="ultra parity")
    del task, model

    train_size = TRAIN if cuda else TRAIN_REHEARSAL
    model_cfg = UltraConfig.default(dataset.num_relations)
    engine = make_engine(
        TransductiveKGTask(dataset, model_cfg, TaskConfig(
            num_negative=train_size["negatives"]), device=device),
        train_size, "ultra train", lr=5e-4)
    ultra_train = phase_train(engine, train_size, device,
                              {"K1": K_LAUNCHES_PER_STEP,
                               "K2": K_LAUNCHES_PER_STEP},
                              label="ultra train")
    if cuda:
        profile_device_time("one ultra train step",
                            lambda: engine.train(batch_per_epoch=1))
    phase_train_parity(engine, TransductiveKGTask(
        dataset, model_cfg, TaskConfig(num_negative=8), device="cpu"), device,
        label="ultra train parity")
    del engine
    runs["ultra"] = {"eval": ultra_eval, "train": ultra_train}

    # classic NBFNet, the NBFNet paper's FB15k-237 setting (distmult, pna)
    # and two rows of its ablation of message and aggregation functions:
    # (distmult, max) and (transe, pna)
    layers = len(classic_nbfnet_config().hidden_dims)
    runs["classic"] = run_classic(
        dataset, device, "classic", dict(),
        eval_per_pass={"K6": layers, "K7": layers},
        train_per_step={"K6": layers, "K7": layers, "K6b": layers,
                        "K7b": layers})
    runs["classic max"] = run_classic(
        dataset, device, "classic max", dict(aggregate_func="max"),
        eval_per_pass={"K4": layers},
        train_per_step={"K4": layers, "K5": layers})
    # transe's pna moments are two K1 sums per layer (its second moment sums
    # rel² + x², which does not factor through the message)
    runs["classic transe-pna"] = run_classic(
        dataset, device, "classic transe-pna", dict(message_func="transe"),
        eval_per_pass={"K1": 2 * layers, "K6": layers},
        train_per_step={"K1": 2 * layers, "K6": layers, "K3": 2 * layers,
                        "K6b": layers})
    # rotate: its sums run K8f (K8b backward); pna's max, min and second
    # moment take the O(E) route, which at the training width would keep
    # about 220 GB for autograd: (rotate, pna) evaluates only
    runs["classic rotate"] = run_classic(
        dataset, device, "classic rotate",
        dict(message_func="rotate", aggregate_func="sum"),
        eval_per_pass={"K8f": layers},
        train_per_step={"K8f": layers, "K8b": layers})
    runs["classic rotate-pna"] = run_classic(
        dataset, device, "classic rotate-pna", dict(message_func="rotate"),
        eval_per_pass={"K8f": layers}, train_per_step=None)

    # ULTRA with compute_dtype: bfloat16 (K1h, K2h), built from a config
    # dict through the port's builders, then the CLI on two shipped configs
    runs["ultra bf16"] = run_ultra_bf16(size, device)
    runs["cli"] = phase_cli(device)

    if not cuda:
        log("[rehearsal] phases 2-25 ran on the CPU; no kernel ran and no "
            "result is reported")
        return 1
    for e in entries.values():
        by_path = {f"{path} {half}": counts[e["name"]]
                   for path, halves in runs.items()
                   for half, counts in halves.items()
                   if counts[e["name"]]}
        e.update(launches=sum(by_path.values()), launches_by_path=by_path)
        if not e["launches"]:
            raise AssertionError(f"{e['name']} never launched on the main "
                                 "path")
    log(nvidia_smi_line())
    print(json.dumps({"kernels": [entries[k] for k in KERNEL_IDS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def inference_config(dataset: dict, compute_dtype: str) -> dict:
    """config/transductive/inference.yaml as run_full.main loads it (no
    checkpoint, no training), with ``dataset`` and the entity tower's
    ``compute_dtype`` set."""
    from ultra_torchdrug_tpu_torch.utils.config import load_config

    cfg = load_config(str(REPO / "config/transductive/inference.yaml"),
                      context=dict(dataset=dataset["class"], gpus=[0],
                                   epochs=0, bpe=0, ckpt=None))[0]
    cfg["dataset"] = dict(dataset)
    cfg["task"]["model"]["compute_dtype"] = compute_dtype
    return cfg


def run_ultra_bf16(size: dict, device) -> dict:
    """ULTRA (config/transductive/inference.yaml's model and task: 6x64,
    distmult, sum, layer norm, short-cut, project) with compute_dtype:
    bfloat16, on chip_smoke's KG through build_dataset, build_task and
    build_engine: evaluation (K1h 12 times per batch of 16, the relation
    tower on its dense fp32 route), its profile, card vs CPU scores, the
    bf16 − fp32 score difference and both MRRs on the same weights; then
    Engine.train at batch 64 with 128 strict negatives and AdamW (K1h and
    K2h 6 times each per step), its profile, and one loss step's gradients
    against the CPU. Returns the launch counts by half."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_engine,
        build_task,
    )

    cuda = device.type == "cuda"
    spec = {"class": "SynthKG", **size}
    cfg = inference_config(spec, "bfloat16")
    t0 = time.perf_counter()
    dataset = build_dataset(cfg["dataset"])
    task = build_task(cfg["task"], dataset, device=device)
    model = task.init_params(seed=0)
    log(f"[ultra bf16] {spec}, model {cfg['task']['model']}: set-up "
        f"{time.perf_counter() - t0:.1f} s; dense relation graph: "
        f"{task.rel_graph.prepare_dense().dense_adj is not None}")
    eval_counts = phase_slice(task, model, device,
                              {"K1h": K1_LAUNCHES_PER_BATCH},
                              label="ultra bf16")
    if cuda:
        profile_device_time("one ultra bf16 eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, atol=BF16_SCORE_ATOL,
                 label="ultra bf16 parity")
    f32_task = build_task(inference_config(spec, "float32")["task"], dataset,
                          device=device)
    compare_dtypes(task, f32_task, model, device)
    del task, f32_task, model

    train_size = TRAIN if cuda else TRAIN_REHEARSAL
    cfg["task"]["num_negative"] = train_size["negatives"]
    cfg["engine"].update(batch_size=train_size["batch"], log_interval=10**9)
    with tempfile.TemporaryDirectory() as work_dir:
        engine = build_engine(cfg, build_task(cfg["task"], dataset,
                                              device=device),
                              work_dir=work_dir, seed=0)
        log(f"[ultra bf16 train] batch {train_size['batch']}, "
            f"{train_size['negatives']} negatives, {cfg['optimizer']}")
        train_counts = phase_train(engine, train_size, device,
                                   {"K1h": K_LAUNCHES_PER_STEP,
                                    "K2h": K_LAUNCHES_PER_STEP},
                                   label="ultra bf16 train")
        if cuda:
            profile_device_time("one ultra bf16 train step",
                                lambda: engine.train(batch_per_epoch=1))
        cpu_cfg = dict(cfg["task"], num_negative=8)
        phase_train_parity(engine, build_task(cpu_cfg, dataset, device="cpu"),
                           device, grad_rtol=BF16_GRAD_RTOL,
                           loss_rtol=BF16_LOSS_RTOL,
                           label="ultra bf16 train parity")
    return {"eval": eval_counts, "train": train_counts}


def compare_dtypes(task, f32_task, model, device):
    """The bf16 and the fp32 model (the conv layers carry the compute
    dtype) on the same weights: their score difference for 2 test queries
    and both MRRs on FAST_TEST test triples."""
    batch = torch.from_numpy(task.dataset.test[:2].astype(np.int64)).to(device)
    f32_model = f32_task.init_params(seed=1)
    f32_model.load_state_dict(model.state_dict())
    scores, mrr = [], []
    for t, model in ((task, model), (f32_task, f32_model)):
        und, rel_graph = t._prepare_graphs(t.fact_graph, t.rel_graph)
        with torch.inference_mode():
            scores.append(torch.cat(t._eval_scores(
                model, t.fact_graph, rel_graph, batch[:, 0], batch[:, 1],
                batch[:, 2], und)))
        mrr.append(t.evaluate(model, "test", batch_size=EVAL_BATCH,
                              fast_test=FAST_TEST)["mrr"])
    diff = (scores[0] - scores[1]).abs()
    log(f"[ultra bf16 vs fp32] same weights, 2 queries, tail and head "
        f"scores: max |bf16 - fp32| {diff.max().item():.4g}, mean "
        f"{diff.mean().item():.4g} (scores' spread {scores[1].std().item():.4g}"
        f"); MRR on {FAST_TEST} test triples: bf16 {mrr[0]:.6f}, fp32 "
        f"{mrr[1]:.6f}")


def phase_cli(device) -> dict:
    """The CLI on the device: ``run_full.main`` on
    config/synthetic/smoke.yaml (one epoch of 5 steps, a checkpoint, a log,
    anomaly mode on), then on config/transductive/inference.yaml with
    ``--dataset SynthKG --epochs 0 --bpe 0 --gpus [0] --ckpt null`` in a
    temporary directory (the config writes under ./output). Returns the
    launch counts of each run; K1 and K2 must launch on the card."""
    import os

    from ultra_torchdrug_tpu_torch import run_full

    counts = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        runs = (("smoke", ["-c", str(REPO / "config/synthetic/smoke.yaml"),
                           "--outdir", tmp]),
                ("inference", ["-c", str(REPO / "config/transductive/"
                                         "inference.yaml"),
                               "--dataset", "SynthKG", "--epochs", "0",
                               "--bpe", "0", "--gpus", "[0]", "--ckpt",
                               "null"]))
        try:
            os.chdir(tmp)
            for label, argv in runs:
                reset_launch_counts()
                t0 = time.perf_counter()
                engine = run_full.main(argv + ["--device", device.type])
                if device.type == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts[label] = launch_counts()
                files = os.listdir(engine.work_dir)
                metrics = engine.metrics["test"]
                want_epoch = 1 if label == "smoke" else 0
                if (engine.epoch != want_epoch or "log.txt" not in files
                        or (label == "smoke"
                            and not any(f.endswith(".ckpt") for f in files))
                        or not all(math.isfinite(v) for v in metrics.values())):
                    raise AssertionError(f"cli {label}: epoch {engine.epoch}, "
                                         f"files {files}, metrics {metrics}")
                used = {k: v for k, v in counts[label].items() if v}
                if device.type == "cuda" and not (
                        used.get("K1") and (label != "smoke" or used.get("K2"))):
                    raise AssertionError(f"cli {label}: launches {used}")
                log(f"[cli] {label}: {seconds:.1f} s on {device}, epoch "
                    f"{engine.epoch}, files {sorted(files)}, test mrr "
                    f"{metrics['mrr']:.6f}, launches {used}")
                del engine
        finally:
            os.chdir(cwd)
    return counts


def run_classic(dataset, device, label: str, variant: dict,
                eval_per_pass: dict, train_per_step) -> tuple:
    """Classic NBFNet (6x32, dependent relations, layer norm, seeded
    weights; ``variant`` sets the message and aggregation) on the dataset:
    evaluation through ClassicNBFNetTask.evaluate (``eval_per_pass``
    launches per scoring direction, two per batch), its profile and its
    card-vs-CPU scores, then, unless ``train_per_step`` is None,
    Engine.train at batch 64, 32 strict negatives and Adam at lr 5e-3
    (``train_per_step`` launches per step), its profile and one loss step's
    gradients against the CPU. Returns the launch counts of the measured
    eval run and, with training, of the train run, by half."""
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.tasks.task import (
        ClassicNBFNetTask,
        TaskConfig,
    )

    cuda = device.type == "cuda"
    nbf_cfg = classic_nbfnet_config(num_relations=dataset.num_relations,
                                    layer_norm=True, **variant)
    t0 = time.perf_counter()
    task = ClassicNBFNetTask(dataset, nbf_cfg, device=device)
    model = task.init_params(seed=0)
    log(f"[{label}] {nbf_cfg.message_func}, {nbf_cfg.aggregate_func}: task "
        f"set-up {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    eval_counts = phase_slice(task, model, device,
                              {k: 2 * v for k, v in eval_per_pass.items()},
                              label=label)
    if cuda:
        profile_device_time(f"one {label} eval batch", lambda: task.evaluate(
            model, "test", batch_size=EVAL_BATCH, fast_test=EVAL_BATCH))
    phase_parity(task, model, device, atol=CLASSIC_SCORE_ATOL,
                 label=f"{label} parity")
    if nbf_cfg.aggregate_func.startswith("pna"):
        phase_clip_crossings(task, model, device, label=f"{label} parity")
    del task, model
    if train_per_step is None:
        return {"eval": eval_counts}

    train_size = CLASSIC_TRAIN if cuda else CLASSIC_TRAIN_REHEARSAL
    engine = make_engine(
        ClassicNBFNetTask(dataset, nbf_cfg, TaskConfig(
            num_negative=train_size["negatives"], strict_negative=True,
            adversarial_temperature=1), device=device),
        train_size, f"{label} train", optimizer="Adam", lr=5e-3)
    train_counts = phase_train(engine, train_size, device, train_per_step,
                               label=f"{label} train")
    if cuda:
        profile_device_time(f"one {label} train step",
                            lambda: engine.train(batch_per_epoch=1))
    phase_train_parity(
        engine, ClassicNBFNetTask(dataset, nbf_cfg, TaskConfig(num_negative=8),
                                  device="cpu"), device,
        grad_rtol=CLASSIC_GRAD_RTOL, label=f"{label} train parity")
    return {"eval": eval_counts, "train": train_counts}


if __name__ == "__main__":
    sys.exit(main())

"""Device timing and least-time bounds for the port's kernels on one NVIDIA
H100, shared by ``chip_smoke.py`` and the ladder tools.

A bound is the least time the card could take for a function's work: the
larger of its compulsory bytes (each input read once, each output written
once) over the memory rate and its operations over the fp32 peak. Every
time here is a device time from CUDA events; none is taken on the CPU.
"""

from __future__ import annotations

import subprocess

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def cuda_time_ms(fn, iters: int, warmup: int = 2,
                 queue_ahead: bool = False) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA events).
    With ``queue_ahead`` the device first spins (about 30 ms at the H100's
    clocks) while the host queues every call, so that a call whose host
    side takes longer than its kernels is timed by the device, not by the
    host's pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    and feature (message, weight, sum) over the fp32 peak. ``operands`` is
    K1's (rowptr, src, etype, eid, w, rel, x)."""
    rowptr, src, etype, eid, w, rel, x = operands
    E = src.numel()
    V, F = rowptr.numel() - 1, x.shape[1]
    nbytes = (edge_bytes(E) + (rel.numel() + x.numel()) * x.element_size()
              + V * F * 4)
    return roofline_ms(nbytes, 3 * E * F)


def gpu_query() -> dict:
    """The card's name, power limit and current SM clock as nvidia-smi
    reports them (``--query-gpu=name,power.limit,clocks.sm``), and the
    SM count from PyTorch."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    name, power, clock = (s.strip() for s in
                          out.stdout.strip().splitlines()[0].split(","))
    return dict(name=name, power_limit=power, sm_clock=clock,
                sm_clock_hz=float(clock.split()[0]) * 1e6,
                sm_count=torch.cuda.get_device_properties(
                    0).multi_processor_count)

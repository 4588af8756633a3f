"""Device timing and least-time bounds for the port's kernels on one NVIDIA
H100, shared by ``chip_smoke.py``, the ladder tools and
``redesign_times.py``. This module imports only torch: ``redesign_times.py``
loads it by path to time another checkout's kernels with it.

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


def times_in_turns(fns: dict, iters: int, queue_ahead: bool = False) -> dict:
    """cuda_time_ms of each named function, read twice in turns (the
    functions in order, then in reverse order), the lesser of its two
    readings: the first reading after an idle or allocation-heavy phase can
    run 15 % slow, whichever function it times (PERF.md)."""
    reads = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        reads[name].append(cuda_time_ms(fns[name], iters,
                                        queue_ahead=queue_ahead))
    return {name: min(r) for name, r in reads.items()}


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


def sparse_mm_halves(csr, w):
    """K3's function (the transe backward) as two library calls, timed
    beside K3 and never used by the port: dx = Aᵀ g and dr = T g, with
    Aᵀ[s, v] and T[r, v] the summed weights of the edges s → v and of the
    type-r edges into v, as coalesced CSR tensors. Returns (Aᵀ, T)."""
    V, R = csr.src_rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    counts = (csr.src_rowptr[1:] - csr.src_rowptr[:-1]).long()
    src = torch.repeat_interleave(
        torch.arange(V, device=counts.device), counts)
    dst, etype = csr.src_dst.long(), csr.src_etype.long()
    weight = w.index_select(0, csr.src_eid.long())
    return tuple(
        torch.sparse_coo_tensor(torch.stack([rows, dst]), weight,
                                (n, V)).coalesce().to_sparse_csr()
        for rows, n in ((src, V), (etype, R)))


def k3_half_times(k3, at, t, grad, num_edges: int, iters: int = 20) -> dict:
    """K3's halves each alone, ``k3(need_dx, need_dr)``, beside
    torch.sparse.mm's halves (``at``, ``t`` from sparse_mm_halves) on the
    same g, and each half's bound: g read once, its output written once,
    the edges; a product and a sum per edge and feature. Keys ms_dx,
    ms_dr, library_ms_dx, library_ms_dr, library_ms (their sum),
    bound_ms_dx, bound_ms_dr."""
    out = dict(
        ms_dx=cuda_time_ms(lambda: k3(True, False), iters),
        ms_dr=cuda_time_ms(lambda: k3(False, True), iters),
        library_ms_dx=cuda_time_ms(lambda: torch.sparse.mm(at, grad), iters),
        library_ms_dr=cuda_time_ms(lambda: torch.sparse.mm(t, grad), iters))
    out["library_ms"] = out["library_ms_dx"] + out["library_ms_dr"]
    (V, F), E = grad.shape, num_edges
    for half, rows in (("dx", V), ("dr", t.shape[0])):
        out[f"bound_ms_{half}"] = roofline_ms(
            edge_bytes(E) + (V + rows) * F * 4, 2 * E * F)[0]
    return out


def k9_times(shift, plain, x: torch.Tensor, n: int, iters: int = 50) -> dict:
    """K9 (``shift()``, the ring shift of the n blocks of x) beside its
    plain version (``plain()``), torch.cat of the rotated blocks (its
    library call, the views made once, outside the timing) and torch.roll,
    all queued ahead of the device, and K9 and torch.cat at the host's
    pace; every time the lesser of two readings in turns
    (times_in_turns). The bound: every byte read and written once. Keys
    ms, plain_ms, library_ms, roll_ms, host_paced_ms,
    library_host_paced_ms, bound_ms, bound_by."""
    blocks = list(x.chunk(n))
    rotated = [blocks[(s - 1) % n] for s in range(n)]
    vb = x.shape[0] // n
    queued = times_in_turns(dict(
        ms=shift, plain_ms=plain, library_ms=lambda: torch.cat(rotated),
        roll_ms=lambda: torch.roll(x, vb, dims=0)), iters, queue_ahead=True)
    paced = times_in_turns(dict(
        host_paced_ms=shift,
        library_host_paced_ms=lambda: torch.cat(rotated)), iters)
    bound_ms, bound_by = roofline_ms(2 * x.numel() * x.element_size(), 0)
    return dict(**queued, **paced, bound_ms=bound_ms, bound_by=bound_by)


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

"""Times of K3 (the transe backward) and K9 (the ring shift) on the card,
beside the PyTorch calls that compute the same functions, and the host's
set-up seconds of the layouts they read, written to JSON.

K3 at F = 2,048 (the classic transe/pna training width, 64 x 32): the
whole call and each half alone (dx only, dr only), on chip_smoke.py's
uniform KG (FB15k-237's counts, undirected with inverse edges: V = 14,541,
E = 496,188, R = 474) and on bench.py's heavy-tailed KG
(diagnostics/workloads.py::build_workload, V = 15,000, E = 557,056,
R = 474, edges head -> tail), each beside ``torch.sparse.mm``'s two halves.
K9 at the ring's shapes (n = 4 shards of v_block = 3,636 rows, F = 1,024
and 4,096 fp32): queued ahead of the device and at the host's pace, beside
``torch.cat`` of the rotated blocks and ``torch.roll``. Every kernel result
is held against its plain version before it is timed. Set-up: the seconds
of ``prepare_csr(backward=True)`` on the uniform KG (what a training task
builds once, for ULTRA or classic NBFNet) and of ``prepare_ring`` on it
(4 shards, per-bucket CSRs with their backward layouts), three readings
each.

The script imports ``ultra_torchdrug_tpu_torch`` from ``--root`` (default:
the checkout it lies in), and times it with this checkout's
diagnostics/timing.py, the helpers that chip_smoke.py uses, so that two
commits are timed alike on one card in one call, each in its own process,
in turns:

    python ultra_torchdrug_tpu_torch/diagnostics/redesign_times.py \\
        --out output/times.json
    python ultra_torchdrug_tpu_torch/diagnostics/redesign_times.py \\
        --root output/parent --out output/times_parent.json

It needs the card and raises without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

K3_FEAT = 64 * 32
FB = dict(num_nodes=14541, num_edges=310116, num_relations=237)
RING_SHARDS = 4
RING_FEATS = (16 * 64, 64 * 64)  # ULTRA eval batch and train step widths


def _timing():
    """This checkout's diagnostics/timing.py (it imports only torch),
    loaded by path, so that it times whichever package ``--root`` holds."""
    spec = importlib.util.spec_from_file_location(
        "redesign_timing", Path(__file__).resolve().with_name("timing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _show(label: str, out: dict):
    print(f"[times] {label}: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in out.items()), flush=True)


def time_k3(torch, timing, bwd, csr, w, label: str) -> dict:
    V = csr.src_rowptr.numel() - 1
    R = csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(K3_FEAT + 5)
    g = torch.randn((V, K3_FEAT), generator=gen, device=w.device)
    rel = torch.zeros((R, K3_FEAT), device=w.device)  # gives dr's shape

    def k3(need_dx=True, need_dr=True):
        return bwd.rspmm_bwd_cuda(csr, w, rel, None, g, need_dx, need_dr,
                                  mode="add_rel")

    dx, dr = k3()
    want_dx, want_dr = bwd.rspmm_bwd_plain(csr, w, rel, None, g,
                                           mode="add_rel")
    torch.cuda.synchronize()
    for got, want in ((dx, want_dx), (dr, want_dr)):
        atol = max(1e-4, 1e-5 * want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    err = max((dx - want_dx).abs().max().item(),
              (dr - want_dr).abs().max().item())
    del dx, dr, want_dx, want_dr
    at, t = timing.sparse_mm_halves(csr, w)
    out = dict(V=V, E=int(csr.src_dst.numel()), R=R, F=K3_FEAT,
               max_abs_err=err, ms=timing.cuda_time_ms(k3, 20),
               **timing.k3_half_times(k3, at, t, g, w.numel()))
    _show(f"K3 {label}", out)
    return out


def time_k9(torch, timing, rdma, F: int, vb: int) -> dict:
    n = RING_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(F)
    x = torch.randn((n * vb, F), generator=gen, device="cuda")
    if not torch.equal(rdma.ring_shift(x, n), rdma.ring_shift_plain(x, n)):
        raise AssertionError(f"K9 F={F}: differs from its plain version")
    out = dict(n=n, v_block=vb, F=F, **timing.k9_times(
        lambda: rdma.ring_shift(x, n), lambda: rdma.ring_shift_plain(x, n),
        x, n))
    _show(f"K9 F={F}", out)
    return out


def setup_seconds(fact) -> dict:
    """Three readings each of the host's seconds for the uniform KG's
    ``prepare_csr(backward=True)`` and ``prepare_ring`` (4 shards,
    per-bucket CSRs with their backward layouts, as a distmult training
    task builds them)."""
    und = fact.undirected_with_inverse()
    out = {"prepare_csr_s": [], "prepare_ring_s": []}
    for _ in range(3):
        t0 = time.perf_counter()
        und.prepare_csr(backward=True)
        t1 = time.perf_counter()
        und.prepare_ring(RING_SHARDS, pallas=True, balance="auto",
                         permuted_io=True, backward=True)
        out["prepare_csr_s"].append(t1 - t0)
        out["prepare_ring_s"].append(time.perf_counter() - t1)
    print(f"[times] set-up s: {out}", flush=True)
    return out


def main(argv=None) -> dict:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(here),
                    help="the checkout whose ultra_torchdrug_tpu_torch is "
                         "timed (default: this one)")
    ap.add_argument("--out", required=True, help="the JSON file to write")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import ultra_torchdrug_tpu_torch as port

    if Path(port.__file__).resolve().parent != root / port.__name__:
        raise SystemExit(f"imported {port.__file__}, not {root}'s")
    if not torch.cuda.is_available():
        raise SystemExit("redesign_times needs the card")
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu_torch.data.graph import build_csr
    from ultra_torchdrug_tpu_torch.diagnostics.workloads import build_workload
    from ultra_torchdrug_tpu_torch.ops import rspmm_bwd_cuda as bwd
    from ultra_torchdrug_tpu_torch.parallel import rdma

    timing = _timing()
    smi = _smi()
    print(f"[times] {root}: {smi}", flush=True)
    device = torch.device("cuda")

    def weights(E, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        w = torch.rand((E,), generator=gen, device=device) + 0.5
        return w * (torch.rand((E,), generator=gen, device=device) >= 0.2)

    fact = synthetic_transductive("SynthFB15k237", seed=0,
                                  **FB).fact_graph(None)[0]
    result = dict(root=str(root), device=smi, **setup_seconds(fact))
    und = fact.undirected_with_inverse().prepare_csr(backward=True)
    tri, _, _ = build_workload(features=False)
    hub = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], 15000, 474,
                    backward=True)
    result["k3_uniform"] = time_k3(torch, timing, bwd, und.csr.to(device),
                                   weights(und.num_edges, 7), "uniform KG")
    result["k3_hub"] = time_k3(torch, timing, bwd, hub.to(device),
                               weights(len(tri), 8), "bench.py's KG")
    vb = -(-FB["num_nodes"] // RING_SHARDS)
    result["k9"] = [time_k9(torch, timing, rdma, F, vb) for F in RING_FEATS]
    result["hub_max_out_degree"] = int(np.bincount(tri[:, 0]).max())
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"[times] wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()

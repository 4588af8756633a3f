"""P2 on the card: the K1 strip-down ladder (ops/rspmm_ladder_cuda.py) on
bench.py's heavy-tailed KG, written to a JSON file.

The counterpart of script/diagnostics/blocked_ladder.py. The workload is a
copy of bench.py::build_workload (diagnostics/workloads.py): V = 15,000,
E = 557,056 edges head -> tail, R = 474, F = 4,096 fp32, where the busiest
row takes 107,150 in-edges and the 1,024 busiest take 53 % of E. Its
variants map to the card's:

    b0_full -> full        b1_noflush, b7_nochain -> nowrite
    b2_statrow -> statrow  b4_norel -> norel       b5_floor -> floor
    b6_nosum -> multiacc   b10a/b10b_fsplit -> ftile
    b3_statbuf: none (no stream buffer on the card)

and ``split`` cuts every row into segments of at most 256 edges, as the
TPU's edge-chunked grid spreads a hub row over many grid steps. Timing and
checks as kernel_floor.py. The JSON (``--out``, default
KERNEL_LADDER_H100.json) holds the workload, the card's name and power
limit, the method, and per variant ms, ns per edge, SM cycles per edge,
share of K1's bound and max error. KERNEL_LADDER.json is the TPU ladder's
and is never written here.

    python -m ultra_torchdrug_tpu_torch.diagnostics.blocked_ladder
    python -m ultra_torchdrug_tpu_torch.diagnostics.blocked_ladder \\
        --variants all --out output/ladder.json
    python -m ultra_torchdrug_tpu_torch.diagnostics.blocked_ladder \\
        --device cpu --nodes 300 --edges 4000 --relations 12 --feat 64 \\
        --out output/ladder.json

Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from .. import default_device
from ..ops import rspmm_ladder_cuda as ladder
from .kernel_floor import TIMED_ITERS, parse_variants, run_ladder
from .workloads import blocked_ladder_workload, blocked_operands

DEFAULT_VARIANTS = "full,nowrite,statrow,norel,floor"
DEFAULT_OUT = "KERNEL_LADDER_H100.json"
TPU_ARTIFACT = "KERNEL_LADDER.json"


def run(variants=DEFAULT_VARIANTS, out=DEFAULT_OUT, nodes=15000,
        edges=544 * 1024, relations=474, feat=4096, device=None) -> dict:
    if Path(out).name == TPU_ARTIFACT:
        raise ValueError(f"{TPU_ARTIFACT} is the TPU ladder's record; write "
                         "the card's elsewhere")
    device = default_device(device)
    names = parse_variants(variants)
    wl = blocked_ladder_workload(V=nodes, E=edges, R=relations)
    w, rel, x = blocked_operands(wl, feat, device)
    csr = wl.csr.to(device)
    ops = ladder.ladder_operands(csr.rowptr, csr.src, csr.etype, csr.eid, w,
                                 rel, x)
    workload = dict(V=wl.num_nodes, E=wl.num_edges, R=wl.num_relations,
                    F=feat, max_in_degree=wl.max_in_degree,
                    top1024_in_edge_share=wl.top1024_share,
                    median_in_degree=wl.median_in_degree,
                    split_segments=ops.seg_ptr.numel() - 1)
    print(f"[ladder] blocked_ladder: {workload} ({device})", flush=True)
    res = run_ladder(ops, names, "blocked_ladder")
    results = dict(
        workload=workload, device=res["device"], measured_at=time.strftime(
            "%Y-%m-%d"),
        method=(f"CUDA events over {TIMED_ITERS} back-to-back launches after "
                "2 warm-up calls; each variant held against its plain "
                "PyTorch version first" if device.type == "cuda" else
                "plain versions on the CPU; no time measured"),
        bound_ms=res["bound_ms"], bound_by=res["bound_by"],
        variants=res["variants"])
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[ladder] blocked_ladder: K1's bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}; wrote {out}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma-separated variants, or 'all'")
    ap.add_argument("--nodes", type=int, default=15000)
    ap.add_argument("--edges", type=int, default=544 * 1024)
    ap.add_argument("--relations", type=int, default=474)
    ap.add_argument("--feat", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.variants, args.out, args.nodes, args.edges,
               args.relations, args.feat, args.device)


if __name__ == "__main__":
    main()

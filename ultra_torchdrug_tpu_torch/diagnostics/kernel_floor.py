"""P1 on the card: the K1 strip-down ladder (ops/rspmm_ladder_cuda.py) on
kernel_floor's chunked synthetic, one line per variant.

The counterpart of script/diagnostics/kernel_floor.py, with its flags and
defaults (E = 524,288 edges in chunks of te = 8,192, runs of 32 edges per
row within tv = 256 rows, V = 4,096 gathered rows, R = 480, F = 4,096, fp32;
so each of the 256 rows takes 2,048 edges). Its variants map to the card's:

    v0_current -> full      v2_noscalar -> noweight   v3_multiacc4 -> multiacc
    v4_pure_fma -> floor    v5_drrmw -> drrmw         v6_packed, v8 -> packed
    v7_direct -> direct     v1_nobranch: none (K1 has no flush branch)

Each variant is timed with CUDA events over back-to-back launches after a
warm-up (the TPU script's chained-depth slope cancelled a remote round trip
the card does not have), and held against its plain version. A line gives
ms, ns per edge, SM cycles per edge (ms x the SM clock nvidia-smi read after
the timing x the SM count / E), the share of K1's bound and the max error.

    python -m ultra_torchdrug_tpu_torch.diagnostics.kernel_floor
    python -m ultra_torchdrug_tpu_torch.diagnostics.kernel_floor --variants all
    python -m ultra_torchdrug_tpu_torch.diagnostics.kernel_floor \\
        --device cpu --edges 128 --te 64 --tv 8 --vrows 64 --feat 256 \\
        --relations 8 --runlen 8

Without a card it raises unless ``--device cpu`` is given; on the CPU the
variants run their plain versions and no time is measured.
"""

from __future__ import annotations

import argparse

import torch

from .. import default_device
from ..ops import rspmm_ladder_cuda as ladder
from .timing import cuda_time_ms, gpu_query, k1_bound_ms
from .workloads import kernel_floor_workload

DEFAULT_VARIANTS = "full,noweight,multiacc,floor"
TIMED_ITERS = 20


def parse_variants(spec: str) -> list:
    names = list(ladder.VARIANTS) if spec == "all" else spec.split(",")
    for name in names:
        ladder.check_variant_name(name)
    return names


def run_ladder(ops: ladder.LadderOperands, variants, label: str,
               iters: int = TIMED_ITERS) -> dict:
    """Every variant against its plain version on ``ops``, then timed (on
    the card) over ``iters`` back-to-back calls; prints one line each and
    returns {"bound_ms", "bound_by", "device", "variants": {name: row}}.
    Raises if a variant disagrees with its plain version, or with full's
    result where it must equal it bitwise (packed, ftile, and nowrite with
    its store on), or if nowrite writes with its store off."""
    cuda = ops.x.device.type == "cuda"
    bound_ms, bound_by = k1_bound_ms((ops.rowptr, ops.src, ops.etype,
                                      ops.eid, ops.weight, ops.relation,
                                      ops.x))
    E = ops.num_edges
    plains, masses, full_out, rows = {}, {}, None, {}
    gpu = None
    for name in variants:
        terms = ladder.terms_of(name)
        key = name if name == "drrmw" else terms
        if key not in plains:
            plains[key] = ladder.ladder_plain(name, ops)
        if terms not in masses:
            masses[terms] = ladder.rounding_mass(name, ops)
        # nowrite is checked with its store on, and timed with it off
        got = ladder.ladder_cuda(name, ops)
        if cuda:
            torch.cuda.synchronize()
        err = ladder.check_variant(name, got, plains[key], masses[terms])
        if name == "full":
            full_out = got
        if name in ladder.BITWISE_FULL + ("nowrite",) and (
                full_out is not None and not torch.equal(got, full_out)):
            raise AssertionError(f"{name} differs from full bitwise")
        del got
        write, out = name != "nowrite", None
        if not write:
            fill = torch.full((ops.num_rows, ops.x.shape[1]), 3.0,
                              device=ops.x.device)
            out = ladder.ladder_cuda(name, ops, out=fill.clone(), write=False)
            if not torch.equal(out, fill):
                raise AssertionError(f"{name} wrote with write=False")
        row = dict(ms=None, ns_per_edge=None, sm_cycles_per_edge=None,
                   share_of_bound=None, max_abs_err=err)
        if cuda:
            ms = cuda_time_ms(lambda: ladder.ladder_cuda(
                name, ops, out=out, write=write), iters)
            gpu = gpu_query()
            row.update(ms=ms, ns_per_edge=ms * 1e6 / E,
                       sm_cycles_per_edge=ms * 1e-3 * gpu["sm_clock_hz"]
                       * gpu["sm_count"] / E,
                       share_of_bound=bound_ms / ms, sm_clock=gpu["sm_clock"])
            if name == "full":
                row["plain_ms"] = cuda_time_ms(
                    lambda: ladder.ladder_plain(name, ops), 3, warmup=1)
            print(f"[ladder] {label} {name:9s} {ms:9.4f} ms "
                  f"{row['ns_per_edge']:8.4f} ns/edge "
                  f"{row['sm_cycles_per_edge']:8.1f} SM-cycles/edge "
                  f"{row['share_of_bound']:7.2%} of K1's bound "
                  f"max_abs_err {err:.3g}"
                  + (f" plain {row['plain_ms']:.4f} ms"
                     if "plain_ms" in row else ""), flush=True)
        else:
            print(f"[ladder] {label} {name:9s} time not measured (cpu) "
                  f"max_abs_err {err:.3g}", flush=True)
        rows[name] = row
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                device=gpu and {k: gpu[k] for k in ("name", "power_limit")},
                variants=rows)


def floor_operands(wl, device) -> ladder.LadderOperands:
    csr = wl.csr.to(device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return ladder.ladder_operands(csr.rowptr, csr.src, csr.etype, csr.eid,
                                  dev(wl.edge_weight), dev(wl.relation),
                                  dev(wl.x))


def run(edges=524288, runlen=32, variants=DEFAULT_VARIANTS, te=8192, tv=256,
        vrows=4096, feat=4096, relations=480, device=None) -> dict:
    device = default_device(device)
    wl = kernel_floor_workload(E=edges, runlen=runlen, F=feat, V=vrows,
                               R=relations, te=te, tv=tv)
    ops = floor_operands(wl, device)
    print(f"[ladder] kernel_floor: E={wl.num_edges} runlen={runlen} "
          f"te={te} tv={tv} V={vrows} R={relations} F={feat} ({device})",
          flush=True)
    res = run_ladder(ops, parse_variants(variants), "kernel_floor")
    res["workload"] = dict(E=wl.num_edges, runlen=runlen, te=te, tv=tv,
                           V=vrows, R=relations, F=feat,
                           max_in_degree=int((ops.rowptr[1:] - ops.rowptr[
                               :-1]).max().item()))
    print(f"[ladder] kernel_floor: K1's bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}; {res['device']}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=524288)
    ap.add_argument("--runlen", type=int, default=32)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma-separated variants, or 'all'")
    ap.add_argument("--te", type=int, default=8192)
    ap.add_argument("--tv", type=int, default=256)
    ap.add_argument("--vrows", type=int, default=4096)
    ap.add_argument("--feat", type=int, default=4096)
    ap.add_argument("--relations", type=int, default=480)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.edges, args.runlen, args.variants, args.te, args.tv,
               args.vrows, args.feat, args.relations, args.device)


if __name__ == "__main__":
    main()

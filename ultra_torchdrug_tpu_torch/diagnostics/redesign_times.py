"""Times of K1 (the rspmm forward), K1h (K1 with bf16 operands), K2 (its
distmult backward), K2h (K2 with bf16 operands), K3 (the transe backward),
K6 and K7 (classic NBFNet's PNA max/min and moments forwards), K6b and
K7b (their backward), K4 and K5 (its max and min forward and backward),
K8f and K8b (its rotate forward and backward) and K9 (the ring shift) on
the card, beside the PyTorch calls that compute the same functions where
there are such, and the host's set-up seconds of the layouts they read,
written to JSON.

K1 on chip_smoke.py's uniform KG (below) in mode mul_rel at F = 1,024 and
4,096 (ULTRA's eval batch and train step) and in mode add_rel at F = 512
and 2,048 (classic transe/pna's), and on bench.py's heavy-tailed KG at
F = 4,096; K2 at F = 4,096, whole and each half alone (dx only, dr only),
on both KGs. Each is held against its plain version first: K1's and K2's
tolerances plus 8 fp32 ulps of each entry's absolute mass
(diagnostics/timing.py::assert_mass_close), since the parent's K2 sums a dr
row of about 1,000 terms 1.2e-4 away from the plain version at F = 4,096.
K1's host side at the edge ring's bucket shape: the uniform KG on 4
shards, each of its 16 buckets' CSRs at F = 1,024 (ULTRA's eval width), 192
calls (12 rounds of the buckets, as many as a ring eval batch makes),
microseconds of the host's clock per call with the kernels queued behind
a device spin (timing.py::host_us_per_call), beside the device time a
call.

K6b (``argext_pair``, modes mul_rel and add_rel, its planes K6's own
outputs on post-ReLU x, so that messages tie) and K7b (``moments``) at
F = 2,048 (classic NBFNet's training width, 64 x 32), whole and each half
alone, each half beside its bound (timing.py::gather_bound_ms), on both
KGs below, held first within the backward's tolerance plus 8 fp32 ulps of
each entry's absolute mass and bitwise across two calls; K6b with the
share of its gated loads that no feature passes
(timing.py::gate_skip_share). K5 (``argext``, modes mul_rel and add_rel,
its planes K4's own max on post-ReLU x) and K8b (D = 32, rel per query) the
same way at F = 2,048, K8b held within K2's dx tolerance and K3's dr
tolerance plus the mass (timing.py::rotate_mass), each half's bound from
timing.py's GATHER_WORK (K8b's halves K8B_HALVES). The passes' layout is
read where the tree has one (a tree before K5's staged design has no plan
for K5).

K2h at F = 4,096 (ULTRA's bf16 training width) on both KGs, whole and each
half alone, its operands bf16 before the call (the wrapper's cast is then
a no-op), held first within K2's tolerance (dr: 1e-5 of the largest entry
where that is more) plus the mass (timing.py::k2_mass on the widened
values) and bitwise across two calls, each half beside its bound
(timing.py::k2_half_times: bf16 reads, fp32 writes). K8f (D = 32) at
F = 512 and 2,048 (classic rotate's eval and training widths) on the
uniform KG and at 2,048 on bench.py's KG, held within K1's tolerance (the
absolute one 1e-5 of the largest entry) plus the mass (timing.py::
k8f_mass) and bitwise across two calls, beside its bound (GATHER_WORK).

K1h (mode mul_rel, bf16 operands before the call) at F = 1,024 and 4,096
(ULTRA's bf16 eval and training widths) on the uniform KG and at 4,096 on
bench.py's KG, held within K1's tolerance plus the mass (timing.py::
k1_mass on the widened values) of the plain version's sums in float64
(timing.py::k1h_sums64) and bitwise across two calls. A tree whose K1h
reads no segments (the first design) is timed without them. K6 (modes
mul_rel and add_rel), K4 (max and min, both modes) and K7, all on
post-ReLU x (so that messages tie), at F = 512 and 2,048 (classic pna's
and max's eval and training widths) on the uniform KG and at 2,048 on
bench.py's KG, K4 and K6 held equal to their plain versions under ==, K7
within 1e-5 plus the mass of the plain sums in float64 (timing.py::
k7_sums64, k7_mass), each bitwise across two calls and timed twice (the
lesser reading is ``ms``), beside its bound (GATHER_WORK); K6 also on its
scalar path with rel rows gathered (F = 2,046, 2,000 rel rows, the graph's
474 relations among them), both modes.

K3 at F = 2,048 (the classic transe/pna training width, 64 x 32): the
whole call and each half alone (dx only, dr only), on chip_smoke.py's
uniform KG (FB15k-237's counts, undirected with inverse edges: V = 14,541,
E = 496,188, R = 474) and on bench.py's heavy-tailed KG
(diagnostics/workloads.py::build_workload, V = 15,000, E = 557,056,
R = 474, edges head -> tail), each beside ``torch.sparse.mm``'s two halves.
K9 at the ring's shapes (n = 4 shards of v_block = 3,636 rows, F = 1,024
and 4,096 fp32), through the ring's wrapper (parallel/rdma.py::
shift_blocks over the row blocks of one tensor, so the package under
``--root`` needs that wrapper): queued ahead of the device and at the
host's pace, beside
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
K1_FEATS = (16 * 64, 64 * 64)  # ULTRA eval batch and train step widths
K1_ADD_FEATS = (16 * 32, 64 * 32)  # classic transe/pna's, mode add_rel
K2_FEAT = 64 * 64
PNA_FEAT = 64 * 32  # classic NBFNet's training width
PNA_KINDS = (("K6b", "argext_pair", "mul_rel"),
             ("K6b", "argext_pair", "add_rel"), ("K7b", "moments", "mul_rel"))
K5_KINDS = (("K5", "argext", "mul_rel"), ("K5", "argext", "add_rel"))
ROTATE_DIM = 32  # classic NBFNet's: F = 64 queries x 32
FB = dict(num_nodes=14541, num_edges=310116, num_relations=237)
RING_SHARDS = 4
PARTS = ("setup", "k1", "k2", "k2h", "pna", "k5", "k8f", "k8b", "k3", "k9",
         "k1h", "k6", "k4", "k7", "k6g")
K1H_FEATS = K1_FEATS  # ULTRA's bf16 eval batch and train step widths
# classic pna's and max's eval and training widths
PNA_FWD_FEATS = (16 * 32, 64 * 32)
# the forwards' kinds and modes by part
FWD_PARTS = {"k6": (("maxmin", "mul_rel"), ("maxmin", "add_rel")),
             "k4": tuple((agg, mode) for agg in ("max", "min")
                         for mode in ("mul_rel", "add_rel")),
             "k7": (("addsq", "mul_rel"),)}
# (F, R) of K6's scalar path with rel rows gathered: F % 4 != 0, and the
# 32-feature rel slice of R rows above the shared-memory budget
K6G_SHAPE = (2046, 2000)
K8F_FEATS = (16 * 32, 64 * 32)  # classic rotate's eval and training widths
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


def _kw(csr) -> dict:
    """The forward's segments where the checkout's Csr has them (a checkout
    before the hub-aware K1 takes none)."""
    return {"segments": csr.segments} if hasattr(csr, "segments") else {}


def time_k1(torch, timing, fwd, csr, w, F: int, mode: str,
            label: str) -> dict:
    V, R = csr.rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 1)
    x = torch.randn((V, F), generator=gen, device=w.device)
    rel = torch.randn((R, F), generator=gen, device=w.device)
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    kw = _kw(csr)
    got = fwd.rspmm_fwd_cuda(*ops, mode, **kw)
    want = fwd.rspmm_fwd_plain(*ops, mode)
    mass = timing.k1_mass(ops, mode)
    err = timing.assert_mass_close(got, want, mass, 1e-5, 1e-5,
                                   f"K1 {label}")
    del got, want, mass
    bound_ms, bound_by = timing.k1_bound_ms(ops)
    out = dict(V=V, E=int(csr.src.numel()), R=R, F=F, mode=mode,
               max_abs_err=err, ms=timing.cuda_time_ms(
                   lambda: fwd.rspmm_fwd_cuda(*ops, mode, **kw),
                   50 if F <= 1024 else 20),
               bound_ms=bound_ms, bound_by=bound_by)
    if hasattr(fwd, "k1_plan"):
        out["plan"] = fwd.k1_plan(R, F, V, csr.seg_ptr.numel() - 1, mode)
    _show(f"K1 {label} {mode} F={F}", out)
    return out


def k1_ring_host(torch, timing, fwd, und, w, device) -> dict:
    """K1's host microseconds a call over the ring's bucket CSRs (see the
    module's text), and its device microseconds a call."""
    from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
        build_ring_rspmm_inputs)

    ring = build_ring_rspmm_inputs(
        und.edge_index.numpy(), und.edge_type.numpy(), und.num_nodes,
        RING_SHARDS, num_relations=und.num_relations, pallas=True,
        balance="auto", permuted_io=True, backward=True).to(device)
    F, vb = K1_FEATS[0], ring.v_block
    gen = torch.Generator(device=device).manual_seed(F + 3)
    x = torch.randn((vb, F), generator=gen, device=device)
    rel = torch.randn((und.num_relations, F), generator=gen, device=device)
    buckets = [(c.rowptr, c.src, c.etype, c.eid, w, rel, x, "mul_rel",
                _kw(c)) for row in ring.csr for c in row if c.src.numel()]

    def round_of_buckets():
        for *ops, kw in buckets:
            fwd.rspmm_fwd_cuda(*ops, **kw)

    rounds = 192 // len(buckets)
    out = dict(buckets=len(buckets), calls=rounds * len(buckets), F=F,
               host_us=timing.host_us_per_call(round_of_buckets, rounds)
               / len(buckets),
               device_us=timing.cuda_time_ms(round_of_buckets, rounds,
                                             queue_ahead=True)
               * 1e3 / len(buckets))
    _show("K1 ring buckets", out)
    return out


def time_k2(torch, timing, bwd, csr, w, label: str) -> dict:
    V, F = csr.src_rowptr.numel() - 1, K2_FEAT
    R = csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 2)
    rel = torch.randn((R, F), generator=gen, device=w.device)
    x = torch.randn((V, F), generator=gen, device=w.device)
    g = torch.randn((V, F), generator=gen, device=w.device)
    ops = (csr, w, rel, x, g)

    def k2(need_dx=True, need_dr=True):
        return bwd.rspmm_bwd_cuda(*ops, need_dx, need_dr)

    got, got2 = k2(), k2()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError(f"K2 {label}: two calls differ")
    del got2
    want = bwd.rspmm_bwd_plain(*ops)
    masses = timing.k2_mass(*ops)
    err = max(timing.assert_mass_close(a, b, m, 1e-5, 1e-4,
                                       f"K2 {label} {half}")
              for a, b, m, half in zip(got, want, masses, ("dx", "dr")))
    del got, want, masses
    out = dict(V=V, E=int(csr.src_dst.numel()), R=R, F=F, max_abs_err=err,
               ms=timing.cuda_time_ms(k2, 20),
               **timing.k2_half_times(k2, ops))
    if hasattr(bwd, "k2_plan"):
        out["plan"] = bwd.k2_plan(csr, F)
    _show(f"K2 {label}", out)
    return out


def time_k2h(torch, timing, bwd, csr, w, label: str) -> dict:
    V, F = csr.src_rowptr.numel() - 1, K2_FEAT
    R = csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 12)
    rel, x, g = (torch.randn(s, generator=gen, device=w.device).bfloat16()
                 for s in ((R, F), (V, F), (V, F)))
    ops = (csr, w, rel, x, g)

    def k2h(need_dx=True, need_dr=True):
        return bwd.rspmm_bwd_bf16_cuda(*ops, need_dx, need_dr)

    got, got2 = k2h(), k2h()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError(f"K2h {label}: two calls differ")
    del got2
    want = bwd.rspmm_bwd_bf16_plain(*ops)
    masses = timing.k2_mass(csr, w, *(t.float() for t in (rel, x, g)))
    err = max(timing.assert_mass_close(
        a, b, m, 1e-5, atol, f"K2h {label} {half}")
        for a, b, m, half, atol in zip(
            got, want, masses, ("dx", "dr"),
            (1e-4, max(1e-4, 1e-5 * want[1].abs().max().item()))))
    del got, want, masses
    bound_ms, bound_by = timing.roofline_ms(
        timing.edge_bytes(w.numel()) + (x.numel() + g.numel() + rel.numel())
        * 2 + (x.numel() + rel.numel()) * 4, 6 * w.numel() * F)
    out = dict(V=V, E=int(csr.src_dst.numel()), R=R, F=F, max_abs_err=err,
               ms=timing.cuda_time_ms(k2h, 20), bound_ms=bound_ms,
               bound_by=bound_by, **timing.k2_half_times(k2h, ops))
    if hasattr(bwd, "k2h_plan"):
        out["plan"] = bwd.k2h_plan(csr, F)
    _show(f"K2h {label}", out)
    return out


def time_k8f(torch, timing, fwd, csr, w, F: int, label: str) -> dict:
    V, R = csr.rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 13)
    x = torch.randn((V, F), generator=gen, device=w.device)
    rel = torch.randn((R, F), generator=gen, device=w.device)
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    # a tree whose K8f reads no segments takes none
    segmented = hasattr(fwd, "k8f_plan")
    kw = {"segments": csr.segments} if segmented else {}

    def k8f():
        return fwd.rotate_fwd_cuda(*ops, ROTATE_DIM, **kw)

    got, got2 = k8f(), k8f()
    if not torch.equal(got, got2):
        raise AssertionError(f"K8f {label}: two calls differ")
    del got2
    want = fwd.rspmm_fwd_plain(*ops, "rot_rel", ROTATE_DIM)
    err = timing.assert_mass_close(
        got, want, timing.k8f_mass(ops, ROTATE_DIM), 1e-5,
        1e-5 * max(1.0, want.abs().max().item()), f"K8f {label}")
    del got, want
    bound_ms, bound_by = timing.gather_bound_ms("K8f", w, rel, x)
    out = dict(V=V, E=int(csr.src.numel()), R=R, F=F, dim=ROTATE_DIM,
               max_abs_err=err,
               ms=timing.cuda_time_ms(k8f, 50 if F <= 512 else 20),
               bound_ms=bound_ms, bound_by=bound_by)
    if segmented:
        out["plan"] = fwd.k8f_plan(R, F, V, csr.seg_ptr.numel() - 1,
                                   ROTATE_DIM)
    _show(f"K8f {label} F={F}", out)
    return out


def time_k1h(torch, timing, fwd, csr, w, F: int, label: str) -> dict:
    V, R = csr.rowptr.numel() - 1, csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 17)
    x = torch.randn((V, F), generator=gen, device=w.device).bfloat16()
    rel = torch.randn((R, F), generator=gen, device=w.device).bfloat16()
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    # a tree whose K1h reads no segments takes none
    segmented = hasattr(fwd, "k1h_plan")
    kw = {"segments": csr.segments} if segmented else {}

    def k1h():
        return fwd.rspmm_fwd_bf16_cuda(*ops, "mul_rel", **kw)

    got, got2 = k1h(), k1h()
    if not torch.equal(got.view(torch.int32), got2.view(torch.int32)):
        raise AssertionError(f"K1h {label}: two calls differ")
    del got2
    want = timing.k1h_sums64(ops)
    err = timing.assert_mass_close(
        got, want, timing.k1_mass((*ops[:5], rel.float(), x.float())), 1e-5,
        1e-5, f"K1h {label}")
    del got, want
    bound_ms, bound_by = timing.k1_bound_ms(ops)
    out = dict(V=V, E=int(csr.src.numel()), R=R, F=F, mode="mul_rel",
               max_abs_err=err,
               ms=timing.cuda_time_ms(k1h, 50 if F <= 1024 else 20),
               bound_ms=bound_ms, bound_by=bound_by)
    if segmented:
        out["plan"] = fwd.k1h_plan(R, F, V, csr.seg_ptr.numel() - 1)
    _show(f"K1h {label} F={F}", out)
    return out


# the forward kinds of ops/rspmm_pna_cuda.py by kernel, and the seed of
# each kernel's operands
FWD_ID = {"maxmin": "K6", "max": "K4", "min": "K4", "addsq": "K7"}
FWD_SEED = {"K6": 18, "K4": 19, "K7": 20}


def time_fwd(torch, timing, pna, csr, w, F: int, kind: str, mode: str,
             label: str, num_relations: int = 0,
             strict: bool = True) -> dict:
    """K6 (``maxmin``), K4 (``max``, ``min``) or K7 (``addsq``) on
    post-ReLU x, with the graph's relations or ``num_relations`` rel rows
    (more than the graph's: the rel rows a shape gathers): two calls
    bitwise equal; K4 and K6 equal to the plain version under ==, K7
    within 1e-5 plus 8 fp32 ulps of each entry's absolute mass of the plain
    sums in float64 (timing.py::k7_sums64, k7_mass; without ``strict`` a
    K7 beyond it is recorded, not raised: see --lenient-sums); then timed,
    the lesser of two readings."""
    kid = FWD_ID[kind]
    V = csr.rowptr.numel() - 1
    R = num_relations or csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + FWD_SEED[kid])
    rel = torch.randn((R, F), generator=gen, device=w.device)
    x = torch.randn((V, F), generator=gen, device=w.device).clamp_(min=0)

    def run():
        return pna.pna_fwd_cuda(kind, csr, w, rel, x, mode)

    got, got2 = run(), run()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, got2)):
        raise AssertionError(f"{kid} {kind} {mode} {label}: two calls differ")
    del got2
    err, beyond = 0.0, None
    if kind == "addsq":
        for a, want, mass in zip(got, timing.k7_sums64(csr, w, rel, x),
                                 timing.k7_mass(csr, w, rel, x)):
            try:
                err = max(err, timing.assert_mass_close(
                    a, want, mass, 1e-5, 1e-5, f"K7 {label} F={F}"))
            except AssertionError as exc:
                if strict:
                    raise
                beyond = str(exc)
                err = max(err, (a - want).abs().max().item())
    elif not all(torch.equal(a, b) for a, b in zip(
            got, pna.pna_fwd_plain(kind, csr, w, rel, x, mode))):
        raise AssertionError(f"{kid} {kind} {mode} {label}: differs from its "
                             "plain version")
    del got
    bound_ms, bound_by = timing.gather_bound_ms(kid, w, rel, x)
    iters = 50 if F <= 512 else 20
    readings = [timing.cuda_time_ms(run, iters) for _ in range(2)]
    out = dict(V=V, E=int(csr.src.numel()), R=R, F=F, kind=kind, mode=mode,
               max_abs_err=err, ms=min(readings), readings=readings,
               bound_ms=bound_ms, bound_by=bound_by)
    if beyond:
        out["beyond_tolerance"] = beyond
    try:  # a tree before K4's and K7's staged design plans K6 alone
        out["plan"] = pna.pna_fwd_plan(R, F, V, csr.seg_ptr.numel() - 1,
                                       mode, kind=kind)
    except TypeError:
        if kind == "maxmin":
            out["plan"] = pna.pna_fwd_plan(R, F, V, csr.seg_ptr.numel() - 1,
                                           mode)
    _show(f"{kid} {label} {kind} {mode} F={F}", out)
    return out


def time_pna(torch, timing, pna, csr, w, kid: str, kind: str, mode: str,
             label: str) -> dict:
    V, F = csr.src_rowptr.numel() - 1, PNA_FEAT
    R = csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 4)
    rel = torch.randn((R, F), generator=gen, device=w.device)
    x = torch.randn((V, F), generator=gen, device=w.device).clamp_(min=0)
    g = [torch.randn((V, F), generator=gen, device=w.device)
         for _ in range(2)]
    if kind == "argext_pair":
        mx, mn = pna.pna_fwd_cuda("maxmin", csr, w, rel, x, mode)
        planes = (g[0], mx, g[1], mn)
    elif kind == "argext":
        planes = (g[0], *pna.pna_fwd_cuda("max", csr, w, rel, x, mode))
    else:
        planes = tuple(g)
    ops = (csr, w, rel, x, planes, mode)

    def run(need_dx=True, need_dr=True):
        return pna.pna_bwd_cuda(kind, *ops, need_dx, need_dr)

    got, got2 = run(), run()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError(f"{kid} {mode} {label}: two calls differ")
    del got2
    want = pna.pna_bwd_plain(kind, *ops)
    masses = timing.pna_mass(kind, *ops)
    err = max(timing.assert_mass_close(
        a, b, m, 1e-5, max(1e-4, 1e-5 * b.abs().max().item()),
        f"{kid} {mode} {label} {half}")
        for a, b, m, half in zip(got, want, masses, ("dx", "dr")))
    del got, want, masses
    bound_ms, bound_by = timing.gather_bound_ms(kid, w, rel, x)
    out = dict(V=V, E=int(csr.src_dst.numel()), R=R, F=F, mode=mode,
               max_abs_err=err, ms=timing.cuda_time_ms(run, 20),
               bound_ms=bound_ms, bound_by=bound_by,
               **timing.pna_half_times(run, kid, w, rel, x))
    if kind == "argext_pair":
        out["gated_loads_skipped"] = timing.gate_skip_share(csr, w, rel, x,
                                                            planes, mode)
    plan = _pna_plan(pna, kind, csr, F, mode)
    if plan is not None:
        out["plan"] = plan
    _show(f"{kid} {label} {mode}", out)
    return out


def _pna_plan(pna, kind: str, csr, F: int, mode: str):
    """The passes' layout where the tree has one, else None: older trees
    have no ``pna_bwd_plan``, and where K5 runs the first design it raises
    ValueError for ``argext``."""
    if not hasattr(pna, "pna_bwd_plan"):
        return None
    try:
        return pna.pna_bwd_plan(kind, csr, F, mode)
    except ValueError:
        if kind != "argext":
            raise
        return None


def time_k8b(torch, timing, bwd, csr, w, label: str) -> dict:
    V, F = csr.src_rowptr.numel() - 1, PNA_FEAT
    R = csr.rel_chunk_ptr.numel() - 1
    gen = torch.Generator(device=w.device).manual_seed(F + 9)
    rel = torch.randn((R, F), generator=gen, device=w.device)
    x = torch.randn((V, F), generator=gen, device=w.device)
    g = torch.randn((V, F), generator=gen, device=w.device)
    ops = (csr, w, rel, x, g, ROTATE_DIM)

    def run(need_dx=True, need_dr=True):
        return bwd.rotate_bwd_cuda(*ops, need_dx, need_dr)

    got, got2 = run(), run()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError(f"K8b {label}: two calls differ")
    del got2
    want = bwd.rotate_bwd_plain(*ops)
    masses = timing.rotate_mass(*ops)
    # dx K2's tolerance, dr K3's (PERF.md), each plus the mass
    err = max(timing.assert_mass_close(
        a, b, m, 1e-5, atol, f"K8b {label} {half}")
        for a, b, m, half, atol in zip(
            got, want, masses, ("dx", "dr"),
            (1e-4, max(1e-4, 1e-5 * want[1].abs().max().item()))))
    del got, want, masses
    bound_ms, bound_by = timing.gather_bound_ms("K8b", w, rel, x)
    out = dict(V=V, E=int(csr.src_dst.numel()), R=R, F=F, dim=ROTATE_DIM,
               max_abs_err=err, ms=timing.cuda_time_ms(run, 20),
               bound_ms=bound_ms, bound_by=bound_by,
               **timing.pna_half_times(run, "K8b", w, rel, x))
    if hasattr(bwd, "k8b_plan"):
        out["plan"] = bwd.k8b_plan(csr, F, ROTATE_DIM)
    _show(f"K8b {label}", out)
    return out


def time_k9(torch, timing, rdma, F: int, vb: int) -> dict:
    n = RING_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(F)
    x = torch.randn((n * vb, F), generator=gen, device="cuda")

    def shift(wrapper):
        return wrapper(list(x.chunk(n)), [x.device] * n)

    if not torch.equal(torch.cat(shift(rdma.shift_blocks)),
                       torch.cat(shift(rdma.shift_blocks_plain))):
        raise AssertionError(f"K9 F={F}: differs from its plain version")
    out = dict(n=n, v_block=vb, F=F, **timing.k9_times(
        lambda: shift(rdma.shift_blocks),
        lambda: shift(rdma.shift_blocks_plain), x, n))
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
    ap.add_argument("--lenient-sums", action="store_true",
                    help="record (key beyond_tolerance), not raise on, a K7 "
                         "on bench.py's KG beyond its tolerance: a tree "
                         "whose K7 sums a hub row serially (the first "
                         "design) drifts past it")
    ap.add_argument("--kernels", nargs="+", default=list(PARTS),
                    choices=PARTS,
                    help="what to time (default: all): the set-up seconds, "
                         "K1, K2, K2h, K6b and K7b, K5, K8f, K8b, K3, K9, "
                         "K1h, K6, K4, K7, K6 on its scalar path with rel "
                         "rows gathered")
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
    from ultra_torchdrug_tpu_torch.ops import rspmm_cuda as fwd
    from ultra_torchdrug_tpu_torch.ops import rspmm_pna_cuda as pna
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
    parts = set(args.kernels)
    result = dict(root=str(root), device=smi)
    if "setup" in parts:
        result.update(setup_seconds(fact))
    und = fact.undirected_with_inverse().prepare_csr(backward=True)
    tri, _, _ = build_workload(features=False)
    hub = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], 15000, 474,
                    backward=True)
    uni_csr, hub_csr = und.csr.to(device), hub.to(device)
    uni_w, hub_w = weights(und.num_edges, 5), weights(len(tri), 6)
    if "k1" in parts:
        result["k1_uniform"] = [
            time_k1(torch, timing, fwd, uni_csr, uni_w, F, mode, "uniform KG")
            for mode, feats in (("mul_rel", K1_FEATS),
                                ("add_rel", K1_ADD_FEATS))
            for F in feats]
        result["k1_ring_host"] = k1_ring_host(torch, timing, fwd, und, uni_w,
                                              device)
        result["k1_hub"] = time_k1(torch, timing, fwd, hub_csr, hub_w,
                                   K1_FEATS[1], "mul_rel", "bench.py's KG")
    if "k2" in parts:
        result["k2_uniform"] = time_k2(torch, timing, bwd, uni_csr, uni_w,
                                       "uniform KG")
        result["k2_hub"] = time_k2(torch, timing, bwd, hub_csr, hub_w,
                                   "bench.py's KG")
    if "k2h" in parts:
        result["k2h_uniform"] = time_k2h(torch, timing, bwd, uni_csr, uni_w,
                                         "uniform KG")
        result["k2h_hub"] = time_k2h(torch, timing, bwd, hub_csr, hub_w,
                                     "bench.py's KG")
    torch.cuda.empty_cache()
    kinds = (PNA_KINDS if "pna" in parts else ()) + (
        K5_KINDS if "k5" in parts else ())
    if kinds:
        for key, csr, w in (("uniform", uni_csr, uni_w),
                            ("hub", hub_csr, hub_w)):
            for kid, kind, mode in kinds:
                result.setdefault(f"{kid.lower()}_{key}", []).append(
                    time_pna(torch, timing, pna, csr, w, kid, kind, mode,
                             "uniform KG" if key == "uniform"
                             else "bench.py's KG"))
                torch.cuda.empty_cache()
    if "k8f" in parts:
        result["k8f_uniform"] = [
            time_k8f(torch, timing, fwd, uni_csr, uni_w, F, "uniform KG")
            for F in K8F_FEATS]
        result["k8f_hub"] = time_k8f(torch, timing, fwd, hub_csr, hub_w,
                                     K8F_FEATS[1], "bench.py's KG")
        torch.cuda.empty_cache()
    if "k1h" in parts:
        result["k1h_uniform"] = [
            time_k1h(torch, timing, fwd, uni_csr, uni_w, F, "uniform KG")
            for F in K1H_FEATS]
        result["k1h_hub"] = time_k1h(torch, timing, fwd, hub_csr, hub_w,
                                     K1H_FEATS[1], "bench.py's KG")
        torch.cuda.empty_cache()
    for part, kinds in FWD_PARTS.items():
        if part not in parts:
            continue
        result[f"{part}_uniform"] = [
            time_fwd(torch, timing, pna, uni_csr, uni_w, F, kind, mode,
                     "uniform KG")
            for kind, mode in kinds for F in PNA_FWD_FEATS]
        result[f"{part}_hub"] = [
            time_fwd(torch, timing, pna, hub_csr, hub_w, PNA_FWD_FEATS[1],
                     kind, mode, "bench.py's KG",
                     strict=not args.lenient_sums) for kind, mode in kinds]
        torch.cuda.empty_cache()
    if "k6g" in parts:
        result["k6g_uniform"] = [
            time_fwd(torch, timing, pna, uni_csr, uni_w, K6G_SHAPE[0],
                     "maxmin", mode, "uniform KG",
                     num_relations=K6G_SHAPE[1])
            for mode in ("mul_rel", "add_rel")]
        torch.cuda.empty_cache()
    if "k8b" in parts:
        for key, csr, w in (("uniform", uni_csr, uni_w),
                            ("hub", hub_csr, hub_w)):
            result[f"k8b_{key}"] = time_k8b(
                torch, timing, bwd, csr, w,
                "uniform KG" if key == "uniform" else "bench.py's KG")
            torch.cuda.empty_cache()
    if "k3" in parts:
        result["k3_uniform"] = time_k3(torch, timing, bwd, und.csr.to(device),
                                       weights(und.num_edges, 7),
                                       "uniform KG")
        result["k3_hub"] = time_k3(torch, timing, bwd, hub.to(device),
                                   weights(len(tri), 8), "bench.py's KG")
    if "k9" in parts:
        vb = -(-FB["num_nodes"] // RING_SHARDS)
        result["k9"] = [time_k9(torch, timing, rdma, F, vb)
                        for F in RING_FEATS]
    result["hub_max_out_degree"] = int(np.bincount(tri[:, 0]).max())
    result["hub_max_in_degree"] = int(np.bincount(tri[:, 1]).max())
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"[times] wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()

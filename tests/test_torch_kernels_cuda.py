"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips where there is no
card; the decision is taken inside the ``cuda_device`` fixture, at run time.

Run on a machine with the card:
    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerance atol = rtol = 1e-5 for K1: the kernel sums each row's edges in CSR
order, the plain version with index_add_ in another order. K2 uses rtol 1e-5,
atol 1e-4: its dr rows sum up to a few hundred products of N(0, 1) values.
On hub rows (10^3 to 10^5 edges) K1, K2, K2h, K6b, K7b, K5, K8f and K8b
add 8 fp32 ulps of each entry's absolute mass to those (diagnostics/
timing.py::assert_mass_close): their segments' partial rows sum in another
order than the plain version.
K6 and K4 must equal their plain versions exactly (an extremum of the same
fp32 products), on hub rows too; K7 takes K1's tolerance for the same
reason, on hub rows plus 8 fp32 ulps of each entry's absolute mass against
the plain sums taken in float64 (the fp32 plain version's index_add_ adds
a hub row in atomics order on the card). K3, K5 and
K6b/K7b take K2's, with the absolute tolerance widened to 1e-5 of the
result's largest entry: a dr row sums a thousand or more terms (K7b's carry
x² and reach ~1e2), whose partial sums grow to that size, in another order.
K8f takes K1's with the absolute tolerance 1e-5 of its largest entry (nvcc
contracts the complex product's a·b − c·d into an FMA); K8b takes K2's for
dx and K3's for dr. K1h and K2h (the bf16 operand mode) take K1's and
K2's (K2h's dr on hub rows K3's): the operands round to the same bf16
values on both sides and each forward message is rounded from the same
exact product, so only the order of the fp32 sums differs. K9 (the ring shift) copies bytes: it must equal
its plain version bitwise; the ring op on the card (K1 and K2 per bucket,
K9 between steps) takes K1's and K2's tolerances against the CPU. The K1
strip-down ladder (P1, P2) holds each variant to
ops/rspmm_ladder_cuda.py::check_variant: K1's tolerance plus 8 fp32 ulps
of each entry's absolute mass (its terms sum in another order), dr 1e-4 of
its largest entry; full equals K1 on the rows of one segment (at most
256 edges; a longer row K1 sums by segments, held to full's tolerance),
and packed, ftile and nowrite equal full, bitwise.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu_torch.data.graph import Graph, build_csr
from ultra_torchdrug_tpu_torch.diagnostics import (
    blocked_ladder,
    kernel_floor,
    timing,
)
from ultra_torchdrug_tpu_torch.ops import (
    rspmm_bwd_cuda,
    rspmm_cuda,
    rspmm_pna_cuda,
)
from ultra_torchdrug_tpu_torch.ops import rspmm_ladder_cuda as ladder
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    generalized_rspmm,
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.parallel import rdma
from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
    build_ring_rspmm_inputs,
    ring_rspmm,
    ring_rspmm_addsq,
    ring_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.parallel.sharded_rspmm import (
    build_partitioned_rspmm_inputs,
    partitioned_rspmm,
)

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _graph(rng, V, E, R, empty_rows=0, empty_rels=0):
    tri = np.stack([rng.integers(0, V - empty_rows, E),
                    rng.integers(0, V - empty_rows, E),
                    rng.integers(0, R - empty_rels, E)], 1)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0  # masked edges
    return Graph.from_triplets(tri, V, R,
                               edge_weight=w).prepare_csr(backward=True)


# (V, E, R, F): the small/ragged shapes of the CPU tests (F = 10 takes the
# scalar path, F = 64 the float4 path, F = 1028 two feature tiles), and a
# graph with more rows than edges
SHAPES = [(37, 300, 6, 10), (37, 300, 6, 64), (50, 20, 3, 12),
          (37, 300, 6, 1028)]


@pytest.mark.parametrize("V,E,R,F", SHAPES)
@pytest.mark.parametrize("mode", ["mul_rel", "add_rel"])
def test_k1_matches_plain(cuda_device, rng, mode, V, E, R, F):
    g = _graph(rng, V, E, R, empty_rows=5).to(cuda_device)
    rel = torch.from_numpy(rng.normal(size=(R, F)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, F)).astype(np.float32))
    rel, x = rel.to(cuda_device), x.to(cuda_device)
    csr = g.csr
    args = (csr.rowptr, csr.src, csr.etype, csr.eid, g.edge_weight, rel, x,
            mode)
    before = rspmm_cuda.launches
    got = rspmm_cuda.rspmm_fwd_cuda(*args, segments=csr.segments)
    torch.cuda.synchronize()
    assert rspmm_cuda.launches == before + 1
    want = rspmm_cuda.rspmm_fwd_plain(*args)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.all(got[V - 5:] == 0)  # rows with no edges write 0


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_generalized_rspmm_card_matches_cpu(cuda_device, rng, msg):
    """The op routes CUDA tensors through K1 and agrees with its CPU path,
    in the [V, B, D] form with a per-batch relation."""
    V, E, R, B, D = 37, 300, 6, 3, 16
    g = _graph(rng, V, E, R)
    rel = torch.from_numpy(rng.normal(size=(R, B, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    want = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, rel, x,
                             msg=msg, num_nodes=V)
    gc = g.to(cuda_device)
    before = rspmm_cuda.launches
    got = generalized_rspmm(gc.edge_index, gc.edge_type, gc.edge_weight,
                            rel.to(cuda_device), x.to(cuda_device), msg=msg,
                            num_nodes=V, csr=gc.csr)
    assert rspmm_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_k1_rejects_bad_operands(cuda_device, rng):
    g = _graph(rng, 37, 300, 6).to(cuda_device)
    csr = g.csr
    rel = torch.zeros((6, 8), device=cuda_device)
    x = torch.zeros((37, 8), device=cuda_device)
    seg = dict(segments=csr.segments)
    with pytest.raises(TypeError):  # int64 indices
        rspmm_cuda.rspmm_fwd_cuda(csr.rowptr.long(), csr.src, csr.etype,
                                  csr.eid, g.edge_weight, rel, x, "mul_rel",
                                  **seg)
    with pytest.raises(ValueError):  # non-contiguous x
        rspmm_cuda.rspmm_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                                  g.edge_weight, rel,
                                  torch.zeros((8, 37), device=cuda_device).T,
                                  "mul_rel", **seg)
    with pytest.raises(ValueError):  # operand on the CPU
        rspmm_cuda.rspmm_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                                  g.edge_weight, rel.cpu(), x, "mul_rel",
                                  **seg)
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, g.edge_weight, rel, x,
           "mul_rel")
    with pytest.raises(TypeError):  # no segments
        rspmm_cuda.rspmm_fwd_cuda(*ops, segments=None)
    with pytest.raises(ValueError):  # the segments on the CPU
        rspmm_cuda.rspmm_fwd_cuda(*ops, segments=g.csr.to("cpu").segments)
    with pytest.raises(ValueError):  # another CSR's segments
        rspmm_cuda.rspmm_fwd_cuda(*ops, segments=_graph(
            rng, 40, 300, 6).to(cuda_device).csr.segments)


# (V, E, R, F): scalar (F = 10) and float4 (F = 64) widths, two feature tiles
# (F = 1028), more rows than edges, and ~700 edges on each of two relations
# (three chunks each) beside a relation without edges
K2_SHAPES = [(37, 300, 6, 10), (37, 300, 6, 64), (37, 300, 6, 1028),
             (50, 20, 3, 12), (60, 1400, 3, 64)]


def _k2_operands(rng, V, E, R, F, device):
    g = _graph(rng, V, E, R, empty_rows=5, empty_rels=1).to(device)
    ops = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
           for s in ((R, F), (V, F), (V, F))]
    return g, ops


@pytest.mark.parametrize("V,E,R,F", K2_SHAPES)
def test_k2_matches_plain(cuda_device, rng, V, E, R, F):
    g, (rel, x, grad) = _k2_operands(rng, V, E, R, F, cuda_device)
    before = rspmm_bwd_cuda.launches["K2"]
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight, rel, x, grad)
    torch.cuda.synchronize()
    assert rspmm_bwd_cuda.launches["K2"] == before + 1
    want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_plain(g.csr, g.edge_weight,
                                                      rel, x, grad)
    torch.testing.assert_close(dx, want_dx, **K2_TOL)
    torch.testing.assert_close(dr, want_dr, **K2_TOL)
    assert torch.all(dx[V - 5:] == 0)  # rows that send no edge
    assert torch.all(dr[R - 1] == 0)  # the relation without edges
    # one half alone
    dx2, none = rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight, rel, x,
                                              grad, need_dr=False)
    none2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight, rel, x,
                                               grad, need_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx2, dx) and torch.equal(dr2, dr)


def test_k2_is_deterministic(cuda_device, rng):
    g, (rel, x, grad) = _k2_operands(rng, 60, 1400, 3, 64, cuda_device)
    a = rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight, rel, x, grad)
    b = rspmm_bwd_cuda.rspmm_bwd_cuda(g.csr, g.edge_weight, rel, x, grad)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k2_rejects_bad_operands(cuda_device, rng):
    g, (rel, x, grad) = _k2_operands(rng, 37, 300, 6, 8, cuda_device)
    csr, w = g.csr, g.edge_weight
    with pytest.raises(TypeError):  # float64 gradient
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr, w, rel, x, grad.double())
    with pytest.raises(ValueError):  # non-contiguous x
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr, w, rel,
                                      torch.zeros((8, 37), device=cuda_device).T,
                                      grad)
    with pytest.raises(ValueError):  # relation with the wrong row count
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr, w, rel[:5].contiguous(), x, grad)
    with pytest.raises(ValueError):  # layouts on the CPU
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr.to("cpu"), w, rel, x, grad)


@pytest.mark.parametrize("msg", ["mul", "add"])
@pytest.mark.parametrize("shared_rel", [False, True])
def test_generalized_rspmm_gradient_card_matches_cpu(cuda_device, rng,
                                                     shared_rel, msg):
    """Autograd through the op on the card (K1 forward, K2 backward for
    distmult, K3 for transe) against its CPU path (autograd through the
    plain forward), in the [V, B, D] form."""
    V, E, R, B, D = 37, 300, 6, 3, 16
    g = _graph(rng, V, E, R)
    rel_shape = (R, D) if shared_rel else (R, B, D)
    rel = torch.from_numpy(rng.normal(size=rel_shape).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    gc = g.to(cuda_device)
    kid = "K2" if msg == "mul" else "K3"
    grads = []
    for graph, dev in ((g, "cpu"), (gc, cuda_device)):
        r = rel.to(dev).requires_grad_()
        xx = x.to(dev).requires_grad_()
        out = generalized_rspmm(graph.edge_index, graph.edge_type,
                                graph.edge_weight, r, xx, msg=msg,
                                num_nodes=V, csr=graph.csr)
        before = dict(rspmm_bwd_cuda.launches)
        grads.append([t.cpu() for t in torch.autograd.grad(
            out, (r, xx), cot.to(dev))])
        before[kid] += graph is gc
        assert rspmm_bwd_cuda.launches == before
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, **K2_TOL)


def _normal(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device)


@pytest.mark.parametrize("F", [10, 64, 100, 1028])
def test_k1_k2_hub_rows_match_plain(cuda_device, rng, F):
    """K1 (both modes, with the CSR's segments and with each row one
    segment) and K2 on hub rows of 10^3 and 10^4 edges, rows of 256 and
    257, empty rows and an empty relation: F = 10 the scalar path, 100 a
    last slice of 36 features, 1028 several slices. Within the mass
    tolerance of the plain version, rows without edges 0, bitwise equal
    across two calls, one launch counted a call, each K2 half alone equal
    to the whole."""
    V, R = 3000, 7
    csr, w = rspmm_cuda.hub_operands(F, cuda_device, V=V, R=R)
    assert csr.long_rows.tolist() == [0, 1, 5]
    assert csr.src_long_rows.tolist() == [2, 3, 4]
    rel, x, grad = (_normal(rng, s, cuda_device)
                    for s in ((R, F), (V, F), (V, F)))
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    for mode in ("mul_rel", "add_rel"):
        want = rspmm_cuda.rspmm_fwd_plain(*ops, mode)
        mass = timing.k1_mass(ops, mode)
        before = rspmm_cuda.launches
        got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode, segments=csr.segments)
        again = rspmm_cuda.rspmm_fwd_cuda(*ops, mode, segments=csr.segments)
        torch.cuda.synchronize()
        assert rspmm_cuda.launches == before + 2
        assert torch.equal(got, again)
        timing.assert_mass_close(got, want, mass, 1e-5, 1e-5, f"K1 {mode}")
        assert torch.all(got[V - 5:] == 0)
    args = (csr, w, rel, x, grad)
    before = rspmm_bwd_cuda.launches["K2"]
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert rspmm_bwd_cuda.launches["K2"] == before + 2
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
    masses = timing.k2_mass(*args)
    for got, want, mass in zip((dx, dr),
                               rspmm_bwd_cuda.rspmm_bwd_plain(*args), masses):
        timing.assert_mass_close(got, want, mass, 1e-5, 1e-4, "K2")
    assert torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)
    dx3, none = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dr=False)
    none2, dr3 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx3, dx) and torch.equal(dr3, dr)


def test_k1_k2_run_on_every_card(rng):
    """K1 (its rel slice above 48 KB of shared memory), K2, K2h, K8f, K1h
    and K6 on each card in turn, against their plain versions: the raised
    shared-memory limit and the SM count are kept per device and per
    instantiation (csrc/rspmm_staged.cuh::Occupancy)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the per-device launch state")
    V, E, R, F = 600, 6000, 237, 64  # a rel slice of 237 x 64 x 4 = 61 KB
    g = _graph(rng, V, E, R)
    rel, x, grad = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                    for s in ((R, F), (V, F), (V, F)))
    want = rspmm_cuda.rspmm_fwd_plain(
        g.csr.rowptr, g.csr.src, g.csr.etype, g.csr.eid, g.edge_weight, rel,
        x, "mul_rel")
    want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_plain(
        g.csr, g.edge_weight, rel, x, grad)
    want_h = rspmm_bwd_cuda.rspmm_bwd_bf16_plain(g.csr, g.edge_weight, rel,
                                                 x, grad)
    want_rot = rspmm_cuda.rspmm_fwd_plain(
        g.csr.rowptr, g.csr.src, g.csr.etype, g.csr.eid, g.edge_weight, rel,
        x, "rot_rel", 32)
    want_1h = rspmm_cuda.rspmm_fwd_bf16_plain(
        g.csr.rowptr, g.csr.src, g.csr.etype, g.csr.eid, g.edge_weight, rel,
        x, "mul_rel")
    want_6 = rspmm_pna_cuda.pna_fwd_plain("maxmin", g.csr, g.edge_weight,
                                          rel, x, "mul_rel")
    for index in range(torch.cuda.device_count()):
        device = torch.device("cuda", index)
        gd = g.to(device)
        c = gd.csr
        got = rspmm_cuda.rspmm_fwd_cuda(
            c.rowptr, c.src, c.etype, c.eid, gd.edge_weight, rel.to(device),
            x.to(device), "mul_rel", segments=c.segments)
        torch.testing.assert_close(got.cpu(), want, **TOL)
        dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(
            c, gd.edge_weight, rel.to(device), x.to(device), grad.to(device))
        torch.testing.assert_close(dx.cpu(), want_dx, **K2_TOL)
        torch.testing.assert_close(dr.cpu(), want_dr, **K2_TOL)
        got_h = rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(
            c, gd.edge_weight, rel.to(device), x.to(device), grad.to(device))
        for a, b in zip(got_h, want_h):
            torch.testing.assert_close(a.cpu(), b, **K2_TOL)
        got_rot = rspmm_cuda.rotate_fwd_cuda(
            c.rowptr, c.src, c.etype, c.eid, gd.edge_weight, rel.to(device),
            x.to(device), 32, segments=c.segments)
        torch.testing.assert_close(got_rot.cpu(), want_rot, **TOL)
        got_1h = rspmm_cuda.rspmm_fwd_bf16_cuda(
            c.rowptr, c.src, c.etype, c.eid, gd.edge_weight, rel.to(device),
            x.to(device), "mul_rel", segments=c.segments)
        torch.testing.assert_close(got_1h.cpu(), want_1h, **TOL)
        got_6 = rspmm_pna_cuda.pna_fwd_cuda(
            "maxmin", c, gd.edge_weight, rel.to(device), x.to(device),
            "mul_rel")
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got_6, want_6))


@pytest.mark.parametrize("F", [13, 132])
def test_k1_k2_large_r_gather_rel_rows(cuda_device, rng, F):
    """With R = 2,000 relations the rel slice exceeds the shared-memory
    budget (csrc/rspmm_staged.cuh: 256 KB at 32 features, 512 KB at 64)
    and K1 and K2's dx pass gather rel rows; with R = 7 they stage it.
    Both against the plain versions (mass tolerance: a 700-edge hub)."""
    V, E = 3000, 30000
    for R, where in ((2000, "gathered"), (7, "shared")):
        rng_r = np.random.default_rng(R + F)
        tri = np.stack([rng_r.integers(0, V, E), rng_r.integers(0, V, E),
                        rng_r.integers(0, R, E)], 1)
        tri[:700, 1] = 1
        csr = build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R,
                        backward=True).to(cuda_device)
        w = torch.from_numpy(rng_r.uniform(0.5, 1.5, E).astype(
            np.float32)).to(cuda_device)
        rel, x, grad = (_normal(rng_r, s, cuda_device)
                        for s in ((R, F), (V, F), (V, F)))
        plan = rspmm_cuda.k1_plan(R, F, V, csr.seg_ptr.numel() - 1)
        assert plan["rel"] == where, plan
        assert rspmm_bwd_cuda.k2_plan(csr, F)["dx"]["rel"] == where
        ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
        for mode in ("mul_rel", "add_rel"):
            got = rspmm_cuda.rspmm_fwd_cuda(*ops, mode,
                                            segments=csr.segments)
            timing.assert_mass_close(
                got, rspmm_cuda.rspmm_fwd_plain(*ops, mode),
                timing.k1_mass(ops, mode), 1e-5, 1e-5, f"K1 R={R} {mode}")
        args = (csr, w, rel, x, grad)
        for got, want, mass in zip(rspmm_bwd_cuda.rspmm_bwd_cuda(*args),
                                   rspmm_bwd_cuda.rspmm_bwd_plain(*args),
                                   timing.k2_mass(*args)):
            timing.assert_mass_close(got, want, mass, 1e-5, 1e-4,
                                     f"K2 R={R}")


@pytest.mark.parametrize("V,E,R,F", K2_SHAPES + [(2000, 60000, 40, 2048)])
def test_k3_matches_plain(cuda_device, rng, V, E, R, F):
    """K3 (the transe backward) reads neither x nor the relation: x is None,
    the relation gives dr's shape only."""
    g, (rel, _, grad) = _k2_operands(rng, V, E, R, F, cuda_device)
    args = (g.csr, g.edge_weight, rel, None, grad)
    before = rspmm_bwd_cuda.launches["K3"]
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel")
    torch.cuda.synchronize()
    assert rspmm_bwd_cuda.launches["K3"] == before + 1
    want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel")
    _assert_sums_close(dx, want_dx)
    _assert_sums_close(dr, want_dr)
    assert torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)
    dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel")
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)  # deterministic
    none, dr3 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dx=False,
                                              mode="add_rel")
    assert none is None and torch.equal(dr3, dr)


def test_k3_rejects_bad_operands(cuda_device, rng):
    g, (rel, x, grad) = _k2_operands(rng, 37, 300, 6, 8, cuda_device)
    csr, w = g.csr, g.edge_weight
    with pytest.raises(TypeError):  # float64 gradient
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr, w, rel, None, grad.double(),
                                      mode="add_rel")
    with pytest.raises(ValueError):  # relation with the wrong row count
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr, w, rel[:5].contiguous(), None,
                                      grad, mode="add_rel")
    with pytest.raises(ValueError):  # layouts on the CPU
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr.to("cpu"), w, rel, None, grad,
                                      mode="add_rel")
    with pytest.raises(ValueError):  # an unknown mode
        rspmm_bwd_cuda.rspmm_bwd_cuda(csr, w, rel, x, grad, mode="rot_rel")


@pytest.mark.parametrize("F", [10, 64, 1028, 2048])
def test_k3_segments_and_tiles_match_plain(cuda_device, F):
    """K3's dx segments (a 700-edge row written through partial rows) and
    its (destination tile, relation) chunks at ragged widths
    (rspmm_bwd_cuda.transe_ragged_operands: a relation across three tiles,
    one with two chunks in one tile, eid not the identity): bitwise equal
    across two calls, within K3's tolerance of the plain version, rows and
    relations without edges 0, each half alone equal to the whole."""
    args = rspmm_bwd_cuda.transe_ragged_operands(F, seed=F,
                                                 device=cuda_device)
    V, R = args[4].shape[0], args[2].shape[0]
    assert args[0].src_long_rows.tolist() == [3]
    before = rspmm_bwd_cuda.launches["K3"]
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel")
    dx2, dr2 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, mode="add_rel")
    torch.cuda.synchronize()
    assert rspmm_bwd_cuda.launches["K3"] == before + 2
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
    want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_plain(*args, mode="add_rel")
    _assert_sums_close(dx, want_dx)
    _assert_sums_close(dr, want_dr)
    assert torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)
    dx3, none = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dr=False,
                                              mode="add_rel")
    none2, dr3 = rspmm_bwd_cuda.rspmm_bwd_cuda(*args, need_dx=False,
                                               mode="add_rel")
    assert none is None and none2 is None
    assert torch.equal(dx3, dx) and torch.equal(dr3, dr)


# ---------------------------------------------------------------------------
# K6, K7 (the fused PNA forwards) and K6b, K7b (their backward)
# ---------------------------------------------------------------------------

# (V, E, R, F): K2's shapes, and a full-width one (F = 64 queries x 32, the
# classic NBFNet training width) on a graph with ~30 edges per node
PNA_SHAPES = K2_SHAPES + [(2000, 60000, 40, 2048)]
PNA_FWD = [("maxmin", "mul_rel"), ("maxmin", "add_rel"), ("addsq", "mul_rel")]
PNA_BWD = [("argext_pair", "mul_rel"), ("argext_pair", "add_rel"),
           ("moments", "mul_rel")]
K4_FWD = [("max", "mul_rel"), ("max", "add_rel"), ("min", "mul_rel"),
          ("min", "add_rel")]
K5_BWD = [("argext", "mul_rel"), ("argext", "add_rel")]
_FWD_ID = {"maxmin": "K6", "addsq": "K7", "max": "K4", "min": "K4"}
_BWD_ID = {"argext_pair": "K6b", "moments": "K7b", "argext": "K5"}


def _pna_operands(rng, V, E, R, F, device):
    """K6's operands with exact ties: duplicated edges, masked weights and
    post-ReLU x (about half the entries 0); the last 5 rows have no edge and
    the last relation none."""
    g = _graph(rng, V, E, R, empty_rows=5, empty_rels=1)
    tri = np.concatenate([g.edge_list.numpy(), g.edge_list.numpy()[:40]])
    w = np.concatenate([g.edge_weight.numpy(), g.edge_weight.numpy()[:40]])
    g = Graph.from_triplets(tri, V, R, edge_weight=w).prepare_csr(
        backward=True).to(device)
    rel = torch.from_numpy(rng.normal(size=(R, F)).astype(np.float32))
    x = torch.from_numpy(np.maximum(rng.normal(size=(V, F)), 0).astype(
        np.float32))
    return g, rel.to(device), x.to(device)


def _assert_sums_close(got, want):
    atol = max(K2_TOL["atol"], 1e-5 * want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=K2_TOL["rtol"], atol=atol)


@pytest.mark.parametrize("V,E,R,F", PNA_SHAPES)
@pytest.mark.parametrize("kind,mode", PNA_FWD)
def test_k6_k7_match_plain(cuda_device, rng, kind, mode, V, E, R, F):
    _check_fwd(rng, kind, mode, V, E, R, F, cuda_device)


@pytest.mark.parametrize("V,E,R,F", PNA_SHAPES)
@pytest.mark.parametrize("kind,mode", K4_FWD)
def test_k4_matches_plain(cuda_device, rng, kind, mode, V, E, R, F):
    _check_fwd(rng, kind, mode, V, E, R, F, cuda_device)


def _check_fwd(rng, kind, mode, V, E, R, F, cuda_device):
    g, rel, x = _pna_operands(rng, V, E, R, F, cuda_device)
    kid = _FWD_ID[kind]
    before = rspmm_pna_cuda.launches[kid]
    got = rspmm_pna_cuda.pna_fwd_cuda(kind, g.csr, g.edge_weight, rel, x,
                                      mode)
    torch.cuda.synchronize()
    assert rspmm_pna_cuda.launches[kid] == before + 1
    want = rspmm_pna_cuda.pna_fwd_plain(kind, g.csr, g.edge_weight, rel, x,
                                        mode)
    assert len(got) == len(want) == (1 if kid == "K4" else 2)
    for a, b in zip(got, want):
        if kind != "addsq":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, **TOL)
        assert torch.all(a[V - 5:] == 0)  # rows without edges write 0


# (F, R, hub) of K6's hub rows: F = 10 the scalar path, 64 one slice, 1028
# a ragged last slice, 2048 the training width; R = 7 the rel slice in
# shared memory, 2,000 rel rows gathered; hubs of 10^4 and 10^5 edges
K6_HUB = ([(F, 7, 10000) for F in (10, 64, 1028, 2048)]
          + [(F, 2000, 10000) for F in (13, 132)] + [(64, 7, 100000)])


@pytest.mark.parametrize("F,R,hub", K6_HUB)
@pytest.mark.parametrize("mode", ["mul_rel", "add_rel"])
def test_k6_hub_rows_match_plain(cuda_device, mode, F, R, hub):
    """K6 on K1's destination-row segments: hub rows of ``hub`` and 10^3
    in-edges, rows of 256 and 257, 40 duplicated edges, weight-0 edges
    and post-ReLU x (messages tie, zeros of both signs), rows without edges
    and an empty relation. Equal to the plain version under ==, bitwise
    equal across two calls, one launch counted a call, rows without edges
    0; the round trip K6 -> K6b gives the plain gradients within the mass
    tolerance (K6b's gate sees the same ties)."""
    seed = F + R + hub
    csr, w = rspmm_cuda.hub_operands(seed, cuda_device,
                                     E=max(40000, 2 * hub + 20000), R=R,
                                     duplicated=40, hub=hub)
    V = csr.rowptr.numel() - 1
    rng = np.random.default_rng(seed)
    rel = _normal(rng, (R, F), cuda_device)
    x = _normal(rng, (V, F), cuda_device).clamp_(min=0)
    if F % 4 == 0:
        plan = rspmm_pna_cuda.pna_fwd_plan(R, F, V, csr.seg_ptr.numel() - 1,
                                           mode)
        assert plan["rel"] == ("shared" if R == 7 else "gathered"), plan
    before = rspmm_pna_cuda.launches["K6"]
    got = rspmm_pna_cuda.pna_fwd_cuda("maxmin", csr, w, rel, x, mode)
    again = rspmm_pna_cuda.pna_fwd_cuda("maxmin", csr, w, rel, x, mode)
    torch.cuda.synchronize()
    assert rspmm_pna_cuda.launches["K6"] == before + 2
    want = rspmm_pna_cuda.pna_fwd_plain("maxmin", csr, w, rel, x, mode)
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    for a, b, c in zip(got, again, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, c)
        assert torch.all(a[no_dst] == 0)
    g_mx, g_mn = (_normal(rng, (V, F), cuda_device) for _ in range(2))
    planes = (g_mx, got[0], g_mn, got[1])
    dx, dr = rspmm_pna_cuda.pna_bwd_cuda("argext_pair", csr, w, rel, x,
                                         planes, mode)
    want_planes = (g_mx, want[0], g_mn, want[1])
    want_bwd = rspmm_pna_cuda.pna_bwd_plain("argext_pair", csr, w, rel, x,
                                            want_planes, mode)
    masses = timing.pna_mass("argext_pair", csr, w, rel, x, want_planes,
                             mode)
    for a, b, mass in zip((dx, dr), want_bwd, masses):
        atol = max(1e-4, 1e-5 * b.abs().max().item())
        timing.assert_mass_close(a, b, mass, 1e-5, atol,
                                 f"K6 -> K6b {mode} F={F} R={R}")


def _fwd_hub_operands(F, R, hub, device):
    """rspmm_cuda.hub_operands' hub rows of ``hub`` and 10^3 in-edges, rows
    of 256 and 257, 40 duplicated edges and weight-0 edges, rows and a
    relation without edges, with N(0, 1) rel and post-ReLU x at width F
    (messages tie, zeros of both signs); returns (csr, w, rel, x, rng)."""
    seed = F + R + hub
    csr, w = rspmm_cuda.hub_operands(seed, device,
                                     E=max(40000, 2 * hub + 20000), R=R,
                                     duplicated=40, hub=hub)
    V = csr.rowptr.numel() - 1
    rng = np.random.default_rng(seed)
    rel = _normal(rng, (R, F), device)
    x = _normal(rng, (V, F), device).clamp_(min=0)
    return csr, w, rel, x, rng


def _fwd_twice(kind, ops, mode):
    """Two calls of K4, K6 or K7 on ``ops``, bitwise equal, each counted as
    one launch; returns the first call's planes."""
    kid = _FWD_ID[kind]
    before = rspmm_pna_cuda.launches[kid]
    got = rspmm_pna_cuda.pna_fwd_cuda(kind, *ops, mode)
    again = rspmm_pna_cuda.pna_fwd_cuda(kind, *ops, mode)
    torch.cuda.synchronize()
    assert rspmm_pna_cuda.launches[kid] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return got


@pytest.mark.parametrize("F,R,hub", K6_HUB)
@pytest.mark.parametrize("kind,mode", K4_FWD)
def test_k4_hub_rows_match_plain(cuda_device, kind, mode, F, R, hub):
    """K4 (max and min, both modes) on K1's destination-row segments, on
    K6's hub rows: equal to the plain version under ==, bitwise equal
    across two calls, one launch counted a call, rows without edges 0."""
    csr, w, rel, x, _ = _fwd_hub_operands(F, R, hub, cuda_device)
    (got,) = _fwd_twice(kind, (csr, w, rel, x), mode)
    (want,) = rspmm_pna_cuda.pna_fwd_plain(kind, csr, w, rel, x, mode)
    assert torch.equal(got, want)
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    assert torch.all(got[no_dst] == 0)


@pytest.mark.parametrize("F,R,hub", K6_HUB)
def test_k7_hub_rows_match_plain(cuda_device, F, R, hub):
    """K7 on K1's destination-row segments, on K6's hub rows: within 1e-5
    plus 8 fp32 ulps of each entry's absolute mass (timing.py::k7_mass) of
    the plain sums taken in float64 (timing.py::k7_sums64: the fp32 plain
    version's index_add_ adds a hub row in atomics order on the card),
    bitwise equal across two calls, one launch counted a call, rows
    without edges 0."""
    csr, w, rel, x, _ = _fwd_hub_operands(F, R, hub, cuda_device)
    got = _fwd_twice("addsq", (csr, w, rel, x), "mul_rel")
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    for a, want, mass in zip(got, timing.k7_sums64(csr, w, rel, x),
                             timing.k7_mass(csr, w, rel, x)):
        timing.assert_mass_close(a, want, mass, TOL["rtol"], TOL["atol"],
                                 f"K7 F={F} R={R} hub={hub}")
        assert torch.all(a[no_dst] == 0)


@pytest.mark.parametrize("F,R,hub", [(10, 7, 10000), (2048, 7, 10000),
                                     (132, 2000, 10000), (64, 7, 100000)])
@pytest.mark.parametrize("kind,mode", K4_FWD)
def test_k4_k5_hub_rows_round_trip(cuda_device, kind, mode, F, R, hub):
    """K4's planes on hub rows through K5 give the gradients that the plain
    forward's planes give through K5's plain version, within the
    backward's tolerance plus the mass (timing.py::pna_mass): the gate
    m == out[v] fires on the same ties."""
    csr, w, rel, x, rng = _fwd_hub_operands(F, R, hub, cuda_device)
    (got,) = rspmm_pna_cuda.pna_fwd_cuda(kind, csr, w, rel, x, mode)
    (want,) = rspmm_pna_cuda.pna_fwd_plain(kind, csr, w, rel, x, mode)
    g = _normal(rng, x.shape, cuda_device)
    dx, dr = rspmm_pna_cuda.pna_bwd_cuda("argext", csr, w, rel, x, (g, got),
                                         mode)
    args = ("argext", csr, w, rel, x, (g, want), mode)
    for a, b, mass in zip((dx, dr), rspmm_pna_cuda.pna_bwd_plain(*args),
                          timing.pna_mass(*args)):
        atol = max(1e-4, 1e-5 * b.abs().max().item())
        timing.assert_mass_close(a, b, mass, 1e-5, atol,
                                 f"K4 -> K5 {kind} {mode} F={F} R={R}")


@pytest.mark.parametrize("kind,mode", PNA_FWD + K4_FWD)
def test_pna_fwd_plan_every_kind(cuda_device, kind, mode):
    """pna_fwd_plan of K4, K6 and K7: 64-feature slices on the float4
    path, 32 on the scalar path, the rel slice in shared memory at R = 7
    and rel rows gathered at R = 2,000; every kind lays out K1's segments
    alike."""
    for R, where in ((7, "shared"), (2000, "gathered")):
        for F, width in ((2048, 64), (13, 32)):
            plan = rspmm_pna_cuda.pna_fwd_plan(R, F, 14541, 20000, mode,
                                               kind=kind)
            assert plan["rel"] == where, plan
            assert plan["slice_floats"] == width, plan
            assert plan["slices"] == -(-F // width), plan
            assert plan["ctas_per_slice"] >= 1, plan
    with pytest.raises(ValueError):  # K7 is distmult only
        rspmm_pna_cuda.pna_fwd_plan(7, 64, 100, 10, "add_rel", kind="addsq")


@pytest.mark.parametrize("V,E,R,F", PNA_SHAPES)
@pytest.mark.parametrize("kind,mode", PNA_BWD)
def test_k6b_k7b_match_plain(cuda_device, rng, kind, mode, V, E, R, F):
    _check_bwd(rng, kind, mode, V, E, R, F, cuda_device)


@pytest.mark.parametrize("V,E,R,F", PNA_SHAPES)
@pytest.mark.parametrize("kind,mode", K5_BWD)
def test_k5_matches_plain(cuda_device, rng, kind, mode, V, E, R, F):
    _check_bwd(rng, kind, mode, V, E, R, F, cuda_device)


def _check_bwd(rng, kind, mode, V, E, R, F, cuda_device):
    """The argext planes are the card's own K6 / K4 outputs, so the gates
    fire on ties."""
    g, rel, x = _pna_operands(rng, V, E, R, F, cuda_device)
    grads = [torch.from_numpy(rng.normal(size=(V, F)).astype(np.float32)).to(
        cuda_device) for _ in range(2)]
    if kind == "argext_pair":
        mx, mn = rspmm_pna_cuda.pna_fwd_cuda("maxmin", g.csr, g.edge_weight,
                                             rel, x, mode)
        planes = (grads[0], mx, grads[1], mn)
    elif kind == "argext":
        (mx,) = rspmm_pna_cuda.pna_fwd_cuda("max", g.csr, g.edge_weight, rel,
                                            x, mode)
        planes = (grads[0], mx)
    else:
        planes = tuple(grads)
    kid = _BWD_ID[kind]
    args = (kind, g.csr, g.edge_weight, rel, x, planes, mode)
    before = rspmm_pna_cuda.launches[kid]
    dx, dr = rspmm_pna_cuda.pna_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert rspmm_pna_cuda.launches[kid] == before + 1
    want_dx, want_dr = rspmm_pna_cuda.pna_bwd_plain(*args)
    _assert_sums_close(dx, want_dx)
    _assert_sums_close(dr, want_dr)
    assert torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)
    dx2, dr2 = rspmm_pna_cuda.pna_bwd_cuda(*args)  # deterministic
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
    # one half alone
    assert rspmm_pna_cuda.pna_bwd_cuda(*args, need_dr=False)[1] is None
    assert torch.equal(rspmm_pna_cuda.pna_bwd_cuda(*args,
                                                   need_dx=False)[1], dr)


def _pna_hub_args(kind, mode, F, R, seed, device):
    """K6b's or K7b's arguments on rspmm_cuda.hub_operands' hub rows with 40
    duplicated edges: post-ReLU x (exact zeros), the planes K6's own
    outputs (K6b) or N(0, 1) gradients (K7b)."""
    csr, w = rspmm_cuda.hub_operands(seed, device, R=R, duplicated=40)
    V = csr.src_rowptr.numel() - 1
    rng = np.random.default_rng(seed)
    rel = _normal(rng, (R, F), device)
    x = _normal(rng, (V, F), device).clamp_(min=0)
    grads = [_normal(rng, (V, F), device) for _ in range(2)]
    if kind == "argext_pair":
        mx, mn = rspmm_pna_cuda.pna_fwd_cuda("maxmin", csr, w, rel, x, mode)
        planes = (grads[0], mx, grads[1], mn)
    else:
        planes = tuple(grads)
    return (kind, csr, w, rel, x, planes, mode)


@pytest.mark.parametrize("F", [10, 64, 1028, 2048])
@pytest.mark.parametrize("kind,mode", PNA_BWD)
def test_k6b_k7b_hub_rows_match_plain(cuda_device, kind, mode, F):
    """K6b (both modes) and K7b on hub rows of 10^3 and 10^4 edges both
    ways, rows of 256 and 257, duplicated edges, weight-0 edges, empty rows
    and an empty relation, with R = 7 (the dx pass's rel slice in shared
    memory) and R = 2,000 (rel rows gathered): F = 10 the scalar path, 64
    one slice, 1028 a last slice of 4 features, 2048 the training width.
    Within the backward's tolerance plus 8 fp32 ulps of each entry's
    absolute mass (timing.py::pna_mass), rows and relations without edges
    0, bitwise equal across two calls, one launch counted a call, each half
    alone equal to the whole."""
    kid = _BWD_ID[kind]
    for R, where in ((7, "shared"), (2000, "gathered")):
        args = _pna_hub_args(kind, mode, F, R, F + R, cuda_device)
        csr = args[1]
        assert rspmm_pna_cuda.pna_bwd_plan(kind, csr, F, mode)["dx"][
            "rel"] == where
        before = rspmm_pna_cuda.launches[kid]
        dx, dr = rspmm_pna_cuda.pna_bwd_cuda(*args)
        dx2, dr2 = rspmm_pna_cuda.pna_bwd_cuda(*args)
        torch.cuda.synchronize()
        assert rspmm_pna_cuda.launches[kid] == before + 2
        assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
        masses = timing.pna_mass(*args)
        for got, want, mass in zip(
                (dx, dr), rspmm_pna_cuda.pna_bwd_plain(*args), masses):
            atol = max(K2_TOL["atol"], 1e-5 * want.abs().max().item())
            timing.assert_mass_close(got, want, mass, K2_TOL["rtol"], atol,
                                     f"{kid} {mode} R={R}")
        no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
        assert torch.all(dx[no_src] == 0) and torch.all(dr[R - 1] == 0)
        assert torch.equal(rspmm_pna_cuda.pna_bwd_cuda(
            *args, need_dr=False)[0], dx)
        assert torch.equal(rspmm_pna_cuda.pna_bwd_cuda(
            *args, need_dx=False)[1], dr)


def test_k6b_k7b_run_on_every_card():
    """K6b (both modes) and K7b on each card in turn (the dx pass's rel
    slice above 48 KB of shared memory) against their plain versions: the
    raised shared-memory limit and the SM count are kept per device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the per-device launch state")
    F, R = 64, 237  # a rel slice of 237 x 64 x 4 = 61 KB
    for kind, mode in PNA_BWD:
        args = _pna_hub_args(kind, mode, F, R, R, "cpu")
        want = rspmm_pna_cuda.pna_bwd_plain(*args)
        masses = timing.pna_mass(*args)
        _, csr, w, rel, x, planes, _ = args
        for index in range(torch.cuda.device_count()):
            device = torch.device("cuda", index)
            got = rspmm_pna_cuda.pna_bwd_cuda(
                kind, csr.to(device), w.to(device), rel.to(device),
                x.to(device), tuple(p.to(device) for p in planes), mode)
            for a, b, mass in zip(got, want, masses):
                atol = max(K2_TOL["atol"], 1e-5 * b.abs().max().item())
                timing.assert_mass_close(a.cpu(), b, mass, K2_TOL["rtol"],
                                         atol, f"{kind} {mode} {device}")


def _k5_hub_args(agg, mode, F, R, seed, device):
    """K5's arguments on rspmm_cuda.hub_operands' hub rows with 40
    duplicated edges: post-ReLU x (exact zeros), the planes an N(0, 1)
    gradient and K4's own ``agg`` output on the card."""
    csr, w = rspmm_cuda.hub_operands(seed, device, R=R, duplicated=40)
    V = csr.src_rowptr.numel() - 1
    rng = np.random.default_rng(seed)
    rel = _normal(rng, (R, F), device)
    x = _normal(rng, (V, F), device).clamp_(min=0)
    g = _normal(rng, (V, F), device)
    (out,) = rspmm_pna_cuda.pna_fwd_cuda(agg, csr, w, rel, x, mode)
    return ("argext", csr, w, rel, x, (g, out), mode)


def _k8b_hub_args(dim, F, R, seed, device):
    """K8b's arguments on rspmm_cuda.hub_operands' hub rows: N(0, 1) rel, x
    and g, blocks of ``dim``."""
    csr, w = rspmm_cuda.hub_operands(seed, device, R=R, duplicated=40)
    V = csr.src_rowptr.numel() - 1
    rng = np.random.default_rng(seed)
    return (csr, w, *(_normal(rng, s, device)
                      for s in ((R, F), (V, F), (V, F))), dim)


def _k5_k8b_call(kid, args, **kw):
    """K5's or K8b's wrapper on ``args``."""
    if kid == "K5":
        return rspmm_pna_cuda.pna_bwd_cuda(*args, **kw)
    return rspmm_bwd_cuda.rotate_bwd_cuda(*args, **kw)


def _k5_k8b_want(kid, args):
    """(the plain version's (dx, dr), the masses, the atol of each half) of
    K5 or K8b on ``args``: K5 K3's tolerance on both halves, K8b K2's on dx
    and K3's on dr."""
    if kid == "K5":
        plain = rspmm_pna_cuda.pna_bwd_plain(*args)
        return (plain, timing.pna_mass(*args),
                [max(1e-4, 1e-5 * p.abs().max().item()) for p in plain])
    plain = rspmm_bwd_cuda.rotate_bwd_plain(*args)
    return (plain, timing.rotate_mass(*args),
            [1e-4, max(1e-4, 1e-5 * plain[1].abs().max().item())])


# (kernel, K5's extremum or K8b's block width D, K5's mode, F): F = 10 the
# scalar path, 64 one slice, 1028 a last slice of 4 features, 2048 the
# training width; D = 32 a slice two whole blocks, 128 half of one block's
# real and imaginary parts, 6 the scalar path with slices across blocks
# (F = 1026: a last slice of one complex position)
K5_K8B_HUB = ([("K5", agg, mode, F) for agg in ("max", "min")
               for mode in ("mul_rel", "add_rel") for F in (10, 64, 1028, 2048)]
              + [("K8b", D, None, F) for D, F in ((32, 64), (32, 2048),
                                                  (128, 1024), (6, 66),
                                                  (6, 1026))])


@pytest.mark.parametrize("kid,spec,mode,F", K5_K8B_HUB)
def test_k5_k8b_hub_rows_match_plain(cuda_device, kid, spec, mode, F):
    """K5 (of K4's own max or min, both modes) and K8b on hub rows of 10^3
    and 10^4 edges both ways, rows of 256 and 257, duplicated edges (exact
    ties, each taking all of g), weight-0 edges, empty rows and an empty
    relation, with R = 7 (the dx pass's rel slice in shared memory) and
    R = 2,000 (rel rows gathered). Within the tolerance plus 8 fp32 ulps of
    each entry's absolute mass (timing.py::pna_mass, rotate_mass), rows and
    relations without edges 0, bitwise equal across two calls, one launch
    counted a call, each half alone equal to the whole."""
    launches = (rspmm_pna_cuda.launches if kid == "K5"
                else rspmm_bwd_cuda.launches)
    for R, where in ((7, "shared"), (2000, "gathered")):
        seed = F + R
        args = (_k5_hub_args(spec, mode, F, R, seed, cuda_device)
                if kid == "K5"
                else _k8b_hub_args(spec, F, R, seed, cuda_device))
        plain, masses, atols = _k5_k8b_want(kid, args)
        if kid == "K5":
            csr = args[1]
            plan = rspmm_pna_cuda.pna_bwd_plan("argext", csr, F, mode)
        else:
            csr = args[0]
            plan = rspmm_bwd_cuda.k8b_plan(csr, F, spec)
        assert plan["dx"]["rel"] == where, plan
        before = launches[kid]
        dx, dr = _k5_k8b_call(kid, args)
        dx2, dr2 = _k5_k8b_call(kid, args)
        torch.cuda.synchronize()
        assert launches[kid] == before + 2
        assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
        for got, want, mass, atol in zip((dx, dr), plain, masses, atols):
            timing.assert_mass_close(got, want, mass, K2_TOL["rtol"], atol,
                                     f"{kid} {spec} {mode} R={R}")
        no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
        assert torch.all(dx[no_src] == 0) and torch.all(dr[R - 1] == 0)
        assert torch.equal(_k5_k8b_call(kid, args, need_dr=False)[0], dx)
        assert torch.equal(_k5_k8b_call(kid, args, need_dx=False)[1], dr)


def test_k5_k8b_run_on_every_card():
    """K5 (both modes, max and min) and K8b on each card in turn (the dx
    pass's rel slice above 48 KB of shared memory) against their plain
    versions: the raised shared-memory limit and the SM count are kept per
    device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the per-device launch state")
    F, R = 64, 237  # a rel slice of 237 x 64 x 4 = 61 KB
    cases = [("K5", _k5_hub_args(agg, mode, F, R, R, "cpu"))
             for agg, mode in (("max", "mul_rel"), ("min", "add_rel"))]
    cases.append(("K8b", _k8b_hub_args(32, F, R, R, "cpu")))
    for kid, args in cases:
        plain, masses, atols = _k5_k8b_want(kid, args)
        for index in range(torch.cuda.device_count()):
            device = torch.device("cuda", index)
            moved = [a.to(device) if hasattr(a, "to") else a for a in args]
            if kid == "K5":  # the planes
                moved[5] = tuple(p.to(device) for p in args[5])
            got = _k5_k8b_call(kid, moved)
            for a, b, mass, atol in zip(got, plain, masses, atols):
                timing.assert_mass_close(a.cpu(), b, mass, K2_TOL["rtol"],
                                         atol, f"{kid} {device}")


# (kernel, F, K8f's block width D): K2h at F = 10 and 1028 (the scalar
# path), 64 (one slice), 2056 (a ragged last slice) and 4096 (the training
# width); K8f at D = 32 (a slice two whole blocks), 128 (half of one
# block's real and imaginary parts), 6 (the scalar path, slices across
# blocks; F = 1026 a last slice of one complex position); a hub of 10^5
# edges (the third field) for each
K2H_K8F_HUB = ([("K2h", F, None, 10000) for F in (10, 64, 1028, 2056, 4096)]
               + [("K8f", F, D, 10000) for D, F in ((32, 64), (32, 2048),
                                                    (128, 1024), (6, 66),
                                                    (6, 1026))]
               + [("K2h", 64, None, 100000), ("K8f", 64, 32, 100000)])


@pytest.mark.parametrize("kid,F,dim,hub", K2H_K8F_HUB)
def test_k2h_k8f_hub_rows_match_plain(cuda_device, kid, F, dim, hub):
    """K2h (on K2's source-row segments and tile chunks) and K8f (on K1's
    destination-row segments) on hub rows of ``hub`` and 10^3 edges both
    ways, rows of 256 and 257, 40 duplicated edges, weight-0 edges, empty
    rows and an empty relation, with R = 7 (the rel slice in shared
    memory) and R = 2,000 (rel rows gathered on the 16-byte path and K8f's
    scalar one). Within the tolerance plus 8 fp32 ulps of each entry's
    absolute mass (timing.py::k2_mass on the widened values, k8f_mass),
    rows without edges 0, bitwise equal across two calls, one launch
    counted a call; K2h's halves alone equal the whole."""
    for R, where in ((7, "shared"), (2000, "gathered")):
        seed = F + R + hub
        csr, w = rspmm_cuda.hub_operands(seed, cuda_device,
                                         E=max(40000, 2 * hub + 20000), R=R,
                                         duplicated=40, hub=hub)
        V = csr.src_rowptr.numel() - 1
        rng = np.random.default_rng(seed)
        rel, x, g = (_normal(rng, s, cuda_device)
                     for s in ((R, F), (V, F), (V, F)))
        if kid == "K2h":
            args = (csr, w, rel.bfloat16(), x.bfloat16(), g.bfloat16())
            if F % 8 == 0:
                plan = rspmm_bwd_cuda.k2h_plan(csr, F)
                assert plan["dx"]["rel"] == where, plan
            before = rspmm_bwd_cuda.launches["K2h"]
            got = rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(*args)
            again = rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(*args)
            torch.cuda.synchronize()
            assert rspmm_bwd_cuda.launches["K2h"] == before + 2
            want = rspmm_bwd_cuda.rspmm_bwd_bf16_plain(*args)
            masses = timing.k2_mass(csr, w, *(t.float() for t in args[2:]))
            atols = (1e-4, max(1e-4, 1e-5 * want[1].abs().max().item()))
            no_src = (csr.src_rowptr[1:] == csr.src_rowptr[:-1]).nonzero()
            assert torch.all(got[0][no_src] == 0)
            assert torch.all(got[1][R - 1] == 0)
            assert torch.equal(rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(
                *args, need_dr=False)[0], got[0])
            assert torch.equal(rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(
                *args, need_dx=False)[1], got[1])
        else:
            ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
            plan = rspmm_cuda.k8f_plan(R, F, V, csr.seg_ptr.numel() - 1, dim)
            assert plan["rel"] == where, plan
            before = rspmm_cuda.rotate_launches
            got = [rspmm_cuda.rotate_fwd_cuda(*ops, dim,
                                              segments=csr.segments)]
            again = [rspmm_cuda.rotate_fwd_cuda(*ops, dim,
                                                segments=csr.segments)]
            torch.cuda.synchronize()
            assert rspmm_cuda.rotate_launches == before + 2
            want = [rspmm_cuda.rspmm_fwd_plain(*ops, "rot_rel", dim)]
            masses = [timing.k8f_mass(ops, dim)]
            atols = [1e-5 * max(1.0, want[0].abs().max().item())]
            no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
            assert torch.all(got[0][no_dst] == 0)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b, mass, atol in zip(got, want, masses, atols):
            timing.assert_mass_close(a, b, mass, TOL["rtol"], atol,
                                     f"{kid} F={F} R={R} hub={hub}")


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_pna_pairs_card_match_cpu(cuda_device, rng, msg):
    """The fused pairs and the single extrema route CUDA tensors through
    K6/K7, K4 and K6b/K7b, K5 and agree with their CPU path, values and
    gradients, in the [V, B, D] form with a shared relation; max and min
    exactly."""
    V, E, R, B, D = 37, 300, 6, 3, 16
    g, _, _ = _pna_operands(rng, V, E, R, 4, "cpu")
    rel = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    x = torch.from_numpy(np.maximum(rng.normal(size=(V, B, D)), 0).astype(
        np.float32))
    cot = [torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
           for _ in range(2)]
    ops = [lambda *a, **k: generalized_rspmm_maxmin(*a, msg=msg, **k),
           lambda *a, **k: (generalized_rspmm(*a, msg=msg, agg="max", **k),
                            generalized_rspmm(*a, msg=msg, agg="min", **k))]
    if msg == "mul":
        ops.append(generalized_rspmm_addsq)
    gc = g.to(cuda_device)
    for op in ops:
        results = []
        for graph, dev in ((g, "cpu"), (gc, cuda_device)):
            r = rel.to(dev).requires_grad_()
            xx = x.to(dev).requires_grad_()
            a, b = op(graph.edge_index, graph.edge_type, graph.edge_weight, r,
                      xx, num_nodes=V, csr=graph.csr)
            grads = torch.autograd.grad(
                (a * cot[0].to(dev)).sum() + (b * cot[1].to(dev)).sum(),
                (r, xx))
            results.append([t.detach().cpu() for t in (a, b, *grads)])
        (a0, b0, *g0), (a1, b1, *g1) = results
        if op is not generalized_rspmm_addsq:
            assert torch.equal(a0, a1) and torch.equal(b0, b1)
        else:
            torch.testing.assert_close(a1, a0, **TOL)
            torch.testing.assert_close(b1, b0, **TOL)
        for u, v in zip(g1, g0):
            _assert_sums_close(u, v)


def test_pna_kernels_reject_bad_operands(cuda_device, rng):
    g, rel, x = _pna_operands(rng, 37, 300, 6, 8, cuda_device)
    csr, w = g.csr, g.edge_weight
    with pytest.raises(TypeError):  # float64 x
        rspmm_pna_cuda.pna_fwd_cuda("maxmin", csr, w, rel, x.double(),
                                    "mul_rel")
    with pytest.raises(ValueError):  # K7 is distmult only
        rspmm_pna_cuda.pna_fwd_cuda("addsq", csr, w, rel, x, "add_rel")
    with pytest.raises(ValueError):  # a plane of the wrong shape
        rspmm_pna_cuda.pna_bwd_cuda("moments", csr, w, rel, x,
                                    (x, x[:5].contiguous()), "mul_rel")
    with pytest.raises(ValueError):  # layouts on the CPU
        rspmm_pna_cuda.pna_bwd_cuda("moments", csr.to("cpu"), w, rel, x,
                                    (x, x), "mul_rel")
    with pytest.raises(TypeError):  # K4: float64 x
        rspmm_pna_cuda.pna_fwd_cuda("max", csr, w, rel, x.double(),
                                    "add_rel")
    with pytest.raises(ValueError):  # K4: an unknown kind
        rspmm_pna_cuda.pna_fwd_cuda("mean", csr, w, rel, x, "mul_rel")
    with pytest.raises(ValueError):  # K5: two planes, not four
        rspmm_pna_cuda.pna_bwd_cuda("argext", csr, w, rel, x, (x, x, x, x),
                                    "mul_rel")
    with pytest.raises(ValueError):  # K5: a plane of the wrong shape
        rspmm_pna_cuda.pna_bwd_cuda("argext", csr, w, rel, x,
                                    (x, x[:5].contiguous()), "add_rel")


# ---------------------------------------------------------------------------
# K8f and K8b (the rotate forward and backward)
# ---------------------------------------------------------------------------

# (V, E, R, B, D): D/2 = 3 and 5 take the scalar path, 4 and 16 the float4
# path; B·D = 2080 needs two feature tiles; a graph with more rows than
# edges; ~700 edges on each of two relations; the classic training width
ROTATE_SHAPES = [(37, 300, 6, 3, 6), (37, 300, 6, 2, 32), (50, 20, 3, 2, 10),
                 (60, 1400, 3, 4, 8), (37, 300, 6, 65, 32),
                 (2000, 60000, 40, 64, 32)]


@pytest.mark.parametrize("V,E,R,B,D", ROTATE_SHAPES)
def test_k8f_k8b_match_plain(cuda_device, rng, V, E, R, B, D):
    g, (rel, x, grad) = _k2_operands(rng, V, E, R, B * D, cuda_device)
    csr = g.csr
    fwd = (csr.rowptr, csr.src, csr.etype, csr.eid, g.edge_weight, rel, x)
    before = rspmm_cuda.rotate_launches
    out = rspmm_cuda.rotate_fwd_cuda(*fwd, D, segments=csr.segments)
    torch.cuda.synchronize()
    assert rspmm_cuda.rotate_launches == before + 1
    assert torch.equal(rspmm_cuda.rotate_fwd_cuda(*fwd, D,
                                                  segments=csr.segments), out)
    want = rspmm_cuda.rspmm_fwd_plain(*fwd, "rot_rel", D)
    torch.testing.assert_close(
        out, want, rtol=1e-5, atol=1e-5 * max(1.0, want.abs().max().item()))
    assert torch.all(out[V - 5:] == 0)  # rows with no edges write 0
    bwd = (csr, g.edge_weight, rel, x, grad, D)
    before = rspmm_bwd_cuda.launches["K8b"]
    dx, dr = rspmm_bwd_cuda.rotate_bwd_cuda(*bwd)
    torch.cuda.synchronize()
    assert rspmm_bwd_cuda.launches["K8b"] == before + 1
    want_dx, want_dr = rspmm_bwd_cuda.rotate_bwd_plain(*bwd)
    torch.testing.assert_close(dx, want_dx, **K2_TOL)
    _assert_sums_close(dr, want_dr)
    assert torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)
    dx2, dr2 = rspmm_bwd_cuda.rotate_bwd_cuda(*bwd)  # deterministic
    assert torch.equal(dx, dx2) and torch.equal(dr, dr2)
    # one half alone
    assert rspmm_bwd_cuda.rotate_bwd_cuda(*bwd, need_dr=False)[1] is None
    assert torch.equal(rspmm_bwd_cuda.rotate_bwd_cuda(*bwd,
                                                      need_dx=False)[1], dr)


@pytest.mark.parametrize("shared_rel", [False, True])
def test_rotate_op_card_matches_cpu(cuda_device, rng, shared_rel):
    """The rotate sum routes CUDA tensors through K8f and K8b and agrees
    with its CPU path (autograd through the plain forward), values and
    gradients; a shared relation's gradient sums over the batch."""
    V, E, R, B, D = 37, 300, 6, 3, 16
    g = _graph(rng, V, E, R)
    rel_shape = (R, D) if shared_rel else (R, B, D)
    rel = torch.from_numpy(rng.normal(size=rel_shape).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    gc = g.to(cuda_device)
    results = []
    for graph, dev in ((g, "cpu"), (gc, cuda_device)):
        r = rel.to(dev).requires_grad_()
        xx = x.to(dev).requires_grad_()
        before = (rspmm_cuda.rotate_launches, rspmm_bwd_cuda.launches["K8b"])
        out = generalized_rspmm(graph.edge_index, graph.edge_type,
                                graph.edge_weight, r, xx, msg="rotate",
                                num_nodes=V, csr=graph.csr)
        grads = torch.autograd.grad(out, (r, xx), cot.to(dev))
        on_card = int(graph is gc)
        assert (rspmm_cuda.rotate_launches,
                rspmm_bwd_cuda.launches["K8b"]) == (before[0] + on_card,
                                                    before[1] + on_card)
        results.append([t.detach().cpu() for t in (out, *grads)])
    (o0, *g0), (o1, *g1) = results
    torch.testing.assert_close(o1, o0, **TOL)
    for u, v in zip(g1, g0):
        _assert_sums_close(u, v)


def test_rotate_kernels_reject_bad_operands(cuda_device, rng):
    g, (rel, x, grad) = _k2_operands(rng, 37, 300, 6, 12, cuda_device)
    csr, w = g.csr, g.edge_weight
    fwd = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel)
    with pytest.raises(ValueError):  # a block width that does not divide F
        rspmm_cuda.rotate_fwd_cuda(*fwd, x, 8, segments=csr.segments)
    with pytest.raises(TypeError):  # no segments
        rspmm_cuda.rotate_fwd_cuda(*fwd, x, 6, segments=None)
    with pytest.raises(ValueError):  # an odd block width
        rspmm_bwd_cuda.rotate_bwd_cuda(csr, w, rel, x, grad, 3)
    with pytest.raises(TypeError):  # float64 x
        rspmm_cuda.rotate_fwd_cuda(*fwd, x.double(), 6,
                                   segments=csr.segments)
    with pytest.raises(ValueError):  # layouts on the CPU
        rspmm_bwd_cuda.rotate_bwd_cuda(csr.to("cpu"), w, rel, x, grad, 6)


# (V, E, R, F) for the bf16 kernels: F = 10, 12 and 1028 are not multiples
# of 8 and take the scalar path, 64 and 2056 the 16-byte path (2056 in two
# feature tiles), and ~700 edges on each of two relations (three chunks)
BF16_SHAPES = [(37, 300, 6, 10), (37, 300, 6, 64), (37, 300, 6, 1028),
               (37, 300, 6, 2056), (50, 20, 3, 12), (60, 1400, 3, 64)]


@pytest.mark.parametrize("V,E,R,F", BF16_SHAPES)
def test_k1h_k2h_match_plain(cuda_device, rng, V, E, R, F):
    g, (rel, x, grad) = _k2_operands(rng, V, E, R, F, cuda_device)
    csr, w = g.csr, g.edge_weight
    for mode in ("mul_rel", "add_rel"):
        args = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x, mode)
        before = rspmm_cuda.bf16_launches
        got = rspmm_cuda.rspmm_fwd_bf16_cuda(*args, segments=csr.segments)
        torch.cuda.synchronize()
        assert rspmm_cuda.bf16_launches == before + 1
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, rspmm_cuda.rspmm_fwd_bf16_plain(*args),
                                   **TOL)
        assert torch.all(got[V - 5:] == 0)
    before = rspmm_bwd_cuda.launches["K2h"]
    dx, dr = rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(csr, w, rel, x, grad)
    torch.cuda.synchronize()
    assert rspmm_bwd_cuda.launches["K2h"] == before + 1
    want_dx, want_dr = rspmm_bwd_cuda.rspmm_bwd_bf16_plain(csr, w, rel, x,
                                                           grad)
    torch.testing.assert_close(dx, want_dx, **K2_TOL)
    torch.testing.assert_close(dr, want_dr, **K2_TOL)
    assert torch.all(dx[V - 5:] == 0) and torch.all(dr[R - 1] == 0)
    again = rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(csr, w, rel, x, grad)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dr)


# (F, R, hub) of K1h's hub rows: F = 10 and 1028 the scalar path, 64 one
# slice, 2056 a ragged last slice, 4096 the training width; R = 7 the rel
# slice in shared memory, 2,000 rel rows gathered; hubs of 10^4 and 10^5
K1H_HUB = ([(F, 7, 10000) for F in (10, 64, 1028, 2056, 4096)]
           + [(F, 2000, 10000) for F in (16, 132)] + [(64, 7, 100000)])


@pytest.mark.parametrize("F,R,hub", K1H_HUB)
@pytest.mark.parametrize("mode", ["mul_rel", "add_rel"])
def test_k1h_hub_rows_match_plain(cuda_device, mode, F, R, hub):
    """K1h on K1's destination-row segments: hub rows of ``hub`` and 10^3
    in-edges, rows of 256 and 257, 40 duplicated edges, weight-0 edges,
    rows without edges and an empty relation. Within K1h's tolerance plus 8
    fp32 ulps of each entry's absolute mass (timing.py::k1_mass on the
    widened values) of the plain version's sums in float64
    (timing.py::k1h_sums64: the fp32 plain version's own rounding on a row
    of 10^5 edges reaches the tolerance), bitwise equal across two calls,
    one launch counted a call, rows without edges 0."""
    seed = F + R + hub
    csr, w = rspmm_cuda.hub_operands(seed, cuda_device,
                                     E=max(40000, 2 * hub + 20000), R=R,
                                     duplicated=40, hub=hub)
    V = csr.rowptr.numel() - 1
    rng = np.random.default_rng(seed)
    rel = _normal(rng, (R, F), cuda_device).bfloat16()
    x = _normal(rng, (V, F), cuda_device).bfloat16()
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w, rel, x)
    if F % 8 == 0:
        plan = rspmm_cuda.k1h_plan(R, F, V, csr.seg_ptr.numel() - 1, mode)
        assert plan["rel"] == ("shared" if R == 7 else "gathered"), plan
    before = rspmm_cuda.bf16_launches
    got = rspmm_cuda.rspmm_fwd_bf16_cuda(*ops, mode, segments=csr.segments)
    again = rspmm_cuda.rspmm_fwd_bf16_cuda(*ops, mode, segments=csr.segments)
    torch.cuda.synchronize()
    assert rspmm_cuda.bf16_launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = timing.k1h_sums64(ops, mode)
    mass = timing.k1_mass((*ops[:5], rel.float(), x.float()), mode)
    timing.assert_mass_close(got, want, mass, TOL["rtol"], TOL["atol"],
                             f"K1h {mode} F={F} R={R} hub={hub}")
    no_dst = (csr.rowptr[1:] == csr.rowptr[:-1]).nonzero()
    assert torch.all(got[no_dst] == 0)


def test_k1h_rounds_the_product_to_bf16(cuda_device):
    """(1 + 2^-7)² has no bf16 value: K1h sums its rounding, 1 + 2^-6."""
    a = 1 + 2.0 ** -7
    g = Graph.from_triplets(np.array([[1, 0, 0], [2, 0, 0]]), 3, 1)
    csr = g.prepare_csr().csr.to(cuda_device)
    for F in (8, 10):  # the 16-byte and the scalar path
        rel = torch.full((1, F), a, device=cuda_device)
        x = torch.full((3, F), a, device=cuda_device)
        out = rspmm_cuda.rspmm_fwd_bf16_cuda(
            csr.rowptr, csr.src, csr.etype, csr.eid,
            torch.ones(2, device=cuda_device), rel, x, "mul_rel",
            segments=csr.segments)
        assert torch.all(out[0] == 2 * (1 + 2.0 ** -6))


@pytest.mark.parametrize("msg", ["mul", "add"])
@pytest.mark.parametrize("shared_rel", [False, True])
def test_bf16_op_gradient_card_matches_cpu(cuda_device, rng, shared_rel, msg):
    """Autograd through the op with compute_dtype="bfloat16" on the card
    (K1h forward; K2h backward for distmult, K3 for transe) against the CPU
    (their plain versions), in the [V, B, D] form."""
    V, E, R, B, D = 37, 300, 6, 3, 16
    g = _graph(rng, V, E, R)
    rel_shape = (R, D) if shared_rel else (R, B, D)
    rel = torch.from_numpy(rng.normal(size=rel_shape).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    gc = g.to(cuda_device)
    kid = "K2h" if msg == "mul" else "K3"
    results = []
    for graph, dev in ((g, "cpu"), (gc, cuda_device)):
        r = rel.to(dev).requires_grad_()
        xx = x.to(dev).requires_grad_()
        fwd_before = rspmm_cuda.bf16_launches
        out = generalized_rspmm(graph.edge_index, graph.edge_type,
                                graph.edge_weight, r, xx, msg=msg,
                                num_nodes=V, csr=graph.csr,
                                compute_dtype="bfloat16")
        assert rspmm_cuda.bf16_launches == fwd_before + (graph is gc)
        before = dict(rspmm_bwd_cuda.launches)
        results.append([t.detach().cpu() for t in (out, *torch.autograd.grad(
            out, (r, xx), cot.to(dev)))])
        before[kid] += graph is gc
        assert rspmm_bwd_cuda.launches == before
    torch.testing.assert_close(results[1][0], results[0][0], **TOL)
    for a, b in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(b, a, **K2_TOL)


def test_bf16_kernels_reject_bad_operands(cuda_device, rng):
    g, (rel, x, grad) = _k2_operands(rng, 37, 300, 6, 8, cuda_device)
    csr, w = g.csr, g.edge_weight
    with pytest.raises(ValueError):  # relation with the wrong row count
        rspmm_bwd_cuda.rspmm_bwd_bf16_cuda(csr, w, rel[:5], x, grad)
    ops = (csr.rowptr, csr.src, csr.etype, csr.eid, w)
    with pytest.raises(ValueError):  # operand on the CPU
        rspmm_cuda.rspmm_fwd_bf16_cuda(*ops, rel.cpu(), x, "mul_rel",
                                       segments=csr.segments)
    with pytest.raises(ValueError, match="mode"):
        rspmm_cuda.rspmm_fwd_bf16_cuda(*ops, rel, x, "rot_rel",
                                       segments=csr.segments)
    with pytest.raises(TypeError, match="RowSegments"):  # no segments
        rspmm_cuda.rspmm_fwd_bf16_cuda(*ops, rel, x, "mul_rel",
                                       segments=None)


# (n shards, rows per block, features): 7 fp32 rows of 5 features are 140
# bytes, not a multiple of 16, so the blocks after the first are misaligned
# (the byte path) and the first one has a byte tail; 1 x 3 bf16 features are
# 6 bytes. 8 x 1,024 fp32 rows are 32 KB, 2,048 units, a whole number of
# 256-thread CTAs (n = 1: one block, copied to its own slot), and 9 x
# 1,000 fp32 rows 36,000 bytes, 2,250 units, a last CTA partly idle
K9_SHAPES = [(2, 7, 5), (3, 7, 5), (4, 7, 5), (3, 1, 3), (4, 64, 256),
             (3, 3636, 1024), (1, 8, 1024), (4, 8, 1024), (3, 9, 1000)]


@pytest.mark.parametrize("n,vb,F", K9_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_matches_plain_bitwise(cuda_device, n, vb, F, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n * vb + F)
    x = torch.randn((n * vb, F), generator=gen, device=cuda_device).to(dtype)
    blocks, devices = list(x.chunk(n)), [cuda_device] * n
    before = rdma.launches
    got = rdma.shift_blocks(blocks, devices)
    assert rdma.launches == before + 1
    want = rdma.shift_blocks_plain(blocks, devices)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    assert torch.equal(torch.cat(got), torch.cat(want))
    # block 0 moved to shard 1 (to itself when there is one shard)
    assert torch.equal(got[1 % n], x[:vb])


@pytest.mark.parametrize("rows", [5, 4097])
def test_k9_takes_separate_blocks(cuda_device, rows):
    """Per-shard source blocks, each its own allocation (the multi-card
    layout): every source 16-byte aligned, the destinations rows of one
    buffer (5 x 3 fp32 rows: 60 bytes, so the second and third are
    misaligned; 4,097 x 3: 3,072 units, twelve CTAs)."""
    src = [torch.arange(rows * 3, dtype=torch.float32,
                        device=cuda_device).view(rows, 3) + 1e5 * s
           for s in range(3)]
    dst = rdma.shift_blocks(src, [cuda_device] * 3)
    torch.cuda.synchronize()
    for s in range(3):
        assert torch.equal(dst[(s + 1) % 3], src[s])


def test_k9_rejects_bad_operands(cuda_device):
    x = torch.zeros((8, 4), device=cuda_device)
    blocks = list(x.chunk(4))
    devices = [cuda_device] * 4
    with pytest.raises(ValueError, match="a block on cpu"):
        rdma.shift_blocks(blocks[:3] + [blocks[3].cpu()], devices)
    with pytest.raises(ValueError, match="4 blocks and 3 devices"):
        rdma.shift_blocks(blocks, devices[:3])
    # blocks on another card: K9 pushes across cards, or raises only where
    # the host offers no peer access between them
    if torch.cuda.device_count() >= 2:
        other = torch.device("cuda", 1)
        cards = [x.device] * 2 + [other] * 2
        split = [b.to(d) for b, d in zip(blocks, cards)]
        split = [b + s for s, b in enumerate(split)]
        if torch.cuda.can_device_access_peer(x.device, other):
            got = rdma.shift_blocks(split, cards)
            torch.cuda.synchronize()
            assert all(got[(s + 1) % 4].device == cards[(s + 1) % 4]
                       and torch.equal(got[(s + 1) % 4].cpu(),
                                       split[s].cpu()) for s in range(4))
        else:
            with pytest.raises(RuntimeError, match="peer access"):
                rdma.shift_blocks(split, cards)
    with pytest.raises(ValueError, match="one dtype and shape"):
        rdma.shift_blocks(blocks[:3] + [torch.zeros(2, 5,
                                                    device=cuda_device)],
                          devices)
    with pytest.raises(ValueError, match="contiguous"):
        rdma.shift_blocks([b.t() for b in blocks], devices)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_diagonal", [False, True])
def test_ring_rspmm_card_matches_cpu(cuda_device, rng, n, compute_dtype,
                                     block_diagonal):
    """The ring with per-bucket CSRs and the rdma exchange on the card (K1
    or K1h per non-empty bucket forward, K2 or K2h backward, K9 between
    steps) against the same op on the CPU (their plain versions), with
    the launches counted; block_diagonal keeps every edge inside its
    block, so only the n diagonal buckets have edges."""
    V, E, R, B, D = 43, 300, 5, 3, 8
    g = _graph(rng, V, E, R)
    if block_diagonal:
        vb = -(-V // n)
        tri = g.edge_list.numpy().copy()
        tri[:, 1] = np.minimum((tri[:, 0] // vb) * vb + tri[:, 1] % vb, V - 1)
        g = Graph.from_triplets(tri, V, R, edge_weight=g.edge_weight.numpy())
    ei, et = g.edge_index.numpy(), g.edge_type.numpy()
    ri = build_ring_rspmm_inputs(ei, et, V, n, num_relations=R, pallas=True)
    rel = torch.from_numpy(rng.normal(size=(R, B, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    bf16 = compute_dtype == "bfloat16"
    fwd_id, bwd_id = ("K1h", "K2h") if bf16 else ("K1", "K2")
    results = []
    for dev in ("cpu", cuda_device):
        r = rel.to(dev).requires_grad_()
        xx = x.to(dev).requires_grad_()
        counts = (rspmm_cuda.launches, rspmm_cuda.bf16_launches,
                  rdma.launches, rspmm_bwd_cuda.launches[bwd_id])
        out = ring_rspmm(g.edge_weight.to(dev), ri.to(dev), r, xx, msg="mul",
                         compute_dtype=compute_dtype, exchange="rdma")
        grads = torch.autograd.grad(out, (r, xx), cot.to(dev))
        results.append([t.detach().cpu() for t in (out, *grads)])
        if dev == "cpu":
            continue
        k1 = (rspmm_cuda.bf16_launches - counts[1] if bf16
              else rspmm_cuda.launches - counts[0])
        assert k1 == ri.nonempty_buckets, fwd_id
        assert not block_diagonal or ri.nonempty_buckets == n
        assert (rspmm_bwd_cuda.launches[bwd_id] - counts[3]
                == ri.nonempty_buckets)
        assert rdma.launches - counts[2] == 2 * (n - 1)
    torch.testing.assert_close(results[1][0], results[0][0], **TOL)
    for a, b in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(b, a, **K2_TOL)


@pytest.mark.parametrize("msg,compute_dtype", [
    ("mul", "float32"), ("mul", "bfloat16"), ("add", "float32")])
@pytest.mark.parametrize("balance", [False, True])
def test_partitioned_rspmm_card_matches_cpu(cuda_device, rng, msg,
                                            compute_dtype, balance):
    """The partitioned op on the card (K1 or K1h a shard forward; K2, K2h
    or K3 a shard backward, in the shard's two row spaces: x of v_block
    rows, the gradient of V rows) against the same op on the CPU (their
    plain versions), with one launch of each a shard with edges."""
    V, E, R, B, D, n = 43, 300, 5, 3, 8, 4
    g = _graph(rng, V, E, R)
    lay = build_partitioned_rspmm_inputs(g.edge_index.numpy(),
                                         g.edge_type.numpy(), V, R, n,
                                         balance=balance)
    rel = torch.from_numpy(rng.normal(size=(R, B, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    bf16 = compute_dtype == "bfloat16"
    bwd_id = "K3" if msg == "add" else ("K2h" if bf16 else "K2")
    results = []
    for dev in ("cpu", cuda_device):
        r, xx = rel.to(dev).requires_grad_(), x.to(dev).requires_grad_()
        counts = (rspmm_cuda.bf16_launches if bf16 else rspmm_cuda.launches,
                  rspmm_bwd_cuda.launches[bwd_id])
        out = partitioned_rspmm(g.edge_weight.to(dev), lay.to(dev), r, xx,
                                msg=msg, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(out, (r, xx), cot.to(dev))
        results.append([t.detach().cpu() for t in (out, *grads)])
        if dev == "cpu":
            continue
        fwd = rspmm_cuda.bf16_launches if bf16 else rspmm_cuda.launches
        assert fwd - counts[0] == n and (
            rspmm_bwd_cuda.launches[bwd_id] - counts[1] == n)
    torch.testing.assert_close(results[1][0], results[0][0], **TOL)
    for a, b in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(b, a, **K2_TOL)


@pytest.mark.parametrize("schedule", ["max", "min", "maxmin", "addsq"])
def test_ring_schedules_card_match_cpu(cuda_device, rng, schedule):
    """The ring's extremum, pair and moments schedules on the card (plain
    PyTorch steps, K9 between them: one shift of the packed planes a
    step each way) against the same op on the CPU: extrema equal, their
    gradients and the moments within K2's tolerance."""
    V, E, R, B, D, n = 43, 300, 5, 3, 8, 4
    g = _graph(rng, V, E, R)
    ri = build_ring_rspmm_inputs(g.edge_index.numpy(), g.edge_type.numpy(),
                                 V, n, num_relations=R, balance=True,
                                 permuted_io=False)
    fn, kw = {"max": (ring_rspmm, dict(msg="mul", agg="max")),
              "min": (ring_rspmm, dict(msg="add", agg="min")),
              "maxmin": (ring_rspmm_maxmin, dict(msg="mul")),
              "addsq": (ring_rspmm_addsq, {})}[schedule]
    rel = torch.from_numpy(rng.normal(size=(R, B, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cots = [torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
            for _ in range(2)]
    results = []
    for dev in ("cpu", cuda_device):
        r, xx = rel.to(dev).requires_grad_(), x.to(dev).requires_grad_()
        k9 = rdma.launches
        out = fn(g.edge_weight.to(dev), ri.to(dev), r, xx,
                 exchange="rdma", **kw)
        out = out if isinstance(out, tuple) else (out,)
        loss = sum((o * c.to(dev)).sum() for o, c in zip(out, cots))
        grads = torch.autograd.grad(loss, (r, xx))
        results.append([t.detach().cpu() for t in (*out, *grads)])
        if dev != "cpu":
            assert rdma.launches - k9 == 2 * (n - 1)
    outs = len(results[0]) - 2
    for a, b in zip(results[0][:outs], results[1][:outs]):
        if schedule == "addsq":
            torch.testing.assert_close(b, a, **TOL)
        else:
            assert torch.equal(a, b)
    for a, b in zip(results[0][outs:], results[1][outs:]):
        torch.testing.assert_close(b, a, **K2_TOL)


def test_ring_rspmm_hub_buckets_card_matches_cpu(cuda_device, rng):
    """The ring's per-bucket CSRs carry their own segments: with a
    1,200-edge destination hub and a 1,200-edge source hub over 4 shards,
    buckets hold rows of more than 256 edges (long rows), and the ring on
    the card (K1 and K2 per bucket, K9 between steps) agrees with the CPU
    run (rtol 1e-5 besides K1's and K2's absolute tolerances: the hubs'
    sums reach tens)."""
    V, E, R, B, D, n = 400, 6000, 5, 3, 8, 4
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1)
    tri[:1200, 1] = 7
    tri[1200:2400, 0] = 11
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    g = Graph.from_triplets(tri, V, R, edge_weight=w)
    ri = build_ring_rspmm_inputs(tri[:, :2], tri[:, 2], V, n,
                                 num_relations=R, pallas=True)
    assert any(c.long_rows.numel() for row in ri.csr for c in row)
    assert any(c.src_long_rows.numel() for row in ri.csr for c in row)
    rel = torch.from_numpy(rng.normal(size=(R, B, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(V, B, D)).astype(np.float32))
    results = []
    for dev in ("cpu", cuda_device):
        r = rel.to(dev).requires_grad_()
        xx = x.to(dev).requires_grad_()
        out = ring_rspmm(g.edge_weight.to(dev), ri.to(dev), r, xx, msg="mul",
                         exchange="rdma")
        grads = torch.autograd.grad(out, (r, xx), cot.to(dev))
        results.append([t.detach().cpu() for t in (out, *grads)])
    torch.testing.assert_close(results[1][0], results[0][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("F", [10, 64, 1028])
@pytest.mark.parametrize("variant", ladder.VARIANTS)
def test_ladder_variants_match_plain(cuda_device, variant, F):
    """Each ladder variant held to check_ragged at ragged shapes (F = 10
    the scalar path, 1028 several feature tiles): its plain version, rows
    without edges 0, full equal to K1 on rows of one segment and the
    bitwise variants to full;
    one launch counted per call."""
    ops = ladder.ragged_operands(F, seed=F, device=cuda_device)
    before = ladder.launches[variant]
    ladder.ladder_cuda(variant, ops)
    assert ladder.launches[variant] == before + 1
    ladder.check_ragged(variant, ops)


def test_ladder_rejects_bad_operands(cuda_device):
    ops = ladder.ragged_operands(16, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        ladder.ladder_cuda("full", dataclasses.replace(
            ops, relation=ops.relation.cpu()))
    with pytest.raises(TypeError, match="must be torch.float32"):
        ladder.ladder_cuda("full", dataclasses.replace(ops, x=ops.x.double()))
    with pytest.raises(ValueError, match="out must be"):
        ladder.ladder_cuda("nowrite", ops, out=torch.empty(
            3, 16, device=cuda_device), write=False)
    with pytest.raises(ValueError, match="does not fit"):
        ladder.ladder_cuda("packed", dataclasses.replace(ops, packed=None))


def test_ladder_tools_on_the_card(cuda_device, tmp_path):
    """Both tools at a small size on the card: every variant timed and
    held against its plain version."""
    res = kernel_floor.run(variants="all", edges=16384, te=8192, tv=64,
                           vrows=512, feat=512, relations=32, device="cuda")
    assert all(r["ms"] > 0 for r in res["variants"].values())
    out = tmp_path / "ladder.json"
    data = blocked_ladder.run(variants="all", out=str(out), nodes=2000,
                              edges=40000, relations=24, feat=256,
                              device="cuda")
    assert data["device"]["name"] == torch.cuda.get_device_name(0)
    assert set(data["variants"]) == set(ladder.VARIANTS)


# ---------------------------------------------------------------------------
# the slices' paths on the card: inductive evaluation, multi-graph steps and
# a reference .pth load, each against the port's CPU run (ULTRA's limits:
# scores 1e-4, loss 1e-5 relative, gradients 1e-4 norm-wise)
# ---------------------------------------------------------------------------


def _smoke_task_cfg():
    """smoke.yaml's task section (2x8 towers, distmult, sum)."""
    from ultra_torchdrug_tpu_torch.utils.config import load_config

    root = Path(__file__).resolve().parent.parent
    return load_config(str(root / "config/synthetic/smoke.yaml"),
                       context={"outdir": "unused"})[0]["task"]


def _k1_count():
    return rspmm_cuda.launches


def test_inductive_eval_card_matches_cpu(cuda_device):
    """InductiveKGTask on SynthInductiveKG (2x8 towers): the test split's
    scores over the inference graph on the card (K1) against the CPU, and
    the card's metrics, hits@10_50 among them, finite."""
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_inductive
    from ultra_torchdrug_tpu_torch.engine.build import build_task

    cfg = dict(_smoke_task_cfg(),
               **{"class": "InductiveKnowledgeGraphCompletionAdapted"})
    dataset = synthetic_inductive()
    weights = build_task(cfg, dataset, device="cpu").init_params(
        seed=0).state_dict()
    scores = []
    for dev in ("cpu", cuda_device):
        task = build_task(cfg, dataset, device=dev)
        model = task.init_params(seed=0)
        model.load_state_dict(weights)  # a generator draws per device
        graph, rel = task.graphs["test"], task.rel_graphs["test"]
        und, rel = task._prepare_graphs(graph, rel)
        b = torch.from_numpy(dataset.test[:8].astype(np.int64)).to(dev)
        before = _k1_count()
        with torch.inference_mode():
            scores.append([s.cpu() for s in task._eval_scores(
                model, graph, rel, b[:, 0], b[:, 1], b[:, 2], und)])
        metrics = task.evaluate(model, "test", 16)
    assert _k1_count() > before
    assert "hits@10_50" in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    for a, b in zip(*scores):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_multigraph_step_card_matches_cpu(cuda_device):
    """One loss step on each SynthJoint graph (three graphs) on the card
    (K1, K2) against the CPU: the same weights, batch and injected
    negatives."""
    from ultra_torchdrug_tpu_torch.data.datasets import (
        JointDataset,
        synthetic_transductive,
    )
    from ultra_torchdrug_tpu_torch.engine.build import build_task

    cfg = dict(_smoke_task_cfg(), **{"class": "MultiGraphPreTraining"})
    dataset = JointDataset("SynthJoint", [
        synthetic_transductive(f"synth{i}", 40 + 5 * i, 300, 5, seed=i)
        for i in range(3)])
    tasks = [build_task(cfg, dataset, device=dev)
             for dev in ("cpu", cuda_device)]
    models = [t.init_params(seed=0) for t in tasks]
    models[1].load_state_dict(models[0].state_dict())
    for gid in range(3):
        batch = tasks[0].train_triples[gid][:4]
        neg = torch.from_numpy(np.random.default_rng(gid).integers(
            0, tasks[0].fact_graphs[gid].num_nodes, (4, 8)))
        results = []
        for task, model in zip(tasks, models):
            model.zero_grad(set_to_none=True)
            loss, _ = task.loss_step(model, None, batch, gid,
                                     neg=neg.to(task.device))
            loss.backward()
            results.append((loss.item(), [p.grad.cpu()
                                          for p in model.parameters()]))
        (loss_cpu, g_cpu), (loss_dev, g_dev) = results
        assert abs(loss_dev - loss_cpu) <= 1e-5 * max(1.0, abs(loss_cpu))
        for a, b in zip(g_dev, g_cpu):
            assert ((a - b).norm() / b.norm().clamp(min=1e-12)) <= 1e-4


def test_pth_load_on_the_card(cuda_device, tmp_path):
    """A .pth exported from a CPU model loads through Engine.load into an
    engine on the card: every weight equals the file's, on the card, and
    the loaded model scores as the CPU model does."""
    from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
    from ultra_torchdrug_tpu_torch.engine.build import build_task
    from ultra_torchdrug_tpu_torch.engine.engine import Engine
    from ultra_torchdrug_tpu_torch.utils.checkpoint import (
        export_torch_checkpoint,
    )

    cfg = _smoke_task_cfg()
    dataset = synthetic_transductive("SynthKG", 40, 300, 5, seed=0)
    cpu_task = build_task(cfg, dataset, device="cpu")
    cpu_model = cpu_task.init_params(seed=5)
    path = str(tmp_path / "model.pth")
    export_torch_checkpoint(path, cpu_model)
    from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

    engine = Engine(build_task(cfg, dataset, device=cuda_device),
                    batch_size=16, seed=1, work_dir=str(tmp_path),
                    logger=get_root_logger(None))
    engine.load(path)
    for k, v in engine.model.state_dict().items():
        assert v.device.type == "cuda"
        assert torch.equal(v.cpu(), cpu_model.state_dict()[k]), k
    scores = []
    for task, model in ((cpu_task, cpu_model), (engine.task, engine.model)):
        und, rel = task._prepare_graphs(task.fact_graph, task.rel_graph)
        b = torch.from_numpy(dataset.test[:4].astype(np.int64)).to(
            task.device)
        with torch.inference_mode():
            scores.append([s.cpu() for s in task._eval_scores(
                model, task.fact_graph, rel, b[:, 0], b[:, 1], b[:, 2],
                und)])
    for a, b in zip(*scores):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)

"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips where there is no
card; the decision is taken inside the ``cuda_device`` fixture, at run time.

Run on a machine with the card:
    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerance atol = rtol = 1e-5 for K1: the kernel sums each row's edges in CSR
order, the plain version with index_add_ in another order. K2 uses rtol 1e-5,
atol 1e-4: its dr rows sum up to a few hundred products of N(0, 1) values.
K6 and K4 must equal their plain versions exactly (an extremum of the same
fp32 products); K7 takes K1's tolerance for the same reason. K3, K5 and
K6b/K7b take K2's, with the absolute tolerance widened to 1e-5 of the
result's largest entry: a dr row sums a thousand or more terms (K7b's carry
x² and reach ~1e2), whose partial sums grow to that size, in another order.
K8f takes K1's with the absolute tolerance 1e-5 of its largest entry (nvcc
contracts the complex product's a·b − c·d into an FMA); K8b takes K2's for
dx and K3's for dr. K1h and K2h (the bf16 operand mode) take K1's and
K2's: the operands round to the same bf16 values on both sides and each
forward message is rounded from the same exact product, so only the order
of the fp32 sums differs. K9 (the ring shift) copies bytes: it must equal
its plain version bitwise; the ring op on the card (K1 and K2 per bucket,
K9 between steps) takes K1's and K2's tolerances against the CPU. The K1
strip-down ladder (P1, P2) holds each variant to
ops/rspmm_ladder_cuda.py::check_variant: K1's tolerance plus 8 fp32 ulps
of each entry's absolute mass (its terms sum in another order), dr 1e-4 of
its largest entry; full equals K1, and packed, ftile and nowrite equal
full, bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.diagnostics import blocked_ladder, kernel_floor
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
    got = rspmm_cuda.rspmm_fwd_cuda(*args)
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
    with pytest.raises(TypeError):  # int64 indices
        rspmm_cuda.rspmm_fwd_cuda(csr.rowptr.long(), csr.src, csr.etype,
                                  csr.eid, g.edge_weight, rel, x, "mul_rel")
    with pytest.raises(ValueError):  # non-contiguous x
        rspmm_cuda.rspmm_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                                  g.edge_weight, rel,
                                  torch.zeros((8, 37), device=cuda_device).T,
                                  "mul_rel")
    with pytest.raises(ValueError):  # operand on the CPU
        rspmm_cuda.rspmm_fwd_cuda(csr.rowptr, csr.src, csr.etype, csr.eid,
                                  g.edge_weight, rel.cpu(), x, "mul_rel")


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
    out = rspmm_cuda.rotate_fwd_cuda(*fwd, D)
    torch.cuda.synchronize()
    assert rspmm_cuda.rotate_launches == before + 1
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
        rspmm_cuda.rotate_fwd_cuda(*fwd, x, 8)
    with pytest.raises(ValueError):  # an odd block width
        rspmm_bwd_cuda.rotate_bwd_cuda(csr, w, rel, x, grad, 3)
    with pytest.raises(TypeError):  # float64 x
        rspmm_cuda.rotate_fwd_cuda(*fwd, x.double(), 6)
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
        got = rspmm_cuda.rspmm_fwd_bf16_cuda(*args)
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
            torch.ones(2, device=cuda_device), rel, x, "mul_rel")
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
    with pytest.raises(ValueError):  # operand on the CPU
        rspmm_cuda.rspmm_fwd_bf16_cuda(csr.rowptr, csr.src, csr.etype,
                                       csr.eid, w, rel.cpu(), x, "mul_rel")
    with pytest.raises(ValueError, match="mode"):
        rspmm_cuda.rspmm_fwd_bf16_cuda(csr.rowptr, csr.src, csr.etype,
                                       csr.eid, w, rel, x, "rot_rel")


# (n shards, rows per block, features): 7 fp32 rows of 5 features are 140
# bytes, not a multiple of 16, so the blocks after the first are misaligned
# (the byte path) and the first one has a byte tail; 1 x 3 bf16 features are
# 6 bytes
K9_SHAPES = [(2, 7, 5), (3, 7, 5), (4, 7, 5), (3, 1, 3), (4, 64, 256),
             (3, 3636, 1024)]


@pytest.mark.parametrize("n,vb,F", K9_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_matches_plain_bitwise(cuda_device, n, vb, F, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(n * vb + F)
    x = torch.randn((n * vb, F), generator=gen, device=cuda_device).to(dtype)
    before = rdma.launches
    got = rdma.ring_shift(x, n)
    assert rdma.launches == before + 1
    want = rdma.ring_shift_plain(x, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got[vb:2 * vb], x[:vb])  # block 0 moved to shard 1


def test_k9_takes_separate_blocks(cuda_device):
    """Per-shard buffers, each its own allocation (the multi-card layout)."""
    src = [torch.full((5, 3), float(s), device=cuda_device) for s in range(3)]
    dst = [torch.empty(5, 3, device=cuda_device) for _ in range(3)]
    rdma.ring_shift_blocks(src, dst)
    torch.cuda.synchronize()
    for s in range(3):
        assert torch.all(dst[(s + 1) % 3] == s)


def test_k9_rejects_bad_operands(cuda_device):
    x = torch.zeros((8, 4), device=cuda_device)
    blocks = list(x.chunk(4))
    with pytest.raises(ValueError, match="overlap"):
        rdma.ring_shift_blocks(blocks, blocks)
    with pytest.raises(NotImplementedError, match="item 9"):
        rdma.ring_shift_blocks(blocks, [b.cpu() for b in blocks])
    with pytest.raises(ValueError, match="one dtype and shape"):
        rdma.ring_shift_blocks(blocks, [torch.zeros(2, 5, device=cuda_device)
                                        for _ in blocks])
    with pytest.raises(ValueError, match="equal blocks"):
        rdma.ring_shift(x, 3)


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


@pytest.mark.parametrize("F", [10, 64, 1028])
@pytest.mark.parametrize("variant", ladder.VARIANTS)
def test_ladder_variants_match_plain(cuda_device, variant, F):
    """Each ladder variant held to check_ragged at ragged shapes (F = 10
    the scalar path, 1028 several feature tiles): its plain version, rows
    without edges 0, full equal to K1 and the bitwise variants to full;
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

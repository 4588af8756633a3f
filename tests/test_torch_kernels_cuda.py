"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips where there is no
card; the decision is taken inside the ``cuda_device`` fixture, at run time.

Run on a machine with the card:
    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerance atol = rtol = 1e-5: the kernel sums each row's edges in CSR order,
the plain version with index_add_ in another order.
"""

import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.ops import rspmm_cuda
from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _graph(rng, V, E, R, empty_rows=0):
    tri = np.stack([rng.integers(0, V, E),
                    rng.integers(0, V - empty_rows, E),
                    rng.integers(0, R, E)], 1)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0  # masked edges
    return Graph.from_triplets(tri, V, R, edge_weight=w).prepare_csr()


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

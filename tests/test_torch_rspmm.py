"""The PyTorch port's relational SpMM (plain version, CPU) against the JAX
package's segment-op path and its Pallas kernel in interpret mode.

Tolerance atol = rtol = 1e-5: the summation order differs between the
implementations (per-edge index_add_, segment_sum, the kernel's CSR rows,
dense matmuls), so the results agree to fp32 rounding, not bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import Graph as TGraph
from ultra_torchdrug_tpu_torch.ops import rspmm_cuda
from ultra_torchdrug_tpu_torch.ops.dense import dense_rspmm
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    broadcast_rel_flat,
    generalized_rspmm as t_rspmm,
)

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, R, B, D = 37, 300, 6, 2, 5  # F = B*D = 10: not a multiple of 4
EMPTY_ROWS = 5  # the last rows receive no edge


def make_inputs(rng):
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V - EMPTY_ROWS, E),
                    rng.integers(0, R, E)], 1).astype(np.int32)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0  # masked edges
    return dict(
        tri=tri, w=w,
        rel=rng.normal(size=(R, D)).astype(np.float32),
        rel_b=rng.normal(size=(R, B, D)).astype(np.float32),
        x=rng.normal(size=(V, B, D)).astype(np.float32),
    )


def _operands(inp, per_batch_rel, flat):
    rel = inp["rel_b"] if per_batch_rel else inp["rel"]
    x = inp["x"]
    if flat:
        rel = np.broadcast_to(rel[:, None, :], (R, B, D)) if rel.ndim == 2 \
            else rel
        rel, x = rel.reshape(R, B * D), x.reshape(V, B * D)
    return np.ascontiguousarray(rel), x


def _port(inp, rel, x, msg):
    g = TGraph.from_triplets(inp["tri"], V, R, edge_weight=inp["w"])
    return t_rspmm(g.edge_index, g.edge_type, g.edge_weight,
                   torch.from_numpy(rel), torch.from_numpy(x), msg=msg,
                   agg="add", num_nodes=V).numpy()


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("per_batch_rel", [False, True])
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_plain_matches_jax_xla(rng, msg, per_batch_rel, flat):
    inp = make_inputs(rng)
    rel, x = _operands(inp, per_batch_rel, flat)
    ei, et = inp["tri"][:, :2], inp["tri"][:, 2]
    want = j_rspmm(jnp.asarray(ei), jnp.asarray(et), jnp.asarray(inp["w"]),
                   jnp.asarray(rel), jnp.asarray(x), msg=msg, agg="add",
                   num_nodes=V, impl="xla")
    got = _port(inp, rel, x, msg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[V - EMPTY_ROWS:], 0.0)


def _float64_sum(inp, rel, x, msg):
    tri, w = inp["tri"], inp["w"].astype(np.float64)
    rel_e = rel.astype(np.float64)[tri[:, 2]]
    if rel_e.ndim < x.ndim:
        rel_e = rel_e[:, None, :]
    x_e = x.astype(np.float64)[tri[:, 0]]
    m = (rel_e * x_e if msg == "mul" else rel_e + x_e)
    out = np.zeros(x.shape)
    np.add.at(out, tri[:, 1], m * w.reshape((-1,) + (1,) * (m.ndim - 1)))
    return out


@pytest.mark.parametrize("per_batch_rel", [False, True])
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_plain_matches_jax_pallas_interpret(rng, msg, per_batch_rel):
    inp = make_inputs(rng)
    rel, x = _operands(inp, per_batch_rel, flat=False)
    jg = JGraph.from_triplets(inp["tri"], V, R,
                              edge_weight=inp["w"]).prepare_pallas()
    want = j_rspmm(jg.edge_index, jg.edge_type, jg.edge_weight,
                   jnp.asarray(rel), jnp.asarray(x), msg=msg, agg="add",
                   num_nodes=V, impl="pallas", layouts=jg.layouts)
    got = _port(inp, rel, x, msg)
    exact = _float64_sum(inp, rel, x, msg)
    np.testing.assert_allclose(got, exact, **TOL)
    # The Pallas add-aggregation keeps one running sum over a tile's rows
    # and writes each row as a difference of two running sums, so its own
    # rounding is at the running sum's magnitude (for transe messages, rel +
    # x, several times 1e-5 from the float64 sum at this shape). The port
    # must agree with it to 1e-5 beyond that error of its own.
    pallas_err = float(np.abs(np.asarray(want) - exact).max())
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-5 + pallas_err)


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_csr_wrapper_on_cpu_matches_edge_form(rng, msg):
    """rspmm_fwd_cuda on CPU tensors runs the plain version over the CSR
    (weights re-gathered through eid) and gives the edge-form result."""
    inp = make_inputs(rng)
    rel, x = _operands(inp, per_batch_rel=True, flat=True)
    g = TGraph.from_triplets(inp["tri"], V, R,
                             edge_weight=inp["w"]).prepare_csr()
    before = rspmm_cuda.launches
    got = rspmm_cuda.rspmm_fwd_cuda(
        g.csr.rowptr, g.csr.src, g.csr.etype, g.csr.eid, g.edge_weight,
        torch.from_numpy(rel), torch.from_numpy(x),
        "mul_rel" if msg == "mul" else "add_rel", segments=g.csr.segments)
    assert rspmm_cuda.launches == before  # the plain version is no launch
    np.testing.assert_allclose(got.numpy(), _port(inp, rel, x, msg), **TOL)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("per_batch_rel", [False, True])
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_dense_matches_sparse(rng, msg, per_batch_rel, flat):
    inp = make_inputs(rng)
    rel, x = _operands(inp, per_batch_rel, flat)
    g = TGraph.from_triplets(inp["tri"], V, R, edge_weight=inp["w"])
    A = g.prepare_dense(min_density=0.0).dense_adj
    got = dense_rspmm(A, torch.from_numpy(rel), torch.from_numpy(x), msg=msg)
    np.testing.assert_allclose(got.numpy(), _port(inp, rel, x, msg), **TOL)


def test_broadcast_rel_flat_is_b_major(rng):
    rel = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    flat = broadcast_rel_flat(rel, B)
    assert flat.shape == (R, B * D)
    for b in range(B):
        torch.testing.assert_close(flat[:, b * D:(b + 1) * D], rel)


@pytest.mark.parametrize("msg,agg", [("rotate", "add"), ("rotate", "max"),
                                     ("rotate", "min")])
def test_rotate_matches_jax_xla(rng, msg, agg):
    """Rotate through the op on the CPU (the plain version for add, the O(E)
    route for max and min) against the JAX package's segment-op path,
    forward and gradients, with a per-batch relation and D = 6 (three
    complex lanes a block). Gradients to 1e-4: sums of products of the
    gradient in another order; the max/min gradients of both share a tie
    among the tied edges."""
    inp = make_inputs(rng)
    Dr = 6
    rel, x, cot = (rng.normal(size=s).astype(np.float32)
                   for s in ((R, B, Dr), (V, B, Dr), (V, B, Dr)))
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])

    def j_loss(r, xx):
        out = j_rspmm(ei, et, jnp.asarray(inp["w"]), r, xx, msg=msg, agg=agg,
                      num_nodes=V, impl="xla")
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(rel),
                                              jnp.asarray(x))
    g = TGraph.from_triplets(inp["tri"], V, R, edge_weight=inp["w"])
    r_t = torch.from_numpy(rel).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    got = t_rspmm(g.edge_index, g.edge_type, g.edge_weight, r_t, x_t, msg=msg,
                  agg=agg, num_nodes=V)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                (r_t, x_t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.detach().numpy()[V - EMPTY_ROWS:], 0.0)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)

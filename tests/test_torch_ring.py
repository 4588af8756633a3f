"""The port's edge-partitioned ring path against the JAX package on the CPU:
the mesh, the degree-balanced relabelling, the ring's buckets, the ring
shift's plain version, and ring_rspmm's forward and gradients against the
JAX package's single-device ``generalized_rspmm`` and its VJP (what
tests/test_parallel.py holds the JAX ring to). No JAX mesh is built: the
port's shards all live on the CPU here, as on the one card there.

Tolerance 1e-5 absolute and relative: the ring adds n partial sums per
owner block in step order, the single-device op sums each row's edges in
another order, over fewer than a hundred fp32 products of N(0, 1) values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.parallel.balance import (
    degree_balanced_permutation as j_balance,
)
from ultra_torchdrug_tpu.parallel.ring_rspmm import (
    build_ring_rspmm_inputs as j_build,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.models.layers import (
    ConvConfig,
    GeneralizedRelationalConv,
    conv_apply,
)
from ultra_torchdrug_tpu_torch.nn.core import init_parameters_
from ultra_torchdrug_tpu_torch.parallel import balance, mesh, rdma
from ultra_torchdrug_tpu_torch.parallel import ring_rspmm as ring_mod
from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
    build_ring_rspmm_inputs,
    ring_rspmm,
)

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, R, B, D = 43, 200, 5, 3, 8  # V not divisible by 2, 3 or 4: pad rows


def _edges(seed=0, hub=False):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, V, E), rng.integers(0, V, E)
    if hub:  # a third of the edges touch the first two nodes
        src[: E // 3] = rng.integers(0, 2, E // 3)
    et = rng.integers(0, R, E)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0  # masked edges
    return np.stack([src, dst], 1), et, w


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("balanced", [False, True])
def test_buckets_match_jax(n, balanced):
    ei, et, _ = _edges(n, hub=True)
    want = j_build(ei, et, V, n, pallas=False, balance=balanced)
    got = build_ring_rspmm_inputs(ei, et, V, n, num_relations=R,
                                  balance=balanced)
    assert (got.v_block, got.n_shards, got.num_nodes) == (
        want.v_block, want.n_shards, want.num_nodes)
    for family in ("fwd", "rev"):
        for name in ("gather_local", "out_local", "etype", "edge_id",
                     "valid"):
            np.testing.assert_array_equal(
                getattr(getattr(got, family), name).numpy(),
                np.asarray(getattr(getattr(want, family), name)),
                err_msg=f"{family}.{name}")
    if balanced:
        np.testing.assert_array_equal(got.to_new.numpy(),
                                      np.asarray(want.to_new))
        np.testing.assert_array_equal(got.to_old.numpy(),
                                      np.asarray(want.to_old))
    else:
        assert got.to_new is None and want.to_new is None


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_degree_balanced_permutation_matches_jax(n):
    ei, _, _ = _edges(n, hub=True)
    got = balance.degree_balanced_permutation(ei[:, 0], ei[:, 1], V, n)
    want = j_balance(ei[:, 0], ei[:, 1], V, n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the heaviest block's total degree (each edge counted at both ends)
    ends = np.concatenate([ei[:, 0], ei[:, 1]])
    assert (balance.block_edge_counts(got[0][ends], V, n).max()
            <= balance.block_edge_counts(ends, V, n).max())


def test_bucket_csrs_hold_each_pair_with_global_edge_ids():
    ei, et, _ = _edges(3)
    ri = build_ring_rspmm_inputs(ei, et, V, 3, num_relations=R, pallas=True)
    vb = ri.v_block
    seen = []
    for i, row in enumerate(ri.csr):
        for j, c in enumerate(row):
            eid = c.eid.long().numpy()
            seen.append(eid)
            assert len(eid) == ri.edge_counts[i, j]
            assert np.all(ei[eid, 1] // vb == i)
            assert np.all(ei[eid, 0] // vb == j)
            assert c.has_backward and c.rowptr.numel() == vb + 1
            np.testing.assert_array_equal(
                np.sort(c.src_eid.long().numpy()), np.sort(eid))
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(E))
    assert ri.nonempty_buckets == np.count_nonzero(ri.edge_counts)


def _jax_reference(ei, et, w, rel, x, msg, probe):
    def f(rel, x):
        out = j_rspmm(jnp.asarray(ei), jnp.asarray(et), jnp.asarray(w), rel, x,
                      msg=msg, agg="add", num_nodes=V)
        return jnp.sum(out * probe), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rel), jnp.asarray(x))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_ring(ri, w, rel, x, msg, probe, exchange):
    r = torch.from_numpy(rel).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    if ri.permuted_io:  # the caller owns the padded, relabelled block domain
        blocks = torch.cat([xx, xx.new_zeros((ri.v_pad - V, B, D))])
        if ri.to_old is not None:
            blocks = blocks[ri.to_old]
        out = ring_rspmm(torch.from_numpy(w), ri, r, blocks, msg=msg,
                         exchange=exchange)
        out = out[:V] if ri.to_new is None else out[ri.to_new]
    else:
        out = ring_rspmm(torch.from_numpy(w), ri, r, xx, msg=msg,
                         exchange=exchange)
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), (r, xx))
    return [t.detach().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("msg", ["mul", "add"])
@pytest.mark.parametrize("rel_form", ["shared", "per_batch"])
@pytest.mark.parametrize("csr_route", [False, True])
def test_ring_rspmm_matches_jax_single_device(n, msg, rel_form, csr_route):
    """Forward, d_relation and dx, with balance and permuted IO on and off
    and both exchanges; the bucket-CSR route (K1/K2's plain versions here)
    and the plain bucket route."""
    ei, et, w = _edges(10 * n + (msg == "add"), hub=True)
    rng = np.random.default_rng(n)
    rel = rng.normal(size=(R, D) if rel_form == "shared" else (R, B, D))
    rel = rel.astype(np.float32)
    x = rng.normal(size=(V, B, D)).astype(np.float32)
    probe = rng.normal(size=(V, B, D)).astype(np.float32)
    want = _jax_reference(ei, et, w, rel, x, msg, probe)
    for balanced in (False, True):
        for permuted_io in (False, True):
            ri = build_ring_rspmm_inputs(ei, et, V, n, num_relations=R,
                                         pallas=csr_route, balance=balanced,
                                         permuted_io=permuted_io)
            for exchange in ("ppermute", "rdma"):
                got = _port_ring(ri, w, rel, x, msg, probe, exchange)
                for name, a, b in zip(("out", "d_rel", "dx"), got, want):
                    np.testing.assert_allclose(
                        a, b, err_msg=f"{name} balance={balanced} "
                        f"permuted_io={permuted_io} {exchange}", **TOL)


@pytest.mark.parametrize("csr_route", [False, True])
def test_ring_rspmm_with_empty_buckets(csr_route, monkeypatch):
    """Edges only inside each block of 11 rows: 12 of the 16 buckets are
    empty and are skipped (no kernel call), the result still the JAX
    package's."""
    n, vb = 4, 11
    rng = np.random.default_rng(9)
    src = rng.integers(0, V, E)
    dst = np.minimum((src // vb) * vb + rng.integers(0, vb, E), V - 1)
    ei, et = np.stack([src, dst], 1), rng.integers(0, R, E)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    rel = rng.normal(size=(R, B, D)).astype(np.float32)
    x = rng.normal(size=(V, B, D)).astype(np.float32)
    probe = rng.normal(size=(V, B, D)).astype(np.float32)
    ri = build_ring_rspmm_inputs(ei, et, V, n, num_relations=R,
                                 pallas=csr_route)
    assert ri.v_block == vb and ri.nonempty_buckets == n
    calls = []
    for name in ("rspmm_fwd_cuda", "rspmm_bwd_cuda"):
        real = getattr(ring_mod, name)
        monkeypatch.setattr(ring_mod, name, lambda *a, real=real, **k:
                            calls.append(1) or real(*a, **k))
    got = _port_ring(ri, w, rel, x, "mul", probe, "rdma")
    assert len(calls) == (2 * n if csr_route else 0)
    want = _jax_reference(ei, et, w, rel, x, "mul", probe)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_ring_rspmm_flat_operands_and_bf16_route():
    """Flat [V, F] operands give the [V, B, D] result; bf16 on the CSR route
    runs K1h/K2h's plain versions, which the single-device bf16 op also
    runs, so the two agree to the fp32 summation order."""
    from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm

    ei, et, w = _edges(5)
    rng = np.random.default_rng(5)
    rel = torch.from_numpy(rng.normal(size=(R, B * D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(V, B * D)).astype(np.float32))
    g = Graph.from_triplets(np.concatenate([ei, et[:, None]], 1), V, R,
                            edge_weight=w).prepare_csr(backward=True)
    ri = build_ring_rspmm_inputs(ei, et, V, 4, num_relations=R, pallas=True)
    for dtype in ("float32", "bfloat16"):
        want = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight,
                                 rel, x, msg="mul", num_nodes=V, csr=g.csr,
                                 compute_dtype=dtype)
        got = ring_rspmm(g.edge_weight, ri, rel, x, msg="mul",
                         compute_dtype=dtype, exchange="rdma")
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("csr_route", [False, True])
def test_exchanges_agree_bitwise(csr_route):
    ei, et, w = _edges(3)
    rng = np.random.default_rng(3)
    rel = rng.normal(size=(R, B, D)).astype(np.float32)
    x = rng.normal(size=(V, B, D)).astype(np.float32)
    probe = rng.normal(size=(V, B, D)).astype(np.float32)
    ri = build_ring_rspmm_inputs(ei, et, V, 3, num_relations=R,
                                 pallas=csr_route)
    a = _port_ring(ri, w, rel, x, "mul", probe, "ppermute")
    b = _port_ring(ri, w, rel, x, "mul", probe, "rdma")
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_shift_plain_moves_each_block_one_shard_right(n):
    x = torch.arange(n * 6, dtype=torch.float32).reshape(n * 3, 2)
    got = rdma.ring_shift(x, n)  # a CPU tensor: the plain version
    for s in range(n):
        assert torch.equal(got[((s + 1) % n) * 3:((s + 1) % n + 1) * 3],
                           x[s * 3:(s + 1) * 3])
    assert got.data_ptr() != x.data_ptr()


def _conv(aggregate_func, **ring):
    cfg = ConvConfig(input_dim=D, output_dim=D, num_relations=R,
                     query_input_dim=D, aggregate_func=aggregate_func,
                     layer_norm=True, rel_mode="embedding", **ring)
    layer = GeneralizedRelationalConv(cfg)
    init_parameters_(layer, torch.Generator().manual_seed(0))
    return layer


RING = dict(rspmm_impl="ring", edge_axis="edge", ring_exchange="rdma")


def _ring_graph(n=4, permuted_io=False):
    ei, et, w = _edges(4)
    g = Graph.from_triplets(np.concatenate([ei, et[:, None]], 1), V, R,
                            edge_weight=w).prepare_csr(backward=True)
    return g.prepare_ring(n, pallas=True, permuted_io=permuted_io)


@pytest.mark.parametrize("aggregate_func", ["max", "pna", "max_nobound",
                                            "pna_nobound"])
def test_unported_aggregations_raise_under_an_edge_mesh(aggregate_func):
    g = _ring_graph()
    layer = _conv(aggregate_func, **RING)
    x = torch.randn(V, B * D)
    with mesh.use_mesh(mesh.make_mesh(edge=4, device="cpu")):
        with pytest.raises(NotImplementedError, match="item 9"):
            conv_apply(layer, g, x, x)
    conv_apply(layer, g, x, x)  # off the mesh: the single-device kernels
    with pytest.raises(NotImplementedError, match="item 9"):
        ring_rspmm(g.edge_weight, g.ring_inputs, torch.randn(R, B * D), x,
                   msg="mul", agg="max")


@pytest.mark.parametrize("aggregate_func", ["sum", "mean", "mean_nobound"])
def test_conv_routes_sums_through_the_ring_on_the_mesh_only(
        aggregate_func, monkeypatch):
    """On the mesh a ring conv's sums take ring_rspmm and agree with the
    single-device conv; off the mesh (the JAX package's rule) and for
    permuted-IO buckets met with original-order states they do not take
    it."""
    calls = []
    real = ring_mod._RingRspmm.apply
    monkeypatch.setattr(ring_mod._RingRspmm, "apply",
                        lambda *a: calls.append(1) or real(*a))
    g = _ring_graph()
    ring_layer = _conv(aggregate_func, **RING)
    plain_layer = _conv(aggregate_func)
    x = torch.randn(V, B * D)
    want = conv_apply(plain_layer, g, x, x)
    with mesh.use_mesh(mesh.make_mesh(edge=4, device="cpu")):
        got = conv_apply(ring_layer, g, x, x)
        assert len(calls) == 1
        conv_apply(ring_layer, _ring_graph(permuted_io=True), x, x)
        assert len(calls) == 1
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(conv_apply(ring_layer, g, x, x), want, **TOL)
    assert len(calls) == 1


def test_mesh_raises_where_the_slice_does_not_reach():
    # a data axis runs over processes: one process cannot hold two rows
    with pytest.raises(ValueError, match="needs 2 processes.*has 1"):
        mesh.make_mesh(data=2, edge=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        mesh.make_mesh(edge=2, devices=["cpu", "meta"])
    m = mesh.make_mesh(edge=4, device="cpu")
    assert m.shape == {"data": 1, "edge": 4} and m.axis_names == (
        "data", "edge")
    assert m.device == torch.device("cpu") and mesh.current_mesh() is None
    with mesh.use_mesh(m):
        assert mesh.current_mesh() is m
    assert mesh.current_mesh() is None

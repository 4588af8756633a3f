"""Edge shards on several devices (parallel/mesh.py, parallel/placement.py,
the placed layouts of parallel/ring_rspmm.py and parallel/sharded_rspmm.py)
on the CPU.

The placement rule as a pure function, with the data-parallel backend
rule that gives each rank its home card; a mesh over four cards built
without a card (placement only); each path's layouts placed on a
four-shard mesh whose devices alternate ``cpu`` and ``meta`` (nothing is
computed on ``meta``: the test reads where each tensor lies, before and
after ``Graph.to``); then every edge path through its per-shard code on
layouts placed with every shard on the CPU, against the JAX package's
single-device op: the ring's sums (the kernels' route and the plain
one), max and min, PNA's pair and moments, the partitioned path and the
``xla`` body, with their gradients, and ``parallel.relation_edge``'s
placement of both towers' layouts. The paths across cards run on the
card (tests/test_torch_cards_cuda.py, ``chip_smoke.py`` phases 52-53).

Tolerances, each with its reason: sums and their gradients 1e-5, the same
fp32 products summed in another order (by shard, then by bucket or CSR
row); extrema equal (``==``), their gradients 1e-5, as in
tests/test_torch_ring_extrema.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mp_worker as worker
from test_torch_partitioned import _edges, _jax_reference, _operands
from test_torch_partitioned import _port as _port_op
from test_torch_ring_extrema import _inputs, _jax_pairs, _t
from test_torch_ring_ultra import one_torch_thread  # noqa: F401  (a fixture)

from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.parallel import distributed, mesh, rdma
from ultra_torchdrug_tpu_torch.parallel.placement import (
    blocks_on,
    replicate,
    shard_devices,
)
from ultra_torchdrug_tpu_torch.parallel.ring_rspmm import (
    build_ring_rspmm_inputs,
    ring_rspmm,
    ring_rspmm_addsq,
    ring_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.parallel.sharded_rspmm import (
    build_partitioned_rspmm_inputs,
    partitioned_rspmm,
    sharded_rspmm,
)

TOL = dict(rtol=1e-5, atol=1e-5)
V, R = 43, 5  # the two imported modules' graph sizes
CPU = torch.device("cpu")
MIXED = [torch.device(d) for d in ("cpu", "meta", "cpu", "meta")]


@pytest.mark.parametrize("count,data,want", [
    (1, 1, [[0, 0, 0, 0]]),
    (1, 2, [[0, 0], [0, 0]]),
    (2, 1, [[0, 1, 0, 1]]),
    (2, 2, [[0, 1], [0, 1]]),
    (4, 1, [[0, 1, 2, 3]]),
    (4, 2, [[0, 1], [2, 3]]),
])
def test_shard_cards_follow_the_placement_rule(count, data, want):
    """Shard s of data row r on card (r * edge + s) mod count: one card
    holds every shard, four cards one shard each, data 2 x edge 2 on four
    cards rank 0 on cards 0-1 and rank 1 on 2-3, fewer cards in turn."""
    edge = len(want[0])
    assert [mesh.shard_cards(r, edge, count) for r in range(data)] == want
    with pytest.raises(ValueError, match="no card"):
        mesh.shard_cards(0, edge, 0)


@pytest.mark.parametrize("local,local_world,count,edge,want", [
    (1, 2, 4, 2, ("nccl", "cuda:2")),  # data 2 x edge 2 on four cards
    (0, 2, 4, 2, ("nccl", "cuda:0")),
    (1, 2, 2, 2, ("gloo", "cuda:0")),  # both rows start on card 0
    (1, 2, 4, 4, ("gloo", "cuda:0")),
    (3, 4, 8, 2, ("nccl", "cuda:6")),
])
def test_a_ranks_home_is_its_rows_first_card(local, local_world, count,
                                             edge, want):
    backend, dev = distributed.backend_rule("cuda", local, local_world,
                                            cuda_count=count, edge=edge)
    assert (backend, str(dev)) == want
    assert dev.index == mesh.shard_cards(local, edge, count)[0]


@pytest.mark.parametrize("edge,count", [(4, 4), (4, 2), (2, 1)])
def test_make_mesh_places_the_shards_on_the_cards(monkeypatch, caplog,
                                                  edge, count):
    """The default device "cuda" spreads the shards over the host's cards
    (counted, not touched: the count is monkeypatched); a device with an
    index pins them all; the mesh logs where each shard went."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    with caplog.at_level("INFO"):
        m = mesh.make_mesh(edge=edge)
    assert [d.index for d in m.devices] == mesh.shard_cards(0, edge, count)
    assert m.device == torch.device("cuda", 0)
    assert "shards on ['cuda:0', " in caplog.text
    pinned = mesh.make_mesh(edge=edge, device="cuda:1")
    assert pinned.devices == (torch.device("cuda", 1),) * edge


def _placed_graph():
    ei, et, _ = _edges(4)
    tri = np.concatenate([ei, et[:, None]], 1)
    return Graph.from_triplets(tri, V, R)


def _assert_on(tensors, device):
    for t in tensors:
        assert t.device == device, (t.device, device)


def _csr_tensors(c):
    return [t for t in vars(c).values() if torch.is_tensor(t)]


def test_layouts_lie_on_their_shards_devices():
    """Ring buckets and per-bucket CSRs, and the partitioned CSRs, on a
    4-shard mesh of alternating devices: row s and shard s's forward CSRs
    on devices[s], the backward's bucket (s, b) (the forward's pair csr[b]
    [s]) on devices[s] too, the index maps on the home; Graph.to keeps
    them there."""
    g = _placed_graph().prepare_ring(4, pallas=True, balance=True,
                                     devices=MIXED)
    g = g.prepare_csr_sharded(4, backward=True, balance=True, devices=MIXED)
    for graph in (g, g.to("cpu")):
        ri, part = graph.ring_inputs, graph.part_layouts
        assert ri.devices == part.devices == tuple(MIXED)
        _assert_on([ri.to_old, ri.to_new, part.to_old, part.to_new], CPU)
        for s, d in enumerate(MIXED):
            for family in (ri.fwd, ri.rev):
                _assert_on([getattr(family, f)[s] for f in
                            ("gather_local", "out_local", "etype",
                             "edge_id", "valid")], d)
            for b in range(4):
                _assert_on(_csr_tensors(ri.csr[s][b]), d)
                _assert_on(_csr_tensors(ri.csr_rev[s][b]), d)
                # an off-diagonal CSR lies on both of its shards' devices
                assert (ri.csr_rev[s][b].eid.numel()
                        == ri.csr[b][s].eid.numel() == ri.edge_counts[b, s])
            _assert_on(_csr_tensors(part.fwd[s]) + _csr_tensors(part.rev[s]),
                       d)


def test_one_device_layouts_follow_graph_to():
    """Layouts whose shards share the graph's device (the default) move
    whole with Graph.to, and a pair of shards on one device shares one
    CSR object for the forward and the backward."""
    g = _placed_graph().prepare_ring(3, pallas=True).prepare_csr_sharded(3)
    for graph in (g, g.to("meta")):
        ri, dev = graph.ring_inputs, graph.device
        assert ri.devices == graph.part_layouts.devices == (dev,) * 3
        assert ri.fwd.etype[2].device == ri.rev.valid[0].device == dev
        assert graph.part_layouts.fwd[2].eid.device == dev
        assert all(ri.csr_rev[s][b] is ri.csr[b][s]
                   for s in range(3) for b in range(3))


def test_placement_helpers_on_one_device():
    """With every shard on the home device the blocks are views, nothing
    is copied, and a home that is not shard 0's device raises."""
    x = torch.arange(12.0).reshape(6, 2)
    blocks = blocks_on(x, 2, (CPU,) * 3)
    assert all(b.data_ptr() == x[2 * s:].data_ptr()
               for s, b in enumerate(blocks))
    assert replicate(x, (CPU, CPU))[CPU] is x
    with pytest.raises(ValueError, match="home"):
        shard_devices(MIXED[1:] + MIXED[:1], CPU)
    moved = rdma.shift_blocks(blocks, (CPU,) * 3)
    assert [m.data_ptr() for m in moved] == [blocks[2].data_ptr(),
                                             blocks[0].data_ptr(),
                                             blocks[1].data_ptr()]
    assert rdma.shift_blocks_plain(blocks, ("cpu",) * 3)[0] is blocks[2]


def _ring_port(fn, inp, n, pallas=False, **kw):
    """``fn`` over ring layouts placed with every shard on the CPU: its
    outputs and the gradients of Σ <g_i, out_i> with respect to
    (relation, x)."""
    ri = build_ring_rspmm_inputs(inp["tri"][:, :2], inp["tri"][:, 2], V, n,
                                 num_relations=R, pallas=pallas,
                                 balance=True).to_mesh(("cpu",) * n)
    assert ri.devices == (CPU,) * n
    rel, x = _t(inp["rel"]).requires_grad_(), _t(inp["x"]).requires_grad_()
    out = fn(_t(inp["w"]), ri, rel, x, **kw)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum((o * _t(g)).sum() for o, g in zip(out, inp["g"]))
    grads = torch.autograd.grad(loss, (rel, x))
    return [v.detach().numpy() for v in (*out, *grads)]


def _jax_ring_reference(inp, msg, agg):
    """The JAX single-device op (XLA) and its gradients of <g0, out>."""
    ei, et = jnp.asarray(inp["tri"][:, :2]), jnp.asarray(inp["tri"][:, 2])

    def f(rel, x):
        out = j_rspmm(ei, et, jnp.asarray(inp["w"]), rel, x, msg=msg,
                      agg=agg, num_nodes=V, impl="xla")
        return jnp.sum(out * inp["g"][0]), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(inp["rel"]),
                                          jnp.asarray(inp["x"]))
    return [np.asarray(v) for v in (out, *grads)]


@pytest.mark.parametrize("msg,pallas,exchange", [
    ("mul", True, "rdma"), ("mul", False, "ppermute"), ("add", False,
                                                        "rdma")])
def test_placed_ring_sums_match_jax(msg, pallas, exchange):
    """The ring's sums on 4 placed shards: K1/K2 per bucket (their plain
    versions here) for distmult with CSRs, the plain gathers otherwise."""
    inp = _inputs(11)
    inp["g"] = inp["g"][:1]
    got = _ring_port(ring_rspmm, inp, 4, pallas=pallas, msg=msg,
                     exchange=exchange)
    for a, b in zip(got, _jax_ring_reference(inp, msg, "add")):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("agg", ["max", "min"])
def test_placed_ring_extrema_match_jax(agg):
    """max and min on 3 placed shards; the JAX package's XLA route shares
    the gradient among tied edges, so the operands have no zero rows or
    weights here (no ties)."""
    inp = _inputs(12)
    inp["x"] = inp["x"] + np.float32(3.0)
    inp["w"] = np.abs(inp["w"]) + np.float32(0.5)
    inp["g"] = inp["g"][:1]
    got = _ring_port(ring_rspmm, inp, 3, msg="mul", agg=agg,
                     exchange="rdma")
    want = _jax_ring_reference(inp, "mul", agg)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **TOL)


def test_placed_ring_pair_and_moments_match_jax():
    """PNA's fused pair (against interpret-mode Pallas, which shares the
    ring's tie convention) and its moments on 4 placed shards."""
    inp = _inputs(13)
    (mx, mn), grads = _jax_pairs(inp, "mul")
    got = _ring_port(ring_rspmm_maxmin, inp, 4, msg="mul",
                     exchange="ppermute")
    np.testing.assert_array_equal(got[0], mx)
    np.testing.assert_array_equal(got[1], mn)
    for a, b in zip(got[2:], grads[0]):
        np.testing.assert_allclose(a, b, **TOL)
    got = _ring_port(ring_rspmm_addsq, inp, 4, exchange="rdma")
    inp2 = dict(inp, rel=inp["rel"] ** 2, x=inp["x"] ** 2, g=inp["g"][1:])
    want_s = _jax_ring_reference(dict(inp, g=inp["g"][:1]), "mul", "add")
    want_sq = _jax_ring_reference(inp2, "mul", "add")
    np.testing.assert_allclose(got[0], want_s[0], **TOL)
    np.testing.assert_allclose(got[1], want_sq[0], **TOL)
    # d/drel and d/dx of <g1, Σ w rel² x²>: the chain rule through squares
    d_rel = want_s[1] + 2 * inp["rel"] * want_sq[1]
    d_x = want_s[2] + 2 * inp["x"] * want_sq[2]
    np.testing.assert_allclose(got[2], d_rel, **TOL)
    np.testing.assert_allclose(got[3], d_x, **TOL)


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_placed_partitioned_and_xla_match_jax(msg):
    """The partitioned kernels (their plain versions) over CSRs placed
    with every shard on the CPU, and the ``xla`` body with the shards'
    devices given, against the JAX single-device op."""
    ei, et, w = _edges(21)
    rel, x, probe = _operands(21, "per_batch")
    want = _jax_reference(ei, et, w, rel, x, msg, probe)
    lay = build_partitioned_rspmm_inputs(ei, et, V, R, 4,
                                         balance=True).to_mesh(["cpu"] * 4)
    got = _port_op(lambda w, r, xx: partitioned_rspmm(w, lay, r, xx,
                                                      msg=msg),
                   w, rel, x, probe)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    got = _port_op(lambda w, r, xx: sharded_rspmm(
        torch.from_numpy(ei), torch.from_numpy(et), w, r, xx, msg=msg,
        num_nodes=V, n_shards=3, devices=(CPU,) * 3), w, rel, x, probe)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("impl", ["auto", "ring"])
def test_relation_edge_places_both_towers_layouts(impl):
    """Under ``parallel.relation_edge`` the task prepares the entity and
    the relation graph's edge layouts placed on the mesh's shard devices;
    ``Graph.to`` to the task's device keeps them placed."""
    from ultra_torchdrug_tpu_torch.engine.build import (
        build_dataset,
        build_task,
        mesh_scope,
    )

    cfg = worker.train_config()
    cfg["parallel"] = {"edge": 2, "relation_edge": True}
    cfg["rspmm_impl"] = impl
    with mesh_scope(cfg, "cpu") as (m, edge_axis, rel_edge_axis):
        task = build_task(cfg["task"], build_dataset(cfg["dataset"]),
                          rspmm_impl=impl, device="cpu", edge_axis=edge_axis,
                          rel_edge_axis=rel_edge_axis)
        und, rel_graph = task._prepare_graphs(task.fact_graph,
                                              task.rel_graph, backward=True)
    for graph in (und, rel_graph):
        lay = graph.ring_inputs if impl == "ring" else graph.part_layouts
        assert lay is not None and lay.devices == m.devices == (CPU, CPU)

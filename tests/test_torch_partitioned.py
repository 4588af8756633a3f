"""The port's partitioned path (parallel/sharded_rspmm.py) against the JAX
package on the CPU: the per-shard layouts against the JAX package's
``build_partitioned_rspmm_inputs``, ``partitioned_rspmm`` (the kernels'
plain versions here) and ``sharded_rspmm`` (the ``xla`` body) against its
single-device ``generalized_rspmm`` and its VJP, the bf16 route against
its bf16 op on interpret-mode Pallas, and ULTRA under an edge mesh of 4
shards (the partitioned path, its ``xla`` body and
``parallel.relation_edge`` on the partitioned path and on the ring)
against the JAX single-device model. No JAX mesh is built: the port's
shards all live on the CPU.

Tolerances, each with its reason:
  * layouts: equal;
  * the op and its gradients: 1e-5 absolute and relative, sums of the same
    fp32 products in another order (by shard, then by CSR row);
  * bf16: 1e-5, tests/test_torch_bf16.py's limit for the single-device op
    (the same bf16 roundings, fp32 sums in another order);
  * ULTRA: scores and loss 1e-5, gradients 1e-4 norm-wise, as in
    tests/test_torch_ring_ultra.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import BF16, _jax_exact, _op_graph
from test_torch_ring_ultra import (  # noqa: F401  (fixtures)
    one_torch_thread,
    setup,
)

from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.parallel.sharded_rspmm import (
    build_partitioned_rspmm_inputs as j_build,
)
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.models.layers import (
    ConvConfig,
    GeneralizedRelationalConv,
    conv_apply,
)
from ultra_torchdrug_tpu_torch.models.ultra import (
    Ultra,
    UltraConfig,
    ultra_eval_scores,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm
from ultra_torchdrug_tpu_torch.parallel import ring_rspmm as ring_mod
from ultra_torchdrug_tpu_torch.parallel import sharded_rspmm as part_mod
from ultra_torchdrug_tpu_torch.parallel.mesh import make_mesh, use_mesh
from ultra_torchdrug_tpu_torch.parallel.sharded_rspmm import (
    build_partitioned_rspmm_inputs,
    partitioned_rspmm,
    sharded_rspmm,
)
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig
from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask as TTask

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, R, B, D = 43, 200, 5, 3, 8  # V divides by none of 2, 3, 4


def _edges(seed, hub=True, num_edges=E):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, V, num_edges), rng.integers(0, V, num_edges)
    if hub:  # a third of the edges leave or enter the first two nodes
        k = num_edges // 6
        src[:k] = rng.integers(0, 2, k)
        dst[k:2 * k] = rng.integers(0, 2, k)
    et = rng.integers(0, R, num_edges)
    w = rng.uniform(0.5, 1.5, num_edges).astype(np.float32)
    w[rng.uniform(size=num_edges) < 0.2] = 0.0  # masked edges
    return np.stack([src, dst], 1), et, w


def _jax_edges(family, s):
    """{edge id: (row, gather, relation)} of shard s of a stacked JAX
    layout family."""
    lay = jax.tree_util.tree_map(lambda a: np.asarray(a)[s], family)
    valid = lay.valid > 0
    rows = lay.cr_pairs[0][:, None] * lay.tile_rows + lay.row_local
    return {int(e): (int(r), int(g), int(t)) for e, r, g, t in zip(
        lay.edge_id[valid], rows[valid], lay.gather1[valid], lay.aux[valid])}


def _port_edges(rowptr, gather, etype, eid):
    rows = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr.numpy()))
    return {int(e): (int(r), int(g), int(t)) for e, r, g, t in zip(
        eid.numpy(), rows, gather.numpy(), etype.numpy())}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("balanced", [False, True])
def test_layouts_match_jax(n, balanced):
    """Each shard's forward edges (destination in its block: block-local
    row, global source, relation) and reverse edges (source in its block:
    block-local row, global destination), the relabelling and v_block as
    the JAX package builds them; the JAX package's transe relation family
    holds the reverse family's edges, which K3 reads from the reverse CSRs'
    (destination tile, relation) chunks."""
    ei, et, _ = _edges(n)
    want = j_build(ei, et, V, R, n, include_rel_layout=True,
                   balance=balanced)
    got = build_partitioned_rspmm_inputs(ei, et, V, R, n, balance=balanced)
    assert (got.v_block, got.n_shards, got.num_nodes) == (
        want.v_block, want.n_shards, want.num_nodes)
    if balanced:
        np.testing.assert_array_equal(got.to_new.numpy(),
                                      np.asarray(want.to_new))
        np.testing.assert_array_equal(got.to_old.numpy(),
                                      np.asarray(want.to_old))
    else:
        assert got.to_new is None and want.to_new is None
    seen = []
    for s in range(n):
        fwd, rev = got.fwd[s], got.rev[s]
        assert fwd.rowptr.numel() == rev.src_rowptr.numel() == got.v_block + 1
        assert _port_edges(fwd.rowptr, fwd.src, fwd.etype, fwd.eid) == (
            _jax_edges(want.fwd, s))
        rev_edges = _port_edges(rev.src_rowptr, rev.src_dst, rev.src_etype,
                                rev.src_eid)
        assert rev_edges == _jax_edges(want.rev, s)
        assert set(rev_edges) == set(_jax_edges(want.rel, s))
        assert np.array_equal(np.sort(rev.tile_eid.numpy()),
                              np.sort(list(rev_edges)))
        assert (got.fwd_counts[s], got.rev_counts[s]) == (
            fwd.eid.numel(), rev.src_eid.numel())
        seen.append(fwd.eid.numpy())
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(E))


def _jax_reference(ei, et, w, rel, x, msg, probe):
    """The JAX single-device op's output and its gradients (d_relation,
    dx) of <probe, out>, jitted (one compilation, not one per operation)."""
    def f(rel, x):
        out = j_rspmm(jnp.asarray(ei), jnp.asarray(et), jnp.asarray(w), rel,
                      x, msg=msg, agg="add", num_nodes=V)
        return jnp.sum(out * probe), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(rel), jnp.asarray(x))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port(fn, w, rel, x, probe, **kw):
    r = torch.from_numpy(rel).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    out = fn(torch.from_numpy(w), r, xx, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), (r, xx))
    return [t.detach().numpy() for t in (out, *grads)]


def _operands(seed, rel_form):
    rng = np.random.default_rng(seed)
    rel = rng.normal(size=(R, D) if rel_form == "shared" else (R, B, D))
    return (rel.astype(np.float32),
            rng.normal(size=(V, B, D)).astype(np.float32),
            rng.normal(size=(V, B, D)).astype(np.float32))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("msg", ["mul", "add"])
@pytest.mark.parametrize("rel_form", ["shared", "per_batch"])
def test_partitioned_rspmm_matches_jax_single_device(n, msg, rel_form):
    """Forward, d_relation and dx of the kernel body (K1 and K2 or K3 a
    shard, their plain versions here), balanced and not."""
    ei, et, w = _edges(10 * n + (msg == "add"))
    rel, x, probe = _operands(n, rel_form)
    want = _jax_reference(ei, et, w, rel, x, msg, probe)
    for balanced in (False, True):
        lay = build_partitioned_rspmm_inputs(ei, et, V, R, n,
                                             balance=balanced)
        assert (lay.to_new is not None) == balanced
        got = _port(lambda w, r, xx: partitioned_rspmm(w, lay, r, xx,
                                                       msg=msg),
                    w, rel, x, probe)
        for name, a, b in zip(("out", "d_rel", "dx"), got, want):
            np.testing.assert_allclose(a, b, err_msg=f"{name} {balanced}",
                                       **TOL)


def test_partitioned_rspmm_with_an_empty_shard(monkeypatch):
    """No edge enters or leaves the last of 4 blocks: its shard launches
    nothing and gives zero rows; the result is still the JAX package's.
    Flat [V, F] operands."""
    ei, et, w = _edges(3, hub=False)
    ei = np.minimum(ei, 32)  # rows 33-42, the last block, lose their edges
    lay = build_partitioned_rspmm_inputs(ei, et, V, R, 4, balance=False)
    assert lay.v_block == 11 and lay.fwd_counts[3] == lay.rev_counts[3] == 0
    calls = []
    for name in ("rspmm_fwd_cuda", "rspmm_bwd_cuda"):
        real = getattr(part_mod, name)
        monkeypatch.setattr(part_mod, name, lambda *a, real=real, **k:
                            calls.append(1) or real(*a, **k))
    rel, x, probe = (a.reshape(a.shape[0], -1)
                     for a in _operands(3, "per_batch"))
    got = _port(lambda w, r, xx: partitioned_rspmm(w, lay, r, xx, msg="mul"),
                w, rel, x, probe)
    assert len(calls) == 2 * 3
    want = _jax_reference(ei, et, w, rel, x, "mul", probe)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert np.all(got[0][33:] == 0) and np.all(got[2][33:] == 0)


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_sharded_rspmm_pads_the_edges_to_the_shards(msg):
    """The ``xla`` body with E = 201 edges over 4 shards (three weight-0
    padding edges), both relation forms."""
    ei, et, w = _edges(7, num_edges=201)
    for rel_form in ("shared", "per_batch"):
        rel, x, probe = _operands(7, rel_form)
        want = _jax_reference(ei, et, w, rel, x, msg, probe)
        got = _port(lambda w, r, xx: sharded_rspmm(
            torch.from_numpy(ei), torch.from_numpy(et), w, r, xx, msg=msg,
            num_nodes=V, n_shards=4), w, rel, x, probe)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)


def test_partitioned_bf16_matches_jax_pallas():
    """``compute_dtype="bfloat16"`` on 3 shards (K1h and K2h's plain
    versions) against the JAX package's bf16 op on interpret-mode Pallas,
    distmult with a shared relation, as tests/test_torch_bf16.py holds the
    single-device op (transe's bf16 sums share the kernel body; its
    backward is K3 in fp32, held above)."""
    rng = np.random.default_rng(11)
    tri, w, layouts, graph = _op_graph(rng)
    nv, nr = graph.num_nodes, graph.num_relations
    part = build_partitioned_rspmm_inputs(tri[:, :2], tri[:, 2], nv, nr, 3)
    cases = [("mul", rng.normal(size=(nr, 4)).astype(np.float32),
              rng.normal(size=(nv, 2, 4)).astype(np.float32),
              rng.normal(size=(nv, 2, 4)).astype(np.float32))]

    def j_fn(arrays):
        results = []
        for (msg, *_), (rel, x, cot) in zip(cases, arrays):
            def f(rel, x, msg=msg):
                return j_rspmm(jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2]),
                               jnp.asarray(w), rel, x, msg=msg, num_nodes=nv,
                               impl="pallas", layouts=layouts,
                               compute_dtype=BF16)
            out, vjp = jax.vjp(f, rel, x)
            results.append((out, *vjp(cot)))
        return results

    want = _jax_exact(j_fn, [c[1:] for c in cases])
    for (msg, rel, x, cot), expected in zip(cases, want):
        got = _port(lambda w, r, xx: partitioned_rspmm(
            w, part, r, xx, msg=msg, compute_dtype=BF16), w, rel, x, cot)
        for a, b in zip(got, expected):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
        # the operands were rounded: the fp32 op differs by far more
        f32 = generalized_rspmm(graph.edge_index, graph.edge_type,
                                graph.edge_weight, torch.from_numpy(rel),
                                torch.from_numpy(x), msg=msg, num_nodes=nv)
        assert np.abs(f32.numpy() - got[0]).max() > 1e-3


# the towers' routes under an edge mesh: (entity rspmm_impl, relation
# tower edge-sharded, the op each route must call)
ROUTES = {
    "partitioned": ("auto", False, ("_PartitionedRspmm",)),
    "xla": ("xla", False, ("_ShardedRspmm",)),
    "relation_edge partitioned": ("auto", True, ("_PartitionedRspmm",)),
    "relation_edge ring": ("ring", True, ("_RingRspmm",)),
}


@pytest.fixture
def op_calls(monkeypatch):
    """The partitioned, sharded and ring ops' calls during the test, by
    name."""
    calls = []
    for mod, name in ((part_mod, "_PartitionedRspmm"),
                      (part_mod, "_ShardedRspmm"),
                      (ring_mod, "_RingRspmm"), (ring_mod, "_RingExtremum"),
                      (ring_mod, "_RingMaxMin"), (ring_mod, "_RingAddSq")):
        fn = getattr(mod, name)
        monkeypatch.setattr(fn, "apply", lambda *a, name=name, real=fn.apply:
                            calls.append(name) or real(*a))
    return calls


@pytest.mark.parametrize("route", list(ROUTES))
def test_ultra_under_an_edge_mesh_matches_jax_single_device(setup, op_calls,
                                                            route):
    """ULTRA (2x8 towers, tests/test_torch_ring_ultra.py's weights and
    data) with its entity tower, and its relation tower under
    ``relation_edge``, on an edge mesh of 4 shards: tail and head scores of
    8 test triples, then one loss step's loss and every gradient, against
    the JAX package's single-device model."""
    s = setup
    impl, relation_edge, ops = ROUTES[route]
    edge = dict(rspmm_impl=impl, edge_axis="edge", ring_exchange="rdma")
    entity = dataclasses.replace(s["tcfg"].entity, **edge)
    relation = s["tcfg"].relation
    if relation_edge:
        relation = dataclasses.replace(relation, **edge)
    tcfg = UltraConfig(entity=entity, relation=relation)
    model = Ultra(tcfg)  # the convs route by their own configs
    model.load_state_dict(s["model"].state_dict())
    mesh = make_mesh(edge=4, device="cpu")
    with use_mesh(mesh):
        task = TTask(s["tds"], tcfg, TaskConfig(), device="cpu")
        und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph,
                                              backward=True)
    assert (und.part_layouts is not None) == (impl == "auto")
    assert (rel_graph.part_layouts is not None) == (relation_edge
                                                    and impl == "auto")
    assert (rel_graph.ring_inputs is not None) == (impl == "ring")
    b = torch.from_numpy(s["test"].astype(np.int64))
    with use_mesh(mesh), torch.inference_mode():
        scores = task._eval_scores(model, task.fact_graph, rel_graph,
                                   b[:, 0], b[:, 1], b[:, 2], und)
    for got, want in zip(scores, s["scores"]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # 2 entity layers x (tail + head), and 2 relation layers for both
    assert set(op_calls) == set(ops)
    assert len(op_calls) == 4 + 2 * relation_edge
    with use_mesh(mesh):
        loss, _ = task.loss_step(
            model, None, s["batch"],
            neg=torch.from_numpy(s["neg"].astype(np.int64)))
        loss.backward()
    np.testing.assert_allclose(loss.item(), s["loss"], rtol=1e-5, atol=0)
    for name, p in model.named_parameters():
        want = s["grads"][name]
        err = ((p.grad - want).norm() / want.norm().clamp(min=1e-12)).item()
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("aggregate_func", ["sum", "mean", "pna"])
def test_edge_mesh_conv_raises_without_its_layouts(aggregate_func):
    """Under an edge mesh a conv on the kernels' route (``rspmm_impl``
    auto) whose graph lacks the per-shard CSRs raises and names what
    builds them: no plain route stands in for the partitioned kernels.
    Max needs none: off the ring it takes the single-device K4."""
    ei, et, w = _edges(3)
    g = Graph.from_triplets(np.concatenate([ei, et[:, None]], 1), V, R,
                            edge_weight=w).prepare_csr(backward=True)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(V, B * D)).astype(np.float32))

    def conv(aggregate_func):
        return GeneralizedRelationalConv(ConvConfig(
            input_dim=D, output_dim=D, num_relations=R, query_input_dim=D,
            aggregate_func=aggregate_func, rel_mode="embedding",
            edge_axis="edge"))

    with use_mesh(make_mesh(edge=4, device="cpu")):
        with pytest.raises(ValueError, match="prepare_csr_sharded"):
            conv_apply(conv(aggregate_func), g, x, x)
        conv_apply(conv("max"), g, x, x)


def test_eval_entry_point_builds_the_edge_layouts(setup, op_calls):
    """``ultra_eval_scores`` without a prepared ``fact_graph_und`` builds
    the layouts of the entity tower's impl under the active edge mesh
    (``propagation_graph``: here the per-shard CSRs) and scores 8 test
    triples as the JAX single-device model does."""
    s = setup
    entity = dataclasses.replace(s["tcfg"].entity, rspmm_impl="auto")
    tcfg = UltraConfig(entity=entity, relation=s["tcfg"].relation)
    model = Ultra(tcfg)
    model.load_state_dict(s["model"].state_dict())
    task = TTask(s["tds"], tcfg, TaskConfig(), device="cpu")
    _, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
    b = torch.from_numpy(s["test"].astype(np.int64))
    with use_mesh(make_mesh(edge=4, device="cpu")), torch.inference_mode():
        scores = ultra_eval_scores(model, task.fact_graph, rel_graph,
                                   b[:, 0], b[:, 1], b[:, 2])
    for got, want in zip(scores, s["scores"]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert set(op_calls) == {"_PartitionedRspmm"}


# run_full's edge routes: (rspmm_impl, the entity tower's aggregation,
# ring_exchange, the ops an eval batch calls: the entity tower's and the
# relation tower's, which aggregates by sum)
CLI_ROUTES = {
    "auto": ("auto", "sum", "rdma", {"_PartitionedRspmm"}),
    "auto pna": ("auto", "pna", "rdma", {"_PartitionedRspmm"}),
    "xla": ("xla", "sum", "rdma", {"_ShardedRspmm"}),
    "ring": ("ring", "sum", "rdma", {"_RingRspmm"}),
    "ring max ppermute": ("ring", "max", "ppermute",
                          {"_RingExtremum", "_RingRspmm"}),
    "ring pna": ("ring", "pna", "rdma",
                 {"_RingMaxMin", "_RingAddSq", "_RingRspmm"}),
}


@pytest.mark.parametrize("route", list(CLI_ROUTES))
def test_run_full_reaches_both_towers_routes(tmp_path, op_calls, route):
    """``run_full.main`` on config/synthetic/smoke.yaml with ``parallel:
    {edge: 4, relation_edge: true}``, no training and 8 triples a split:
    both towers on the partitioned kernels, the sharded ``xla`` body or
    the ring (max with ppermute, pna with rdma) under the edge mesh, the
    relation tower's graph with its own layouts; the metrics are
    finite."""
    import yaml

    from test_torch_ring_ultra import SMOKE

    from ultra_torchdrug_tpu_torch import run_full

    impl, aggregate, exchange, ops = CLI_ROUTES[route]
    cfg = yaml.safe_load(open(SMOKE).read().replace("{{ outdir }}",
                                                    str(tmp_path)))
    cfg.update(parallel={"edge": 4, "relation_edge": True}, rspmm_impl=impl,
               fast_test=8)
    cfg["task"]["model"].update(aggregate_func=aggregate,
                                ring_exchange=exchange)
    cfg["train"]["num_epoch"] = 0
    path = tmp_path / "smoke_edge.yaml"
    path.write_text(yaml.safe_dump(cfg))
    engine = run_full.main(["-c", str(path), "--device", "cpu"])
    model_cfg = engine.task.model_cfg
    for tower in (model_cfg.entity, model_cfg.relation):
        assert (tower.edge_axis, tower.rspmm_impl) == ("edge", impl)
    assert model_cfg.entity.aggregate_func == aggregate
    assert engine.mesh.edge == 4
    assert set(op_calls) == ops
    # an eval batch: 2 entity layers x (tail + head), one op a layer (two
    # for pna's pair and moments), and 2 relation layers
    per_batch = 2 * 2 * (2 if aggregate == "pna" else 1) + 2
    assert op_calls and len(op_calls) % per_batch == 0
    assert all(np.isfinite(v) for v in engine.metrics["test"].values())

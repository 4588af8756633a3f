"""Edge shards on several cards (parallel/mesh.py's placement), on a host
with two or more cards. Every test here is marked ``cuda`` and skips where
there is no card or only one; the decision is taken inside the ``cards``
fixture, at run time.

Run on a machine with four cards:
    python -m pytest -m cuda tests/test_torch_cards_cuda.py -q

K9 between cards copies bytes: it must equal its plain version (PyTorch's
copies) exactly, also over 200 back-to-back shifts of distinct fills read
after one synchronize (the ordering of each launch against the receiving
cards' streams, and the allocator's reuse of freed destination blocks).
Every edge path (partitioned, ``xla``, the ring's sums, max, min, PNA's
pair and moments) on several cards is held against the same path on one
card and on the CPU (see the test's docstring for each tolerance). The
partitioned path on several cards must give the one-card run's scores
bitwise (each shard's kernel computes the same rows from the same
copies). ULTRA's ring tower with its states kept on the shards' cards
(parallel/card_rows.py) is held, eval scores, loss and every gradient,
against one card and the CPU, and each card's state tensor must lie on
the card its shards name.
"""

import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu_torch.data.datasets import synthetic_transductive
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config,
    rel_nbfnet_config,
)
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig, ultra_init
from ultra_torchdrug_tpu_torch.parallel import rdma
from ultra_torchdrug_tpu_torch.parallel import ring_rspmm as ring_mod
from ultra_torchdrug_tpu_torch.parallel.card_rows import card_groups
from ultra_torchdrug_tpu_torch.parallel.mesh import make_mesh, use_mesh
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
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig, TransductiveKGTask

pytestmark = pytest.mark.cuda

V, E, R, B, D = 1003, 12000, 7, 4, 32


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs: edge shards on several "
                    "cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _shard_devices(cards, n):
    return [cards[s % len(cards)] for s in range(n)]


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_between_cards_matches_plain(cards, n, dtype):
    """Shards in turn over the cards (n = 5 on four cards puts shards 0
    and 4 on card 0, whose shift stays on the card): K9 equals the plain
    shift exactly, one launch a source card."""
    devices = _shard_devices(cards, n)
    blocks = [torch.randn((3636, 64), device=d).to(dtype) for d in devices]
    before = rdma.launches
    got = rdma.shift_blocks(blocks, devices)
    assert rdma.launches - before == len(set(devices))
    want = rdma.shift_blocks_plain(blocks, devices)
    torch.cuda.synchronize()
    for s in range(n):
        assert got[s].device == devices[s]
        assert torch.equal(got[s], want[s])


def test_k9_ordering_and_allocator(cards):
    """200 shifts back to back between cards, each of a distinct fill
    written just before it on the sending cards' streams, each result
    dropped at once (its block goes back to the receiving card's
    allocator while later shifts store to blocks of that memory), read
    after one synchronize: every kept result is exact."""
    devices = _shard_devices(cards, 4)
    rows, kept = 4096, {}
    blocks = [torch.empty((rows, 256), device=d) for d in devices]
    for i in range(200):
        for s, b in enumerate(blocks):
            b.fill_(float(i * 8 + s))
        out = rdma.shift_blocks(blocks, devices)
        if i % 20 == 19:
            kept[i] = out
    torch.cuda.synchronize()
    for i, out in kept.items():
        for s in range(4):
            want = float(i * 8 + (s - 1) % 4)
            assert bool((out[s] == want).all()), (i, s)


def _graph(seed):
    rng = np.random.default_rng(seed)
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    return Graph.from_triplets(tri, V, R, edge_weight=w), rng


def _run(path, g, devices, operands):
    """``path``'s outputs over 4 shards on ``devices`` (layouts placed by
    ``to_mesh``; the operands on devices[0]), and the gradients of
    Σ <probe_i, out_i> with respect to (relation, x), all on the CPU."""
    ei, et = g.edge_index.numpy(), g.edge_type.numpy()
    home = devices[0]
    w, rel, x, *probes = (t.to(home) for t in operands)
    if path.startswith("partitioned"):
        lay = build_partitioned_rspmm_inputs(ei, et, V, R, 4, balance=True)
        lay = lay.to_mesh(devices)

        def op(r, xx):
            return partitioned_rspmm(w, lay, r, xx, msg="mul")
    elif path == "xla":
        def op(r, xx):
            return sharded_rspmm(g.edge_index.to(home), g.edge_type.to(home),
                                 w, r, xx, msg="mul", num_nodes=V, n_shards=4,
                                 devices=devices)
    else:
        kind, exchange = path.split()[1:]
        ri = build_ring_rspmm_inputs(ei, et, V, 4, num_relations=R,
                                     pallas=kind == "sum", balance=True)
        ri = ri.to_mesh(devices)

        def op(r, xx):
            if kind == "pair":
                return ring_rspmm_maxmin(w, ri, r, xx, msg="mul",
                                         exchange=exchange)
            if kind == "moments":
                return ring_rspmm_addsq(w, ri, r, xx, exchange=exchange)
            return ring_rspmm(w, ri, r, xx, msg="mul",
                              agg="add" if kind == "sum" else kind,
                              exchange=exchange)
    rel, x = rel.clone().requires_grad_(), x.clone().requires_grad_()
    out = op(rel, x)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum((o * p).sum() for o, p in zip(out, probes))
    grads = torch.autograd.grad(loss, (rel, x))
    return [t.detach().cpu() for t in (*out, *grads)], len(out)


# every edge path: the partitioned kernels (K1 forward, K2 backward), the
# ``xla`` body, and the ring's sums (K1/K2 a bucket) with both exchanges,
# its max and min, PNA's pair and its moments
PATHS = ["partitioned", "xla", "ring sum rdma", "ring sum ppermute",
         "ring max rdma", "ring min ppermute", "ring pair rdma",
         "ring moments rdma"]


@pytest.mark.parametrize("path", PATHS)
def test_edge_paths_on_cards_match_one_card_and_the_cpu(cards, path):
    """4 shards over the cards against the same 4 shards on card 0 and on
    the CPU, forward and gradients, from one set of seeded numpy operands.
    The CPU run is the per-shard code with every shard on the CPU and the
    kernels' plain versions, which tests/test_torch_mesh_cards.py holds
    against the JAX package's single-device op (the card's machine has no
    JAX). The partitioned path's outputs on the cards equal one card's
    bitwise; extrema equal the CPU's exactly (the same fp32 products,
    folded by max or min); sums within 1e-5 (the same products summed in
    another order), gradients 1e-4 norm-wise (the card-vs-CPU gradient
    limit: d_relation sums some 1,700 edges a relation, where the
    moments' squared terms cancel, and the card adds them atomically in
    any order)."""
    g, rng = _graph(7)
    k = 2 if path.split()[1:2] in (["pair"], ["moments"]) else 1
    operands = [g.edge_weight] + [
        torch.from_numpy(rng.normal(size=s).astype(np.float32))
        for s in [(R, B, D), (V, B, D)] + [(V, B, D)] * k]
    if "max" in path or "min" in path or "pair" in path:
        # no ties: distinct products, none of them 0
        operands[2] = operands[2] + 3.0
    many, n_out = _run(path, g, _shard_devices(cards, 4), operands)
    one, _ = _run(path, g, [cards[0]] * 4, operands)
    cpu, _ = _run(path, g, [torch.device("cpu")] * 4, operands)
    for ref in (one, cpu):
        for i, (a, b) in enumerate(zip(many, ref)):
            if i < n_out and (path == "partitioned" and ref is one
                              or path.split()[1:2] in (["max"], ["min"],
                                                       ["pair"])):
                assert torch.equal(a, b), (path, i)
            elif i < n_out:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            else:
                err = float((a - b).norm() / b.norm())
                assert err <= 1e-4, (path, i, err)


def _ultra_ring(devices, model, dataset, cfg, batch, neg, test):
    """ULTRA's eval scores of ``test``, loss and gradients of one step on
    ``batch`` with ``neg``, its entity tower on the ring over 4 shards on
    ``devices`` (a pinned device or one a shard) with ``model``'s weights;
    each ring op's (layout, the cards' state tensors' devices)."""
    mesh = (make_mesh(edge=4, device=devices) if isinstance(devices, str)
            else make_mesh(edge=4, devices=devices))
    home = mesh.device
    model = model.to(home)
    calls = []
    real = ring_mod._RingRspmm.apply
    ring_mod._RingRspmm.apply = lambda *a: calls.append(
        (a[1], [t.device for t in a[7:]])) or real(*a)
    try:
        with use_mesh(mesh):
            task = TransductiveKGTask(dataset, cfg, TaskConfig(),
                                      device=home)
            b = torch.from_numpy(test.astype(np.int64)).to(home)
            with torch.inference_mode():
                und, rel_graph = task._prepare_graphs(task.fact_graph,
                                                      task.rel_graph)
                scores = task._eval_scores(model, task.fact_graph, rel_graph,
                                           b[:, 0], b[:, 1], b[:, 2], und)
            model.zero_grad(set_to_none=True)
            loss, _ = task.loss_step(model, None, batch, neg=neg.to(home))
            loss.backward()
    finally:
        ring_mod._RingRspmm.apply = real
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return ([s.cpu() for s in scores], loss.item(), grads, calls)


@pytest.mark.parametrize("exchange", ["rdma", "ppermute"])
def test_ultra_ring_states_on_the_cards(cards, exchange):
    """ULTRA 2x32 (4 shards over the cards, the rdma or ppermute ring,
    balance "auto") against 4 shards on card 0 and on the CPU: eval scores
    1e-4, the loss 1e-5 relative and every gradient 1e-4 norm-wise (the
    card-vs-CPU limits); every ring op takes a state tensor a card, on the
    card of that card's shards (``card_groups``)."""
    dataset = synthetic_transductive("SynthKG", 1003, 12000, 7, seed=0)
    cfg = UltraConfig(
        entity=entity_nbfnet_config(
            input_dim=32, hidden_dims=(32, 32), num_relations=14,
            rspmm_impl="ring", edge_axis="edge", ring_exchange=exchange),
        relation=rel_nbfnet_config(input_dim=32, hidden=32, num_layers=2))
    model = ultra_init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    batch = dataset.train[rng.choice(len(dataset.train), 8, replace=False)]
    neg = torch.from_numpy(rng.integers(0, 1003, (8, 16)))
    test = dataset.test[:8]
    devices = _shard_devices(cards, 4)
    many = _ultra_ring(devices, model, dataset, cfg, batch, neg, test)
    groups = card_groups(devices)
    assert many[3] and all(
        layout.devices == tuple(devices) and layout.groups == groups
        and placed == [devices[g[0]] for g in groups]
        for layout, placed in many[3])
    for ref in (_ultra_ring("cuda:0", model, dataset, cfg, batch, neg, test),
                _ultra_ring("cpu", model, dataset, cfg, batch, neg, test)):
        assert all(len(placed) == 1 for _, placed in ref[3])
        for got, want in zip(many[0], ref[0]):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert abs(many[1] - ref[1]) <= 1e-5 * abs(ref[1])
        for name, want in ref[2].items():
            err = float((many[2][name] - want).norm()
                        / want.norm().clamp(min=1e-12))
            assert err <= 1e-4, (exchange, name, err)

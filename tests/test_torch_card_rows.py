"""The ring's block-domain states kept on the shards' cards
(parallel/card_rows.py; the entity tower of models/nbfnet.py and
models/layers.py over ``CardRows``) on the CPU.

The state type's grouping, its blocks, its row-wise map and the round trip
through the home; then ULTRA (2x8 towers) on the smoke-size KG of
tests/test_torch_ring_ultra.py, its entity tower on a balanced,
permuted-IO ring, against the JAX package's single-device ULTRA on the same
weights (``load_jax_params``). Every case runs twice: with every shard on
the CPU (one tensor, the block-domain state itself) and with one tensor a
shard, forced by monkeypatching the grouping rule
(``card_rows.card_groups``), which runs the arithmetic of several cards on
one CPU: the per-card updates, the parameters' copies, the per-card
boundary and readout and PNA's global scale. A spy shows that the tower
then forms no state of the block domain's rows on the home, and a copy of
the tower mutated to normalise PNA's scale per card fails against JAX. The
tower on several cards runs on the card (tests/test_torch_cards_cuda.py,
``chip_smoke.py`` phases 52-53).

The JAX references: XLA for the sums (sum, mean, transe, two relation
towers), interpret-mode Pallas for max and pna (whose tie convention the
ring shares: every tied edge takes all of the gradient) and for bf16
operands (compiled with ``xla_allow_excess_precision`` off, as in
tests/test_torch_bf16.py, so that XLA keeps the kernel's bf16 rounding).

Tolerances, each with its reason: eval scores 1e-5 and the loss 1e-5
relative, as in tests/test_torch_ring_ultra.py (fp32 sums in another
order: ring steps, buckets, segment_sum); every gradient 1e-4 norm-wise
(‖a - b‖ / ‖b‖), two stacked layers' sums and their backward in another
order; pna's gradients too, well inside ``chip_smoke.py``'s
PNA_RING_GRAD_RTOL (2e-3, the card against the single device); bf16
operands 1e-4 throughout, as tests/test_torch_bf16.py holds the bf16 tower
(a bf16 rounding of a layer's input that falls on the other side of a
rounding boundary in the two packages moves a value by 2^-8 of itself).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ring_ultra import one_torch_thread  # noqa: F401  (a fixture)
from torch.utils._python_dispatch import TorchDispatchMode

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_eval
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.models.ultra import ultra_train_scores as j_train
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import _criterion_loss as j_criterion
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.models import layers, nbfnet
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.parallel import card_rows
from ultra_torchdrug_tpu_torch.parallel import ring_rspmm as ring_mod
from ultra_torchdrug_tpu_torch.parallel.card_rows import (
    CardLayout,
    CardRows,
    card_groups,
)
from ultra_torchdrug_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_cards,
    use_mesh,
)
from ultra_torchdrug_tpu_torch.tasks.task import TaskConfig as TTaskConfig
from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask as TTask
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

NUM_NODES, NUM_EDGES, NUM_REL, DIM = 46, 320, 5, 8
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
BF16_TOL = 1e-4
RING = dict(rspmm_impl="ring", edge_axis="edge")
CPU = torch.device("cpu")
MIXED = [torch.device(d) for d in ("cpu", "meta", "cpu", "meta")]
EXACT_XLA = {"xla_allow_excess_precision": False}


def _per_shard(devices):
    """The forced grouping: one tensor a shard, whatever its device."""
    return tuple((s,) for s in range(len(devices)))


@pytest.fixture(params=["one", "per_shard"])
def grouping(request, monkeypatch):
    """Every shard on the CPU as one tensor, or one tensor a shard."""
    if request.param == "per_shard":
        monkeypatch.setattr(card_rows, "card_groups", _per_shard)
    return request.param


# ---------------------------------------------------------------------------
# the state type
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count,want", [
    (4, ((0,), (1,), (2,), (3,))),
    (2, ((0, 2), (1, 3))),
    (1, ((0, 1, 2, 3),)),
])
def test_card_groups_follow_the_placement_rule(count, want):
    """Four shards placed by ``shard_cards`` on four, two and one cards:
    a card's shards in shard order, card 0 first (edge 4 on 2 cards puts
    shards 0 and 2 on card 0)."""
    devices = [torch.device("cuda", c) for c in shard_cards(0, 4, count)]
    assert card_groups(devices) == want
    layout = CardLayout.of(devices, 5)
    assert layout.cards[0] == layout.home == devices[0]
    assert [layout.rows(c) for c in range(count)] == [5 * len(g)
                                                      for g in want]
    for s in range(4):
        c, i = layout.place(s)
        assert want[c][i] == s


def test_card_rows_on_mixed_devices():
    """Shards on alternating ``cpu``/``meta`` devices: each card's tensor
    on its device, a shard's block a view of its card's rows, the map run
    once a card with per-card constants beside it."""
    layout = CardLayout.of(MIXED, 3)
    assert layout.groups == ((0, 2), (1, 3))
    full = torch.arange(12 * 2, dtype=torch.float32).reshape(12, 2)
    rows = CardRows.from_home(full, layout)
    assert [t.device for t in rows.tensors] == [CPU, torch.device("meta")]
    assert rows.shape == (12, 2)
    # card 0 holds shards 0 and 2 in shard order
    assert torch.equal(rows.tensors[0], torch.cat([full[0:3], full[6:9]]))
    for s in range(4):
        assert rows.block(s).device == MIXED[s]
        assert rows.block(s).shape == (3, 2)
    assert rows.block(2).data_ptr() == rows.tensors[0][3:].data_ptr()
    doubled = rows.map(lambda t, k: t * k, consts=(layout.replicate(
        torch.tensor(2.0)),))
    assert torch.equal(doubled.tensors[0], 2 * rows.tensors[0])
    assert doubled.tensors[1].device == torch.device("meta")
    with pytest.raises(ValueError, match="expected 6 rows on meta"):
        CardRows(layout, (rows.tensors[0], rows.tensors[0]))


@pytest.mark.parametrize("rule", ["one", "two", "per_shard"])
def test_card_rows_round_trip_on_the_cpu(monkeypatch, rule):
    """Four shards on the CPU grouped as one tensor, two cards in turn or
    one tensor a shard: blocks, map, ``locate``, ``cut``/``join`` and the
    round trip through the home are exact, and gradients flow back through
    the cut."""
    if rule == "two":
        monkeypatch.setattr(card_rows, "card_groups", lambda d: ((0, 2),
                                                                 (1, 3)))
    elif rule == "per_shard":
        monkeypatch.setattr(card_rows, "card_groups", _per_shard)
    layout = CardLayout.of([CPU] * 4, 3)
    full = torch.randn(12, 5, requires_grad=True)
    rows = CardRows.from_home(full, layout)
    if rule == "one":
        assert rows.tensors[0] is full
    for s in range(4):
        assert torch.equal(rows.block(s), full[3 * s:3 * s + 3])
    assert torch.equal(rows.map(torch.add, rows).to_home(), 2 * full)
    card, local = layout.locate(torch.arange(12))
    for r in range(12):
        assert torch.equal(rows.tensors[card[r]][local[r]], full[r])
    cols = layout.join([t.T for t in rows.tensors], dim=1)
    assert torch.equal(cols, full.T)
    (rows.to_home() * torch.arange(12.0)[:, None]).sum().backward()
    assert torch.equal(full.grad, torch.arange(12.0)[:, None].expand(12, 5))


# ---------------------------------------------------------------------------
# ULTRA on the smoke-size KG against the JAX single device
# ---------------------------------------------------------------------------

# the JAX references: their entity tower's options, the route (XLA, or
# interpret-mode Pallas with the kernels' tie convention and bf16 rounding)
# and UltraConfig's options
REFERENCES = {
    "sum": ({}, "xla", {}),
    "mean": (dict(aggregate_func="mean"), "xla", {}),
    "max": (dict(aggregate_func="max"), "pallas", {}),
    "pna": (dict(aggregate_func="pna"), "pallas", {}),
    "transe": (dict(message_func="transe"), "xla", {}),
    "bf16": (dict(compute_dtype="bfloat16"), "pallas", {}),
    "towers": ({}, "xla", dict(num_rel_models=3)),
    "concat": (dict(concat_hidden=True), "xla", {}),
}
# case: (reference, shards, exchange, the port's other entity options)
CASES = {
    "sum-3": ("sum", 3, "rdma", {}),
    "sum-4": ("sum", 4, "rdma", {}),
    "ppermute": ("sum", 3, "ppermute", {}),
    "remat_full": ("sum", 4, "rdma", dict(remat="full")),
    "save_rspmm": ("sum", 3, "ppermute", dict(remat="save_rspmm")),
    "micro_batch": ("sum", 4, "rdma", dict(micro_batch=2)),
    "score_chunk": ("sum", 3, "rdma", dict(score_chunk=5)),
    "mean": ("mean", 3, "rdma", {}),
    "max": ("max", 4, "rdma", {}),
    "pna": ("pna", 4, "ppermute", {}),
    "transe": ("transe", 3, "rdma", {}),
    "bf16": ("bf16", 4, "rdma", {}),
    "towers": ("towers", 3, "rdma", {}),
    "concat_hidden": ("concat", 4, "ppermute", {}),
}


@pytest.fixture(scope="module")
def kg():
    jds = j_synth("SynthKG", NUM_NODES, NUM_EDGES, NUM_REL, seed=0)
    tds = t_synth("SynthKG", NUM_NODES, NUM_EDGES, NUM_REL, seed=0)
    jfact, train = jds.fact_graph(None)
    rng = np.random.default_rng(3)
    return dict(jds=jds, tds=tds, jfact=jfact,
                jrel=j_relgraph(jfact).prepare_dense(),
                batch=train[rng.choice(len(train), 6, replace=False)],
                neg=rng.integers(0, NUM_NODES, (6, 9)).astype(np.int32),
                test=jds.test[:8])


def _jit(fn, exact, *args):
    if exact:
        return jax.jit(fn).lower(*args).compile(
            compiler_options=EXACT_XLA)(*args)
    return jax.jit(fn)(*args)


@pytest.fixture(scope="module")
def references(kg):
    """The JAX single device's eval scores, loss and gradients of each
    reference, computed at first use and kept for the module."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        entity, route, ultra = REFERENCES[name]
        jcfg = JUltraConfig(
            entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM, DIM),
                             num_relations=2 * NUM_REL, rspmm_impl=route,
                             **entity),
            relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2),
            **ultra)
        params = ultra_init(jax.random.PRNGKey(0), jcfg)
        und = {}
        if route == "pallas":
            und = dict(fact_graph_und=kg["jfact"].undirected_with_inverse()
                       .prepare_pallas(interleave=8, **(
                           dict(bwd_block_rows=256)
                           if entity.get("aggregate_func") == "pna"
                           else {})))
        exact = "compute_dtype" in entity
        test, batch = kg["test"], kg["batch"]
        scores = _jit(lambda p, h, t, r: j_eval(
            p, jcfg, kg["jfact"], kg["jrel"], h, t, r, **und), exact, params,
            *(jnp.asarray(test[:, i]) for i in range(3)))

        def j_loss(p):
            s = j_train(p, jcfg, kg["jfact"], kg["jrel"],
                        *(jnp.asarray(batch[:, i]) for i in range(3)),
                        jnp.asarray(kg["neg"]), **und)
            return j_criterion(JTaskConfig(), s, None)

        loss, grads = _jit(jax.value_and_grad(j_loss), exact, params)
        cache[name] = dict(
            params=jax.tree_util.tree_map(np.asarray, params), ultra=ultra,
            entity=entity, scores=[np.asarray(a) for a in scores],
            loss=float(loss), grads=jax_params_to_state_dict(
                jax.tree_util.tree_map(np.asarray, grads)))
        return cache[name]

    return get


@pytest.fixture
def forced_balance(monkeypatch):
    """The degree-balanced relabelling forced on (the task asks for
    "auto", which this near-uniform graph does not need), so that the
    boundary and the readout go through to_new."""
    monkeypatch.setattr(ring_mod, "resolve_balance", lambda *a: True)


@pytest.fixture
def ring_ops(monkeypatch):
    """Each ring op's call: (op, the CardRows layout, the cards' x
    tensors' shapes)."""
    calls = []
    for name, before in (("_RingRspmm", 7), ("_RingExtremum", 7),
                         ("_RingMaxMin", 6), ("_RingAddSq", 5)):
        fn = getattr(ring_mod, name)
        monkeypatch.setattr(fn, "apply", lambda *a, real=fn.apply, name=name,
                            before=before: calls.append(
                                (name, a[1], [tuple(t.shape)
                                              for t in a[before:]]))
                            or real(*a))
    return calls


def _port_task(kg, ref, n, exchange, options):
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM, DIM),
                         num_relations=2 * NUM_REL, ring_exchange=exchange,
                         **RING, **ref["entity"], **options),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2),
        **ref["ultra"])
    model = load_jax_params(Ultra(tcfg), ref["params"])
    mesh = make_mesh(edge=n, device="cpu")
    with use_mesh(mesh):
        task = TTask(kg["tds"], tcfg, TTaskConfig(), device="cpu")
    return task, model, mesh


def _port_eval(kg, task, model, mesh):
    b = torch.from_numpy(kg["test"].astype(np.int64))
    with use_mesh(mesh), torch.inference_mode():
        und, rel_graph = task._prepare_graphs(task.fact_graph, task.rel_graph)
        scores = task._eval_scores(model, task.fact_graph, rel_graph,
                                   b[:, 0], b[:, 1], b[:, 2], und)
    return und, scores


def _port_step(kg, task, model, mesh):
    model.zero_grad(set_to_none=True)
    with use_mesh(mesh):
        loss, _ = task.loss_step(model, None, kg["batch"],
                                 neg=torch.from_numpy(
                                     kg["neg"].astype(np.int64)))
        loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _grad_gaps(got, want) -> dict:
    assert set(got) == set(want)
    return {k: ((got[k] - w).norm() / w.norm().clamp(min=1e-12)).item()
            for k, w in want.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_ultra_on_the_cards_matches_jax_single_device(
        kg, references, grouping, forced_balance, ring_ops, monkeypatch,
        case):
    """ULTRA's eval scores, loss and every gradient through the tower kept
    on the cards (one tensor, or one a shard) against the JAX single
    device. Each ring op takes the cards' tensors: one of the whole block
    domain, or one of v_block rows a shard."""
    name, n, exchange, options = CASES[case]
    ref = references(name)
    checkpoints, chunks = [], []
    real_checkpoint, real_rows = nbfnet.checkpoint, nbfnet._score_rows
    monkeypatch.setattr(nbfnet, "checkpoint", lambda *a, **k: (
        checkpoints.append(a[0]) or real_checkpoint(*a, **k)))
    monkeypatch.setattr(nbfnet, "_score_rows", lambda *a: (
        chunks.append(a[3]) or real_rows(*a)))
    task, model, mesh = _port_task(kg, ref, n, exchange, options)
    und, (tt, th) = _port_eval(kg, task, model, mesh)
    ri = und.ring_inputs
    assert ri.n_shards == n and ri.permuted_io and ri.to_new is not None
    cards = 1 if grouping == "one" else n
    assert ring_ops and all(
        layout.devices == ri.devices and len(shapes) == cards
        and all(s[0] == ri.v_pad // cards for s in shapes)
        for _, layout, shapes in ring_ops)
    bf16 = REFERENCES[name][0].get("compute_dtype") == "bfloat16"
    tol = dict(rtol=BF16_TOL, atol=BF16_TOL) if bf16 else SCORE_TOL
    jt, jh = ref["scores"]
    np.testing.assert_allclose(tt.numpy(), jt, **tol)
    np.testing.assert_allclose(th.numpy(), jh, **tol)
    loss, grads = _port_step(kg, task, model, mesh)
    np.testing.assert_allclose(loss, ref["loss"], rtol=tol["rtol"], atol=0)
    gaps = _grad_gaps(grads, ref["grads"])
    worst = max(gaps.values())
    assert worst <= (BF16_TOL if bf16 else GRAD_RTOL), gaps
    if "remat" in options:
        assert checkpoints  # the layer stack ran under its checkpoints
    if "micro_batch" in options:
        assert len(checkpoints) == len(kg["batch"]) // 2
    # the all-entity head ran on each card's rows, in chunks when asked
    assert chunks and set(chunks) == {options.get("score_chunk", 0)}


class _RowSpy(TorchDispatchMode):
    """Every operation's outputs of ``rows`` rows, or ``rows * B`` rows (a
    [V*B, D] view) for the batch sizes ``batches``, and at least ``width``
    features: a node state of the whole block domain."""

    def __init__(self, rows, width, batches):
        super().__init__()
        self.rows = {rows} | {rows * b for b in batches}
        self.width, self.seen = width, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and t.shape[0] in self.rows
                    and t.shape[-1] >= self.width):
                self.seen.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("name", ["sum", "pna"])
def test_no_block_domain_state_on_the_home(kg, references, forced_balance,
                                           ring_ops, monkeypatch, name):
    """With one tensor a shard, an eval batch and a step form no tensor
    of the block domain's rows (nor a [rows * B, D] view): the ring ops
    neither cut a home tensor (``_to_blocks``, ``CardRows.from_home``) nor
    bring one home (``to_home``, ``_from_blocks``), and keep no home-side
    block helpers; every state stays in its shard's v_block rows."""
    assert not any(hasattr(ring_mod, name) for name in (
        "blocks_on", "home_buffer", "collect"))
    home_calls = []
    for owner, attr in ((ring_mod, "_to_blocks"), (ring_mod, "_from_blocks"),
                        (CardRows, "to_home")):
        real = getattr(owner, attr)
        monkeypatch.setattr(owner, attr, lambda *a, real=real, attr=attr: (
            home_calls.append(attr) or real(*a)))
    real_from_home = CardRows.from_home.__func__
    monkeypatch.setattr(CardRows, "from_home", classmethod(
        lambda cls, *a: home_calls.append("from_home")
        or real_from_home(cls, *a)))
    task, model, mesh = _port_task(kg, references(name), 4, "rdma", {})
    with use_mesh(mesh):
        und, _ = task._prepare_graphs(task.fact_graph, task.rel_graph)
    v_pad = und.ring_inputs.v_pad
    # eval batches of 8 queries, train batches of 6 (12 flipped)
    batches = (6, 8, 12)
    with _RowSpy(v_pad, DIM, batches) as seen_whole:
        _port_eval(kg, task, model, mesh)
    # with every shard on the CPU as one tensor the spy sees the states
    assert seen_whole.seen
    monkeypatch.setattr(card_rows, "card_groups", _per_shard)
    ring_ops.clear()
    with _RowSpy(v_pad, DIM, batches) as spy:
        _port_eval(kg, task, model, mesh)
        _port_step(kg, task, model, mesh)
    assert ring_ops and all(len(shapes) == 4 for _, _, shapes in ring_ops)
    assert not home_calls
    assert not spy.seen, spy.seen[:5]


def _per_card_pna_constants(cfg, graph, ring):
    """A mutant of ``layers._row_constants``: PNA's log-degree scale
    normalised by its mean over each card's own real rows (the trap of a
    per-card mean) in place of the whole graph's."""
    consts = REAL_ROW_CONSTANTS(cfg, graph, ring)
    if ring is None or not cfg.aggregate_func.startswith("pna"):
        return consts
    degree = consts[0]
    layout = CardLayout.of(ring.devices, ring.v_block)
    old = (torch.arange(ring.v_pad) if ring.to_old is None else ring.to_old)
    real = (old < graph.num_nodes).to(degree.dtype)[:, None]
    scales = [layers.pna_scales(d, float(r.sum())) for d, r in zip(
        layout.cut(degree), layout.cut(real))]
    return degree, layout.join(scales)


REAL_ROW_CONSTANTS = layers._row_constants


def test_pna_scale_is_the_whole_graphs_mean(kg, references, forced_balance,
                                            monkeypatch):
    """PNA's scale is normalised by its mean over the whole graph's real
    nodes: on the smoke-size KG the blocks' mean log-degrees differ, the
    tower with one tensor a shard matches JAX, and a copy mutated to take
    each card's own mean does not (the test sees the trap)."""
    monkeypatch.setattr(card_rows, "card_groups", _per_shard)
    ref = references("pna")
    task, model, mesh = _port_task(kg, ref, 4, "rdma", {})
    und, (tt, _) = _port_eval(kg, task, model, mesh)
    ri = und.ring_inputs
    degree = layers.block_degree(und, ri)
    real = ri.to_old < NUM_NODES
    means = [float(torch.log(degree[s * ri.v_block:(s + 1) * ri.v_block])
                   [real[s * ri.v_block:(s + 1) * ri.v_block]].mean())
             for s in range(4)]
    assert max(means) - min(means) > 0.05, means
    np.testing.assert_allclose(tt.numpy(), ref["scores"][0], **SCORE_TOL)
    monkeypatch.setattr(layers, "_row_constants", _per_card_pna_constants)
    _, (mt, _) = _port_eval(kg, task, model, mesh)
    gap = float(np.abs(mt.numpy() - ref["scores"][0]).max())
    print(f"per-card PNA scale: the blocks' mean log-degree {means}; the "
          f"mutant's tail scores differ from JAX by {gap:.3g} at most")
    assert gap > 100 * SCORE_TOL["atol"], gap
    loss, grads = _port_step(kg, task, model, mesh)
    gaps = _grad_gaps(grads, ref["grads"])
    assert abs(loss - ref["loss"]) > 1e-5 * abs(ref["loss"]) or max(
        gaps.values()) > GRAD_RTOL


def test_states_on_the_cards_need_the_ring(kg, references):
    """A conv given states kept on the cards where its route is not the
    ring raises rather than mixing the block domain with original rows."""
    task, model, mesh = _port_task(kg, references("sum"), 4, "rdma", {})
    with use_mesh(mesh):
        und, _ = task._prepare_graphs(task.fact_graph, task.rel_graph)
    cfg = dataclasses.replace(model.model.layers[0].cfg, rspmm_impl="auto")
    ri = und.ring_inputs
    x = CardRows.from_home(torch.zeros(ri.v_pad, DIM),
                           CardLayout.of(ri.devices, ri.v_block))
    conv = layers.GeneralizedRelationalConv(cfg)
    with use_mesh(mesh), pytest.raises(ValueError, match="take the ring"):
        layers.conv_aggregate(conv, und, x, rel_injected=torch.zeros(
            2 * NUM_REL, DIM), block_domain=True)

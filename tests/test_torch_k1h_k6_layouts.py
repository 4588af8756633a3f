"""The layouts of K1h (the bf16 sum forward, csrc/rspmm_fwd.cu on
csrc/rspmm_staged.cuh) and K6 (the PNA max/min forward, csrc/rspmm_pna_fwd.cu)
on the CPU. Both run over K1's destination rows cut into 256-edge segments
(data/graph.py::build_csr's ``seg_*`` and ``long_*``): each segment's
edges in edge order, written to its row, or for a row of more than 256
edges to a partial row, which a second kernel combines in segment order.

K1h: the operands rounded to bf16 and widened to fp32, each message
rel ⊙ x (or rel + x) formed in fp32 and rounded to bf16, then weighted and
summed in fp32; the long rows' partial rows summed in segment order. Held
to ``rspmm_fwd_bf16_plain`` within K1h's tolerance (rtol = atol = 1e-5)
plus 8 fp32 ulps of each entry's absolute mass (the sums run in another
order; diagnostics/timing.py's allowance for hub rows).

K6: m = (rel ⊙ x) · w (or (rel + x) · w) in fp32, the max and the min of a
segment's messages, a segment without edges 0 in both planes, and a long
row's partial maxima and minima combined by max and min in segment order.
Held to ``pna_fwd_plain`` exactly under ``==`` (a zero's sign may differ
where a weight-0 edge's -0 meets a +0). The extrema this order gives feed
K6b's plain version to the same gradients as the plain forward's do, so
K6b's gate m == mx[v] sees the new layout's ties as before.

The graphs have rows of 256, 257 and 700 edges, rows without edges, a
relation without edges, weight-0 edges and duplicated edges (their
messages tie exactly); x is post-ReLU for K6, so that many messages are 0.

Last, the port's ops on such a hub graph against the JAX package's on
interpret-mode Pallas, with both gradients: ``generalized_rspmm`` with
``compute_dtype="bfloat16"`` (K1h forward on the card; the JAX reference
compiled with ``xla_allow_excess_precision`` off, as tests/test_torch_bf16.py
runs it; rtol = atol = 1e-5) and ``generalized_rspmm_maxmin`` (K6 and K6b on
the card; the extrema exactly, the gradients within rtol 1e-6, atol 1e-5,
as tests/test_torch_pna_layouts.py holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_maxmin as j_maxmin
from ultra_torchdrug_tpu_torch.data.graph import (
    SEGMENT_EDGES,
    Graph,
    build_csr,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    generalized_rspmm,
    generalized_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.ops.rspmm_cuda import rspmm_fwd_bf16_plain
from ultra_torchdrug_tpu_torch.ops.rspmm_pna_cuda import (
    pna_bwd_plain,
    pna_fwd_plain,
)

MODES = ("mul_rel", "add_rel")
F = 16
MASS_ULPS = 8 * np.finfo(np.float32).eps
BF16 = "bfloat16"
EXACT_XLA = {"xla_allow_excess_precision": False}


def _edges(rng, V, E, R, rows=(), empty_rows=0, empty_rel=False,
           duplicated=40):
    """E edges over V rows and R relations; ``rows`` lists (row, in-edges,
    out-edges) to plant, whose other ends, like both ends of the remaining
    edges, are drawn from the rows not planted and not among the last
    ``empty_rows``; with ``empty_rel`` the last relation has no edge; the
    last ``duplicated`` edges repeat the first unplanted ones. Returns
    (src, dst, et, the index of the edge each repeats or -1)."""
    planted = [row for row, _, _ in rows]
    others = np.setdiff1d(np.arange(V - empty_rows), planted)
    src = rng.choice(others, E)
    dst = rng.choice(others, E)
    et = rng.integers(0, R - 1 if empty_rel else R, E)
    at = 0
    for row, n_in, n_out in rows:
        dst[at:at + n_in] = row
        src[at + n_in:at + n_in + n_out] = row
        at += n_in + n_out
    copy_of = np.full(E, -1)
    copy_of[E - duplicated:] = np.arange(at, at + duplicated)
    for a in (src, dst, et):
        a[E - duplicated:] = a[at:at + duplicated]
    return src, dst, et, copy_of


CASES = {
    "rows of 256 and 257 edges": dict(
        V=600, E=3000, R=5, rows=((3, 256, 0), (9, 257, 0))),
    "700-edge hub, empty rows and relation": dict(
        V=3000, E=4000, R=6, rows=((17, 700, 0),), empty_rows=5,
        empty_rel=True),
    "one relation, no long row": dict(V=300, E=2000, R=1),
}


def _case(rng, case, relu=False):
    """The case's CSR (eid a permutation), masked weights (duplicated edges
    keep their original's), rel and x ~ N(0, 1) (x post-ReLU with
    ``relu``) as numpy float32, and the CSR's fields as numpy."""
    spec = dict(CASES[case])
    V, E, R = spec.pop("V"), spec.pop("E"), spec.pop("R")
    src, dst, et, copy_of = _edges(rng, V, E, R, **spec)
    ids = rng.permutation(E)  # eid not the identity
    csr = build_csr(src, dst, et, V, R, backward=True, edge_ids=ids)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    dup = copy_of >= 0
    w[ids[dup]] = w[ids[copy_of[dup]]]
    rel, x = (rng.normal(size=s).astype(np.float32) for s in ((R, F), (V, F)))
    if relu:
        x = np.maximum(x, 0)
    n = {k: v.numpy() for k, v in vars(csr).items() if v is not None}
    for row, n_in, _ in spec.get("rows", ()):
        assert (row in n["long_rows"]) == (n_in > SEGMENT_EDGES)
    return csr, n, w, rel, x


def _bf16(a):
    """a rounded to bf16 (to nearest, ties to even) and widened to fp32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _by_segments(n, width, segment, combine, empty):
    """A pass over the destination rows' segments [rows, width]:
    ``segment(a, b)`` of each segment's edges [a, b), written to its row or
    to its partial slot, then each long row's partial rows folded by
    ``combine`` in segment order. Checks that each segment holds at most
    SEGMENT_EDGES edges of its row, that every row is written once and
    that rows without edges hold ``empty``."""
    seg_ptr, seg_out = n["seg_ptr"], n["seg_out"]
    long_rows, long_ptr = n["long_rows"], n["long_ptr"]
    degree = np.diff(n["rowptr"])
    row_of = np.repeat(np.arange(len(degree)), degree)
    out = np.full((len(degree), width), np.nan, np.float32)
    partial = np.zeros((max(long_ptr[-1], 1), width), np.float32)
    long_of = {}
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        assert b - a >= 2
        long_of.update({p: row for p in range(a, b)})
    for i in range(len(seg_out)):
        a, b = seg_ptr[i], seg_ptr[i + 1]
        row = seg_out[i] if seg_out[i] >= 0 else long_of[~seg_out[i]]
        assert b - a <= SEGMENT_EDGES
        assert np.all(row_of[a:b] == row)
        if seg_out[i] >= 0:
            out[row] = segment(a, b)
        else:
            assert b > a  # a long row's segments hold edges
            partial[~seg_out[i]] = segment(a, b)
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        acc = partial[a]
        for p in range(a + 1, b):
            acc = combine(acc, partial[p])
        out[row] = acc
    assert not np.isnan(out).any()  # every row written
    assert np.all(out[degree == 0] == empty)
    return out


def _messages(mode, rel_e, x_e):
    return rel_e * x_e if mode == "mul_rel" else rel_e + x_e


# ---------------------------------------------------------------------------
# K1h
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_k1h_segments_sum_to_the_plain_version(rng, case, mode):
    """K1h: each destination row's segments, bf16(msg(rel[r], x[s])) · w of
    the bf16-rounded operands, summed in edge order in fp32; the long
    rows' partial rows in segment order."""
    csr, n, w, rel, x = _case(rng, case)
    want = rspmm_fwd_bf16_plain(
        csr.rowptr, csr.src, csr.etype, csr.eid,
        *(torch.from_numpy(a) for a in (w, rel, x)), mode).numpy()
    rel_h, x_h = _bf16(rel), _bf16(x)
    src, etype, eid = n["src"], n["etype"], n["eid"]

    def terms(a, b):
        m = _bf16(_messages(mode, rel_h[etype[a:b]], x_h[src[a:b]]))
        return m * w[eid[a:b], None]

    def segment(a, b):
        acc = np.zeros(F, np.float32)
        for t in terms(a, b):
            acc = acc + t
        return acc

    got = _by_segments(n, F, segment, np.add, 0.0)
    mass = np.zeros_like(got)
    rows = np.repeat(np.arange(len(got)), np.diff(n["rowptr"]))
    np.add.at(mass, rows, np.abs(terms(0, len(src))))
    assert np.all(np.abs(got - want)
                  <= 1e-5 + 1e-5 * np.abs(want) + MASS_ULPS * mass)


def test_k1h_rounds_each_message_before_the_weight(rng):
    """The plain K1h (and the segments' sums above) round each message to
    bf16 before the weight: on the bf16 operands' own values its sums
    differ from those of the unrounded messages by more than its
    tolerance."""
    csr, n, w, rel, x = _case(rng, "one relation, no long row")
    rel_h, x_h = _bf16(rel), _bf16(x)
    got = rspmm_fwd_bf16_plain(
        csr.rowptr, csr.src, csr.etype, csr.eid,
        *(torch.from_numpy(a) for a in (w, rel_h, x_h)), "mul_rel").numpy()
    exact = np.zeros_like(got)
    rows = np.repeat(np.arange(len(got)), np.diff(n["rowptr"]))
    np.add.at(exact, rows, rel_h[0] * x_h[n["src"]] * w[n["eid"], None])
    assert np.abs(got - exact).max() > 1e-4


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _k6_segments(n, w, rel, x, mode):
    """K6's planes in the kernel's order: each segment's max and min of
    its messages (fp32, the message then the weight), 0 where a row has no
    edge, a long row's partial extrema combined in segment order."""
    src, etype, eid = n["src"], n["etype"], n["eid"]

    def messages(a, b):
        return _messages(mode, rel[etype[a:b]], x[src[a:b]]) * w[eid[a:b],
                                                                 None]

    def extremum(reduce):
        def segment(a, b):
            if a == b:
                return np.zeros(F, np.float32)
            acc = np.full(F, np.inf if reduce is np.minimum else -np.inf,
                          np.float32)
            for m in messages(a, b):
                acc = reduce(acc, m)
            return acc

        return _by_segments(n, F, segment, reduce, 0.0)

    return extremum(np.maximum), extremum(np.minimum)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_k6_segments_equal_the_plain_version(rng, case, mode):
    """K6: the segments' extrema and the long rows' combine equal the plain
    version exactly (== : zeros of either sign are equal)."""
    csr, n, w, rel, x = _case(rng, case, relu=True)
    want = [t.numpy() for t in pna_fwd_plain(
        "maxmin", csr, *(torch.from_numpy(a) for a in (w, rel, x)), mode)]
    got = _k6_segments(n, w, rel, x, mode)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert np.any(got[0] == 0) and np.any(got[1] == 0)  # messages tie at 0


@pytest.mark.parametrize("mode", MODES)
def test_k6_planes_give_k6b_the_plain_gradients(rng, mode):
    """The round trip K6 -> K6b on a hub row with weight-0 and duplicated
    edges: the planes in the segments' order, fed to K6b's plain version,
    give the gradients that the plain forward's planes give (the gate
    m == mx[v] fires on the same edges, every tied edge taking the full
    gradient)."""
    csr, n, w, rel, x = _case(rng, "700-edge hub, empty rows and relation",
                              relu=True)
    ops = [torch.from_numpy(a) for a in (w, rel, x)]
    g_mx, g_mn = (torch.from_numpy(rng.normal(size=x.shape).astype(
        np.float32)) for _ in range(2))
    mx, mn = (torch.from_numpy(p) for p in _k6_segments(n, w, rel, x, mode))
    want_mx, want_mn = pna_fwd_plain("maxmin", csr, *ops, mode)
    got = pna_bwd_plain("argext_pair", csr, *ops, (g_mx, mx, g_mn, mn), mode)
    want = pna_bwd_plain("argext_pair", csr, *ops,
                         (g_mx, want_mx, g_mn, want_mn), mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # ties: in some row an extremum is taken by more than one edge
    rows = np.repeat(np.arange(len(x)), np.diff(n["rowptr"]))
    m = _messages(mode, rel[n["etype"]], x[n["src"]]) * w[n["eid"], None]
    for plane in (mx, mn):
        ties = np.zeros(x.shape, np.int64)
        np.add.at(ties, rows, m == plane.numpy()[rows])
        assert ties.max() > 1


# ---------------------------------------------------------------------------
# the ops on hub rows against the JAX package
# ---------------------------------------------------------------------------

HUB = dict(V=300, E=2400, R=4, B=2, D=4)


def _hub_inputs(rng, relu):
    """A graph with a 700-edge destination hub (row 3), a 700-edge source
    hub (row 11) and rows of 256 and 257 edges both ways, 40 duplicated
    edges, 30 % of the weights 0, the last 4 rows without edges; x [V, B,
    D] (post-ReLU with ``relu``), rel per query [R, B, D] and two
    cotangents, seeded numpy."""
    V, E, R, B, D = (HUB[k] for k in "VERBD")
    src, dst, et, copy_of = _edges(
        rng, V, E, R, rows=((3, 700, 0), (11, 0, 700), (5, 256, 257)),
        empty_rows=4)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.3] = 0.0
    w[copy_of >= 0] = w[copy_of[copy_of >= 0]]
    x = rng.normal(size=(V, B, D)).astype(np.float32)
    return dict(tri=np.stack([src, dst, et], 1).astype(np.int32), w=w,
                x=np.maximum(x, 0) if relu else x,
                rel=rng.normal(size=(R, B, D)).astype(np.float32),
                cot=[rng.normal(size=(V, B, D)).astype(np.float32)
                     for _ in range(2)])


def _jax_grad(op, inp, layouts, compile_options=None, **kw):
    """(outputs..., d rel, d x) of a JAX op under the sum of <cot_i, out_i>
    over its outputs, on interpret-mode Pallas over ``layouts``, jitted."""
    tri = inp["tri"]
    ei, et = jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2])

    def f(r, x):
        outs = op(ei, et, jnp.asarray(inp["w"]), r, x, num_nodes=HUB["V"],
                  impl="pallas", layouts=layouts, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, inp["cot"])), outs

    args = (jnp.asarray(inp["rel"]), jnp.asarray(inp["x"]))
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    (_, outs), (dr, dx) = fn.lower(*args).compile(
        compiler_options=compile_options)(*args)
    return [np.asarray(v) for v in (*outs, dr, dx)]


def _port_grad(op, inp, **kw):
    g = Graph.from_triplets(inp["tri"], HUB["V"], HUB["R"],
                            edge_weight=inp["w"]).prepare_csr(backward=True)
    assert 3 in g.csr.long_rows.tolist()
    assert 11 in g.csr.src_long_rows.tolist()
    r = torch.from_numpy(inp["rel"].copy()).requires_grad_()
    x = torch.from_numpy(inp["x"].copy()).requires_grad_()
    outs = op(g.edge_index, g.edge_type, g.edge_weight, r, x,
              num_nodes=HUB["V"], csr=g.csr, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(outs, inp["cot"]))
    dr, dx = torch.autograd.grad(loss, (r, x))
    return [v.detach().numpy() for v in (*outs, dr, dx)]


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_bf16_op_on_hub_rows_matches_jax_pallas(rng, msg):
    """The sum with compute_dtype="bfloat16" (K1h forward; K2h or, for
    transe, K3 backward on the card) against the TPU kernels with the same
    mode: the forward and both gradients."""
    inp = _hub_inputs(rng, relu=False)
    tri = inp["tri"]
    layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], HUB["V"], HUB["R"],
                                  tile_rows=16, tile_edges=32,
                                  include_rel_layout=True)
    want = _jax_grad(j_rspmm, inp, layouts, EXACT_XLA, msg=msg,
                     compute_dtype=BF16)
    got = _port_grad(generalized_rspmm, inp, msg=msg, compute_dtype=BF16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("msg", ["mul", "add"])
def test_maxmin_op_on_hub_rows_matches_jax_pallas(rng, msg):
    """PNA's max/min pair (K6 forward, K6b backward on the card) against
    the TPU kernels on blocked layouts: the extrema exactly, both gradients
    with every tied edge taking the full gradient."""
    inp = _hub_inputs(rng, relu=True)
    tri = inp["tri"]
    layouts = build_rspmm_layouts(
        tri[:, :2], tri[:, 2], HUB["V"], HUB["R"], tile_rows=16,
        tile_edges=32, blocked=True, block_rows=16, bwd_block_rows=8,
        interleave=8)
    want = _jax_grad(j_maxmin, inp, layouts, msg=msg)
    got = _port_grad(generalized_rspmm_maxmin, inp, msg=msg)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)

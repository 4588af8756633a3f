"""The layouts of K4 (the single max/min forward) and K7 (the PNA moments
forward), kinds of csrc/rspmm_pna_fwd.cu's ``seg_stats`` beside K6, on the
CPU. Both run over K1's destination rows cut into 256-edge segments
(data/graph.py::build_csr's ``seg_*`` and ``long_*``): each segment's edges
in edge order, written to its row, or for a row of more than 256 edges to a
partial row, which a second kernel combines in segment order.

K4: m = (rel ⊙ x) · w (or (rel + x) · w) in fp32, the max (or the min) of a
segment's messages, 0 for a segment without edges, a long row's partial
extrema combined by max (or min) in segment order. Held to
``pna_fwd_plain`` exactly under ``==`` (a zero's sign may differ where a
weight-0 edge's -0 meets a +0); its output fed to K5's plain version
(``argext``) gives the gradients that the plain forward's output gives, so
K5's gate m == out[v] sees the new layout's ties as before.

K7: m = rel ⊙ x, s += m · w and sq += m · (m · w) over a segment's edges in
edge order in fp32, a long row's partial sums added in segment order. Held
to ``pna_fwd_plain`` within K7's tolerance (rtol = atol = 1e-5) plus 8 fp32
ulps of each entry's absolute mass (Σ |m · w| and Σ |m · m · w|: the sums
run in another order; diagnostics/timing.py's allowance for hub rows).

The graphs are tests/test_torch_k1h_k6_layouts.py's: rows of 256, 257 and
700 edges, rows without edges, a relation without edges, weight-0 and
duplicated edges; x is post-ReLU for K4, so that many messages tie at 0.

Last, the port's ops on that file's hub graph against the JAX package's on
interpret-mode Pallas over blocked layouts, with both gradients:
``generalized_rspmm`` with agg max and min (K4 and K5 on the card) and
``generalized_rspmm_addsq`` (K7 and K7b): the extrema exactly, their
gradients within rtol 1e-6, atol 1e-5, the moments and their gradients
within rtol = atol = 1e-5, as tests/test_torch_pna_layouts.py holds them.
"""

import numpy as np
import pytest
import torch
from test_torch_k1h_k6_layouts import (
    CASES,
    F,
    HUB,
    MASS_ULPS,
    MODES,
    _by_segments,
    _case,
    _hub_inputs,
    _jax_grad,
    _messages,
    _port_grad,
)

from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_addsq as j_addsq
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    generalized_rspmm,
    generalized_rspmm_addsq,
)
from ultra_torchdrug_tpu_torch.ops.rspmm_pna_cuda import (
    pna_bwd_plain,
    pna_fwd_plain,
)

AGGS = {"max": np.maximum, "min": np.minimum}


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _k4_segments(n, w, rel, x, mode, agg):
    """K4's plane in the kernel's order: each segment's max (or min) of its
    messages (fp32, the message then the weight), 0 where a row has no
    edge, a long row's partial extrema combined in segment order."""
    src, etype, eid = n["src"], n["etype"], n["eid"]
    reduce = AGGS[agg]

    def segment(a, b):
        if a == b:
            return np.zeros(F, np.float32)
        acc = np.full(F, np.inf if agg == "min" else -np.inf, np.float32)
        for m in _messages(mode, rel[etype[a:b]], x[src[a:b]]) * w[eid[a:b],
                                                                    None]:
            acc = reduce(acc, m)
        return acc

    return _by_segments(n, F, segment, reduce, 0.0)


@pytest.mark.parametrize("agg", list(AGGS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_k4_segments_equal_the_plain_version(rng, case, mode, agg):
    """K4: the segments' extremum and the long rows' combine equal the
    plain version exactly (== : zeros of either sign are equal)."""
    csr, n, w, rel, x = _case(rng, case, relu=True)
    (want,) = pna_fwd_plain(agg, csr, *_torch(w, rel, x), mode)
    got = _k4_segments(n, w, rel, x, mode, agg)
    assert np.array_equal(got, want.numpy())
    assert np.any(got == 0)  # messages tie at 0


@pytest.mark.parametrize("agg", list(AGGS))
@pytest.mark.parametrize("mode", MODES)
def test_k4_output_gives_k5_the_plain_gradients(rng, mode, agg):
    """The round trip K4 -> K5 on a hub row with weight-0 and duplicated
    edges: the extremum in the segments' order, fed to K5's plain version,
    gives the gradients that the plain forward's extremum gives (the gate
    m == out[v] fires on the same edges, every tied edge taking the full
    gradient)."""
    csr, n, w, rel, x = _case(rng, "700-edge hub, empty rows and relation",
                              relu=True)
    ops = _torch(w, rel, x)
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    out = torch.from_numpy(_k4_segments(n, w, rel, x, mode, agg))
    (want_out,) = pna_fwd_plain(agg, csr, *ops, mode)
    got = pna_bwd_plain("argext", csr, *ops, (g, out), mode)
    want = pna_bwd_plain("argext", csr, *ops, (g, want_out), mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # ties: in some row the extremum is taken by more than one edge
    rows = np.repeat(np.arange(len(x)), np.diff(n["rowptr"]))
    m = _messages(mode, rel[n["etype"]], x[n["src"]]) * w[n["eid"], None]
    ties = np.zeros(x.shape, np.int64)
    np.add.at(ties, rows, m == out.numpy()[rows])
    assert ties.max() > 1


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_k7_segments_sum_to_the_plain_version(rng, case):
    """K7: each segment's sums s += m · w, sq += m · (m · w) in edge order
    in fp32, the long rows' partial rows added in segment order, within
    K7's tolerance plus 8 fp32 ulps of each entry's absolute mass; rows
    without edges 0."""
    csr, n, w, rel, x = _case(rng, case)
    want = [t.numpy() for t in pna_fwd_plain(
        "addsq", csr, *_torch(w, rel, x), "mul_rel")]
    src, etype, eid = n["src"], n["etype"], n["eid"]

    def terms(a, b):
        m = rel[etype[a:b]] * x[src[a:b]]
        mw = m * w[eid[a:b], None]
        return mw, m * mw

    def plane(k):
        def segment(a, b):
            acc = np.zeros(F, np.float32)
            for t in terms(a, b)[k]:
                acc = acc + t
            return acc

        return _by_segments(n, F, segment, np.add, 0.0)

    rows = np.repeat(np.arange(len(x)), np.diff(n["rowptr"]))
    for k in range(2):
        got = plane(k)
        mass = np.zeros_like(got)
        np.add.at(mass, rows, np.abs(terms(0, len(src))[k]))
        assert np.all(np.abs(got - want[k])
                      <= 1e-5 + 1e-5 * np.abs(want[k]) + MASS_ULPS * mass)


# ---------------------------------------------------------------------------
# the ops on hub rows against the JAX package
# ---------------------------------------------------------------------------


def _blocked_layouts(inp):
    tri = inp["tri"]
    return build_rspmm_layouts(
        tri[:, :2], tri[:, 2], HUB["V"], HUB["R"], tile_rows=16,
        tile_edges=32, blocked=True, block_rows=16, bwd_block_rows=8,
        interleave=8)


@pytest.mark.parametrize("agg", list(AGGS))
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_extremum_op_on_hub_rows_matches_jax_pallas(rng, msg, agg):
    """The single extremum (K4 forward, K5 backward on the card) against
    the TPU kernels on blocked layouts: the values exactly, both gradients
    with every tied edge taking the full gradient."""
    inp = _hub_inputs(rng, relu=True)
    want = _jax_grad(j_rspmm, inp, _blocked_layouts(inp), msg=msg, agg=agg)
    got = _port_grad(generalized_rspmm, inp, msg=msg, agg=agg)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.all(got[0][-4:] == 0)  # rows without edges give 0
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)


def test_addsq_op_on_hub_rows_matches_jax_pallas(rng):
    """PNA's moments (K7 forward, K7b backward on the card) against the TPU
    kernels on blocked layouts: both sums and both gradients within rtol
    1e-5 (sums of 700 terms in another order)."""
    inp = _hub_inputs(rng, relu=False)
    want = _jax_grad(j_addsq, inp, _blocked_layouts(inp))
    got = _port_grad(generalized_rspmm_addsq, inp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

"""The hub-aware layouts of K1 and K2 (data/graph.py::build_csr), on the CPU:
the destination rows cut into segments (K1), the source rows cut into
segments (K2's dx pass) and the (destination tile, relation) chunks with
their source column ``tile_src`` (K2's dr pass). Each case checks the
layouts' invariants, then forms K1's and K2's sums over them with numpy in
the kernels' order (csrc/rspmm_staged.cuh: each segment's edges in edge
order, then the long rows' partial rows in segment order; in each chunk,
the edges dealt round-robin to the warp's edge streams, each stream's sum
in edge order, the streams combined by a butterfly, then each relation's
chunk rows in slot order) and holds the result to ``rspmm_fwd_plain`` /
``rspmm_bwd_plain``, which use none of these layouts, within rtol 1e-5 and
atol the larger of 1e-4 and 1e-5 of the largest entry (the sums run in
another order).

Last, the port's ``generalized_rspmm`` (its CPU path and its autograd node
over the Csr, whose wrappers run the plain versions on the CPU) against the
JAX package's on a graph with 700-edge hub rows in both directions: the
same seeded numpy inputs, forward and gradient through ``impl="xla"``, as
the JAX package's own tests run it; tolerance rtol 1e-5 and atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import (
    DR_CHUNK_EDGES,
    SEGMENT_EDGES,
    TILE_ROWS,
    Graph,
    build_csr,
    row_segments,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import _RspmmK1K2, generalized_rspmm
from ultra_torchdrug_tpu_torch.ops.rspmm_bwd_cuda import rspmm_bwd_plain
from ultra_torchdrug_tpu_torch.ops.rspmm_cuda import RowSegments, rspmm_fwd_plain

F = 8
# the dr pass's edge streams a warp: two of 16 threads on the vector path
# (64 features of 4 floats a thread), one of 32 on the scalar path
STREAMS = (2, 1)


def _edges(rng, V, E, R, rows=(), empty_rows=0, empty_rel=False):
    """E edges over V rows and R relations; ``rows`` lists (row, in-edges,
    out-edges) to plant (256 and 257 edges straddle the segment length,
    700 is a hub of three segments), whose other ends, like both ends of
    the remaining edges, are drawn from the rows not planted and not among
    the last ``empty_rows``; with ``empty_rel`` the last relation has no
    edge."""
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
    return src, dst, et


CASES = {
    "rows of 256 and 257 edges": dict(
        V=600, E=3000, R=5, rows=((3, 256, 257), (9, 257, 256))),
    "700-edge hubs, empty rows and relation": dict(
        V=5000, E=6000, R=6, rows=((17, 700, 0), (23, 0, 700)),
        empty_rows=5, empty_rel=True),
    "one relation, no long row": dict(V=300, E=2000, R=1),
    "relation over 256 edges in one tile": dict(V=900, E=1500, R=3,
                                                rows=((2, 300, 0),)),
}


def _close(got, want):
    atol = max(1e-4, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _warp_sum(terms, streams):
    """One warp's sum of ``terms`` [n, F] (float32): edge k to stream
    k % streams, each stream's sum in edge order, then the butterfly over
    the streams ((s0 + s1) + (s2 + s3) for four)."""
    part = [np.zeros(terms.shape[1], np.float32) for _ in range(streams)]
    for k, t in enumerate(terms):
        part[k % streams] = part[k % streams] + t
    while len(part) > 1:
        part = [part[i] + part[i + 1] for i in range(0, len(part), 2)]
    return part[0]


def _check_segments(seg_ptr, seg_out, long_rows, long_ptr, rowptr):
    """The invariants of a CSR's segments; returns the degree per row."""
    E = rowptr[-1]
    degree = np.diff(rowptr)
    assert seg_ptr[0] == 0 and seg_ptr[-1] == E
    assert np.all(np.diff(seg_ptr) >= 0)
    assert np.all(np.diff(seg_ptr) <= SEGMENT_EDGES)
    assert np.array_equal(long_rows, np.flatnonzero(degree > SEGMENT_EDGES))
    assert long_ptr[0] == 0
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        assert b - a == -(-degree[row] // SEGMENT_EDGES)
    # each row is its segments in order: a short row is one segment written
    # to the row, a long row's segments fill its slots in order
    slot_of = {}
    for i in range(len(seg_out)):
        if seg_out[i] < 0:
            slot_of[int(~seg_out[i])] = i
        else:
            row = seg_out[i]
            assert (seg_ptr[i], seg_ptr[i + 1]) == (rowptr[row],
                                                    rowptr[row + 1])
    assert sorted(slot_of) == list(range(long_ptr[-1]))
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        segs = [slot_of[p] for p in range(a, b)]
        assert seg_ptr[segs[0]] == rowptr[row]
        assert seg_ptr[segs[-1] + 1] == rowptr[row + 1]
        assert np.all(np.diff(segs) == 1)  # consecutive, in order
    assert np.sum(seg_out >= 0) + len(long_rows) == len(degree)
    return degree


def _row_sums(seg_ptr, seg_out, long_rows, long_ptr, terms, num_rows):
    """K1's (or the dx pass's) result from per-edge ``terms`` in the
    layout's edge order: every row written once, long rows through their
    partial rows summed in segment order."""
    out = np.full((num_rows, terms.shape[1]), np.nan, np.float32)
    partial = np.zeros((max(long_ptr[-1], 1), terms.shape[1]), np.float32)
    for i in range(len(seg_out)):
        total = _warp_sum(terms[seg_ptr[i]:seg_ptr[i + 1]], 1)
        if seg_out[i] >= 0:
            out[seg_out[i]] = total
        else:
            partial[~seg_out[i]] = total
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        acc = np.zeros(terms.shape[1], np.float32)
        for p in range(a, b):
            acc = acc + partial[p]
        out[row] = acc
    assert not np.isnan(out).any()  # every row written
    return out


def _case(rng, case):
    """The case's CSR (eid a permutation), masked weights, rel, x and g, and
    the original edge index of each eid."""
    spec = dict(CASES[case])
    V, E, R = spec.pop("V"), spec.pop("E"), spec.pop("R")
    src, dst, et = _edges(rng, V, E, R, **spec)
    ids = rng.permutation(E)  # eid not the identity
    csr = build_csr(src, dst, et, V, R, backward=True, edge_ids=ids)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    ops = [rng.normal(size=s).astype(np.float32) for s in ((R, F), (V, F),
                                                            (V, F))]
    n = {k: v.numpy() for k, v in vars(csr).items() if v is not None}
    return spec, (src, dst, et, np.argsort(ids)), csr, n, w, ops


def _bwd_plain(csr, w, rel, x, g):
    return (t.numpy() for t in rspmm_bwd_plain(
        csr, torch.from_numpy(w), torch.from_numpy(rel), torch.from_numpy(x),
        torch.from_numpy(g)))


@pytest.mark.parametrize("case", list(CASES))
def test_k1_and_dx_segments_cover_and_sum(rng, case):
    spec, _, csr, n, w, (rel, x, g) = _case(rng, case)
    V = len(n["rowptr"]) - 1

    # K1: the destination rows' segments
    degree = _check_segments(n["seg_ptr"], n["seg_out"], n["long_rows"],
                             n["long_ptr"], n["rowptr"])
    for row, n_in, _ in spec.get("rows", ()):
        assert degree[row] == n_in
        assert (row in n["long_rows"]) == (n_in > SEGMENT_EDGES)
    if spec.get("empty_rows"):
        assert np.all(degree[-spec["empty_rows"]:] == 0)
    terms = rel[n["etype"]] * x[n["src"]] * w[n["eid"], None]
    got = _row_sums(n["seg_ptr"], n["seg_out"], n["long_rows"],
                    n["long_ptr"], terms, V)
    want = rspmm_fwd_plain(*(csr.rowptr, csr.src, csr.etype, csr.eid),
                           torch.from_numpy(w), torch.from_numpy(rel),
                           torch.from_numpy(x), "mul_rel").numpy()
    _close(got, want)
    assert np.all(got[degree == 0] == 0)

    # K2's dx pass: the source rows' segments, rel * g per edge
    want_dx, _ = _bwd_plain(csr, w, rel, x, g)
    out_degree = _check_segments(n["src_seg_ptr"], n["src_seg_out"],
                                 n["src_long_rows"], n["src_long_ptr"],
                                 n["src_rowptr"])
    for row, _, n_out in spec.get("rows", ()):
        assert out_degree[row] == n_out
        assert (row in n["src_long_rows"]) == (n_out > SEGMENT_EDGES)
    terms = rel[n["src_etype"]] * g[n["src_dst"]] * w[n["src_eid"], None]
    dx = _row_sums(n["src_seg_ptr"], n["src_seg_out"], n["src_long_rows"],
                   n["src_long_ptr"], terms, V)
    _close(dx, want_dx)
    assert np.all(dx[out_degree == 0] == 0)


@pytest.mark.parametrize("streams", STREAMS)
@pytest.mark.parametrize("case", list(CASES))
def test_dr_chunks_cover_and_sum(rng, case, streams):
    """K2's dr pass: (destination tile, relation) chunks with tile_src."""
    spec, (src, dst, et, edge_of), csr, n, w, (rel, x, g) = _case(rng, case)
    R, E = len(rel), len(src)
    _, want_dr = _bwd_plain(csr, w, rel, x, g)
    ptr, slot, rel_ptr = n["tile_chunk_ptr"], n["tile_chunk_slot"], \
        n["tile_rel_ptr"]
    tsrc, tdst, teid = n["tile_src"], n["tile_dst"], n["tile_eid"]
    assert np.array_equal(np.sort(teid), np.arange(E))
    assert np.array_equal(tsrc, src[edge_of[teid]])
    assert np.array_equal(tdst, dst[edge_of[teid]])
    tet = et[edge_of[teid]]
    C = len(ptr) - 1
    assert ptr[0] == 0 and ptr[-1] == E and np.all(np.diff(ptr) > 0)
    for c in range(C):
        a, b = ptr[c], ptr[c + 1]
        assert b - a <= DR_CHUNK_EDGES
        assert len(set(tet[a:b])) == 1
        assert len(set(tdst[a:b] // TILE_ROWS)) == 1
    assert np.array_equal(np.sort(slot), np.arange(C))
    chunk_at = np.argsort(slot)
    for r in range(R):  # relation-major slots, in tile order
        own = chunk_at[rel_ptr[r]:rel_ptr[r + 1]]
        assert np.all(tet[ptr[own]] == r) and np.all(np.diff(own) > 0)
    if spec.get("empty_rel"):
        assert rel_ptr[R - 1] == rel_ptr[R]
    partial = np.zeros((C, F), np.float32)
    for c in range(C):
        a, b = ptr[c], ptr[c + 1]
        partial[slot[c]] = _warp_sum(x[tsrc[a:b]] * g[tdst[a:b]]
                                     * w[teid[a:b], None], streams)
    dr = np.zeros((R, F), np.float32)
    for r in range(R):
        for p in range(rel_ptr[r], rel_ptr[r + 1]):
            dr[r] = dr[r] + partial[p]
    _close(dr, want_dr)


def test_every_csr_has_destination_segments(rng):
    """build_csr makes K1's segments with or without the backward layouts,
    the same either way; a graph without edges has one empty segment a
    row."""
    src, dst, et = _edges(rng, 400, 2000, 4, rows=((5, 300, 0),))
    a = build_csr(src, dst, et, 400, 4)
    b = build_csr(src, dst, et, 400, 4, backward=True)
    assert not a.has_backward and a.tile_src is None
    sa, sb = a.segments, b.segments
    for name in ("seg_ptr", "seg_out", "long_rows", "long_ptr"):
        assert torch.equal(getattr(sa, name), getattr(sb, name))
    # row 5's 300 in-edges: two segments, two partial rows
    assert (sa.num_rows, sa.num_long_rows, sa.num_partials) == (400, 1, 2)
    assert a.long_rows.tolist() == [5]
    empty = build_csr(np.zeros(0, int), np.zeros(0, int), np.zeros(0, int),
                      3, 2, backward=True)
    assert empty.seg_ptr.tolist() == [0, 0, 0, 0]
    assert empty.seg_out.tolist() == [0, 1, 2]
    assert empty.long_rows.numel() == 0 and empty.long_ptr.tolist() == [0]
    assert empty.tile_src.numel() == 0


@pytest.mark.parametrize("case", list(CASES))
def test_row_segments_of_rowptr_match_the_csr(rng, case):
    """row_segments rebuilds a CSR's destination-row segments from its
    rowptr alone, as the ladder's check of K1 does."""
    _, _, csr, _, _, _ = _case(rng, case)
    got, want = row_segments(csr.rowptr), csr.segments
    for name in ("seg_ptr", "seg_out", "long_rows", "long_ptr"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    counts = ("num_rows", "num_segments", "num_long_rows", "num_partials")
    assert ([getattr(got, k) for k in counts]
            == [getattr(want, k) for k in counts])


def test_row_segments_are_checked_once(rng):
    """A Csr makes its RowSegments once; RowSegments.of rejects segments
    of another type or that do not fit the CSR's rows."""
    src, dst, et = _edges(rng, 400, 2000, 4, rows=((5, 300, 0),))
    csr = build_csr(src, dst, et, 400, 4)
    s = csr.segments
    assert csr.segments is s and s.num_segments == 401
    parts = (s.seg_ptr, s.seg_out, s.long_rows, s.long_ptr)
    with pytest.raises(ValueError):  # more rows than segments
        RowSegments.of(*parts, 402)
    with pytest.raises(ValueError):  # one seg_out entry short
        RowSegments.of(s.seg_ptr, s.seg_out[:-1], s.long_rows, s.long_ptr,
                       400)
    with pytest.raises(TypeError):
        RowSegments.of(s.seg_ptr.long(), *parts[1:], 400)


HUB = dict(V=1200, E=4000, R=5, B=2, D=6)


def _hub_inputs(rng):
    """A graph with a 700-edge destination hub (row 3) and a 700-edge
    source hub (row 11), masked weights, a per-batch relation, x and the
    cotangent, all seeded numpy."""
    V, E, R, B, D = (HUB[k] for k in "VERBD")
    src, dst, et = _edges(rng, V, E, R, rows=((3, 700, 0), (11, 0, 700)))
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    return dict(tri=np.stack([src, dst, et], 1), w=w,
                rel=rng.normal(size=(R, B, D)).astype(np.float32),
                x=rng.normal(size=(V, B, D)).astype(np.float32),
                g=rng.normal(size=(V, B, D)).astype(np.float32))


def test_generalized_rspmm_hub_rows_match_jax(rng):
    inp = _hub_inputs(rng)
    V, R = HUB["V"], HUB["R"]
    tri, w, g = inp["tri"], inp["w"], inp["g"]

    def j_loss(rel, x):
        out = j_rspmm(jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2]),
                      jnp.asarray(w), rel, x, msg="mul", agg="add",
                      num_nodes=V, impl="xla")
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), (j_dr, j_dx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(inp["rel"]),
                                              jnp.asarray(inp["x"]))
    graph = Graph.from_triplets(tri, V, R, edge_weight=w).prepare_csr(
        backward=True)
    assert graph.csr.long_rows.tolist() == [3]
    assert graph.csr.src_long_rows.tolist() == [11]
    tol = dict(rtol=1e-5, atol=1e-4)
    for via_csr in (False, True):
        rel = torch.from_numpy(inp["rel"]).requires_grad_()
        x = torch.from_numpy(inp["x"]).requires_grad_()
        if via_csr:  # the card's autograd node, plain versions on the CPU
            out = _RspmmK1K2.apply(
                graph.csr, graph.edge_weight, rel.reshape(R, -1),
                x.reshape(V, -1), "mul_rel").reshape(x.shape)
        else:
            out = generalized_rspmm(graph.edge_index, graph.edge_type,
                                    graph.edge_weight, rel, x, msg="mul",
                                    num_nodes=V, csr=graph.csr)
        d_rel, d_x = torch.autograd.grad(out, (rel, x), torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                                   **tol)
        np.testing.assert_allclose(d_rel.numpy(), np.asarray(j_dr), **tol)
        np.testing.assert_allclose(d_x.numpy(), np.asarray(j_dx), **tol)

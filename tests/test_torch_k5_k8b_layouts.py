"""The layouts of K5 (the max/min backward, csrc/rspmm_pna_bwd.cu kind
``argext``) and K8b (the rotate backward, csrc/rspmm_rotate.cu) on the CPU:
K2's hub-aware layouts (data/graph.py::build_csr), the source rows cut into
256-edge segments (the dx passes) and the (destination tile, relation)
chunks (the dr passes). Each case forms the gradients with numpy over the
layouts in the kernels' order: the dx pass's segments, each summed in edge
order, then the long rows' partial rows in segment order; the dr pass's
chunks, their edges dealt round-robin to the warp's edge streams (K5: two
on the vector path, one on the scalar path; K8b: four streams of 8 threads
on the vector path, one of 32 on the scalar path), each stream's sum in
edge order, the streams combined by a butterfly, then each relation's
partial rows in slot order. K5's gate recomputes K4's message and compares
it bitwise with the saved extremum (K4's plain forward, max or min, modes
mul_rel and add_rel). K8b's sums run slice by slice over its complex column
map: slices of 32 complex positions, whose real parts lie at b * D + k and
imaginary parts at b * D + D / 2 + k of a row, for D = 32 (a slice is two
whole blocks), 128 (half of one block's real and imaginary parts) and 6
(the scalar path; slices run across blocks). The results are held to
``pna_bwd_plain("argext")`` and ``rotate_bwd_plain``, which use none of
these layouts, within rtol 1e-5 and atol the larger of 1e-4 and 1e-5 of the
largest entry (the sums run in another order). The graphs have rows of
256, 257 and 700 edges in both directions, duplicated edges (exact ties,
each taking all of g), weight-0 edges, rows without edges and a relation
without edges.

Last, the port's ops on such a hub graph at F = 8 against the JAX
package's on interpret-mode Pallas: ``generalized_rspmm`` with agg max and
min, as tests/test_torch_extremum.py runs it (the blocked layouts, the
per-edge K5 backward, and the interleaved ones, K5b; values exactly,
gradients rtol 1e-6 and atol 1e-5), and the rotate op, as
tests/test_torch_rotate.py runs it on explicitly blocked layouts (K8f and
K8b's TPU kernels; rtol and atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm as j_rspmm
from ultra_torchdrug_tpu_torch.data.graph import (
    DR_CHUNK_EDGES,
    SEGMENT_EDGES,
    TILE_ROWS,
    Graph,
    build_csr,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm
from ultra_torchdrug_tpu_torch.ops.rspmm_bwd_cuda import rotate_bwd_plain
from ultra_torchdrug_tpu_torch.ops.rspmm_pna_cuda import (
    pna_bwd_plain,
    pna_fwd_plain,
)

# K5's width (scalar path 1 stream, vector path 2 streams of 16 threads)
F5 = 8
K5_STREAMS = (2, 1)
# K8b: complex positions a slice, and (D, F, dr streams a warp): the vector
# path's four streams where D / 2 % 4 == 0 (one where a row pointer is not
# aligned), the scalar path's one; F = 66 at D = 6 ends in a slice of one
# position
POSITIONS = 32
ROTATE = [(32, 128, 4), (32, 128, 1), (128, 256, 4), (6, 66, 1)]
K5_KINDS = [(agg, mode) for agg in ("max", "min")
            for mode in ("mul_rel", "add_rel")]


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
        V=600, E=3000, R=5, rows=((3, 256, 257), (9, 257, 256))),
    "700-edge hubs, empty rows and relation": dict(
        V=5000, E=6000, R=6, rows=((17, 700, 0), (23, 0, 700)),
        empty_rows=5, empty_rel=True),
    "one relation, no long row": dict(V=300, E=2000, R=1),
}


def _case(rng, case, F):
    """The case's CSR (eid a permutation), masked weights (duplicated edges
    keep their original's), rel ~ N(0, 1), post-ReLU x (exact zeros) and
    g ~ N(0, 1), as numpy float32, and the CSR's fields as numpy."""
    spec = dict(CASES[case])
    V, E, R = spec.pop("V"), spec.pop("E"), spec.pop("R")
    src, dst, et, copy_of = _edges(rng, V, E, R, **spec)
    ids = rng.permutation(E)  # eid not the identity
    csr = build_csr(src, dst, et, V, R, backward=True, edge_ids=ids)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    dup = copy_of >= 0
    w[ids[dup]] = w[ids[copy_of[dup]]]
    rel = rng.normal(size=(R, F)).astype(np.float32)
    x = np.maximum(rng.normal(size=(V, F)), 0).astype(np.float32)
    g = rng.normal(size=(V, F)).astype(np.float32)
    n = {k: v.numpy() for k, v in vars(csr).items() if v is not None}
    return spec, (src, dst, et, np.argsort(ids)), csr, n, w, rel, x, g


def _warp_sum(terms, streams):
    """One warp's sum of ``terms`` [n, F] (float32): edge k to stream
    k % streams, each stream's sum in edge order, then the butterfly over
    the streams."""
    part = [np.zeros(terms.shape[1], np.float32) for _ in range(streams)]
    for k, t in enumerate(terms):
        part[k % streams] = part[k % streams] + t
    while len(part) > 1:
        part = [part[i] + part[i + 1] for i in range(0, len(part), 2)]
    return part[0]


def _close(got, want):
    atol = max(1e-4, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _segment_rows(n):
    """Each source-row segment's row: its own, or the long row whose
    partial slots hold it."""
    seg_out, long_rows = n["src_seg_out"], n["src_long_rows"]
    if not len(long_rows):
        return seg_out
    return np.where(seg_out >= 0, seg_out, long_rows[np.searchsorted(
        n["src_long_ptr"][1:], ~seg_out, side="right")])


def _dx_by_segments(n, V, width, segment_sum):
    """dx [V, width] from ``segment_sum(a, b, row)`` of each source-row
    segment's edges [a, b), written to its row or to its partial slot, then
    the long rows' partial rows summed in segment order."""
    seg_ptr, seg_out = n["src_seg_ptr"], n["src_seg_out"]
    long_rows, long_ptr = n["src_long_rows"], n["src_long_ptr"]
    degree = np.diff(n["src_rowptr"])
    rows = _segment_rows(n)
    dx = np.full((V, width), np.nan, np.float32)
    partial = np.zeros((max(long_ptr[-1], 1), width), np.float32)
    for i in range(len(seg_out)):
        a, b = seg_ptr[i], seg_ptr[i + 1]
        assert b - a <= SEGMENT_EDGES
        assert np.all(np.repeat(np.arange(V), degree)[a:b] == rows[i])
        total = segment_sum(a, b, rows[i])
        if seg_out[i] >= 0:
            dx[seg_out[i]] = total
        else:
            partial[~seg_out[i]] = total
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        acc = np.zeros(width, np.float32)
        for p in range(a, b):
            acc = acc + partial[p]
        dx[row] = acc
    assert not np.isnan(dx).any()  # every row written
    assert np.all(dx[degree == 0] == 0)
    return dx


def _dr_by_chunks(n, et, edge_of, R, width, chunk_sum):
    """dr [R, width] from ``chunk_sum(a, b, r)`` of each (destination tile,
    relation) chunk's edges [a, b) of relation r in tile order, written to
    its slot, then each relation's partial rows summed in slot order."""
    ptr, slot, chunk_rel = (n["tile_chunk_ptr"], n["tile_chunk_slot"],
                            n["tile_chunk_rel"])
    rel_ptr, tdst = n["tile_rel_ptr"], n["tile_dst"]
    tet = et[edge_of[n["tile_eid"]]]
    C = len(ptr) - 1
    assert len(chunk_rel) == C
    partial = np.zeros((C, width), np.float32)
    for c in range(C):
        a, b = ptr[c], ptr[c + 1]
        assert 0 < b - a <= DR_CHUNK_EDGES
        assert np.all(tet[a:b] == chunk_rel[c])
        assert len(set(tdst[a:b] // TILE_ROWS)) == 1
        assert np.all(np.diff(tdst[a:b]) >= 0)  # sorted destinations
        partial[slot[c]] = chunk_sum(a, b, chunk_rel[c])
    chunk_at = np.argsort(slot)
    dr = np.zeros((R, width), np.float32)
    for r in range(R):
        assert np.all(chunk_rel[chunk_at[rel_ptr[r]:rel_ptr[r + 1]]] == r)
        for p in range(rel_ptr[r], rel_ptr[r + 1]):
            dr[r] = dr[r] + partial[p]
    return dr


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def _k5_planes(agg, mode, csr, w, rel, x, g):
    """K5's planes: g and K4's plain forward (the saved extremum)."""
    (out,) = pna_fwd_plain(agg, csr, torch.from_numpy(w),
                           torch.from_numpy(rel), torch.from_numpy(x), mode)
    return [g, out.numpy()]


def _k5_terms(mode, rel_e, x_e, w_e, g_e, out_e, dx: bool):
    """Each edge's term of the dx pass (rel * c) or the dr pass (x * c), c
    alone for add_rel, as the kernel forms c = [m == out] g w with K4's
    message m = msg(rel, x) w (float32)."""
    w = w_e[:, None]
    m = (rel_e * x_e if mode == "mul_rel" else rel_e + x_e) * w
    c = np.where(m == out_e, g_e * w, np.float32(0))
    if mode == "add_rel":
        return c
    return (rel_e if dx else x_e) * c


def _k5_plain(mode, csr, w, rel, x, planes):
    return [t.numpy() for t in pna_bwd_plain(
        "argext", csr, torch.from_numpy(w), torch.from_numpy(rel),
        torch.from_numpy(x), [torch.from_numpy(p) for p in planes], mode)]


@pytest.mark.parametrize("agg,mode", K5_KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_k5_dx_segments_sum_to_the_plain_version(rng, case, agg, mode):
    """K5's dx pass: each source row's segments, x[s] once a segment, g and
    the saved extremum at each edge's destination."""
    spec, _, csr, n, w, rel, x, g = _case(rng, case, F5)
    V = len(x)
    g, out = _k5_planes(agg, mode, csr, w, rel, x, g)
    want_dx, _ = _k5_plain(mode, csr, w, rel, x, [g, out])
    dst, etype, eid = n["src_dst"], n["src_etype"], n["src_eid"]
    for row, _, n_out in spec.get("rows", ()):
        assert (row in n["src_long_rows"]) == (n_out > SEGMENT_EDGES)

    def segment_sum(a, b, row):
        xs = np.broadcast_to(x[row], (b - a, F5))
        return _warp_sum(_k5_terms(mode, rel[etype[a:b]], xs, w[eid[a:b]],
                                   g[dst[a:b]], out[dst[a:b]], dx=True), 1)

    _close(_dx_by_segments(n, V, F5, segment_sum), want_dx)


@pytest.mark.parametrize("streams", K5_STREAMS)
@pytest.mark.parametrize("agg,mode", K5_KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_k5_dr_chunks_sum_to_the_plain_version(rng, case, agg, mode,
                                               streams):
    """K5's dr pass: the (destination tile, relation) chunks, each chunk's
    relation from tile_chunk_rel."""
    spec, (_, _, et, edge_of), csr, n, w, rel, x, g = _case(rng, case, F5)
    R = len(rel)
    g, out = _k5_planes(agg, mode, csr, w, rel, x, g)
    _, want_dr = _k5_plain(mode, csr, w, rel, x, [g, out])
    tsrc, tdst, teid = n["tile_src"], n["tile_dst"], n["tile_eid"]

    def chunk_sum(a, b, r):
        rel_e = np.broadcast_to(rel[r], (b - a, F5))
        return _warp_sum(_k5_terms(mode, rel_e, x[tsrc[a:b]], w[teid[a:b]],
                                   g[tdst[a:b]], out[tdst[a:b]], dx=False),
                         streams)

    dr = _dr_by_chunks(n, et, edge_of, R, F5, chunk_sum)
    _close(dr, want_dr)
    if spec.get("empty_rel"):
        assert np.all(dr[R - 1] == 0)


@pytest.mark.parametrize("agg", ["max", "min"])
def test_k5_duplicated_edges_tie_and_take_the_full_gradient(rng, agg):
    """A duplicated edge's message equals its original's bit for bit, so
    where one is the extremum both are, and each gets all of g (the TPU
    kernels' convention, ultra_torchdrug_tpu/ops/rspmm.py:195-198): the dx
    terms of the pair are equal, and some pair is gated."""
    _, _, csr, n, w, rel, x, g = _case(rng, "rows of 256 and 257 edges", F5)
    g, out = _k5_planes(agg, "mul_rel", csr, w, rel, x, g)
    src = np.repeat(np.arange(len(x)), np.diff(n["src_rowptr"]))
    dst, etype, eid = n["src_dst"], n["src_etype"], n["src_eid"]
    terms = _k5_terms("mul_rel", rel[etype], x[src], w[eid], g[dst], out[dst],
                      dx=True)
    key = np.stack([src, dst, etype, w[eid].view(np.int32)], 1)
    _, first, counts = np.unique(key, axis=0, return_index=True,
                                 return_counts=True)
    pairs = 0
    for k in np.flatnonzero(counts > 1):
        same = np.flatnonzero((key == key[first[k]]).all(1))
        assert np.array_equal(terms[same[0]], terms[same[1]])
        pairs += bool(np.any(terms[same[0]] != 0))
    assert pairs > 0


# ---------------------------------------------------------------------------
# K8b
# ---------------------------------------------------------------------------


def _column_map(F, D):
    """K8b's slices of a row of F features in blocks of D: for each slice
    of POSITIONS complex positions p, the columns of their real parts
    (p // (D/2)) * D + p % (D/2) and of their imaginary parts, D / 2
    further (csrc/rspmm_rotate.cu::position_offset)."""
    half, P = D // 2, F // 2
    out = []
    for p0 in range(0, P, POSITIONS):
        p = np.arange(p0, min(p0 + POSITIONS, P))
        re = (p // half) * D + p % half
        out.append((re, re + half))
    return out


def _conj_terms(a_e, b_e, w_e, cols):
    """(conj(a) (x) b) * w per edge on one slice's columns (re, im), the
    real parts then the imaginary parts, as the kernel forms them
    (float32)."""
    re, im = cols
    ar, ai, br, bi = a_e[:, re], a_e[:, im], b_e[:, re], b_e[:, im]
    w = w_e[:, None]
    return np.concatenate([(ar * br + ai * bi) * w, (ar * bi - br * ai) * w],
                          1)


def _rotate_plain(csr, w, rel, x, g, D):
    return [t.numpy() for t in rotate_bwd_plain(
        csr, torch.from_numpy(w), torch.from_numpy(rel), torch.from_numpy(x),
        torch.from_numpy(g), D)]


def _rotate_case(rng, case, F):
    """_case at width F with x ~ N(0, 1) (rotate has no ReLU before it)."""
    out = _case(rng, case, F)
    x = rng.normal(size=out[6].shape).astype(np.float32)
    return (*out[:6], x, out[7])


@pytest.mark.parametrize("D,F", [(32, 128), (128, 256), (6, 66), (6, 6)])
def test_k8b_column_map_covers_each_column_once(D, F):
    """The slices' real and imaginary columns partition the row, each
    imaginary part D / 2 after its real part in the same block; at D = 32 a
    slice is two whole blocks."""
    cols = _column_map(F, D)
    allc = np.concatenate([np.concatenate(c) for c in cols])
    assert np.array_equal(np.sort(allc), np.arange(F))
    for re, im in cols:
        assert np.all(re // D == im // D) and np.all(re % D < D // 2)
        if D == 32:
            assert np.array_equal(np.sort(np.concatenate([re, im])),
                                  np.arange(re[0], re[0] + 64))
    assert len(cols) == -(-F // 2 // POSITIONS)


@pytest.mark.parametrize("D,F", sorted({(D, F) for D, F, _ in ROTATE}))
@pytest.mark.parametrize("case", list(CASES))
def test_k8b_dx_segments_sum_to_the_plain_version(rng, case, D, F):
    """K8b's dx pass: each source row's segments, slice by slice, conj(rel)
    (x) g at each edge's destination; no x is read."""
    _, _, csr, n, w, rel, x, g = _rotate_case(rng, case, F)
    V = len(x)
    want_dx, _ = _rotate_plain(csr, w, rel, x, g, D)
    dst, etype, eid = n["src_dst"], n["src_etype"], n["src_eid"]
    dx = np.zeros((V, F), np.float32)
    for cols in _column_map(F, D):
        def segment_sum(a, b, row, cols=cols):
            return _warp_sum(_conj_terms(rel[etype[a:b]], g[dst[a:b]],
                                         w[eid[a:b]], cols), 1)

        part = _dx_by_segments(n, V, 2 * len(cols[0]), segment_sum)
        dx[:, np.concatenate(cols)] = part
    _close(dx, want_dx)


@pytest.mark.parametrize("D,F,streams", ROTATE)
@pytest.mark.parametrize("case", list(CASES))
def test_k8b_dr_chunks_sum_to_the_plain_version(rng, case, D, F, streams):
    """K8b's dr pass: the (destination tile, relation) chunks, slice by
    slice, conj(x[s]) (x) g[v]; the chunk's relation only places its
    partial row."""
    spec, (_, _, et, edge_of), csr, n, w, rel, x, g = _rotate_case(rng, case,
                                                                   F)
    R = len(rel)
    _, want_dr = _rotate_plain(csr, w, rel, x, g, D)
    tsrc, tdst, teid = n["tile_src"], n["tile_dst"], n["tile_eid"]
    dr = np.zeros((R, F), np.float32)
    for cols in _column_map(F, D):
        def chunk_sum(a, b, r, cols=cols):
            return _warp_sum(_conj_terms(x[tsrc[a:b]], g[tdst[a:b]],
                                         w[teid[a:b]], cols), streams)

        dr[:, np.concatenate(cols)] = _dr_by_chunks(
            n, et, edge_of, R, 2 * len(cols[0]), chunk_sum)
    _close(dr, want_dr)
    if spec.get("empty_rel"):
        assert np.all(dr[R - 1] == 0)


# ---------------------------------------------------------------------------
# the ops on hub rows against the JAX package
# ---------------------------------------------------------------------------

HUB = dict(V=300, E=2400, R=4, B=2, D=4)


def _hub_inputs(rng):
    """A graph with a 700-edge destination hub (row 3), a 700-edge source
    hub (row 11) and rows of 256 and 257 edges both ways, 40 duplicated
    edges, 30 % of the weights 0, the last 4 rows without edges; post-ReLU
    x, rel shared [R, D] and per query [R, B, D], and a cotangent, seeded
    numpy, [V, B, D]."""
    V, E, R, B, D = (HUB[k] for k in "VERBD")
    src, dst, et, copy_of = _edges(
        rng, V, E, R, rows=((3, 700, 0), (11, 0, 700), (5, 256, 257)),
        empty_rows=4)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.3] = 0.0
    w[copy_of >= 0] = w[copy_of[copy_of >= 0]]
    return dict(tri=np.stack([src, dst, et], 1).astype(np.int32), w=w,
                x=np.maximum(rng.normal(size=(V, B, D)), 0).astype(
                    np.float32),
                rel=rng.normal(size=(R, D)).astype(np.float32),
                rel_b=rng.normal(size=(R, B, D)).astype(np.float32),
                cot=rng.normal(size=(V, B, D)).astype(np.float32))


def _jax_grad(inp, rel, layouts, **kw):
    """(out, d rel, d x) of the JAX rspmm under <cot, out>, on
    interpret-mode Pallas over ``layouts``, jitted (one lowering of the
    interpret-mode kernels)."""
    tri = inp["tri"]
    ei, et = jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2])

    def f(r, x):
        out = j_rspmm(ei, et, jnp.asarray(inp["w"]), r, x,
                      num_nodes=HUB["V"], impl="pallas", layouts=layouts,
                      **kw)
        return jnp.sum(out * inp["cot"]), out

    (_, out), (dr, dx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(rel),
                                          jnp.asarray(inp["x"]))
    return [np.asarray(v) for v in (out, dr, dx)]


def _port_grad(inp, rel, **kw):
    g = Graph.from_triplets(inp["tri"], HUB["V"], HUB["R"],
                            edge_weight=inp["w"]).prepare_csr(backward=True)
    assert 11 in g.csr.src_long_rows.tolist()
    assert 3 in g.csr.long_rows.tolist()
    r = torch.from_numpy(rel.copy()).requires_grad_()
    x = torch.from_numpy(inp["x"].copy()).requires_grad_()
    out = generalized_rspmm(g.edge_index, g.edge_type, g.edge_weight, r, x,
                            num_nodes=HUB["V"], csr=g.csr, **kw)
    dr, dx = torch.autograd.grad(out, (r, x), torch.from_numpy(inp["cot"]))
    return [v.detach().numpy() for v in (out, dr, dx)]


def _layouts(inp, **kw):
    tri = inp["tri"]
    return build_rspmm_layouts(tri[:, :2], tri[:, 2], HUB["V"], HUB["R"],
                               tile_rows=16, tile_edges=32, blocked=True,
                               block_rows=16, **kw)


@pytest.mark.parametrize("interleave", [0, 8])
@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("msg", ["mul", "add"])
def test_extremum_on_hub_rows_matches_jax_pallas(rng, msg, agg, interleave):
    """agg max and min (K4 forward, K5 backward on the card) against the
    TPU kernels: the per-edge K5 backward on the blocked layouts
    (interleave 0) and K5b on the interleaved ones."""
    inp = _hub_inputs(rng)
    want = _jax_grad(inp, inp["rel_b"], _layouts(
        inp, bwd_block_rows=8, interleave=interleave), msg=msg, agg=agg)
    got = _port_grad(inp, inp["rel_b"], msg=msg, agg=agg)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("per_batch", [False, True])
def test_rotate_on_hub_rows_matches_jax_pallas(rng, per_batch):
    """The rotate sum (K8f forward, K8b backward on the card) against the
    TPU kernels K8f and K8b on explicitly blocked layouts (elsewhere the
    JAX rotate silently takes XLA)."""
    inp = _hub_inputs(rng)
    rel = inp["rel_b"] if per_batch else inp["rel"]
    layouts = _layouts(inp)
    assert layouts.fwd_blk is not None and layouts.rev_blk is not None
    want = _jax_grad(inp, rel, layouts, msg="rotate")
    got = _port_grad(inp, rel, msg="rotate")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the build check that holds other kernels' code to the parent's
# ---------------------------------------------------------------------------


def test_build_diff_reads_registers_and_spills():
    """diagnostics/build_diff.py reads each kernel's registers and spilled
    bytes from nvcc's -Xptxas -v lines (no card or nvcc needed here)."""
    from ultra_torchdrug_tpu_torch.diagnostics.build_diff import resources

    log = """ptxas info    : Compiling entry function '_Z4rowsv' for 'sm_90a'
ptxas info    : Function properties for _Z4rowsv
    0 bytes stack frame, 52 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6chunksv' for 'sm_90a'
ptxas info    : Function properties for _Z6chunksv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert resources(log) == [("_Z4rowsv", 64, 52), ("_Z6chunksv", 126, 0)]

"""The layouts of K6b and K7b (classic NBFNet's PNA backward,
csrc/rspmm_pna_bwd.cu) on the CPU: K2's hub-aware layouts
(data/graph.py::build_csr) and each (destination tile, relation) chunk's
relation ``tile_chunk_rel``. Each case forms K6b's (``argext_pair``, modes
mul_rel and add_rel) and K7b's (``moments``) gradients with numpy over the
layouts in the kernels' order: the dx pass's segments, each summed in edge
order, then the long rows' partial rows in segment order; the dr pass's
chunks, their edges dealt round-robin to the warp's edge streams (two on
the vector path, one on the scalar path), each stream's sum in edge order,
the streams combined by a butterfly, then each relation's partial rows in
slot order. The coefficients are the kernels' (K6b's gates recompute K6's
message and compare it bitwise with the saved extrema). The results are
held to ``pna_bwd_plain``, which uses none of these layouts, within rtol
1e-5 and atol the larger of 1e-4 and 1e-5 of the largest entry (the sums
run in another order). The graphs have rows of 256, 257 and 700 edges in
both directions, duplicated edges (exact ties), weight-0 edges, rows
without edges and a relation without edges.

Last, the port's ``generalized_rspmm_maxmin`` and
``generalized_rspmm_addsq`` gradients on such a hub graph against the JAX
package's, as tests/test_torch_pna.py runs them: the same seeded numpy
inputs, the JAX gradients through interpret-mode Pallas on the blocked
layouts with interleave 8, F = 8; max and min exactly, their gradients
rtol 1e-6 and atol 1e-5, the moments and their gradients rtol and atol
1e-5 (the same products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.ops.csr import build_rspmm_layouts
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_addsq as j_addsq
from ultra_torchdrug_tpu.ops.rspmm import generalized_rspmm_maxmin as j_maxmin
from ultra_torchdrug_tpu_torch.data.graph import (
    DR_CHUNK_EDGES,
    SEGMENT_EDGES,
    TILE_ROWS,
    Graph,
    build_csr,
)
from ultra_torchdrug_tpu_torch.ops.rspmm import (
    generalized_rspmm_addsq,
    generalized_rspmm_maxmin,
)
from ultra_torchdrug_tpu_torch.ops.rspmm_pna_cuda import (
    pna_bwd_plain,
    pna_fwd_plain,
)

F = 8
# the dr pass's edge streams a warp: two of 16 threads on the vector path
# (64 features of 4 floats a thread), one of 32 on the scalar path
STREAMS = (2, 1)
KINDS = [("argext_pair", "mul_rel"), ("argext_pair", "add_rel"),
         ("moments", "mul_rel")]


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


def _case(rng, case):
    """The case's CSR (eid a permutation), masked weights (duplicated edges
    keep their original's), rel, post-ReLU x (exact zeros) and two
    gradients, as numpy float32."""
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
    grads = [rng.normal(size=(V, F)).astype(np.float32) for _ in range(2)]
    n = {k: v.numpy() for k, v in vars(csr).items() if v is not None}
    return spec, (src, dst, et, np.argsort(ids)), csr, n, w, rel, x, grads


def _planes(kind, mode, csr, w, rel, x, grads):
    """The backward's planes: K6's own outputs (so that the gates fire) and
    the gradients, as numpy."""
    if kind == "moments":
        return grads
    mx, mn = (t.numpy() for t in pna_fwd_plain(
        "maxmin", csr, torch.from_numpy(w), torch.from_numpy(rel),
        torch.from_numpy(x), mode))
    return [grads[0], mx, grads[1], mn]


def _terms(kind, mode, rel_e, x_e, w_e, planes_e, dx: bool):
    """Each edge's term of the dx pass (rel * c) or the dr pass (x * c), c
    alone for add_rel, as the kernel forms c (float32)."""
    w = w_e[:, None]
    if kind == "argext_pair":
        g_mx, mx, g_mn, mn = planes_e
        m = (rel_e * x_e if mode == "mul_rel" else rel_e + x_e) * w
        c = (np.where(m == mx, g_mx * w, np.float32(0))
             + np.where(m == mn, g_mn * w, np.float32(0)))
    else:
        g_s, g_sq = planes_e
        c = g_s * w + (np.float32(2) * (rel_e * x_e)) * (g_sq * w)
    if mode == "add_rel":
        return c
    return (rel_e if dx else x_e) * c


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


def _plain(kind, mode, csr, w, rel, x, planes):
    return [t.numpy() for t in pna_bwd_plain(
        kind, csr, torch.from_numpy(w), torch.from_numpy(rel),
        torch.from_numpy(x), [torch.from_numpy(p) for p in planes], mode)]


@pytest.mark.parametrize("kind,mode", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_dx_segments_sum_to_the_plain_version(rng, case, kind, mode):
    """The dx pass: each source row's segments, x[s] once a segment, the
    planes at each edge's destination."""
    spec, _, csr, n, w, rel, x, grads = _case(rng, case)
    V = len(n["src_rowptr"]) - 1
    planes = _planes(kind, mode, csr, w, rel, x, grads)
    want_dx, _ = _plain(kind, mode, csr, w, rel, x, planes)
    seg_ptr, seg_out = n["src_seg_ptr"], n["src_seg_out"]
    long_rows, long_ptr = n["src_long_rows"], n["src_long_ptr"]
    degree = np.diff(n["src_rowptr"])
    for row, _, n_out in spec.get("rows", ()):
        assert degree[row] == n_out
        assert (row in long_rows) == (n_out > SEGMENT_EDGES)
    # each segment's row: its own, or the long row whose slots hold it
    seg_row = np.where(seg_out >= 0, seg_out, long_rows[np.searchsorted(
        long_ptr[1:], ~seg_out, side="right")] if len(long_rows) else 0)
    dst, etype, eid = n["src_dst"], n["src_etype"], n["src_eid"]
    dx = np.full((V, F), np.nan, np.float32)
    partial = np.zeros((max(long_ptr[-1], 1), F), np.float32)
    for i in range(len(seg_out)):
        a, b = seg_ptr[i], seg_ptr[i + 1]
        assert b - a <= SEGMENT_EDGES
        assert np.all(np.repeat(np.arange(V), degree)[a:b] == seg_row[i])
        xs = np.broadcast_to(x[seg_row[i]], (b - a, F))
        total = _warp_sum(_terms(kind, mode, rel[etype[a:b]], xs,
                                 w[eid[a:b]], [p[dst[a:b]] for p in planes],
                                 dx=True), 1)
        if seg_out[i] >= 0:
            dx[seg_out[i]] = total
        else:
            partial[~seg_out[i]] = total
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        acc = np.zeros(F, np.float32)
        for p in range(a, b):
            acc = acc + partial[p]
        dx[row] = acc
    assert not np.isnan(dx).any()  # every row written
    _close(dx, want_dx)
    assert np.all(dx[degree == 0] == 0)
    if spec.get("empty_rows"):
        assert np.all(degree[-spec["empty_rows"]:] == 0)


@pytest.mark.parametrize("streams", STREAMS)
@pytest.mark.parametrize("kind,mode", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_dr_chunks_sum_to_the_plain_version(rng, case, kind, mode, streams):
    """The dr pass: the (destination tile, relation) chunks, each chunk's
    relation from tile_chunk_rel."""
    spec, (src, dst, et, edge_of), csr, n, w, rel, x, grads = _case(rng,
                                                                    case)
    R, E = len(rel), len(src)
    planes = _planes(kind, mode, csr, w, rel, x, grads)
    _, want_dr = _plain(kind, mode, csr, w, rel, x, planes)
    ptr, slot, chunk_rel = (n["tile_chunk_ptr"], n["tile_chunk_slot"],
                            n["tile_chunk_rel"])
    rel_ptr = n["tile_rel_ptr"]
    tsrc, tdst, teid = n["tile_src"], n["tile_dst"], n["tile_eid"]
    tet = et[edge_of[teid]]
    C = len(ptr) - 1
    assert len(chunk_rel) == C and ptr[-1] == E
    partial = np.zeros((C, F), np.float32)
    for c in range(C):
        a, b = ptr[c], ptr[c + 1]
        assert 0 < b - a <= DR_CHUNK_EDGES
        assert np.all(tet[a:b] == chunk_rel[c])
        assert len(set(tdst[a:b] // TILE_ROWS)) == 1
        assert np.all(np.diff(tdst[a:b]) >= 0)  # sorted destinations
        rel_e = np.broadcast_to(rel[chunk_rel[c]], (b - a, F))
        partial[slot[c]] = _warp_sum(_terms(
            kind, mode, rel_e, x[tsrc[a:b]], w[teid[a:b]],
            [p[tdst[a:b]] for p in planes], dx=False), streams)
    chunk_at = np.argsort(slot)
    dr = np.zeros((R, F), np.float32)
    for r in range(R):
        assert np.all(chunk_rel[chunk_at[rel_ptr[r]:rel_ptr[r + 1]]] == r)
        for p in range(rel_ptr[r], rel_ptr[r + 1]):
            dr[r] = dr[r] + partial[p]
    _close(dr, want_dr)
    if spec.get("empty_rel"):
        assert rel_ptr[R - 1] == rel_ptr[R] and np.all(dr[R - 1] == 0)


def test_duplicated_edges_tie_and_take_the_full_gradient(rng):
    """A duplicated edge's message equals its original's bit for bit, so
    where one is the extremum both are, and each gets all of g (the TPU
    kernels' convention, ultra_torchdrug_tpu/ops/rspmm.py:195-198): the dx
    terms of the pair are equal."""
    _, (src, dst, et, _), csr, n, w, rel, x, grads = _case(
        rng, "rows of 256 and 257 edges")
    planes = _planes("argext_pair", "mul_rel", csr, w, rel, x, grads)
    dst_s, etype, eid = n["src_dst"], n["src_etype"], n["src_eid"]
    terms = _terms("argext_pair", "mul_rel", rel[etype],
                   x[np.repeat(np.arange(len(x)), np.diff(n["src_rowptr"]))],
                   w[eid], [p[dst_s] for p in planes], dx=True)
    key = np.stack([np.repeat(np.arange(len(x)), np.diff(n["src_rowptr"])),
                    dst_s, etype, w[eid].view(np.int32)], 1)
    _, first, counts = np.unique(key, axis=0, return_index=True,
                                 return_counts=True)
    pairs = 0
    for k in np.flatnonzero(counts > 1):
        same = np.flatnonzero((key == key[first[k]]).all(1))
        assert np.array_equal(terms[same[0]], terms[same[1]])
        pairs += bool(np.any(terms[same[0]] != 0))
    assert pairs > 0  # some duplicated pair is gated somewhere


HUB = dict(V=300, E=2400, R=4, B=2, D=4)


def _hub_inputs(rng):
    """A graph with a 700-edge destination hub (row 3), a 700-edge source
    hub (row 11) and rows of 256 and 257 edges both ways, 40 duplicated
    edges, 30 % of the weights 0, post-ReLU x and two cotangents, seeded
    numpy."""
    V, E, R, B, D = (HUB[k] for k in "VERBD")
    src, dst, et, copy_of = _edges(
        rng, V, E, R, rows=((3, 700, 0), (11, 0, 700), (5, 256, 257)),
        empty_rows=4)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.3] = 0.0
    w[copy_of >= 0] = w[copy_of[copy_of >= 0]]
    return dict(tri=np.stack([src, dst, et], 1).astype(np.int32), w=w, V=V,
                R=R, x=np.maximum(rng.normal(size=(V, B * D)), 0).astype(
                    np.float32),
                rel=rng.normal(size=(R, B * D)).astype(np.float32),
                g=[rng.normal(size=(V, B * D)).astype(np.float32)
                   for _ in range(2)])


def _jax_pair(op, inp, **kw):
    """(a, b, d rel, d x) of a JAX pair op through interpret-mode Pallas on
    the blocked layouts (interleave 8), jax.grad of <g0, a> + <g1, b>."""
    tri = inp["tri"]
    layouts = build_rspmm_layouts(
        tri[:, :2], tri[:, 2], inp["V"], inp["R"], tile_rows=16,
        tile_edges=32, blocked=True, block_rows=16, bwd_block_rows=8,
        interleave=8)
    ei, et = jnp.asarray(tri[:, :2]), jnp.asarray(tri[:, 2])

    def f(rel, x):
        a, b = op(ei, et, jnp.asarray(inp["w"]), rel, x, num_nodes=inp["V"],
                  impl="pallas", layouts=layouts, **kw)
        return jnp.sum(a * inp["g"][0]) + jnp.sum(b * inp["g"][1]), (a, b)

    (_, (a, b)), (dr, dx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(inp["rel"]),
                                          jnp.asarray(inp["x"]))
    return [np.asarray(v) for v in (a, b, dr, dx)]


def _port_pair(op, inp, **kw):
    g = Graph.from_triplets(inp["tri"], inp["V"], inp["R"],
                            edge_weight=inp["w"]).prepare_csr(backward=True)
    assert 11 in g.csr.src_long_rows.tolist()
    assert 3 in g.csr.long_rows.tolist()
    rel = torch.from_numpy(inp["rel"]).requires_grad_()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    a, b = op(g.edge_index, g.edge_type, g.edge_weight, rel, x,
              num_nodes=inp["V"], csr=g.csr, **kw)
    loss = ((a * torch.from_numpy(inp["g"][0])).sum()
            + (b * torch.from_numpy(inp["g"][1])).sum())
    dr, dx = torch.autograd.grad(loss, (rel, x))
    return [v.detach().numpy() for v in (a, b, dr, dx)]


@pytest.mark.parametrize("op", ["maxmin_mul", "maxmin_add", "addsq"])
def test_pna_pairs_on_hub_rows_match_jax_pallas(rng, op):
    inp = _hub_inputs(rng)
    if op == "addsq":
        want = _jax_pair(j_addsq, inp)
        got = _port_pair(generalized_rspmm_addsq, inp)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    msg = op.split("_")[1]
    want = _jax_pair(j_maxmin, inp, msg=msg)
    got = _port_pair(generalized_rspmm_maxmin, inp, msg=msg)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)

"""The layouts of K2h (the bf16 distmult backward, csrc/rspmm_bwd.cu on
csrc/rspmm_staged.cuh) and K8f (the rotate forward, csrc/rspmm_rotate.cu) on
the CPU. K2h runs K2's passes with bf16 operands: the source rows cut into
256-edge segments (dx) and the (destination tile, relation) chunks (dr),
data/graph.py::build_csr's ``src_seg_*`` and ``tile_*``. K8f runs K1's
destination rows cut into 256-edge segments (``seg_*``, ``long_*``) with a
complex body. Each case forms the sums with numpy over the layouts in the
kernels' order: each segment summed in edge order, then the long rows'
partial rows in segment order; each chunk's edges dealt round-robin to the
warp's edge streams (K2h's dr pass: four streams of 8 threads on the
16-byte path, 64 bf16 features a slice, one of 32 on the scalar path),
each stream's sum
in edge order, the streams combined by a butterfly, then each relation's
partial rows in slot order. K2h's operands are rounded to bf16 and widened
to fp32, its products taken in fp32 with g·w formed first: rel ⊙ (g·w) for
dx, x ⊙ (g·w) for dr. K8f's sums run slice by slice over its complex
column map (slices of 32 complex positions, real parts at b·D + k, imaginary
parts D/2 further) for D = 32, 128 and 6, each term (rel ⊗ x)·w.

The results are held to ``rspmm_bwd_bf16_plain`` and to K8f's plain version
(``rspmm_fwd_plain``, mode ``rot_rel``), which use none of these layouts:
K2h's dx within rtol 1e-5 and atol 1e-4, its dr within atol the larger of
1e-4 and 1e-5 of the largest entry; K8f within rtol 1e-5 and atol 1e-5 of
the largest entry (at least 1e-5). The sums run in another order. The
graphs have rows of 256, 257 and 700 edges in both directions, duplicated
edges, weight-0 edges, rows without edges and a relation without edges.

Last, the port's ops on such a hub graph against the JAX package's on
interpret-mode Pallas: ``generalized_rspmm`` with
``compute_dtype="bfloat16"`` (distmult: forward and both gradients, the
JAX reference compiled with ``xla_allow_excess_precision`` off, as
tests/test_torch_bf16.py runs it; rtol = atol = 1e-5), and the rotate sum
on explicitly blocked layouts, as tests/test_torch_rotate.py runs it
(rtol = atol = 1e-5).
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
from ultra_torchdrug_tpu_torch.ops.rspmm_bwd_cuda import rspmm_bwd_bf16_plain
from ultra_torchdrug_tpu_torch.ops.rspmm_cuda import rspmm_fwd_plain

# K2h's width and its dr streams a warp: four of 8 threads on the 16-byte
# path (8 lanes a thread, 64 features a slice), one of 32 on the scalar path
F2H = 16
K2H_STREAMS = (4, 1)
# K8f: complex positions a slice, and (D, F): F = 66 at D = 6 ends in a
# slice of one position
POSITIONS = 32
K8F = [(32, 128), (128, 256), (6, 66)]
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
        V=600, E=3000, R=5, rows=((3, 256, 257), (9, 257, 256))),
    "700-edge hubs, empty rows and relation": dict(
        V=5000, E=6000, R=6, rows=((17, 700, 0), (23, 0, 700)),
        empty_rows=5, empty_rel=True),
    "one relation, no long row": dict(V=300, E=2000, R=1),
}


def _case(rng, case, F):
    """The case's CSR (eid a permutation), masked weights (duplicated edges
    keep their original's), rel, x and g ~ N(0, 1) as numpy float32, the
    CSR's fields as numpy, and the original edge of each eid."""
    spec = dict(CASES[case])
    V, E, R = spec.pop("V"), spec.pop("E"), spec.pop("R")
    src, dst, et, copy_of = _edges(rng, V, E, R, **spec)
    ids = rng.permutation(E)  # eid not the identity
    csr = build_csr(src, dst, et, V, R, backward=True, edge_ids=ids)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    dup = copy_of >= 0
    w[ids[dup]] = w[ids[copy_of[dup]]]
    rel, x, g = (rng.normal(size=s).astype(np.float32)
                 for s in ((R, F), (V, F), (V, F)))
    n = {k: v.numpy() for k, v in vars(csr).items() if v is not None}
    return spec, (et, np.argsort(ids)), csr, n, w, rel, x, g


def _bf16(a):
    """a rounded to bf16 (to nearest, ties to even) and widened to fp32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


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


def _close_dx(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _close_dr(got, want):
    atol = max(1e-4, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _close_fwd(got, want):
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _by_segments(seg_ptr, seg_out, long_rows, long_ptr, rowptr, width,
                 segment_sum):
    """A row pass's result [rows, width] from ``segment_sum(a, b, row)`` of
    each segment's edges [a, b), written to its row or to its partial slot,
    then the long rows' partial rows summed in segment order. Checks that
    each segment holds at most SEGMENT_EDGES edges of its row, that every
    row is written once and that rows without edges are 0."""
    degree = np.diff(rowptr)
    row_of = np.repeat(np.arange(len(degree)), degree)
    out = np.full((len(degree), width), np.nan, np.float32)
    partial = np.zeros((max(long_ptr[-1], 1), width), np.float32)
    long_of = {}
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        long_of.update({p: row for p in range(a, b)})
    for i in range(len(seg_out)):
        a, b = seg_ptr[i], seg_ptr[i + 1]
        row = seg_out[i] if seg_out[i] >= 0 else long_of[~seg_out[i]]
        assert b - a <= SEGMENT_EDGES
        assert np.all(row_of[a:b] == row)
        total = segment_sum(a, b, row)
        if seg_out[i] >= 0:
            out[row] = total
        else:
            partial[~seg_out[i]] = total
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        acc = np.zeros(width, np.float32)
        for p in range(a, b):
            acc = acc + partial[p]
        out[row] = acc
    assert not np.isnan(out).any()  # every row written
    assert np.all(out[degree == 0] == 0)
    return out


def _src_segments(n, width, segment_sum):
    return _by_segments(n["src_seg_ptr"], n["src_seg_out"],
                        n["src_long_rows"], n["src_long_ptr"],
                        n["src_rowptr"], width, segment_sum)


def _dst_segments(n, width, segment_sum):
    return _by_segments(n["seg_ptr"], n["seg_out"], n["long_rows"],
                        n["long_ptr"], n["rowptr"], width, segment_sum)


def _dr_by_chunks(n, et, edge_of, R, width, chunk_sum):
    """dr [R, width] from ``chunk_sum(a, b)`` of each (destination tile,
    relation) chunk's edges [a, b) in tile order, written to its slot, then
    each relation's partial rows summed in slot order."""
    ptr, slot, chunk_rel = (n["tile_chunk_ptr"], n["tile_chunk_slot"],
                            n["tile_chunk_rel"])
    rel_ptr, tdst = n["tile_rel_ptr"], n["tile_dst"]
    tet = et[edge_of[n["tile_eid"]]]
    partial = np.zeros((len(ptr) - 1, width), np.float32)
    for c in range(len(ptr) - 1):
        a, b = ptr[c], ptr[c + 1]
        assert 0 < b - a <= DR_CHUNK_EDGES
        assert np.all(tet[a:b] == chunk_rel[c])
        assert len(set(tdst[a:b] // TILE_ROWS)) == 1
        partial[slot[c]] = chunk_sum(a, b)
    chunk_at = np.argsort(slot)
    dr = np.zeros((R, width), np.float32)
    for r in range(R):
        assert np.all(chunk_rel[chunk_at[rel_ptr[r]:rel_ptr[r + 1]]] == r)
        for p in range(rel_ptr[r], rel_ptr[r + 1]):
            dr[r] = dr[r] + partial[p]
    return dr


def _k2h_plain(csr, w, rel, x, g):
    return [t.numpy() for t in rspmm_bwd_bf16_plain(
        csr, *(torch.from_numpy(a) for a in (w, rel, x, g)))]


# ---------------------------------------------------------------------------
# K2h
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_k2h_dx_segments_sum_to_the_plain_version(rng, case):
    """K2h's dx pass: each source row's segments, rel[r] ⊙ (g[v] · w) of
    the bf16-rounded operands in fp32."""
    spec, _, csr, n, w, rel, x, g = _case(rng, case, F2H)
    want_dx, _ = _k2h_plain(csr, w, rel, x, g)
    rel_h, g_h = _bf16(rel), _bf16(g)
    dst, etype, eid = n["src_dst"], n["src_etype"], n["src_eid"]
    for row, _, n_out in spec.get("rows", ()):
        assert (row in n["src_long_rows"]) == (n_out > SEGMENT_EDGES)

    def segment_sum(a, b, row):
        gw = g_h[dst[a:b]] * w[eid[a:b], None]
        return _warp_sum(rel_h[etype[a:b]] * gw, 1)

    _close_dx(_src_segments(n, F2H, segment_sum), want_dx)


@pytest.mark.parametrize("streams", K2H_STREAMS)
@pytest.mark.parametrize("case", list(CASES))
def test_k2h_dr_chunks_sum_to_the_plain_version(rng, case, streams):
    """K2h's dr pass: the (destination tile, relation) chunks, x[s] ⊙
    (g[v] · w) of the bf16-rounded operands in fp32; the chunk's relation
    only places its partial row."""
    spec, (et, edge_of), csr, n, w, rel, x, g = _case(rng, case, F2H)
    R = len(rel)
    _, want_dr = _k2h_plain(csr, w, rel, x, g)
    x_h, g_h = _bf16(x), _bf16(g)
    tsrc, tdst, teid = n["tile_src"], n["tile_dst"], n["tile_eid"]

    def chunk_sum(a, b):
        gw = g_h[tdst[a:b]] * w[teid[a:b], None]
        return _warp_sum(x_h[tsrc[a:b]] * gw, streams)

    dr = _dr_by_chunks(n, et, edge_of, R, F2H, chunk_sum)
    _close_dr(dr, want_dr)
    if spec.get("empty_rel"):
        assert np.all(dr[R - 1] == 0)


def test_k2h_plain_version_rounds_its_operands(rng):
    """The plain K2h rounds its operands to bf16: it gives the same sums
    on the operands and on their roundings, and its dx differs from the
    sums of the unrounded products by more than K2h's tolerance."""
    _, _, csr, n, w, rel, x, g = _case(rng, "one relation, no long row", F2H)
    dx_h, dr_h = _k2h_plain(csr, w, rel, x, g)
    dx_r, dr_r = _k2h_plain(csr, w, _bf16(rel), _bf16(x), _bf16(g))
    np.testing.assert_array_equal(dx_h, dx_r)
    np.testing.assert_array_equal(dr_h, dr_r)
    src = np.repeat(np.arange(len(x)), np.diff(n["src_rowptr"]))
    dst, eid = n["src_dst"], n["src_eid"]
    exact = np.zeros_like(dx_h)
    np.add.at(exact, src, rel[0] * (g[dst] * w[eid, None]))
    assert np.abs(dx_h - exact).max() > 1e-4  # the rounding shows


# ---------------------------------------------------------------------------
# K8f
# ---------------------------------------------------------------------------


def _column_map(F, D):
    """K8f's (and K8b's) slices of a row of F features in blocks of D: for
    each slice of POSITIONS complex positions p, the columns of their real
    parts (p // (D/2)) * D + p % (D/2) and of their imaginary parts, D / 2
    further (csrc/rspmm_rotate.cu::position_offset)."""
    half, P = D // 2, F // 2
    out = []
    for p0 in range(0, P, POSITIONS):
        p = np.arange(p0, min(p0 + POSITIONS, P))
        re = (p // half) * D + p % half
        out.append((re, re + half))
    return out


def _rot_terms(a_e, b_e, w_e, cols):
    """(a (x) b) * w per edge on one slice's columns (re, im), the real
    parts then the imaginary parts, as the kernel forms them (float32)."""
    re, im = cols
    ar, ai, br, bi = a_e[:, re], a_e[:, im], b_e[:, re], b_e[:, im]
    w = w_e[:, None]
    return np.concatenate([(ar * br - ai * bi) * w, (ar * bi + br * ai) * w],
                          1)


@pytest.mark.parametrize("D,F", K8F)
@pytest.mark.parametrize("case", list(CASES))
def test_k8f_segments_sum_to_the_plain_version(rng, case, D, F):
    """K8f: each destination row's segments, slice by slice, rel[r] (x)
    x[s] weighted; K1's segments of the same CSR."""
    spec, _, csr, n, w, rel, x, _ = _case(rng, case, F)
    want = rspmm_fwd_plain(csr.rowptr, csr.src, csr.etype, csr.eid,
                           torch.from_numpy(w), torch.from_numpy(rel),
                           torch.from_numpy(x), "rot_rel", D).numpy()
    src, etype, eid = n["src"], n["etype"], n["eid"]
    for row, n_in, _ in spec.get("rows", ()):
        assert (row in n["long_rows"]) == (n_in > SEGMENT_EDGES)
    out = np.zeros((len(n["rowptr"]) - 1, F), np.float32)
    for cols in _column_map(F, D):
        def segment_sum(a, b, row, cols=cols):
            return _warp_sum(_rot_terms(rel[etype[a:b]], x[src[a:b]],
                                        w[eid[a:b]], cols), 1)

        out[:, np.concatenate(cols)] = _dst_segments(n, 2 * len(cols[0]),
                                                     segment_sum)
    _close_fwd(out, want)


@pytest.mark.parametrize("D,F", [(32, 128), (128, 256), (6, 66), (6, 6)])
def test_k8f_column_map_covers_each_column_once(D, F):
    """The slices' real and imaginary columns partition the row, each
    imaginary part D / 2 after its real part in the same block."""
    cols = _column_map(F, D)
    allc = np.concatenate([np.concatenate(c) for c in cols])
    assert np.array_equal(np.sort(allc), np.arange(F))
    for re, im in cols:
        assert np.all(re // D == im // D) and np.all(re % D < D // 2)
    assert len(cols) == -(-F // 2 // POSITIONS)


# ---------------------------------------------------------------------------
# the ops on hub rows against the JAX package
# ---------------------------------------------------------------------------

HUB = dict(V=300, E=2400, R=4, B=2)


def _hub_inputs(rng, D):
    """A graph with a 700-edge destination hub (row 3), a 700-edge source
    hub (row 11) and rows of 256 and 257 edges both ways, 40 duplicated
    edges, 30 % of the weights 0, the last 4 rows without edges; x, rel
    shared [R, D] and per query [R, B, D], and a cotangent, seeded numpy,
    [V, B, D]."""
    V, E, R, B = (HUB[k] for k in "VERB")
    src, dst, et, copy_of = _edges(
        rng, V, E, R, rows=((3, 700, 0), (11, 0, 700), (5, 256, 257)),
        empty_rows=4)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.3] = 0.0
    w[copy_of >= 0] = w[copy_of[copy_of >= 0]]
    return dict(tri=np.stack([src, dst, et], 1).astype(np.int32), w=w,
                x=rng.normal(size=(V, B, D)).astype(np.float32),
                rel=rng.normal(size=(R, D)).astype(np.float32),
                rel_b=rng.normal(size=(R, B, D)).astype(np.float32),
                cot=rng.normal(size=(V, B, D)).astype(np.float32))


def _jax_grad(inp, rel, layouts, compile_options=None, **kw):
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

    args = (jnp.asarray(rel), jnp.asarray(inp["x"]))
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    (_, out), (dr, dx) = fn.lower(*args).compile(
        compiler_options=compile_options)(*args)
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


@pytest.mark.parametrize("per_batch", [False, True])
def test_bf16_op_on_hub_rows_matches_jax_pallas(rng, per_batch):
    """The distmult sum with compute_dtype="bfloat16" (K1h forward, K2h
    backward on the card) against the TPU kernels with the same mode: the
    forward and both gradients."""
    inp = _hub_inputs(rng, 4)
    rel = inp["rel_b"] if per_batch else inp["rel"]
    tri = inp["tri"]
    layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], HUB["V"], HUB["R"],
                                  tile_rows=16, tile_edges=32,
                                  include_rel_layout=True)
    want = _jax_grad(inp, rel, layouts, EXACT_XLA, msg="mul",
                     compute_dtype=BF16)
    got = _port_grad(inp, rel, msg="mul", compute_dtype=BF16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_batch", [False, True])
def test_rotate_on_hub_rows_matches_jax_pallas(rng, per_batch):
    """The rotate sum (K8f forward, K8b backward on the card) at D = 6 (the
    kernels' scalar path) against the TPU kernels K8f and K8b on explicitly
    blocked layouts (elsewhere the JAX rotate silently takes XLA)."""
    inp = _hub_inputs(rng, 6)
    rel = inp["rel_b"] if per_batch else inp["rel"]
    tri = inp["tri"]
    layouts = build_rspmm_layouts(tri[:, :2], tri[:, 2], HUB["V"], HUB["R"],
                                  tile_rows=16, tile_edges=32, blocked=True,
                                  block_rows=16)
    assert layouts.fwd_blk is not None and layouts.rev_blk is not None
    want = _jax_grad(inp, rel, layouts, msg="rotate")
    got = _port_grad(inp, rel, msg="rotate")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the build check that holds other kernels' code to the parent's
# ---------------------------------------------------------------------------


def test_build_diff_names_kernels_without_parameters_and_renames():
    """diagnostics/build_diff.py names a kernel by its demangled name
    without the parameter list (anonymous namespaces and cu++filt's
    template-value casts keep their parentheses), and --rename's patterns
    map an fp32 instantiation that gained the operand type, and K8b's that
    gained the sign, to the parent's names (no card or nvcc needed)."""
    import re

    from ultra_torchdrug_tpu_torch.diagnostics.build_diff import (
        without_parameters,
    )

    name = ("void rspmm::staged::(anonymous namespace)::staged_rows<(int)0, "
            "(bool)1>(rspmm::staged::(anonymous namespace)::Rows<float>)")
    assert without_parameters(name) == (
        "void rspmm::staged::(anonymous namespace)::staged_rows<(int)0, "
        "(bool)1>")
    assert without_parameters("void k<1>") == "void k<1>"
    renames = [(", float>$", ">"),
               ("rotate_seg_rows<(.*), true>$", r"rotate_seg_rows<\1>")]

    def renamed(n):
        for pattern, replacement in renames:
            n = re.sub(pattern, replacement, n)
        return n

    assert renamed("void staged_rows<0, 4, 16, true, float>") == (
        "void staged_rows<0, 4, 16, true>")
    assert renamed("void staged_chunks<8, 8, __nv_bfloat16>") == (
        "void staged_chunks<8, 8, __nv_bfloat16>")
    assert renamed("void rotate_seg_rows<4, 8, false, true>") == (
        "void rotate_seg_rows<4, 8, false>")
    assert renamed("void rotate_seg_rows<4, 8, true, false>") == (
        "void rotate_seg_rows<4, 8, true, false>")

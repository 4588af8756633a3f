"""K3's layouts (data/graph.py::build_csr with backward=True), on the CPU:
the source rows cut into segments (its dx pass) and the edges cut into
(destination tile, relation) chunks (its dr pass). Each case checks the
layout's invariants, then sums g[v] * w over it with numpy as the kernel
does (a partial row per chunk or segment, then the partials in their fixed
order) and holds the result to ``rspmm_bwd_plain``, which uses none of these
layouts, within K3's tolerance: rtol 1e-5 and atol the larger of 1e-4 and
1e-5 of the largest entry (the sums run in another order).
"""

import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu_torch.data.graph import (
    DR_CHUNK_EDGES,
    SEGMENT_EDGES,
    TILE_ROWS,
    build_csr,
)
from ultra_torchdrug_tpu_torch.ops.rspmm_bwd_cuda import rspmm_bwd_plain

F = 8


def _edges(rng, V, E, R, empty_rel=False, hub_row=None, tile_rel=None):
    """E random edges over V rows and R relations (the last one without
    edges with ``empty_rel``); ``hub_row`` sends 700 edges; ``tile_rel``
    puts 400 edges of relation 0 into the first tile."""
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    et = rng.integers(0, R - 1 if empty_rel else R, E)
    if hub_row is not None:
        src[:700] = hub_row
    if tile_rel:
        et[-400:] = 0
        dst[-400:] = rng.integers(0, min(V, TILE_ROWS), 400)
    return src, dst, et


CASES = {
    "empty relation": dict(V=300, E=2000, R=6, empty_rel=True),
    "one relation": dict(V=300, E=2000, R=1),
    "relation over 256 edges in one tile": dict(V=900, E=1500, R=3,
                                                tile_rel=True),
    "V not a multiple of the tile": dict(V=5000, E=6000, R=5),
    "a 700-edge source row": dict(V=5000, E=3000, R=4, hub_row=17,
                                  empty_rel=True),
}


def _close(got, want):
    atol = max(1e-4, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_transe_layouts_cover_and_sum(rng, case):
    spec = dict(CASES[case])
    V, E, R = spec.pop("V"), spec.pop("E"), spec.pop("R")
    src, dst, et = _edges(rng, V, E, R, **spec)
    ids = rng.permutation(E)  # eid not the identity
    csr = build_csr(src, dst, et, V, R, backward=True, edge_ids=ids)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    w[rng.uniform(size=E) < 0.2] = 0.0
    g = rng.normal(size=(V, F)).astype(np.float32)
    want_dx, want_dr = (t.numpy() for t in rspmm_bwd_plain(
        csr, torch.from_numpy(w), torch.zeros((R, F)), None,
        torch.from_numpy(g), mode="add_rel"))
    edge_of = np.argsort(ids)  # original edge index of each eid

    # dr: (destination tile, relation) chunks
    ptr = csr.tile_chunk_ptr.numpy()
    slot = csr.tile_chunk_slot.numpy()
    rel_ptr = csr.tile_rel_ptr.numpy()
    tdst, teid = csr.tile_dst.numpy(), csr.tile_eid.numpy()
    # every edge lands in exactly one chunk
    assert ptr[0] == 0 and ptr[-1] == E and np.all(np.diff(ptr) > 0)
    assert np.array_equal(np.sort(teid), np.arange(E))
    assert np.array_equal(tdst, dst[edge_of[teid]])
    tet = et[edge_of[teid]]
    C = len(ptr) - 1
    tiles = []
    for c in range(C):
        a, b = ptr[c], ptr[c + 1]
        assert b - a <= DR_CHUNK_EDGES
        assert len(set(tet[a:b])) == 1  # one relation
        assert len(set(tdst[a:b] // TILE_ROWS)) == 1  # one tile
        assert np.all(np.diff(tdst[a:b]) >= 0)  # sorted by destination
        tiles.append(tdst[a] // TILE_ROWS)
    assert np.all(np.diff(tiles) >= 0)  # tile-major
    # the slots are relation-major, each relation's chunks in tile order
    assert np.array_equal(np.sort(slot), np.arange(C))
    chunk_at = np.argsort(slot)
    assert rel_ptr[0] == 0 and rel_ptr[-1] == C
    for r in range(R):
        own = chunk_at[rel_ptr[r]:rel_ptr[r + 1]]
        assert np.all(tet[ptr[own]] == r) and np.all(np.diff(own) > 0)
        assert sum(ptr[c + 1] - ptr[c] for c in own) == np.sum(et == r)
    if spec.get("empty_rel"):
        assert rel_ptr[R - 1] == rel_ptr[R]
    if spec.get("tile_rel"):  # relation 0: two chunks or more in tile 0
        assert np.sum(np.array(tiles)[chunk_at[:rel_ptr[1]]] == 0) >= 2
    partial = np.zeros((C, F), np.float32)
    for c in range(C):
        a, b = ptr[c], ptr[c + 1]
        partial[slot[c]] = (g[tdst[a:b]] * w[teid[a:b], None]).sum(0)
    dr = np.stack([partial[rel_ptr[r]:rel_ptr[r + 1]].sum(0)
                   for r in range(R)])
    _close(dr, want_dr)

    # dx: source-row segments, long rows through partial rows
    seg_ptr = csr.src_seg_ptr.numpy()
    seg_out = csr.src_seg_out.numpy()
    long_rows = csr.src_long_rows.numpy()
    long_ptr = csr.src_long_ptr.numpy()
    rowptr = csr.src_rowptr.numpy()
    assert seg_ptr[0] == 0 and seg_ptr[-1] == E
    assert np.all(np.diff(seg_ptr) >= 0)
    assert np.all(np.diff(seg_ptr) <= SEGMENT_EDGES)
    degree = np.diff(rowptr)
    assert np.array_equal(long_rows, np.flatnonzero(degree > SEGMENT_EDGES))
    if spec.get("hub_row") is not None:
        assert spec["hub_row"] in long_rows
    sdst, seid = csr.src_dst.numpy(), csr.src_eid.numpy()
    dx = np.full((V, F), np.nan, np.float32)
    long_partial = np.zeros((max(len(seg_out), 1), F), np.float32)
    for i in range(len(seg_out)):
        a, b = seg_ptr[i], seg_ptr[i + 1]
        total = (g[sdst[a:b]] * w[seid[a:b], None]).sum(0)
        if seg_out[i] >= 0:
            # a row of one segment: exactly that row's edges
            assert (a, b) == (rowptr[seg_out[i]], rowptr[seg_out[i] + 1])
            dx[seg_out[i]] = total
        else:
            long_partial[~seg_out[i]] = total
    for row, a, b in zip(long_rows, long_ptr[:-1], long_ptr[1:]):
        assert b - a == -(-degree[row] // SEGMENT_EDGES)
        dx[row] = long_partial[a:b].sum(0)
    assert not np.isnan(dx).any()  # every row written, rows without edges 0
    assert np.all(dx[degree == 0] == 0)
    _close(dx, want_dx)

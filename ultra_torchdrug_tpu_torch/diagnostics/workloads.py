"""The ladder tools' workloads: P1's chunked synthetic and P2's heavy-tailed
KG, made from the same seeded numpy draws as the TPU scripts.

``kernel_floor_workload`` makes the draws of
script/diagnostics/kernel_floor.py::run_variant (:302-329), in the same
order, and returns the TPU-form arrays (meta, cr, w, data, rel, and the
packed metas of v6_packed and v8_direct_packed) beside the same edges as
K1's destination-sorted CSR. Every chunk of ``te`` edges maps to output
block 0, so an edge's destination is its chunk-local row (meta[c, 2]).

``build_workload`` is a copy of bench.py::build_workload (:25-47): the same
heavy-tailed triplets (and, with ``features``, rel and x). The TPU's P2
(script/diagnostics/blocked_ladder.py:283-292) draws its operands in shapes
that depend on its blocked layout's padding and chunking, which the card
does not build; those draws cannot be reproduced, and P2's operands here
come from a seeded ``torch.Generator`` instead (``blocked_ladder.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.graph import Csr, build_csr

LANE = 128  # the TPU scripts' lane width: data rows are [F // 128, 128]


@dataclasses.dataclass(frozen=True)
class FloorWorkload:
    """P1's arrays. TPU form: meta [C, 4, te] int32 (gather index,
    relation, chunk-local row, 1), cr [2, C], w [C, 1, te], data
    [V, F // 128, 128], rel [R, F // 128, 128]; meta6 / meta8 the packed
    words of v6_packed (idx << 18 | rel << 8 | row) and v8_direct_packed
    (idx << 20 | rel << 10 | row), None where run_variant's bounds on V, R
    and tv do not hold. Edge form: the C * te edges (meta[c, 0] ->
    meta[c, 2], type meta[c, 1]) as K1's CSR over tv rows, the weights
    [E] in edge order, x [V, F] and relation [R, F]."""

    meta: np.ndarray
    cr: np.ndarray
    w: np.ndarray
    data: np.ndarray
    rel: np.ndarray
    meta6: Optional[np.ndarray]
    meta8: Optional[np.ndarray]
    csr: Csr
    edge_weight: np.ndarray
    x: np.ndarray
    relation: np.ndarray

    @property
    def num_edges(self) -> int:
        return self.edge_weight.size


def kernel_floor_workload(E=524288, runlen=32, F=4096, V=4096, R=480, te=8192,
                          tv=256) -> FloorWorkload:
    """run_variant's workload (its defaults): C = E // te chunks of te
    edges with row-sorted destinations in runs of ``runlen`` within tv
    rows, uniform gathers over V rows and relations over R, N(0, 1)
    weights, data and relation rows."""
    ft = F // LANE
    C = E // te
    rng = np.random.default_rng(0)
    meta = np.zeros((C, 4, te), np.int32)
    cr = np.zeros((2, C), np.int32)
    rows_per_chunk = te // runlen
    for c in range(C):
        d = np.repeat(np.arange(rows_per_chunk) % tv, runlen)
        meta[c, 0] = rng.integers(0, V, te)     # gather index
        meta[c, 1] = rng.integers(0, R, te)     # relation
        meta[c, 2] = np.sort(d)[:te]            # row_local
        meta[c, 3] = 1
    cr[1, 0] = 1  # force out-block init on the first chunk
    w = rng.normal(size=(C, 1, te)).astype(np.float32)
    data = rng.normal(size=(V, ft, LANE)).astype(np.float32)
    rel = rng.normal(size=(R, ft, LANE)).astype(np.float32)

    def packed(hi, mid, fits):
        if not fits:
            return None
        out = meta.copy()
        out[:, 0] = (meta[:, 0] << hi) | (meta[:, 1] << mid) | meta[:, 2]
        return out

    src, etype, dst = (meta[:, i].reshape(-1) for i in range(3))
    return FloorWorkload(
        meta=meta, cr=cr, w=w, data=data, rel=rel,
        meta6=packed(18, 8, V <= 1 << 13 and R <= 1 << 10 and tv <= 256),
        meta8=packed(20, 10, V <= 1 << 11 and R <= 1 << 10 and tv <= 1024),
        csr=build_csr(src, dst, etype, tv, R), edge_weight=w.reshape(-1),
        x=data.reshape(V, F), relation=rel.reshape(R, F))


def build_workload(V=15000, E=544 * 1024, R=474, B=64, D=64, seed=0,
                   features=True):
    """Heavy-tailed endpoint distribution (Zipf-like), matching real KG degree
    statistics (FB15k237 etc. are strongly hub-dominated — a uniform-random
    graph would misrepresent both cache behavior and kernel scheduling).

    Returns (triplets [E, 3] int32 (head, tail, relation), rel [R, D] and
    x [V, B, D] float32); without ``features``, (triplets, None, None): the
    triplets come first from the generator and do not change."""
    rng = np.random.default_rng(seed)

    def zipf_nodes(n):
        # 50/50 uniform + zipf(1.5): top-1024 sources cover ~53% of edges,
        # in line with FB15k237-like hub dominance
        n_u = n // 2
        uniform = rng.integers(0, V, n_u)
        ranks = rng.zipf(1.5, size=3 * n)
        ranks = ranks[ranks <= V][: n - n_u] - 1
        perm = rng.permutation(V)  # decouple id order from hotness
        out = np.concatenate([uniform, perm[ranks]])
        return rng.permutation(out).astype(np.int32)

    triplets = np.stack(
        [zipf_nodes(E), zipf_nodes(E), rng.integers(0, R, E)], axis=1
    ).astype(np.int32)
    if not features:
        return triplets, None, None
    rel = rng.normal(size=(R, D)).astype(np.float32) * 0.1
    x = rng.normal(size=(V, B, D)).astype(np.float32) * 0.1
    return triplets, rel, x


@dataclasses.dataclass(frozen=True)
class BlockedWorkload:
    """P2's graph: bench.py's triplets as edges head -> tail (the TPU
    ladder's fwd_blk rows are the tails, blocked_ladder.py:70-76), K1's CSR
    over V rows, and the in-degree statistics that make it heavy-tailed."""

    csr: Csr
    num_nodes: int
    num_relations: int
    num_edges: int
    max_in_degree: int
    top1024_share: float
    median_in_degree: float


def blocked_ladder_workload(V=15000, E=544 * 1024, R=474) -> BlockedWorkload:
    """bench.py's KG with seed 0, as the TPU ladder's build_workload()."""
    tri, _, _ = build_workload(V=V, E=E, R=R, features=False)
    deg = np.bincount(tri[:, 1], minlength=V)
    top = np.sort(deg)[::-1]
    return BlockedWorkload(
        csr=build_csr(tri[:, 0], tri[:, 1], tri[:, 2], V, R), num_nodes=V,
        num_relations=R, num_edges=len(tri), max_in_degree=int(top[0]),
        top1024_share=float(top[:1024].sum() / max(len(tri), 1)),
        median_in_degree=float(np.median(deg)))


def blocked_operands(wl: BlockedWorkload, feat: int, device):
    """P2's operands on ``device`` from a torch.Generator seeded with 0, as
    the TPU ladder's default_rng(0): x [V, F], relation [R, F] and edge
    weights [E], all N(0, 1) as the TPU ladder's."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((wl.num_nodes, feat), generator=gen, device=device)
    rel = torch.randn((wl.num_relations, feat), generator=gen, device=device)
    w = torch.randn((wl.num_edges,), generator=gen, device=device)
    return w, rel, x

"""Static-shape relational graph (counterpart of ultra_torchdrug_tpu/data/graph.py).

Edges are never deleted once a graph is built: masking multiplies the edge
weight by 0, so shapes stay fixed and a weight-0 edge contributes nothing to
any aggregation. Graphs are built on the host (CPU tensors) and moved to the
device with ``Graph.to``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..ops.match import PatternJoinIndex, build_pattern_join
from ..ops.rspmm_cuda import RowSegments

# edges per chunk of the relation-sorted order (the dr pass of the rspmm
# backward reduces one chunk per CTA, then each relation's chunks in order)
DR_CHUNK_EDGES = 256
# the hub-aware layouts of K1, K2 and K3: rows are cut into segments of at
# most SEGMENT_EDGES edges (K1 over the destination rows, the dx passes of
# K2 and K3 over the source rows), and the dr passes read the edges by
# destination tiles of TILE_ROWS rows, so that the chunks that run together
# gather from one tile of g (16 MB at F = 2,048) while it sits in the L2
SEGMENT_EDGES = 256
TILE_ROWS = 2048


@dataclasses.dataclass(frozen=True)
class Csr:
    """The rspmm kernels' layouts of a graph's topology (ops/rspmm_cuda.py,
    ops/rspmm_bwd_cuda.py). A pure function of topology: edge weights are
    gathered per call through the ``*eid`` arrays, so masked weights need no
    new layout. All int32.

    Destination-sorted CSR (the forward, K1):
      rowptr [V + 1] — edges of row v are [rowptr[v], rowptr[v+1])
      src, etype, eid [E] — source node, edge type and original edge index
        of each edge, in destination order (stable within a row)
    Destination-row segments (K1), over those edges, built for every CSR:
      seg_ptr [S + 1] — segment i is [seg_ptr[i], seg_ptr[i+1]); a row of
        at most SEGMENT_EDGES edges, none included, is one segment, a
        longer row is cut into segments of SEGMENT_EDGES
      seg_out [S] — where segment i's sum goes: its row (>= 0) when the row
        is one segment, else ~slot (< 0), a row of the partial sums
      long_rows [L] — the rows cut into several segments, in order
      long_ptr [L + 1] — row long_rows[l] owns the partial slots
        [long_ptr[l], long_ptr[l+1]), in segment order
    The backward's layouts, None unless ``prepare_csr(backward=True)``
    built them:
    Source-sorted CSR (the plain versions; the edge order of the dx
    passes):
      src_rowptr [V + 1]; src_dst, src_etype, src_eid [E] in source order
    Relation-sorted edges cut into chunks of at most DR_CHUNK_EDGES edges,
    none of which crosses a relation (K2h's dr pass):
      rel_src, rel_dst, rel_eid [E] — in relation order (stable)
      chunk_ptr [C + 1] — chunk c is [chunk_ptr[c], chunk_ptr[c+1])
      chunk_rel [C] — the relation of each chunk
      rel_chunk_ptr [R + 1] — relation r owns chunks
        [rel_chunk_ptr[r], rel_chunk_ptr[r+1]) (none when it has no edge)
    The hub-aware backward layouts (K2, K3, K5, K6b, K7b and K8b), built
    with the others:
    Source-row segments (their dx passes), over the source-sorted edges,
    as the destination-row segments above:
      src_seg_ptr [S + 1], src_seg_out [S], src_long_rows [L],
      src_long_ptr [L + 1]
    (destination tile, relation) chunks (their dr passes):
      tile_src, tile_dst, tile_eid [E] — source, destination and original
        edge index of each edge, sorted by destination tile
        (dst // TILE_ROWS), then relation, then destination (stable)
      tile_chunk_ptr [C + 1] — chunk c is [tile_chunk_ptr[c],
        tile_chunk_ptr[c+1]): at most DR_CHUNK_EDGES edges of one relation
        in one tile; the chunks come tile-major
      tile_chunk_slot [C] — the partial row chunk c writes; the slots are
        relation-major, each relation's chunks in tile order
      tile_chunk_rel [C] — the relation of chunk c (K6b's, K7b's and K5's
        dr pass reads its rel row)
      tile_rel_ptr [R + 1] — relation r's slots are [tile_rel_ptr[r],
        tile_rel_ptr[r+1]), summed in that order (none: no edge)
    """

    rowptr: torch.Tensor
    src: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor
    seg_ptr: Optional[torch.Tensor] = None
    seg_out: Optional[torch.Tensor] = None
    long_rows: Optional[torch.Tensor] = None
    long_ptr: Optional[torch.Tensor] = None
    src_rowptr: Optional[torch.Tensor] = None
    src_dst: Optional[torch.Tensor] = None
    src_etype: Optional[torch.Tensor] = None
    src_eid: Optional[torch.Tensor] = None
    rel_src: Optional[torch.Tensor] = None
    rel_dst: Optional[torch.Tensor] = None
    rel_eid: Optional[torch.Tensor] = None
    chunk_ptr: Optional[torch.Tensor] = None
    chunk_rel: Optional[torch.Tensor] = None
    rel_chunk_ptr: Optional[torch.Tensor] = None
    src_seg_ptr: Optional[torch.Tensor] = None
    src_seg_out: Optional[torch.Tensor] = None
    src_long_rows: Optional[torch.Tensor] = None
    src_long_ptr: Optional[torch.Tensor] = None
    tile_src: Optional[torch.Tensor] = None
    tile_dst: Optional[torch.Tensor] = None
    tile_eid: Optional[torch.Tensor] = None
    tile_chunk_ptr: Optional[torch.Tensor] = None
    tile_chunk_slot: Optional[torch.Tensor] = None
    tile_chunk_rel: Optional[torch.Tensor] = None
    tile_rel_ptr: Optional[torch.Tensor] = None

    @property
    def has_backward(self) -> bool:
        return self.src_rowptr is not None

    @functools.cached_property
    def segments(self) -> Optional[RowSegments]:
        """K1's destination-row segments, checked once per Csr: the
        ``segments`` argument of ops/rspmm_cuda.py::rspmm_fwd_cuda."""
        if self.seg_ptr is None:
            return None
        return RowSegments.of(self.seg_ptr, self.seg_out, self.long_rows,
                              self.long_ptr, self.rowptr.numel() - 1)

    def to(self, device) -> "Csr":
        return Csr(**{f.name: None if (t := getattr(self, f.name)) is None
                      else t.to(device) for f in dataclasses.fields(self)})


def _rowptr(keys: np.ndarray, num_rows: int) -> np.ndarray:
    rowptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_rows), out=rowptr[1:])
    return rowptr


def _relation_chunks(etype_sorted: np.ndarray, num_relations: int,
                     chunk_edges: int):
    """(chunk_ptr [C+1], chunk_rel [C], rel_chunk_ptr [R+1]) for edges
    already sorted by relation."""
    counts = np.bincount(etype_sorted, minlength=num_relations)
    rel_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    per_rel = -(-counts // chunk_edges)
    rel_chunk_ptr = np.zeros(num_relations + 1, np.int64)
    np.cumsum(per_rel, out=rel_chunk_ptr[1:])
    chunk_rel = np.repeat(np.arange(num_relations), per_rel)
    local = np.arange(len(chunk_rel)) - rel_chunk_ptr[chunk_rel]
    chunk_ptr = np.append(rel_start[chunk_rel] + local * chunk_edges,
                          len(etype_sorted))
    return chunk_ptr, chunk_rel, rel_chunk_ptr


def _row_segments(counts: np.ndarray, seg_edges: int):
    """The segments of a CSR with ``counts`` edges per row: (seg_ptr,
    seg_out, long_rows, long_ptr), see ``Csr``."""
    per_row = np.maximum(1, -(-counts // seg_edges))
    seg_row = np.repeat(np.arange(len(counts)), per_row)
    first = np.cumsum(per_row) - per_row
    local = np.arange(len(seg_row)) - first[seg_row]
    row_start = np.cumsum(counts) - counts
    seg_ptr = np.append(row_start[seg_row] + local * seg_edges, counts.sum())
    cut = per_row > 1
    in_long = cut[seg_row]
    slot = np.cumsum(in_long) - 1
    seg_out = np.where(in_long, ~slot, seg_row)
    long_rows = np.flatnonzero(cut)
    long_ptr = np.zeros(len(long_rows) + 1, np.int64)
    np.cumsum(per_row[long_rows], out=long_ptr[1:])
    return seg_ptr, seg_out, long_rows, long_ptr


def row_segments(rowptr: torch.Tensor) -> RowSegments:
    """The destination-row segments (``Csr.segments``) of the CSR with
    this rowptr, on its device."""
    counts = np.diff(rowptr.cpu().numpy().astype(np.int64))
    parts = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        rowptr.device) for a in _row_segments(counts, SEGMENT_EDGES))
    return RowSegments.of(*parts, len(counts))


def _tile_chunks(dst: np.ndarray, etype: np.ndarray, num_relations: int,
                 tile_rows: int, chunk_edges: int, by_dst: np.ndarray):
    """The dr chunks of K2, K3, K6b and K7b: (edge order, tile_chunk_ptr,
    tile_chunk_slot, tile_chunk_rel, tile_rel_ptr), see ``Csr``; ``by_dst``
    is the stable destination order."""
    tile = dst // tile_rows
    group = tile * num_relations + etype
    num_groups = (int(tile.max()) + 1 if len(tile) else 0) * num_relations
    # a stable sort by (tile, relation) of the destination order: by tile,
    # relation, destination, then original index; 16-bit keys sort by radix
    key = group[by_dst]
    if num_groups <= 1 << 16:
        key = key.astype(np.uint16)
    order = by_dst[np.argsort(key, kind="stable")]
    counts = np.bincount(group, minlength=num_groups)
    per_group = -(-counts // chunk_edges)
    group_first = np.cumsum(per_group) - per_group
    chunk_group = np.repeat(np.arange(num_groups), per_group)
    local = np.arange(len(chunk_group)) - group_first[chunk_group]
    group_start = np.cumsum(counts) - counts
    chunk_ptr = np.append(group_start[chunk_group] + local * chunk_edges,
                          len(dst))
    chunk_rel = chunk_group % max(num_relations, 1)
    slot = np.empty(len(chunk_rel), np.int64)
    slot[np.argsort(chunk_rel, kind="stable")] = np.arange(len(chunk_rel))
    rel_ptr = np.zeros(num_relations + 1, np.int64)
    np.cumsum(np.bincount(chunk_rel, minlength=num_relations),
              out=rel_ptr[1:])
    return order, chunk_ptr, slot, chunk_rel, rel_ptr


def build_csr(src, dst, etype, num_nodes: int, num_relations: int,
              backward: bool = False, edge_ids=None,
              num_src_nodes: Optional[int] = None) -> Csr:
    """The ``Csr`` of the edges (src[i] -> dst[i], etype[i]) over
    ``num_nodes`` destination rows (host numpy arrays in, CPU tensors out).
    ``eid`` fields hold ``edge_ids[i]`` (default i), the edge's index in the
    weight array that the kernels gather from. ``num_src_nodes`` (default
    ``num_nodes``) is the source side's row count, which the backward's
    source-sorted layouts span: a partitioned shard's reverse CSR has a
    block of source rows and gathers from every destination row."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    et = np.asarray(etype, np.int64)
    if len(src) > np.iinfo(np.int32).max:
        raise ValueError(f"{len(src)} edges exceed the int32 CSR")
    if len(et) and (et.min() < 0 or et.max() >= num_relations):
        raise ValueError(f"edge types must lie in [0, {num_relations})")
    if num_src_nodes is None:
        num_src_nodes = num_nodes
    ids = (np.arange(len(src)) if edge_ids is None
           else np.asarray(edge_ids, np.int64))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    by_dst = np.argsort(dst, kind="stable")
    seg_ptr, seg_out, long_rows, long_ptr = _row_segments(
        np.bincount(dst, minlength=num_nodes), SEGMENT_EDGES)
    layouts = dict(rowptr=i32(_rowptr(dst, num_nodes)), src=i32(src[by_dst]),
                   etype=i32(et[by_dst]), eid=i32(ids[by_dst]),
                   seg_ptr=i32(seg_ptr), seg_out=i32(seg_out),
                   long_rows=i32(long_rows), long_ptr=i32(long_ptr))
    if backward:
        by_src = np.argsort(src, kind="stable")
        by_rel = np.argsort(et, kind="stable")
        chunk_ptr, chunk_rel, rel_chunk_ptr = _relation_chunks(
            et[by_rel], num_relations, DR_CHUNK_EDGES)
        layouts.update(
            src_rowptr=i32(_rowptr(src, num_src_nodes)),
            src_dst=i32(dst[by_src]),
            src_etype=i32(et[by_src]), src_eid=i32(ids[by_src]),
            rel_src=i32(src[by_rel]), rel_dst=i32(dst[by_rel]),
            rel_eid=i32(ids[by_rel]), chunk_ptr=i32(chunk_ptr),
            chunk_rel=i32(chunk_rel), rel_chunk_ptr=i32(rel_chunk_ptr))
        seg_ptr, seg_out, long_rows, long_ptr = _row_segments(
            np.bincount(src, minlength=num_src_nodes), SEGMENT_EDGES)
        (by_tile, tile_chunk_ptr, tile_chunk_slot, tile_chunk_rel,
         tile_rel_ptr) = _tile_chunks(dst, et, num_relations, TILE_ROWS,
                                      DR_CHUNK_EDGES, by_dst)
        layouts.update(
            src_seg_ptr=i32(seg_ptr), src_seg_out=i32(seg_out),
            src_long_rows=i32(long_rows), src_long_ptr=i32(long_ptr),
            tile_src=i32(src[by_tile]), tile_dst=i32(dst[by_tile]),
            tile_eid=i32(ids[by_tile]),
            tile_chunk_ptr=i32(tile_chunk_ptr),
            tile_chunk_slot=i32(tile_chunk_slot),
            tile_chunk_rel=i32(tile_chunk_rel),
            tile_rel_ptr=i32(tile_rel_ptr))
    return Csr(**layouts)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A static-shape relational graph.

      edge_index: int64 [E, 2] — (head, tail) node ids
      edge_type: int64 [E] — relation id per edge
      edge_weight: float32 [E] — multiplicative edge weight (0 == masked out)
      num_nodes, num_relations: vocabulary sizes
      csr: optional kernel layouts (``prepare_csr``)
      dense_adj: optional dense per-etype adjacency [T, N, N] with
        A[t, d, s] = summed edge weight (``prepare_dense``). Weights are
        folded in, so weight-only transforms drop it.
      join_index, join_index_ht: optional ``ops.match.PatternJoinIndex``
        over (h, t, r) and over (h, t) (``prepare_join``); topology only
      ring_inputs: optional ``parallel.ring_rspmm.RingRspmmInputs``, the
        ring path's edge buckets (``prepare_ring``); topology only
      part_layouts: optional ``parallel.sharded_rspmm.
        PartitionedRspmmLayouts``, the partitioned path's per-shard CSRs
        (``prepare_csr_sharded``); topology only
    ``to`` moves every layout; the ring's and the partitioned path's,
    once spread over several devices, keep each shard's layouts where
    they are and move only their index maps.
    """

    edge_index: torch.Tensor
    edge_type: torch.Tensor
    edge_weight: torch.Tensor
    num_nodes: int
    num_relations: int
    csr: Optional[Csr] = None
    dense_adj: Optional[torch.Tensor] = None
    join_index: Optional[PatternJoinIndex] = None
    join_index_ht: Optional[PatternJoinIndex] = None
    ring_inputs: Optional[object] = None
    part_layouts: Optional[object] = None

    @staticmethod
    def from_triplets(triplets, num_nodes: int, num_relations: int,
                      edge_weight=None) -> "Graph":
        """Build from an [E, 3] array of (head, tail, relation) rows."""
        tri = np.asarray(triplets, dtype=np.int64)
        if tri.ndim != 2 or tri.shape[-1] != 3:
            raise ValueError(f"triplets must be [E, 3], got {tri.shape}")
        if edge_weight is None:
            edge_weight = np.ones((tri.shape[0],), dtype=np.float32)
        return Graph(
            edge_index=torch.from_numpy(np.ascontiguousarray(tri[:, :2])),
            edge_type=torch.from_numpy(np.ascontiguousarray(tri[:, 2])),
            edge_weight=torch.as_tensor(
                np.asarray(edge_weight, dtype=np.float32)),
            num_nodes=int(num_nodes),
            num_relations=int(num_relations),
        )

    @property
    def device(self) -> torch.device:
        return self.edge_index.device

    def to(self, device) -> "Graph":
        return dataclasses.replace(
            self,
            edge_index=self.edge_index.to(device),
            edge_type=self.edge_type.to(device),
            edge_weight=self.edge_weight.to(device),
            csr=None if self.csr is None else self.csr.to(device),
            dense_adj=None if self.dense_adj is None
            else self.dense_adj.to(device),
            join_index=None if self.join_index is None
            else self.join_index.to(device),
            join_index_ht=None if self.join_index_ht is None
            else self.join_index_ht.to(device),
            ring_inputs=None if self.ring_inputs is None
            else self.ring_inputs.to(device),
            part_layouts=None if self.part_layouts is None
            else self.part_layouts.to(device),
        )

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[0])

    @property
    def edge_list(self) -> torch.Tensor:
        """[E, 3] (head, tail, relation) — the reference's layout."""
        return torch.cat([self.edge_index, self.edge_type[:, None]], dim=1)

    def degree_out(self) -> torch.Tensor:
        """Sum of edge weights grouped by the receiving node (torchdrug's
        ``degree_out``)."""
        deg = torch.zeros(self.num_nodes, dtype=self.edge_weight.dtype,
                          device=self.device)
        return deg.index_add_(0, self.edge_index[:, 1], self.edge_weight)

    def degree_in(self) -> torch.Tensor:
        """Sum of edge weights grouped by the sending node."""
        deg = torch.zeros(self.num_nodes, dtype=self.edge_weight.dtype,
                          device=self.device)
        return deg.index_add_(0, self.edge_index[:, 0], self.edge_weight)

    def undirected_with_inverse(self) -> "Graph":
        """Append inverse edges (t, h, r + R): edge order [directed; inverse],
        twice the relation vocabulary."""
        return Graph(
            edge_index=torch.cat(
                [self.edge_index, self.edge_index.flip(1)], dim=0),
            edge_type=torch.cat(
                [self.edge_type, self.edge_type + self.num_relations], dim=0),
            edge_weight=torch.cat([self.edge_weight, self.edge_weight], dim=0),
            num_nodes=self.num_nodes,
            num_relations=self.num_relations * 2,
        )

    def with_edge_weight(self, edge_weight: torch.Tensor) -> "Graph":
        # dense_adj has the old weights folded in; the CSR, the join
        # indexes and the ring buckets are topology only
        return dataclasses.replace(self, edge_weight=edge_weight,
                                   dense_adj=None)

    def mask_edges(self, keep_mask: torch.Tensor) -> "Graph":
        """Zero the weight of dropped edges instead of removing them."""
        return self.with_edge_weight(
            self.edge_weight * keep_mask.to(self.edge_weight.dtype))

    def select_edges(self, keep_mask) -> "Graph":
        """The graph of the edges where ``keep_mask`` [E] (bool, numpy or
        torch) is true, in their order: host-side, E changes, and the new
        graph carries none of the prepared layouts."""
        keep = torch.as_tensor(np.asarray(
            keep_mask.cpu() if torch.is_tensor(keep_mask) else keep_mask,
            dtype=bool))
        return Graph(
            edge_index=self.edge_index.cpu()[keep].to(self.device),
            edge_type=self.edge_type.cpu()[keep].to(self.device),
            edge_weight=self.edge_weight.cpu()[keep].to(self.device),
            num_nodes=self.num_nodes,
            num_relations=self.num_relations,
        )

    def prepare_csr(self, backward: bool = False) -> "Graph":
        """Attach the kernels' layouts (``Csr``): the destination-sorted CSR
        with its row segments and, with ``backward`` (graphs that a loss is
        differentiated over), the source-sorted CSR with its segments, the
        relation-sorted chunks and the (destination tile, relation) chunks,
        all stable. Host-side, once per topology."""
        ei = self.edge_index.cpu().numpy()
        csr = build_csr(ei[:, 0], ei[:, 1], self.edge_type.cpu().numpy(),
                        self.num_nodes, self.num_relations, backward)
        return dataclasses.replace(self, csr=csr.to(self.device))

    def prepare_ring(self, n_shards: int, pallas: bool = False,
                     balance=False, permuted_io: bool = False,
                     backward: bool = True, devices=None) -> "Graph":
        """Attach the edge buckets of the ring path (parallel/ring_rspmm.py:
        node rows split into ``n_shards`` blocks, one per edge shard of the
        mesh). ``pallas`` also builds one ``Csr`` per bucket, so that each
        ring step runs the rspmm kernels (distmult); ``backward`` gives those
        their backward layouts. ``balance`` and ``permuted_io`` as in
        ``build_ring_rspmm_inputs``. ``devices`` (the mesh's, one a shard)
        places each shard's layouts on its device (``RingRspmmInputs.
        to_mesh``), the graph's for every shard by default. Host-side, once
        per topology."""
        from ..parallel.ring_rspmm import build_ring_rspmm_inputs

        ring = build_ring_rspmm_inputs(
            self.edge_index.cpu().numpy(), self.edge_type.cpu().numpy(),
            self.num_nodes, n_shards, num_relations=self.num_relations,
            pallas=pallas, balance=balance, permuted_io=permuted_io,
            backward=backward)
        ring = ring.to_mesh(devices or (self.device,) * n_shards)
        return dataclasses.replace(self, ring_inputs=ring)

    def prepare_csr_sharded(self, n_shards: int, backward: bool = False,
                            balance="auto", devices=None) -> "Graph":
        """Attach the partitioned path's per-shard CSRs
        (parallel/sharded_rspmm.py: node rows split into ``n_shards``
        output blocks, one per edge shard of the mesh, each with the CSR of
        the edges into its block and, with ``backward``, of the edges out of
        it). ``balance`` as in ``build_partitioned_rspmm_inputs``. The
        graph keeps its own CSR for the ops off the partitioned path, as
        the JAX package composes ``prepare_pallas`` with
        ``prepare_pallas_sharded``. ``devices`` (the mesh's, one a shard)
        places each shard's CSRs on its device (``PartitionedRspmmLayouts.
        to_mesh``), the graph's for every shard by default. Host-side, once
        per topology."""
        from ..parallel.sharded_rspmm import build_partitioned_rspmm_inputs

        part = build_partitioned_rspmm_inputs(
            self.edge_index.cpu().numpy(), self.edge_type.cpu().numpy(),
            self.num_nodes, max(self.num_relations, 1), n_shards,
            backward=backward, balance=balance)
        part = part.to_mesh(devices or (self.device,) * n_shards)
        return dataclasses.replace(self, part_layouts=part)

    def prepare_join(self, one_hop: bool = False) -> "Graph":
        """Attach the sorted-edge ``PatternJoinIndex`` for the per-step
        easy-edge mask (models/ultra.py::_mask_easy_edges): the join's sort
        happens once here, on the host. ``one_hop`` also builds the
        wildcard-relation index (remove_one_hop configs)."""
        ei, et = self.edge_index.cpu().numpy(), self.edge_type.cpu().numpy()
        ji = self.join_index or build_pattern_join(ei, et)
        ji_ht = self.join_index_ht
        if one_hop and ji_ht is None:
            ji_ht = build_pattern_join(ei, et, wildcard_rel=True)
        return dataclasses.replace(
            self, join_index=None if ji is None else ji.to(self.device),
            join_index_ht=None if ji_ht is None else ji_ht.to(self.device))

    def prepare_dense(self, max_bytes: int = 64 * 1024 * 1024,
                      min_density: float = 0.02) -> "Graph":
        """Attach a dense per-etype adjacency [T, N, N] when the graph is
        small (T·N²·4 B <= max_bytes) and dense (E >= min_density·N²·T), else
        return self unchanged. Current edge weights are folded into A."""
        T = max(self.num_relations, 1)
        N = self.num_nodes
        if T * N * N * 4 > max_bytes:
            return self
        if self.num_edges < min_density * N * N * T:
            return self
        ei = self.edge_index.cpu().numpy()
        et = self.edge_type.cpu().numpy()
        A = np.zeros((T, N, N), np.float32)
        np.add.at(A, (et, ei[:, 1], ei[:, 0]),
                  self.edge_weight.cpu().numpy())
        return dataclasses.replace(
            self, dense_adj=torch.from_numpy(A).to(self.device))

    def __repr__(self):  # pragma: no cover
        return (f"Graph(num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges}, "
                f"num_relations={self.num_relations})")


def pack(graphs) -> tuple:
    """The reference packs lists of graphs into one (``data.Graph.pack``);
    the port's graphs are plain objects, so the packed form is a tuple."""
    return tuple(graphs)

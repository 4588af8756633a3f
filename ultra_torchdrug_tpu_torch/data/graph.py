"""Static-shape relational graph (counterpart of ultra_torchdrug_tpu/data/graph.py).

Edges are never deleted once a graph is built: masking multiplies the edge
weight by 0, so shapes stay fixed and a weight-0 edge contributes nothing to
any aggregation. Graphs are built on the host (CPU tensors) and moved to the
device with ``Graph.to``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.match import PatternJoinIndex, build_pattern_join

# edges per chunk of the relation-sorted order (the dr pass of the rspmm
# backward reduces one chunk per CTA, then each relation's chunks in order)
DR_CHUNK_EDGES = 256


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
    The backward's layouts (K2), None unless ``prepare_csr(backward=True)``
    built them:
    Source-sorted CSR (the dx pass):
      src_rowptr [V + 1]; src_dst, src_etype, src_eid [E] in source order
    Relation-sorted edges cut into chunks of at most DR_CHUNK_EDGES edges,
    none of which crosses a relation (the dr pass):
      rel_src, rel_dst, rel_eid [E] — in relation order (stable)
      chunk_ptr [C + 1] — chunk c is [chunk_ptr[c], chunk_ptr[c+1])
      chunk_rel [C] — the relation of each chunk
      rel_chunk_ptr [R + 1] — relation r owns chunks
        [rel_chunk_ptr[r], rel_chunk_ptr[r+1]) (none when it has no edge)
    """

    rowptr: torch.Tensor
    src: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor
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

    @property
    def has_backward(self) -> bool:
        return self.src_rowptr is not None

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
        # dense_adj has the old weights folded in; the CSR and the join
        # indexes are topology only
        return dataclasses.replace(self, edge_weight=edge_weight,
                                   dense_adj=None)

    def mask_edges(self, keep_mask: torch.Tensor) -> "Graph":
        """Zero the weight of dropped edges instead of removing them."""
        return self.with_edge_weight(
            self.edge_weight * keep_mask.to(self.edge_weight.dtype))

    def prepare_csr(self, backward: bool = False) -> "Graph":
        """Attach the kernels' layouts (``Csr``): the destination-sorted CSR
        and, with ``backward`` (graphs that a loss is differentiated over),
        the source-sorted CSR and the relation-sorted chunks, all stable.
        Host-side, once per topology."""
        ei = self.edge_index.cpu().numpy()
        et = self.edge_type.cpu().numpy()
        if len(ei) > np.iinfo(np.int32).max:
            raise ValueError(f"{len(ei)} edges exceed the int32 CSR")
        if len(et) and (et.min() < 0 or et.max() >= self.num_relations):
            raise ValueError(f"edge types must lie in [0, "
                             f"{self.num_relations})")

        def i32(a):
            return torch.from_numpy(a.astype(np.int32)).to(self.device)

        by_dst = np.argsort(ei[:, 1], kind="stable")
        layouts = dict(
            rowptr=i32(_rowptr(ei[:, 1], self.num_nodes)),
            src=i32(ei[by_dst, 0]), etype=i32(et[by_dst]), eid=i32(by_dst))
        if backward:
            by_src = np.argsort(ei[:, 0], kind="stable")
            by_rel = np.argsort(et, kind="stable")
            chunk_ptr, chunk_rel, rel_chunk_ptr = _relation_chunks(
                et[by_rel], self.num_relations, DR_CHUNK_EDGES)
            layouts.update(
                src_rowptr=i32(_rowptr(ei[:, 0], self.num_nodes)),
                src_dst=i32(ei[by_src, 1]), src_etype=i32(et[by_src]),
                src_eid=i32(by_src),
                rel_src=i32(ei[by_rel, 0]), rel_dst=i32(ei[by_rel, 1]),
                rel_eid=i32(by_rel), chunk_ptr=i32(chunk_ptr),
                chunk_rel=i32(chunk_rel), rel_chunk_ptr=i32(rel_chunk_ptr))
        return dataclasses.replace(self, csr=Csr(**layouts))

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

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


@dataclasses.dataclass(frozen=True)
class Csr:
    """Destination-sorted CSR of a graph's topology, the layout of the rspmm
    forward kernel (ops/rspmm_cuda.py). A pure function of topology: edge
    weights are gathered per call through ``eid``, so masked weights need no
    new layout.

      rowptr: int32 [V + 1] — edges of row v are [rowptr[v], rowptr[v+1])
      src, etype, eid: int32 [E] — source node, edge type and original edge
        index of each edge, in destination order (stable within a row)
    """

    rowptr: torch.Tensor
    src: torch.Tensor
    etype: torch.Tensor
    eid: torch.Tensor

    def to(self, device) -> "Csr":
        return Csr(*(t.to(device) for t in dataclasses.astuple(self)))


@dataclasses.dataclass(frozen=True)
class Graph:
    """A static-shape relational graph.

      edge_index: int64 [E, 2] — (head, tail) node ids
      edge_type: int64 [E] — relation id per edge
      edge_weight: float32 [E] — multiplicative edge weight (0 == masked out)
      num_nodes, num_relations: vocabulary sizes
      csr: optional destination-sorted CSR (``prepare_csr``)
      dense_adj: optional dense per-etype adjacency [T, N, N] with
        A[t, d, s] = summed edge weight (``prepare_dense``). Weights are
        folded in, so weight-only transforms drop it.
    """

    edge_index: torch.Tensor
    edge_type: torch.Tensor
    edge_weight: torch.Tensor
    num_nodes: int
    num_relations: int
    csr: Optional[Csr] = None
    dense_adj: Optional[torch.Tensor] = None

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
        # dense_adj has the old weights folded in; the CSR is topology only
        return dataclasses.replace(self, edge_weight=edge_weight,
                                   dense_adj=None)

    def mask_edges(self, keep_mask: torch.Tensor) -> "Graph":
        """Zero the weight of dropped edges instead of removing them."""
        return self.with_edge_weight(
            self.edge_weight * keep_mask.to(self.edge_weight.dtype))

    def prepare_csr(self) -> "Graph":
        """Attach the destination-sorted CSR (stable within a row). Host-side,
        once per topology."""
        ei = self.edge_index.cpu().numpy()
        et = self.edge_type.cpu().numpy()
        order = np.argsort(ei[:, 1], kind="stable")
        counts = np.bincount(ei[:, 1], minlength=self.num_nodes)
        rowptr = np.zeros(self.num_nodes + 1, np.int64)
        np.cumsum(counts, out=rowptr[1:])
        if rowptr[-1] > np.iinfo(np.int32).max:
            raise ValueError(f"{rowptr[-1]} edges exceed the int32 CSR")

        def i32(a):
            return torch.from_numpy(a.astype(np.int32)).to(self.device)

        csr = Csr(rowptr=i32(rowptr), src=i32(ei[order, 0]),
                  etype=i32(et[order]), eid=i32(order))
        return dataclasses.replace(self, csr=csr)

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

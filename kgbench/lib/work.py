"""The work a request or a step needs, counted from the configuration's
shapes and equations, whatever implements them, and the card's peaks.

Each op is (fp32 operations, compulsory bytes): its inputs read once and
its outputs written once (4 B a value; an edge is its int32 source,
destination and type and its fp32 weight, 16 B). A relational sum over E
edges of T types into V rows of F features takes the fewer of its two
groupings' operations: 3 E F (message, weight, sum an edge) or 2 E F +
2 T V F (the edges' sums a type, then the types' products and sum). Its
backward reads the edges, the output gradient, x and rel and writes dx and
drel, twice the forward's operations. PNA's aggregation writes four planes
(sum, sum of squares, max, min) at 7 operations an edge and feature; its
backward reads x, rel, the four gradients and the two extrema and writes dx
and drel at 16. A linear layer is 2 rows in out operations; the layer's
elementwise work (boundary, layer norm, ReLU, short-cut, PNA's statistics
and scalers) is counted at its operations per value, with no bytes of its
own: it can ride on the layer's pass over its states. A training step is
its forward three times (the backward twice the forward), with no
recomputation: the configurations resolve ``remat: auto`` to none here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# NVIDIA H100 SXM data sheet: dense fp32 outside the tensor cores (TF32 is
# off in the port and its reference) and HBM3, both at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
VALUE = 4
EDGE = 16
# operations a value of the conv's elementwise tail: boundary add 1, layer
# norm 7 (mean, variance 2, normalise 2, scale and shift 2), ReLU 1,
# short-cut 1
CONV_TAIL_OPS = 10
# PNA's statistics a value: mean 2, second moment 3, max 1, min 1, std 3,
# and the 12 products with the degree scalers
PNA_STATS_OPS = 22


@dataclass
class Op:
    """One op's fp32 operations and compulsory bytes; ``rspmm`` marks the
    ops that the relational-SpMM kernels do, ``bwd`` its backward (twice
    its operations over the same bytes when None)."""
    name: str
    flops: float
    nbytes: float
    rspmm: bool = False
    bwd: Optional["Op"] = None

    def bound_s(self) -> float:
        """The least time of this op alone on the card."""
        return max(self.flops / PEAK_FP32_FLOPS, self.nbytes / PEAK_BYTES_PER_S)

    def backward(self) -> "Op":
        return self.bwd or Op(f"{self.name}_bwd", 2 * self.flops, self.nbytes,
                              self.rspmm)


@dataclass
class Work:
    """The ops of one request or step."""
    ops: List[Op] = field(default_factory=list)

    def add(self, op: Op, times: int = 1) -> None:
        self.ops.extend([op] * times)

    def extend(self, other: "Work", times: int = 1) -> None:
        self.ops.extend(other.ops * times)

    def scaled(self, share: float) -> "Work":
        """This work times ``share`` (a graph's share of a mixture's
        steps)."""
        return Work([Op(op.name, op.flops * share, op.nbytes * share,
                        op.rspmm) for op in self.ops])

    def with_backward(self) -> "Work":
        """This forward and its backward, op by op."""
        return Work(self.ops + [op.backward() for op in self.ops])

    @property
    def flops(self) -> float:
        return sum(op.flops for op in self.ops)

    @property
    def nbytes(self) -> float:
        return sum(op.nbytes for op in self.ops)

    def bound_s(self) -> tuple:
        """(the least time of the whole, "flops" or "bytes"): the larger of
        its operations over the fp32 peak and its bytes over the memory
        rate."""
        t_ops = self.flops / PEAK_FP32_FLOPS
        t_bytes = self.nbytes / PEAK_BYTES_PER_S
        return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")

    def rspmm_bound_s(self) -> float:
        """The summed least times of the relational-SpMM ops, each alone."""
        return sum(op.bound_s() for op in self.ops if op.rspmm)


def relational_sum(E, v_src, v_dst, types, F, rel_values,
                   rspmm: bool = True) -> Op:
    """Σ over E edges of w · rel[type] ⊙ x[src] into v_dst rows of F
    features, ``rel_values`` values of rel read; with its backward (reads
    g, x, rel; writes dx, drel)."""
    flops = min(3 * E * F, 2 * E * F + 2 * types * v_dst * F)
    bwd = Op("relational_sum_bwd", 2 * flops,
             EDGE * E + VALUE * (F * (v_dst + 2 * v_src) + 2 * rel_values),
             rspmm)
    return Op("relational_sum", flops,
              EDGE * E + VALUE * (F * (v_src + v_dst) + rel_values), rspmm,
              bwd)


def pna_aggregate(E, V, F, rel_values) -> Op:
    """PNA's four sums over E edges into V rows of F features; its backward
    reads x, rel, the four gradients and the two extrema and writes dx and
    drel."""
    bwd = Op("pna_aggregate_bwd", 16 * E * F,
             EDGE * E + VALUE * (8 * V * F + 2 * rel_values), True)
    return Op("pna_aggregate", 7 * E * F,
              EDGE * E + VALUE * (5 * V * F + rel_values), True, bwd)


def linear(rows, d_in, d_out) -> Op:
    return Op("linear", 2 * rows * d_in * d_out,
              VALUE * (rows * d_in + d_in * d_out + rows * d_out))


def elementwise(values, ops_per_value) -> Op:
    return Op("elementwise", values * ops_per_value, 0)


def kg_shapes(graph: dict, rel_edges: int) -> dict:
    """The sizes the counts read: entities, the fact edges with their
    inverses, relation types, and the relation graph's nodes and edges."""
    R = graph["relations"]
    return {"entities": graph["entities"], "edges": 2 * len(graph["train"]),
            "relation_types": 2 * R, "rel_nodes": 2 * R,
            "rel_edges": int(rel_edges)}

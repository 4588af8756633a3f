"""Relation-graph construction (counterpart of ultra_torchdrug_tpu/data/relgraph.py).

On the undirected+inverse entity graph, two relations are connected iff they
share an entity in the given role combination:

    hh: some entity heads both     tt: some entity tails both
    ht: heads r1 and tails r2      th: tails r1 and heads r2

One-time host-side preprocessing on scipy sparse boolean products.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .graph import Graph

ETYPE_HH, ETYPE_TT, ETYPE_HT, ETYPE_TH = 0, 1, 2, 3


def build_relation_graph(graph: Graph) -> Graph:
    """Entity Graph (R relations) -> relation Graph with 2R nodes, 4 etypes."""
    g = graph.undirected_with_inverse()
    ei = g.edge_index.cpu().numpy()
    heads, tails = ei[:, 0], ei[:, 1]
    rels = g.edge_type.cpu().numpy()
    V, R2 = g.num_nodes, g.num_relations

    def incidence(nodes, relations):
        pairs = np.unique(np.stack([nodes, relations], axis=1), axis=0)
        data = np.ones(len(pairs), dtype=bool)
        return sp.csr_matrix((data, (pairs[:, 0], pairs[:, 1])),
                             shape=(V, R2))

    Eh = incidence(heads, rels)  # entity-heads-relation
    Et = incidence(tails, rels)  # entity-tails-relation
    products = [
        (Eh.T @ Eh, ETYPE_HH),
        (Et.T @ Et, ETYPE_TT),
        (Eh.T @ Et, ETYPE_HT),
        (Et.T @ Eh, ETYPE_TH),
    ]
    triplets = []
    for mat, etype in products:
        coo = mat.tocoo()
        triplets.append(np.stack(
            [coo.row, coo.col, np.full(coo.nnz, etype, dtype=np.int64)],
            axis=1))
    triplets = np.concatenate(triplets, axis=0).astype(np.int32)
    return Graph.from_triplets(triplets, num_nodes=R2, num_relations=4)

"""Random-walk structural encodings (counterpart of
ultra_torchdrug_tpu/utils/rwse.py): the landing probabilities on the
diagonal of the k-step random-walk matrices P^k, P = D^-1 A over the
graph's distinct (head, tail) pairs, and optionally the matrices
themselves as relative positional features. Host-side numpy and scipy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def random_walk_se(graph, ksteps: int, return_all: bool = False,
                   remove_loops: bool = False):
    """rw_landing [V, ksteps] float32 (and rrpe [V, V, ksteps] with
    ``return_all``) of ``graph`` (a data.graph.Graph on any device)."""
    V = graph.num_nodes
    edges = np.unique(graph.edge_index.cpu().numpy(), axis=0)
    if remove_loops:
        edges = edges[edges[:, 0] != edges[:, 1]]
    src, dst = edges[:, 0], edges[:, 1]
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(V, V),
                        dtype=np.float64)
    deg = np.asarray(adj.sum(axis=1)).ravel()
    inv = np.divide(1.0, deg, out=np.zeros_like(deg), where=deg > 0)
    P = sp.diags(inv) @ adj

    steps = ksteps + 1 if remove_loops else ksteps
    rws, rrpes = [], []
    Pk = P.copy()
    for _ in range(steps):
        rws.append(Pk.diagonal())
        if return_all:
            rrpes.append(np.asarray(Pk.todense()))
        Pk = Pk @ P
    rw = np.stack(rws, axis=1)  # [V, steps]
    rrpe = np.stack(rrpes, axis=2) if return_all else None
    if remove_loops:
        # without self-loops the first power's diagonal is all zeros
        rw = rw[:, 1:]
        rrpe = rrpe[..., 1:] if rrpe is not None else None
    rw = rw.astype(np.float32)
    if return_all:
        return rw, rrpe.astype(np.float32)
    return rw

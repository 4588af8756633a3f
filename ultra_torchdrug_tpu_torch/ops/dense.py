"""Dense formulation of the sum-aggregated relational SpMM (counterpart of
ultra_torchdrug_tpu/ops/dense.py), for small dense relational graphs such as
the ULTRA relation graph:

    distmult:  out[d] = Σ_τ rel[τ] ⊙ (A[τ] @ x)[d]
    transe:    out[d] = Σ_τ ( deg[τ, d] · rel[τ] + (A[τ] @ x)[d] )

with A[τ, d, s] = Σ_{e=(s→d, τ)} w_e and deg[τ, d] = Σ_s A[τ, d, s]. fp32
matmuls (TF32 off at package import); the edge-sum order differs from the
sparse op, so comparisons are allclose, not bitwise.
"""

from __future__ import annotations

import torch


def dense_rspmm(A: torch.Tensor, relation: torch.Tensor, x: torch.Tensor, *,
                msg: str) -> torch.Tensor:
    """Sum-aggregated rspmm over a dense per-etype adjacency.

    A: [T, N, N]; x: [N, B, D] with relation [T, D] or [T, B, D], or flat
    x [N, F] with relation [T, F]. Returns the layout of x.
    """
    if msg not in ("mul", "add"):
        raise ValueError(f"unsupported message function {msg!r}")
    flat = x.dim() == 2
    N = x.shape[0]
    xf = x if flat else x.reshape(N, -1)
    hp = torch.matmul(A, xf)  # [T, N, F]: one matmul per edge type
    if flat:
        rel = relation[:, None, :]  # [T, 1, F]
    else:
        hp = hp.reshape(A.shape[0], N, *x.shape[1:])
        rel = (relation[:, None, None, :] if relation.dim() == 2
               else relation[:, None, :, :])
    if msg == "mul":
        return (hp * rel).sum(dim=0)
    deg = A.sum(dim=2)  # [T, N]
    return hp.sum(dim=0) + torch.einsum("tn,t...->n...", deg, rel[:, 0])

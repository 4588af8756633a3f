"""The reference's training steps: for each batch of positives and its
negatives, the easy edges of the batch's candidates masked, every query
scored in tail form, the self-adversarial loss averaged over the batch,
its gradients summed over blocks of queries, and an Adam or AdamW step."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import common
from .common import Adam, Edges


def batch_loss_grads(model, params: List[torch.Tensor], fact, adjacency,
                     batch, neg, temperature: float, block: int,
                     scored_rows: Optional[int] = None):
    """(the batch's loss, its gradients): the loss is the mean over the
    batch's rows, taken ``block`` queries at a time; with ``scored_rows``
    only that many leading rows are scored and averaged (a fault: the rest
    of the batch left out)."""
    h_f, t_f, r_f, V, R = fact
    grid = common.candidates(batch, neg)
    w = common.easy_edge_weights(common.triple_keys(h_f, t_f, r_f, V, R),
                                 common.triple_keys(*grid, V, R))
    edges = Edges.undirected(h_f, t_f, r_f, w, V, R)
    h, t, r = common.tail_form(*grid, R)
    B = scored_rows or batch.shape[0]
    loss = torch.zeros((), dtype=params[0].dtype, device=batch.device)
    grads = [torch.zeros_like(p) for p in params]
    for lo in range(0, B, block):
        s = slice(lo, lo + block)
        scores = model.train_scores(edges, adjacency, batch[s, 2], h[s],
                                    t[s], r[s])
        part = common.bce_adversarial_rows(scores, temperature).sum() / B
        for g, d in zip(grads, torch.autograd.grad(part, params)):
            g += d
        loss += part.detach()
    return loss, grads


def follow_steps(model_cls, params: Dict[str, torch.Tensor], dims: dict,
                 graphs, batches, negs, block: int, prec, optimizer: dict,
                 temperature: float, scored_rows: Optional[int] = None
                 ) -> dict:
    """The reference's own trajectory from ``params`` (copied) over the
    steps' ``batches`` and ``negs``, step i on ``graphs[i]`` = (fact, its
    relation adjacency), fact = (h, t, r, V, R) of its fact triples: each
    step's loss, the first step's gradients, and the parameters after the
    last step, each by name. ``optimizer`` is the configuration's
    (``class`` Adam or AdamW, ``lr``, AdamW's ``weight_decay``);
    ``scored_rows`` as in ``batch_loss_grads``."""
    names = list(params)
    leaves = [params[n].detach().to(prec.dtype).clone().requires_grad_()
              for n in names]
    model = model_cls(dict(zip(names, leaves)), dims,
                      max(fact[4] for fact, _ in graphs), prec)
    decay = optimizer["weight_decay"] if optimizer["class"] == "AdamW" else 0.0
    opt = Adam(leaves, optimizer["lr"], decay)
    losses, first = [], None
    for (fact, adjacency), batch, neg in zip(graphs, batches, negs):
        loss, grads = batch_loss_grads(model, leaves, fact, adjacency, batch,
                                       neg, temperature, block, scored_rows)
        losses.append(float(loss))
        if first is None:
            first = dict(zip(names, grads))
        opt.step(grads)
    return {"losses": losses, "grads": first,
            "params": {n: p.detach() for n, p in zip(names, leaves)}}

"""ULTRA: the two-tower model (counterpart of ultra_torchdrug_tpu/models/ultra.py).

  train:  easy-edge masking -> head/tail flip -> relation tower -> entity
          tower -> the head on the 1 + N candidates of each query
  eval:   relation tower once -> entity tower from (h, r) for tail
          prediction and from (t, r + R) for head prediction, each scoring
          every entity

Easy edges are "removed" by multiplying their weight by 0 (and that of
their inverse copy), so shapes stay fixed. The relation side is one tower
or several (``num_rel_models``; the reference's RelationModelList: more
than one must be num_layers + 1, the first giving the query and tower
i + 1 feeding entity layer i), each per-query (the reference's
CustomNBFNetFull) or, with ``rel_shared``, one [2R, D] output for the batch
(CustomNBFNet).

The module tree follows the reference's ``.pth`` keys: ``model.layers.{i}``
and ``model.mlp`` for the entity tower, ``rel_models.{t}.model.layers.{i}``
(and ``rel_models.{t}.model.learnable_q`` with ``learn_query``) for the
relation towers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..data.graph import Graph
from ..nn.core import init_parameters_
from ..ops.match import edges_in_patterns, edges_in_patterns_indexed
from .nbfnet import (
    NBFNet,
    NBFNetConfig,
    RelNBFNet,
    entity_nbfnet_config,
    entity_nbfnet_score_all,
    rel_nbfnet_apply,
    rel_nbfnet_apply_shared,
    rel_nbfnet_config,
)


@dataclasses.dataclass(frozen=True)
class UltraConfig:
    entity: NBFNetConfig
    relation: NBFNetConfig
    remove_one_hop: bool = False
    num_rel_models: int = 1  # relation towers (RelationModelList)
    rel_shared: bool = False  # one [2R, D] for the batch (CustomNBFNet)

    @staticmethod
    def default(num_relations: int,
                rspmm_impl: str = "auto") -> "UltraConfig":
        """The architecture of every shipped config: 6x64 distmult/sum,
        layer norm + short-cut, project; ``rspmm_impl`` on both towers."""
        return UltraConfig(
            entity=entity_nbfnet_config(
                input_dim=64, hidden_dims=(64,) * 6,
                num_relations=num_relations * 2, rspmm_impl=rspmm_impl),
            relation=rel_nbfnet_config(rspmm_impl=rspmm_impl),
        )


class Ultra(nn.Module):
    def __init__(self, cfg: UltraConfig):
        super().__init__()
        self.cfg = cfg
        self.model = NBFNet(cfg.entity, scoring=True)
        self.rel_models = nn.ModuleList(
            RelNBFNet(cfg.relation) for _ in range(cfg.num_rel_models))


def ultra_init(cfg: UltraConfig, seed: int = 0, device=None) -> Ultra:
    """An Ultra model on ``device`` with weights drawn from a generator
    seeded with ``seed`` (torch's default initializers), in module order:
    the entity tower, then relation towers 0, 1, ..."""
    from .. import default_device

    device = default_device(device)
    model = Ultra(cfg).to(device)
    init_parameters_(model, torch.Generator(device=device).manual_seed(seed))
    return model


def _rel_queries(model: Ultra, rel_graph, pos_r, cfg=None):
    """Run the relation towers: [B, 2R, D] ([2R, D] with ``rel_shared``)
    for one tower, a list of one a tower for several; ``cfg`` the memory
    policies, which every tower takes."""
    apply = (rel_nbfnet_apply_shared if model.cfg.rel_shared
             else rel_nbfnet_apply)
    out = [apply(t.model, rel_graph, pos_r, cfg) for t in model.rel_models]
    return out[0] if len(out) == 1 else out


def _mask_easy_edges(cfg: UltraConfig, fact_graph: Graph, h_index, t_index,
                     r_index) -> Graph:
    """Zero the weights of the directed fact edges (h, t, r) that appear in
    the batch (with remove_one_hop: every edge between h and t, either
    way). Callers expand to the undirected graph afterwards, so the inverse
    copies inherit the mask. Takes the indexed join when the graph carries
    its ``PatternJoinIndex`` (``Graph.prepare_join``)."""
    if cfg.remove_one_hop:
        h_ext = torch.cat([h_index, t_index], dim=-1).reshape(-1)
        t_ext = torch.cat([t_index, h_index], dim=-1).reshape(-1)
        patterns = torch.stack([h_ext, t_ext, torch.zeros_like(h_ext)], -1)
        if fact_graph.join_index_ht is not None:
            hit = edges_in_patterns_indexed(fact_graph.join_index_ht,
                                            patterns)
            return fact_graph.mask_edges(~hit)
        edge_list = fact_graph.edge_list.clone()
        edge_list[:, 2] = 0  # wildcard relation
    else:
        patterns = torch.stack([h_index.reshape(-1), t_index.reshape(-1),
                                r_index.reshape(-1)], -1)
        if fact_graph.join_index is not None:
            hit = edges_in_patterns_indexed(fact_graph.join_index, patterns)
            return fact_graph.mask_edges(~hit)
        edge_list = fact_graph.edge_list
    return fact_graph.mask_edges(~edges_in_patterns(edge_list, patterns))


def _flip_heads_to_tails(h_index, t_index, r_index, num_relations: int):
    """Rows whose head varies are head-corruption rows: turn them into tail
    form through the inverse relation."""
    is_t_neg = (h_index == h_index[:, :1]).all(dim=-1, keepdim=True)
    new_h = torch.where(is_t_neg, h_index, t_index)
    new_t = torch.where(is_t_neg, t_index, h_index)
    new_r = torch.where(is_t_neg, r_index, r_index + num_relations)
    return new_h, new_t, new_r


def candidate_triples(pos_h, pos_t, pos_r, neg_index):
    """(h, t, r) index grids [B, 1 + N] of each query's positive and its N
    negatives: the first half of the rows corrupt the tail, the second half
    the head."""
    B, N = neg_index.shape
    device = pos_h.device
    h_index = pos_h[:, None].expand(B, N + 1)
    t_index = pos_t[:, None].expand(B, N + 1)
    r_index = pos_r[:, None].expand(B, N + 1)
    row_is_tail_neg = (torch.arange(B, device=device) < B // 2)[:, None]
    is_neg_col = (torch.arange(N + 1, device=device) >= 1)[None, :]
    t_index = torch.where(row_is_tail_neg & is_neg_col,
                          torch.cat([pos_t[:, None], neg_index], 1), t_index)
    h_index = torch.where(~row_is_tail_neg & is_neg_col,
                          torch.cat([pos_h[:, None], neg_index], 1), h_index)
    return h_index, t_index, r_index


def ultra_train_scores(model: Ultra, fact_graph: Graph, rel_graph: Graph,
                       pos_h, pos_t, pos_r, neg_index,
                       remove_easy: bool = True,
                       fact_graph_und: Graph = None,
                       model_cfg: UltraConfig = None,
                       rows: slice = None) -> torch.Tensor:
    """Scores for [positive | negatives]: [B, 1 + N].

    neg_index: [B, N]; the first half of the rows are corrupted tails, the
    second half corrupted heads. fact_graph_und: the prepared undirected
    graph (edge order [directed; inverse]) whose layouts are reused with the
    batch's masked weights. model_cfg: the memory policies to apply (a
    task's resolved config; the model's own by default). rows: score only
    these rows of the batch (a data-parallel rank's), on the graph that the
    whole batch masks, so that the rows score as in the whole batch.
    """
    model_cfg = model_cfg or model.cfg
    h_index, t_index, r_index = candidate_triples(pos_h, pos_t, pos_r,
                                                  neg_index)
    graph = fact_graph
    if remove_easy:
        graph = _mask_easy_edges(model.cfg, graph, h_index, t_index, r_index)
    if fact_graph_und is None:
        graph_und = graph.undirected_with_inverse().prepare_csr(backward=True)
    else:
        graph_und = fact_graph_und.with_edge_weight(
            torch.cat([graph.edge_weight, graph.edge_weight]))

    h_index, t_index, r_index = _flip_heads_to_tails(
        h_index, t_index, r_index, fact_graph.num_relations)
    if rows is not None:
        h_index, t_index, r_index = h_index[rows], t_index[rows], r_index[rows]
        pos_r = pos_r[rows]
    rel_queries = _rel_queries(model, rel_graph, pos_r, model_cfg.relation)
    return entity_nbfnet_score_all(
        model.model, graph_und, rel_queries, source=h_index[:, 0],
        query_rel=r_index[:, 0], targets=t_index, cfg=model_cfg.entity)


def ultra_eval_scores(model: Ultra, fact_graph, rel_graph, pos_h, pos_t,
                      pos_r, fact_graph_und=None,
                      model_cfg: UltraConfig = None):
    """All-entity score matrices for tail and head prediction:
    (t_scores [B, V], h_scores [B, V]); ``model_cfg`` as for
    ``ultra_train_scores``."""
    model_cfg = model_cfg or model.cfg
    graph_und = (fact_graph.undirected_with_inverse().prepare_csr()
                 if fact_graph_und is None else fact_graph_und)
    rel_queries = _rel_queries(model, rel_graph, pos_r, model_cfg.relation)
    t_scores = entity_nbfnet_score_all(
        model.model, graph_und, rel_queries, source=pos_h, query_rel=pos_r,
        cfg=model_cfg.entity)
    h_scores = entity_nbfnet_score_all(
        model.model, graph_und, rel_queries, source=pos_t,
        query_rel=pos_r + fact_graph.num_relations, cfg=model_cfg.entity)
    return t_scores, h_scores

"""ULTRA: the two-tower model (counterpart of ultra_torchdrug_tpu/models/ultra.py).

Evaluation runs the relation tower once, then the entity tower from (h, r)
for tail prediction and from (t, r + R) for head prediction, each scoring
every entity. This slice covers one relation tower with per-query
conditioning, the configuration every shipped config uses.

The module tree follows the reference's ``.pth`` keys: ``model.layers.{i}``
and ``model.mlp`` for the entity tower, ``rel_models.0.model.layers.{i}``
for the relation tower.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.core import init_parameters_
from .nbfnet import (
    NBFNet,
    NBFNetConfig,
    RelNBFNet,
    entity_nbfnet_config,
    entity_nbfnet_score_all,
    rel_nbfnet_config,
)


@dataclasses.dataclass(frozen=True)
class UltraConfig:
    entity: NBFNetConfig
    relation: NBFNetConfig

    @staticmethod
    def default(num_relations: int) -> "UltraConfig":
        """The architecture of every shipped config: 6x64 distmult/sum,
        layer norm + short-cut, project."""
        return UltraConfig(
            entity=entity_nbfnet_config(
                input_dim=64, hidden_dims=(64,) * 6,
                num_relations=num_relations * 2),
            relation=rel_nbfnet_config(),
        )


class Ultra(nn.Module):
    def __init__(self, cfg: UltraConfig):
        super().__init__()
        self.cfg = cfg
        self.model = NBFNet(cfg.entity, scoring=True)
        self.rel_models = nn.ModuleList([RelNBFNet(cfg.relation)])


def ultra_init(cfg: UltraConfig, seed: int = 0, device=None) -> Ultra:
    """An Ultra model on ``device`` with weights drawn from a generator
    seeded with ``seed`` (torch's default initializers)."""
    from .. import default_device

    device = default_device(device)
    model = Ultra(cfg).to(device)
    init_parameters_(model, torch.Generator(device=device).manual_seed(seed))
    return model


def _rel_queries(model: Ultra, rel_graph, pos_r):
    """Run the relation tower: [B, 2R, D]."""
    return model.rel_models[0](rel_graph, pos_r)


def ultra_eval_scores(model: Ultra, fact_graph, rel_graph, pos_h, pos_t,
                      pos_r, fact_graph_und=None):
    """All-entity score matrices for tail and head prediction:
    (t_scores [B, V], h_scores [B, V])."""
    graph_und = (fact_graph.undirected_with_inverse().prepare_csr()
                 if fact_graph_und is None else fact_graph_und)
    rel_queries = _rel_queries(model, rel_graph, pos_r)
    t_scores = entity_nbfnet_score_all(
        model.model, graph_und, rel_queries, source=pos_h, query_rel=pos_r)
    h_scores = entity_nbfnet_score_all(
        model.model, graph_und, rel_queries, source=pos_t,
        query_rel=pos_r + fact_graph.num_relations)
    return t_scores, h_scores

"""ULTRA: the program's task built from a configuration file (whose ``task``
section is the published YAML's, read by the program's own config builder),
the reference, and the work counts of a request and a step."""

from __future__ import annotations

from ..lib import work
from ..reference import ultra as reference

REFERENCE = reference.Ultra
param_specs = reference.param_specs


def model_dims(cfg: dict) -> dict:
    """The reference's view of the configuration."""
    m, rm = cfg["task"]["model"], cfg["task"]["rel_models"]["rel_model"]
    return {"input_dim": m["input_dim"], "hidden_dims": m["hidden_dims"],
            "rel_model": {"num_layers": rm["num_layers"]}}


def build_task(cfg: dict, datasets: list, device):
    """The program's task over ``datasets``, as run_full builds it from the
    configuration's task section: ``TransductiveKGTask`` on one graph, the
    pre-training mixture (``MultiGraphPretrainTask``) on several."""
    from ultra_torchdrug_tpu_torch.data.datasets import JointDataset
    from ultra_torchdrug_tpu_torch.engine.build import build_task as build

    section = dict(cfg["task"], eval_batch_size=cfg["eval_batch_size"])
    if len(datasets) == 1:
        section["class"] = "KnowledgeGraphCompletionAdapted"
        return build(section, datasets[0], device=device)
    section["class"] = "MultiGraphPreTraining"
    return build(section, JointDataset("kgbench", list(datasets)),
                 device=device)


def spans() -> list:
    """(owner, attribute, span) of the model's calls that a traced window
    records."""
    from ultra_torchdrug_tpu_torch.models import ultra

    return [(ultra, "_rel_queries", "model.relation_tower"),
            (ultra, "entity_nbfnet_score_all", "model.entity_tower"),
            (ultra, "_mask_easy_edges", "task.easy_edges")]


def _conv_layer(w: work.Work, rows, E, v, types, F, rel_values, D, rspmm):
    """One conv: the relational sum, the linear over [state ; aggregate] and
    the elementwise tail."""
    w.add(work.relational_sum(E, v, v, types, F, rel_values, rspmm))
    w.add(work.linear(rows, 2 * D, D))
    w.add(work.elementwise(rows * D, work.CONV_TAIL_OPS))


def relation_tower(cfg: dict, shapes: dict, B: int) -> work.Work:
    """The relation tower over B queries: the relation graph is small and
    dense, and the program runs it on dense matrix products, not on the
    relational-SpMM kernels."""
    D, N = cfg["task"]["model"]["input_dim"], shapes["rel_nodes"]
    w = work.Work()
    for _ in range(cfg["task"]["rel_models"]["rel_model"]["num_layers"]):
        _conv_layer(w, N * B, shapes["rel_edges"], N, 4, B * D, 4 * D, D,
                    rspmm=False)
    return w


def entity_tower(cfg: dict, shapes: dict, B: int) -> work.Work:
    """The entity tower from B sources: per layer the 2-layer projection of
    the [B, 2R, D] relation representations, then the conv over the fact
    edges and their inverses."""
    D = cfg["task"]["model"]["input_dim"]
    V, E, R2 = shapes["entities"], shapes["edges"], shapes["relation_types"]
    w = work.Work()
    for _ in cfg["task"]["model"]["hidden_dims"]:
        w.add(work.linear(B * R2, D, D), times=2)
        w.add(work.elementwise(B * R2 * D, 1))
        _conv_layer(w, V * B, E, V, R2, B * D, R2 * B * D, D, rspmm=True)
    return w


def head(cfg: dict, rows: int) -> work.Work:
    """The MLP over [state ; query] on ``rows`` candidates."""
    D2 = 2 * cfg["task"]["model"]["input_dim"]
    w = work.Work()
    w.add(work.linear(rows, D2, D2))
    w.add(work.elementwise(rows * D2, 1))
    w.add(work.linear(rows, D2, 1))
    return w


def request_work(cfg: dict, shapes: dict, B: int) -> work.Work:
    """One eval request of B queries, tail and head: the relation tower once,
    the entity tower, the head over every entity and the filtered ranking
    (a comparison and a count an entity) a direction."""
    V = shapes["entities"]
    w = relation_tower(cfg, shapes, B)
    for _ in range(2):
        w.extend(entity_tower(cfg, shapes, B))
        w.extend(head(cfg, V * B))
        w.add(work.elementwise(V * B, 2))
    return w


def step_work(cfg: dict, shapes: dict, B: int) -> work.Work:
    """One training step of B positives with N negatives each: forward
    (both towers, the head on 1 + N candidates a query, the loss at 10
    operations a score) and backward."""
    N = cfg["task"]["num_negative"]
    fwd = relation_tower(cfg, shapes, B)
    fwd.extend(entity_tower(cfg, shapes, B))
    fwd.extend(head(cfg, B * (1 + N)))
    fwd.add(work.elementwise(B * (1 + N), 10))
    return fwd.with_backward()

"""Classic NBFNet: the program's ``ClassicNBFNetTask`` built from a
configuration file whose ``task`` section is the NBFNet repository's
FB15k-237 YAML, the reference, and the work counts of a step."""

from __future__ import annotations

from ..lib import work
from ..reference import classic as reference

REFERENCE = reference.ClassicNBFNet
param_specs = reference.param_specs


def model_dims(cfg: dict) -> dict:
    m = cfg["task"]["model"]
    return {"input_dim": m["input_dim"], "hidden_dims": m["hidden_dims"]}


def build_task(cfg: dict, datasets: list, device):
    """The program's task on one graph, as the port's NBFNet-repository path
    builds it: ``classic_nbfnet_config`` with the model section's values."""
    from ultra_torchdrug_tpu_torch.models.classic_nbfnet import (
        classic_nbfnet_config,
    )
    from ultra_torchdrug_tpu_torch.tasks.task import (
        ClassicNBFNetTask,
        TaskConfig,
    )

    (dataset,) = datasets
    m, t = cfg["task"]["model"], cfg["task"]
    nbf_cfg = classic_nbfnet_config(
        input_dim=m["input_dim"], hidden_dims=tuple(m["hidden_dims"]),
        num_relations=dataset.num_relations,
        message_func=m["message_func"], aggregate_func=m["aggregate_func"],
        dependent=m["dependent"], short_cut=m["short_cut"],
        layer_norm=m["layer_norm"], num_mlp_layer=m["num_mlp_layer"])
    task_cfg = TaskConfig(
        num_negative=t["num_negative"], strict_negative=t["strict_negative"],
        adversarial_temperature=t["adversarial_temperature"],
        criterion=t["criterion"], eval_batch_size=cfg["eval_batch_size"])
    return ClassicNBFNetTask(dataset, nbf_cfg, task_cfg, device=device)


def spans() -> list:
    """(owner, attribute, span) of the model's calls that a traced window
    records."""
    from ultra_torchdrug_tpu_torch.tasks import task

    return [(task, "classic_score_all", "model.towers"),
            (task, "_mask_easy_edges", "task.easy_edges")]


def forward_work(cfg: dict, shapes: dict, B: int, targets: int) -> work.Work:
    """The forward from B sources, the head on ``targets`` candidates: per
    layer the relation vectors projected from the query, PNA's aggregation
    over the fact edges and their inverses, its statistics and scalers, the
    linear over [state ; 12 statistics] and the elementwise tail."""
    D = cfg["task"]["model"]["input_dim"]
    V, E, R2 = shapes["entities"], shapes["edges"], shapes["relation_types"]
    w = work.Work()
    for _ in cfg["task"]["model"]["hidden_dims"]:
        w.add(work.linear(B, D, R2 * D))
        w.add(work.pna_aggregate(E, V, B * D, R2 * B * D))
        w.add(work.elementwise(V * B * D, work.PNA_STATS_OPS))
        w.add(work.linear(V * B, 13 * D, D))
        w.add(work.elementwise(V * B * D, work.CONV_TAIL_OPS))
    w.add(work.linear(targets, 2 * D, 2 * D))
    w.add(work.elementwise(targets * 2 * D, 1))
    w.add(work.linear(targets, 2 * D, 1))
    return w


def request_work(cfg: dict, shapes: dict, B: int) -> work.Work:
    """One eval request of B queries, tail and head, ranked over every
    entity."""
    V = shapes["entities"]
    w = work.Work()
    for _ in range(2):
        w.extend(forward_work(cfg, shapes, B, V * B))
        w.add(work.elementwise(V * B, 2))
    return w


def step_work(cfg: dict, shapes: dict, B: int) -> work.Work:
    """One training step of B positives with N negatives each, forward (the
    loss at 10 operations a score) and backward."""
    rows = B * (1 + cfg["task"]["num_negative"])
    fwd = forward_work(cfg, shapes, B, rows)
    fwd.add(work.elementwise(rows, 10))
    return fwd.with_backward()

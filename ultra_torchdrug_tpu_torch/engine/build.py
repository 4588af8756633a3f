"""Builders (counterpart of ultra_torchdrug_tpu/engine/build.py): config
dicts in the reference's YAML schema -> dataset, model config, task config,
task and engine, with the same keys and defaults as the JAX package.

A top-level ``parallel: {data: N, edge: M}`` section (or the legacy
``engine.data_parallel``) builds the run's mesh (``build_mesh``,
``mesh_scope``): a data axis of N runs over a process group of N
processes (parallel/distributed.py, launched by torchrun), and each
process's M edge shards live on its one device; under an edge axis the
entity tower takes the ring with ``rspmm_impl: ring`` (``ring_exchange:
rdma`` runs kernel K9 for the ring shift). The task classes map as in the
JAX package: the transductive ones to ``TransductiveKGTask``, the
inductive ones to ``InductiveKGTask`` and ``MultiGraphPreTraining`` to
``MultiGraphPretrainTask``, each with its default metrics and relation
count. ``engine.logger: wandb`` gives the engine's meter a
``WandbLogger`` sink (project ``engine.wandb_project``), inert without
wandb. What the port does not carry raises with the ROADMAP Queue 1 item
that will port it: an edge-sharded relation tower
(``parallel.relation_edge``, item 9). The relation side reads
``rel_models.num_rel_models``, ``rel_model.class_str: CustomNBFNet`` (the
shared relation model) and ``rel_model.learn_query`` as the JAX package
does; the engine takes ``engine.steps_per_call``. The model options go
through ``entity_nbfnet_config`` and ``rel_nbfnet_config``, which check
the memory policies (``remat``, ``stack``, ``micro_batch``,
``score_chunk``; the task resolves "auto") and ``rspmm_impl`` (``xla``,
the O(E) route, is logged) and raise on what they do not honour.
"""

from __future__ import annotations

import contextlib
import logging

from ..data import catalog  # noqa: F401  (registers the datasets)
from ..data.datasets import InductiveDataset, JointDataset, TransductiveDataset
from ..models.nbfnet import entity_nbfnet_config, rel_nbfnet_config
from ..models.ultra import UltraConfig
from ..parallel import distributed
from ..parallel.mesh import current_mesh, make_mesh, use_mesh
from ..tasks.task import (
    DEFAULT_INDUCTIVE_METRICS,
    DEFAULT_PRETRAIN_METRICS,
    DEFAULT_TRANSDUCTIVE_METRICS,
    InductiveKGTask,
    MultiGraphPretrainTask,
    TaskConfig,
    TransductiveKGTask,
)
from ..utils.config import lookup
from ..utils.logging import LOGGER_NAME
from .engine import Engine

_TASK_CLASSES = {
    "KnowledgeGraphCompletionAdapted": TransductiveKGTask,
    "KnowledgeGraphCompletionBase": TransductiveKGTask,
    "KnowledgeGraphCompletion": TransductiveKGTask,
    "InductiveKnowledgeGraphCompletionAdapted": InductiveKGTask,
    "InductiveKnowledgeGraphCompletion": InductiveKGTask,
    "MultiGraphPreTraining": MultiGraphPretrainTask,
}
# each task class's dataset type and default metrics
_TASK_DATA = {
    TransductiveKGTask: (TransductiveDataset, DEFAULT_TRANSDUCTIVE_METRICS),
    InductiveKGTask: (InductiveDataset, DEFAULT_INDUCTIVE_METRICS),
    MultiGraphPretrainTask: (JointDataset, DEFAULT_PRETRAIN_METRICS),
}


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"{item})")


def build_dataset(cfg_dataset: dict):
    kwargs = {k: v for k, v in cfg_dataset.items() if k != "class"}
    cls = lookup(cfg_dataset["class"])
    return cls(**kwargs)


def build_mesh(cfg: dict, device=None):
    """The mesh of the top-level ``parallel: {data: N, edge: M}`` section
    (or the legacy ``engine.data_parallel``): this process's data row, its
    edge shards on ``device`` (the card unless the caller names another;
    the rank's own under a process group); None for a 1x1 mesh in one
    process. A data axis other than the process group's size raises
    (``make_mesh``)."""
    par = cfg.get("parallel") or {}
    unknown = set(par) - {"data", "edge", "relation_edge"}
    if unknown:
        raise KeyError(f"unknown parallel option(s) {sorted(unknown)}")
    dp = int(par.get("data", 0) or 0)
    ep = int(par.get("edge", 1) or 1)
    if not dp:
        dp = int(cfg.get("engine", {}).get("data_parallel", 0) or 0) or 1
    if dp * ep <= 1 and distributed.process_count() == 1:
        return None
    return make_mesh(data=dp, edge=ep, device=device)


@contextlib.contextmanager
def mesh_scope(cfg: dict, device=None):
    """Build the run's mesh from cfg and make it the active mesh for the
    scope, which the task reads when it prepares its graphs and the conv
    when it routes. Yields (mesh, edge_axis, rel_edge_axis): edge_axis is
    "edge" on a mesh with more than one edge shard, rel_edge_axis is ""
    unless ``parallel.relation_edge``."""
    mesh = build_mesh(cfg, device)
    edge_axis = "edge" if mesh is not None and mesh.edge > 1 else ""
    rel_edge = (edge_axis if (cfg.get("parallel") or {}).get("relation_edge")
                else "")
    with use_mesh(mesh):
        yield mesh, edge_axis, rel_edge


def _resolve_score_chunk(cfg_task: dict, m: dict) -> int:
    """`full_batch_eval: no` maps onto score_chunk unless score_chunk is
    set, as in the JAX package."""
    chunk = m.get("score_chunk", cfg_task.get("score_chunk"))
    if chunk is not None:
        return int(chunk)
    if not bool(cfg_task.get("full_batch_eval", True)):
        return max(int(cfg_task.get("num_negative", 128)), 1)
    return 0


def build_model_config(cfg_task: dict, num_relations: int,
                       rspmm_impl: str = "auto", edge_axis: str = "",
                       rel_edge_axis: str = None) -> UltraConfig:
    """The model config of ``cfg_task``; ``edge_axis`` edge-shards the
    entity tower, ``rel_edge_axis`` the relation tower (not ported)."""
    if rel_edge_axis:
        raise _unported("an edge-sharded relation tower "
                        "(`parallel.relation_edge`)", "item 9")
    m = cfg_task["model"]
    entity = entity_nbfnet_config(
        input_dim=m["input_dim"],
        hidden_dims=tuple(m["hidden_dims"]),
        num_relations=num_relations * 2,
        message_func=m.get("message_func", "distmult"),
        aggregate_func=m.get("aggregate_func", "sum"),
        short_cut=bool(m.get("short_cut", True)),
        layer_norm=bool(m.get("layer_norm", True)),
        concat_hidden=bool(m.get("concat_hidden", False)),
        num_mlp_layer=int(m.get("num_mlp_layer", 2)),
        project=bool(m.get("project", True)),
        rspmm_impl=rspmm_impl,
        edge_axis=edge_axis,
        ring_exchange=str(m.get("ring_exchange", "ppermute")),
        remat=m.get("remat", cfg_task.get("remat", False)),
        compute_dtype=str(m.get("compute_dtype", "float32")),
        score_chunk=_resolve_score_chunk(cfg_task, m),
        micro_batch=int(m.get("micro_batch", cfg_task.get("micro_batch", 0))),
        stack=str(m.get("stack", cfg_task.get("stack", "auto"))),
    )
    rel_models_cfg = cfg_task.get("rel_models", {})
    rm = rel_models_cfg.get("rel_model", {})
    relation = rel_nbfnet_config(
        input_dim=rm.get("input_dim", 64),
        hidden=rm.get("hidden", 64),
        num_layers=rm.get("num_layers", 6),
        rspmm_impl=rspmm_impl,
        ring_exchange=str(rm.get("ring_exchange",
                                 m.get("ring_exchange", "ppermute"))),
        learn_query=bool(rm.get("learn_query", False)),
        remat=rm.get("remat", cfg_task.get("remat", False)),
        compute_dtype=str(rm.get("compute_dtype",
                                 m.get("compute_dtype", "float32"))),
        stack=str(rm.get("stack", cfg_task.get("stack", "auto"))),
    )
    if entity.rspmm_impl == "xla":
        logging.getLogger(LOGGER_NAME).info(
            "rspmm_impl: xla: every sparse aggregation takes the O(E) route "
            "(ops/rspmm.py::aggregate_edges); no kernel runs")
    return UltraConfig(
        entity=entity,
        relation=relation,
        remove_one_hop=bool(m.get("remove_one_hop", False)),
        num_rel_models=int(rel_models_cfg.get("num_rel_models", 1)),
        rel_shared=rm.get("class_str") == "CustomNBFNet",
    )


def build_task_config(cfg_task: dict,
                      default_metrics=DEFAULT_TRANSDUCTIVE_METRICS
                      ) -> TaskConfig:
    metric = cfg_task.get("metric")
    return TaskConfig(
        num_negative=int(cfg_task.get("num_negative", 128)),
        adversarial_temperature=float(
            cfg_task.get("adversarial_temperature", 0.0)),
        strict_negative=bool(cfg_task.get("strict_negative", True)),
        filtered_ranking=bool(cfg_task.get("filtered_ranking", True)),
        criterion=cfg_task.get("criterion", "bce"),
        margin=float(cfg_task.get("margin", 6.0)),
        metrics=tuple(metric) if metric else default_metrics,
        sample_weight=bool(cfg_task.get("sample_weight", False)),
        fact_ratio=cfg_task.get("fact_ratio"),
        metric_per_rel=bool(cfg_task.get("metric_per_rel", False)),
        toy_eval=bool(cfg_task.get("toy_eval", False)),
        eval_batch_size=cfg_task.get("eval_batch_size"),
    )


def build_task(cfg_task: dict, dataset, rspmm_impl: str = "auto",
               seed: int = 0, device=None, edge_axis: str = "",
               rel_edge_axis: str = None):
    """The task of ``cfg_task`` on ``dataset``, on ``device`` (the card
    unless the caller names another, as ``default_device`` says). A
    multi-graph task's relation count is its graphs' largest. Under an edge
    mesh (``mesh_scope``) with ``edge_axis`` and ``rspmm_impl: ring`` the
    propagation graph gets the ring's buckets."""
    cls_name = cfg_task["class"]
    if cls_name not in _TASK_CLASSES:
        raise KeyError(f"unknown task class {cls_name!r}")
    task_cls = _TASK_CLASSES[cls_name]
    dataset_cls, default_metrics = _TASK_DATA[task_cls]
    if not isinstance(dataset, dataset_cls):
        raise TypeError(f"{cls_name} takes a {dataset_cls.__name__}, not a "
                        f"{type(dataset).__name__}")
    if task_cls is MultiGraphPretrainTask:
        num_relations = max(d.num_relations for d in dataset.datasets)
    else:
        num_relations = dataset.num_relations
    model_cfg = build_model_config(cfg_task, num_relations, rspmm_impl,
                                   edge_axis=edge_axis,
                                   rel_edge_axis=rel_edge_axis)
    task_cfg = build_task_config(cfg_task, default_metrics)
    if task_cls is TransductiveKGTask:
        return task_cls(dataset, model_cfg, task_cfg, seed=seed,
                        device=device)
    return task_cls(dataset, model_cfg, task_cfg, device=device)


def build_engine(cfg: dict, task, work_dir: str = ".", seed: int = 1024,
                 mesh=None) -> Engine:
    """The engine of ``cfg`` over ``task``; its mesh is ``mesh``, else the
    active one, else the one ``cfg`` describes (``build_mesh``)."""
    if mesh is None:
        mesh = current_mesh() or build_mesh(cfg, getattr(task, "device",
                                                         None))
    opt = cfg.get("optimizer", {})
    eng_cfg = cfg.get("engine", {})
    # the reference applies train.clip_grad only under cfg.debug;
    # engine.clip_grad is the ungated knob
    clip_grad = eng_cfg.get("clip_grad")
    if clip_grad is None and cfg.get("debug"):
        clip_grad = cfg.get("train", {}).get("clip_grad")
    metric_logger = None  # rank 0 logs, as it writes the files
    if (str(eng_cfg.get("logger", "logging")).lower() == "wandb"
            and distributed.process_index() == 0):
        from ..utils.debug import WandbLogger

        metric_logger = WandbLogger(
            project=str(eng_cfg.get("wandb_project", "ultra_tpu")),
            config=cfg)
    return Engine(
        task,
        batch_size=int(eng_cfg.get("batch_size", 64)),
        optimizer=opt.get("class", "AdamW"),
        lr=float(opt.get("lr", 5e-4)),
        gradient_interval=int(eng_cfg.get("gradient_interval", 1)),
        clip_grad=float(clip_grad) if clip_grad not in (None, "null") else None,
        log_interval=int(eng_cfg.get("log_interval", 100)),
        seed=seed,
        work_dir=work_dir,
        mesh=mesh,
        steps_per_call=int(eng_cfg.get("steps_per_call", 1)),
        metric_logger=metric_logger,
    )

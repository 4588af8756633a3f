"""Builders (counterpart of ultra_torchdrug_tpu/engine/build.py): config
dicts in the reference's YAML schema -> dataset, model config, task config,
task and engine, with the same keys and defaults as the JAX package.

What the port does not carry raises with the ROADMAP Queue 1 item that will
port it: a ``parallel`` section or ``engine.data_parallel`` > 1 (item 9,
the port runs on one device and builds no mesh), the inductive and
multi-graph task classes (items 3 and 4), ``num_rel_models`` > 1 and the
shared relation model (item 7), ``engine.steps_per_call`` > 1 (item 7),
``engine.logger: wandb`` (item 8), and the task options ``metric_per_rel``,
``toy_eval`` and ``eval_batch_size`` (item 3). The model options go through
``entity_nbfnet_config`` and ``rel_nbfnet_config``, which log the
memory-only ones as not applied and raise on the rest.
"""

from __future__ import annotations

from ..data import catalog  # noqa: F401  (registers the datasets)
from ..models.nbfnet import entity_nbfnet_config, rel_nbfnet_config
from ..models.ultra import UltraConfig
from ..tasks.task import (
    DEFAULT_TRANSDUCTIVE_METRICS,
    TaskConfig,
    TransductiveKGTask,
)
from ..utils.config import lookup
from .engine import Engine

_TRANSDUCTIVE = ("KnowledgeGraphCompletionAdapted",
                 "KnowledgeGraphCompletionBase", "KnowledgeGraphCompletion")
_UNPORTED_TASKS = {
    "InductiveKnowledgeGraphCompletionAdapted": "item 3",
    "InductiveKnowledgeGraphCompletion": "item 3",
    "MultiGraphPreTraining": "item 4",
}


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"{item})")


def build_dataset(cfg_dataset: dict):
    kwargs = {k: v for k, v in cfg_dataset.items() if k != "class"}
    cls = lookup(cfg_dataset["class"])
    return cls(**kwargs)


def check_single_device(cfg: dict):
    """The port runs on one device: a mesh (``parallel``, or
    ``engine.data_parallel`` > 1) raises."""
    data_parallel = int(cfg.get("engine", {}).get("data_parallel", 0) or 0)
    if cfg.get("parallel") or data_parallel > 1:
        raise _unported("a device mesh (`parallel`, `engine.data_parallel`)",
                        "item 9")


def _resolve_score_chunk(cfg_task: dict, m: dict) -> int:
    """`full_batch_eval: no` maps onto score_chunk unless score_chunk is
    set, as in the JAX package (a memory option the port does not apply)."""
    chunk = m.get("score_chunk", cfg_task.get("score_chunk"))
    if chunk is not None:
        return int(chunk)
    if not bool(cfg_task.get("full_batch_eval", True)):
        return max(int(cfg_task.get("num_negative", 128)), 1)
    return 0


def build_model_config(cfg_task: dict, num_relations: int,
                       rspmm_impl: str = "auto") -> UltraConfig:
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
        ring_exchange=str(m.get("ring_exchange", "ppermute")),
        remat=m.get("remat", cfg_task.get("remat", False)),
        compute_dtype=str(m.get("compute_dtype", "float32")),
        score_chunk=_resolve_score_chunk(cfg_task, m),
        micro_batch=int(m.get("micro_batch", cfg_task.get("micro_batch", 0))),
        stack=str(m.get("stack", cfg_task.get("stack", "auto"))),
    )
    rel_models_cfg = cfg_task.get("rel_models", {})
    rm = rel_models_cfg.get("rel_model", {})
    if int(rel_models_cfg.get("num_rel_models", 1)) != 1:
        raise _unported("num_rel_models > 1", "item 7")
    if rm.get("class_str") == "CustomNBFNet":
        raise _unported("the shared relation model (CustomNBFNet)", "item 7")
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
    return UltraConfig(
        entity=entity,
        relation=relation,
        remove_one_hop=bool(m.get("remove_one_hop", False)),
    )


def build_task_config(cfg_task: dict,
                      default_metrics=DEFAULT_TRANSDUCTIVE_METRICS
                      ) -> TaskConfig:
    for key, default in (("metric_per_rel", False), ("toy_eval", False),
                         ("eval_batch_size", None)):
        value = cfg_task.get(key, default)
        if value not in (default, None):
            raise _unported(f"task option {key}={value!r}", "item 3")
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
    )


def build_task(cfg_task: dict, dataset, rspmm_impl: str = "auto",
               seed: int = 0, device=None) -> TransductiveKGTask:
    """The task of ``cfg_task`` on ``dataset``, on ``device`` (the card
    unless the caller names another, as ``default_device`` says)."""
    cls_name = cfg_task["class"]
    if cls_name in _UNPORTED_TASKS:
        raise _unported(f"task class {cls_name}", _UNPORTED_TASKS[cls_name])
    if cls_name not in _TRANSDUCTIVE:
        raise KeyError(f"unknown task class {cls_name!r}")
    model_cfg = build_model_config(cfg_task, dataset.num_relations,
                                   rspmm_impl)
    return TransductiveKGTask(dataset, model_cfg, build_task_config(cfg_task),
                              seed=seed, device=device)


def build_engine(cfg: dict, task, work_dir: str = ".",
                 seed: int = 1024) -> Engine:
    check_single_device(cfg)
    opt = cfg.get("optimizer", {})
    eng_cfg = cfg.get("engine", {})
    # the reference applies train.clip_grad only under cfg.debug;
    # engine.clip_grad is the ungated knob
    clip_grad = eng_cfg.get("clip_grad")
    if clip_grad is None and cfg.get("debug"):
        clip_grad = cfg.get("train", {}).get("clip_grad")
    if str(eng_cfg.get("logger", "logging")).lower() == "wandb":
        raise _unported("engine.logger: wandb", "item 8")
    if int(eng_cfg.get("steps_per_call", 1)) != 1:
        raise _unported("engine.steps_per_call > 1", "item 7")
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
    )

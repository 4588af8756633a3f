"""Single-experiment runner of the port (counterpart of script/run_full.py):
config -> dataset -> task -> engine -> train and validate -> test.

    python -m ultra_torchdrug_tpu_torch.run_full -c <yaml> [--dataset X]
        [--epochs N] [--bpe N] [--ckpt path] [--seed S] [--device cpu]

Undeclared template variables in the YAML become required flags, as in the
reference's run_full. ``--gpus`` is accepted where a config asks for it and
ignored: a process uses one device, the card unless ``--device`` names
another. A ``parallel: {edge: N}`` section builds an N-shard edge mesh on
that device (engine/build.py::mesh_scope), active around the task, the
engine, training and evaluation; with ``rspmm_impl: ring`` the entity tower
then takes the ring path. ``main`` parses the flags and loads the YAML (the
only place that needs yaml and jinja2); ``run`` does the rest from the
loaded dict.

Data parallelism, one process a data row (parallel/distributed.py):

    torchrun --nproc_per_node N -m ultra_torchdrug_tpu_torch.run_full \
        -c <config with parallel: {data: N}> [--device cpu]

``run`` joins the process group before it builds anything: NCCL with a
card a rank, gloo where ranks share a card or with ``--device cpu``. Rank
0 makes the work directory, writes the log file and the checkpoints and
logs to the console; every rank loads the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import pprint
import random
from typing import Optional

import numpy as np
import torch

from . import default_device
from .engine.build import (
    build_dataset,
    build_engine,
    build_task,
    mesh_scope,
)
from .engine.engine import Engine
from .parallel import distributed
from .utils.debug import setup_debug_hook
from .utils.logging import create_working_directory, get_root_logger


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def train_and_validate(cfg: dict, engine: Engine, logger):
    """Training in up to ten chunks of epochs, a checkpoint and a validation
    after each, then the best checkpoint reloaded (the reference's
    run_full.py:62-90)."""
    num_epoch = cfg.get("train", {}).get("num_epoch", 0)
    if num_epoch == 0:
        return
    bpe = cfg.get("train", {}).get("batch_per_epoch")
    fast_test = cfg.get("fast_test")
    step = math.ceil(num_epoch / 10)
    best_result, best_epoch = float("-inf"), -1
    metric_name = cfg.get("metric", "mrr")
    for i in range(0, num_epoch, step):
        engine.train(num_epoch=min(step, num_epoch - i), batch_per_epoch=bpe)
        path = os.path.join(engine.work_dir,
                            f"model_epoch_{engine.epoch}.ckpt")
        engine.save(path)
        metric = engine.evaluate("valid", fast_test=fast_test)
        result = metric[metric_name]
        if result > best_result:
            best_result, best_epoch = result, engine.epoch
    best = os.path.join(engine.work_dir, f"model_epoch_{best_epoch}.ckpt")
    logger.info(f"Load best checkpoint from epoch {best_epoch}")
    engine.load(best)


def test(cfg: dict, engine: Engine):
    """Evaluate on the validation split and, unless ``no_test``, the test
    split."""
    fast_test = cfg.get("fast_test")
    engine.evaluate("valid", fast_test=fast_test)
    if cfg.get("no_test"):
        return
    engine.evaluate("test", fast_test=fast_test)


def setup_process(device=None) -> torch.device:
    """Join the process group when torchrun started this process (a no-op
    in one process); returns this process's device (the card unless the
    caller names another; a rank's own card under NCCL)."""
    distributed.initialize_distributed(device=device)
    return default_device(distributed.rank_device(device))


def rank_work_dir(output_dir: str, *names: str):
    """(work dir, logger): rank 0 makes the directory and every rank gets
    its path; rank 0 logs to the console and to log.txt there, the other
    ranks only their warnings."""
    work_dir = None
    if distributed.process_index() == 0:
        work_dir = create_working_directory(output_dir, *names)
    work_dir = distributed.broadcast_object(work_dir)
    log_file = (os.path.join(work_dir, "log.txt")
                if distributed.process_index() == 0 else None)
    return work_dir, get_root_logger(log_file)


def run(cfg: dict, seed: int = 1024, device=None,
        config_file: Optional[str] = None) -> Engine:
    """The experiment of a loaded config dict on ``device`` (the card unless
    the caller names another); returns the engine, whose ``metrics`` hold
    the last evaluation of each split."""
    device = setup_process(device)
    work_dir, logger = rank_work_dir(
        cfg.get("output_dir", "./output"),
        cfg["task"]["class"],
        str(cfg["dataset"]["class"]),
        cfg["task"]["model"]["class"],
    )
    set_seed(seed)
    logger.info(f"Config file: {config_file}")
    logger.info(pprint.pformat(cfg))
    if cfg.get("debug"):
        setup_debug_hook()
    dataset = build_dataset(cfg["dataset"])
    with mesh_scope(cfg, device) as (mesh, edge_axis, rel_edge_axis):
        task = build_task(cfg["task"], dataset,
                          rspmm_impl=cfg.get("rspmm_impl", "auto"), seed=seed,
                          device=device, edge_axis=edge_axis,
                          rel_edge_axis=rel_edge_axis)
        engine = build_engine(cfg, task, work_dir=work_dir, seed=seed,
                              mesh=mesh)
        if cfg.get("checkpoint") not in (None, "null", "None"):
            engine.load(os.path.expanduser(str(cfg["checkpoint"])),
                        fix_reasoner=bool(cfg.get("fix_reasoner", False)))
        anomaly = (torch.autograd.detect_anomaly()
                   if cfg.get("detect_anomaly") else contextlib.nullcontext())
        with anomaly:
            train_and_validate(cfg, engine, logger)
            test(cfg, engine)
    return engine


def main(argv=None) -> Engine:
    from .utils.config import load_config, parse_args

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None)
    device = parser.parse_known_args(argv)[0].device
    args, context = parse_args(argv)
    cfg = load_config(args.config, context=context)[0]
    return run(cfg, seed=args.seed, device=device, config_file=args.config)


if __name__ == "__main__":
    main()

"""Multi-dataset sweep of the port (counterpart of script/run_many.py):
per-dataset default epoch and batches-per-epoch tables, seed repeats and a
CSV of the test metrics.

    python -m ultra_torchdrug_tpu_torch.run_many -c <yaml> \\
        -d DatasetA:v1,DatasetB [--finetune | --train] [-reps N] \\
        [--epochs N] [--bpe N] [--ckpt path] [--device cpu]

``--finetune`` and ``--train`` take (epochs, batches per epoch) from the
reference's tables ("null" is one pass over the train triples); otherwise
``--epochs`` and ``--bpe``. Each run renders the config with the dataset,
its version, the epochs, bpe, gpus and ckpt, builds the experiment with
run_full's builders, trains and validates, evaluates on test and appends
one row (dataset spec, seed, every scalar test metric) to
``ultra_results_<timestamp>.csv`` in the current directory, rewritten after
each run with the sorted union of the keys as its columns. Runs go on the
card unless ``--device`` names another; under torchrun with a config's
``parallel: {data: N}`` every rank runs the sweep and rank 0 writes the
CSV and the logs.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time

import torch

from . import run_full
from .engine.build import build_dataset, build_engine, build_task, mesh_scope
from .parallel import distributed

SEEDS = [1024, 42, 1337, 512, 256]

# (num_epoch, batch_per_epoch), the reference's tables ("null" = one pass
# over all train triples); Hetionet is kept for the tables' parity though no
# loader ships it; the two Synth* entries are the offline smoke datasets
DEFAULT_FINETUNING = {
    "CoDExSmall": (1, 4000), "CoDExMedium": (1, 4000), "CoDExLarge": (1, 2000),
    "FB15k237": (1, "null"), "WN18RR": (1, "null"), "YAGO310": (1, 2000),
    "DBpedia100k": (1, 1000), "AristoV4": (1, 2000),
    "ConceptNet100k": (1, 2000), "ATOMIC": (1, 200), "NELL995": (1, "null"),
    "Hetionet": (1, 4000),
    "WDsinger": (3, "null"), "FB15k237_10": (1, "null"),
    "FB15k237_20": (1, "null"), "FB15k237_50": (1, 1000),
    "NELL23k": (3, "null"),
    "FB15k237Inductive": (1, "null"), "WN18RRInductive": (1, "null"),
    "NELLInductive": (3, "null"), "ILPC2022SmallInductive": (3, "null"),
    "ILPC2022LargeInductive": (1, 1000), "FBIngram": (3, "null"),
    "WKIngram": (3, "null"), "NLIngram": (3, "null"), "FBNELL": (3, "null"),
    "Metafam": (3, "null"), "WikiTopicsMT1": (3, "null"),
    "WikiTopicsMT2": (3, "null"), "WikiTopicsMT3": (3, "null"),
    "WikiTopicsMT4": (3, "null"), "HamaguchiBM": (1, 100),
    "SynthKG": (1, 10), "SynthInductiveKG": (1, 10),
}
DEFAULT_TRAINING = {
    "CoDExSmall": (10, 1000), "CoDExMedium": (10, 1000),
    "CoDExLarge": (10, 1000), "FB15k237": (10, 1000), "WN18RR": (10, 1000),
    "YAGO310": (10, 2000), "DBpedia100k": (10, 1000), "AristoV4": (10, 1000),
    "ConceptNet100k": (10, 1000), "ATOMIC": (10, 1000),
    "NELL995": (10, 1000), "Hetionet": (10, 1000),
    "WDsinger": (10, 1000), "FB15k237_10": (10, 1000),
    "FB15k237_20": (10, 1000), "FB15k237_50": (10, 1000),
    "NELL23k": (10, 1000),
    "FB15k237Inductive": (10, "null"), "WN18RRInductive": (10, "null"),
    "NELLInductive": (10, "null"), "ILPC2022SmallInductive": (10, "null"),
    "ILPC2022LargeInductive": (10, 1000), "FBIngram": (10, "null"),
    "WKIngram": (10, "null"), "NLIngram": (10, "null"), "FBNELL": (10, "null"),
    "Metafam": (10, "null"), "WikiTopicsMT1": (10, "null"),
    "WikiTopicsMT2": (10, "null"), "WikiTopicsMT3": (10, "null"),
    "WikiTopicsMT4": (10, "null"), "HamaguchiBM": (10, 1000),
    "SynthKG": (10, 10), "SynthInductiveKG": (10, 10),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-d", "--datasets", required=True,
                   help="comma-separated Dataset[:version] list")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--gpus", default="null")
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("-reps", "--repeats", type=int, default=1)
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--bpe", default="null")
    p.add_argument("--device", default=None)
    return p.parse_args(argv)


def schedule(name: str, args) -> tuple:
    """(epochs, bpe) of dataset ``name`` under the flags."""
    if args.finetune:
        return DEFAULT_FINETUNING.get(name, (1, "null"))
    if args.train:
        return DEFAULT_TRAINING.get(name, (10, 1000))
    return args.epochs, args.bpe


def write_rows(csv_path: str, rows: list) -> None:
    fields = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None) -> str:
    """Run the sweep; returns the CSV's path (rank 0 writes it)."""
    from .utils.config import load_config

    args = parse_args(argv)
    device = run_full.setup_process(args.device)
    datasets = [d.strip() for d in args.datasets.split(",") if d.strip()]
    csv_path = distributed.broadcast_object(os.path.abspath(
        f"ultra_results_{time.strftime('%Y-%m-%d-%H-%M-%S')}.csv"))
    rows = []
    for spec in datasets:
        name, _, version = spec.partition(":")
        epochs, bpe = schedule(name, args)
        for rep in range(args.repeats):
            seed = SEEDS[rep % len(SEEDS)]
            context = {
                "dataset": name, "version": version or "v1",
                "epochs": epochs, "bpe": bpe,
                "gpus": args.gpus, "ckpt": args.ckpt,
            }
            cfg = load_config(args.config, context=context)[0]
            work_dir, logger = run_full.rank_work_dir(
                cfg.get("output_dir", "./output"), cfg["task"]["class"],
                name, cfg["task"]["model"]["class"])
            logger.info(f"=== {spec} rep {rep} seed {seed} ===")
            run_full.set_seed(seed)
            dataset = build_dataset(cfg["dataset"])
            with mesh_scope(cfg, device) as (mesh, edge_axis, rel_edge_axis):
                task = build_task(cfg["task"], dataset,
                                  rspmm_impl=cfg.get("rspmm_impl", "auto"),
                                  seed=seed, device=device,
                                  edge_axis=edge_axis,
                                  rel_edge_axis=rel_edge_axis)
                engine = build_engine(cfg, task, work_dir=work_dir,
                                      seed=seed, mesh=mesh)
                if args.ckpt and args.ckpt not in ("null", "None"):
                    engine.load(os.path.expanduser(args.ckpt))
                anomaly = (torch.autograd.detect_anomaly()
                           if cfg.get("detect_anomaly")
                           else contextlib.nullcontext())
                with anomaly:
                    run_full.train_and_validate(cfg, engine, logger)
                    metrics = engine.evaluate(
                        "test", fast_test=cfg.get("fast_test"))
            rows.append({"dataset": spec, "seed": seed,
                         **{k: v for k, v in metrics.items()
                            if not isinstance(v, dict)}})
            if distributed.process_index() == 0:
                write_rows(csv_path, rows)
                logger.info(f"results -> {csv_path}")
    if distributed.process_index() == 0:
        print(csv_path)
    return csv_path


if __name__ == "__main__":
    main()

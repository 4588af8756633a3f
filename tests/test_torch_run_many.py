"""The port's sweep driver (``python -m ultra_torchdrug_tpu_torch.run_many``),
its WandbLogger sink and the rest of ops/variadic.py against the JAX
package's, on the CPU: the epoch tables and seeds equal the script's;
run_many on SynthKG and SynthInductiveKG with ``--epochs 0`` and one .pth
of seeded weights writes the script's CSV columns and rows (metrics within
1e-6 relative); WandbLogger is inert without wandb, and with a fake wandb
module the port's meter logs the JAX meter's keys at its steps; the
variadic functions and bincount give JAX's results on seeded inputs
(variadic_shuffle draws from a torch.Generator, so its invariants are
held, as tests/test_aux.py holds JAX's).
"""

import csv
import glob
import importlib
import logging
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.ops import variadic as j_variadic
from ultra_torchdrug_tpu.utils import logging as j_logging
from ultra_torchdrug_tpu.utils.debug import WandbLogger as JWandbLogger
from ultra_torchdrug_tpu_torch import run_many
from ultra_torchdrug_tpu_torch.engine import build
from ultra_torchdrug_tpu_torch.ops import variadic
from ultra_torchdrug_tpu_torch.utils import config
from ultra_torchdrug_tpu_torch.utils import logging as t_logging
from ultra_torchdrug_tpu_torch.utils.checkpoint import export_torch_checkpoint
from ultra_torchdrug_tpu_torch.utils.debug import WandbLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "script")
CONFIGS = {"SynthKG": "config/transductive/inference.yaml",
           "SynthInductiveKG:v1": "config/inductive/inference.yaml"}


def _jax_run_many():
    """script/run_many.py as a module (it imports script/run_full.py)."""
    sys.path.insert(0, SCRIPT)
    try:
        return importlib.import_module("run_many")
    finally:
        sys.path.remove(SCRIPT)


def test_tables_seeds_and_flags_match_the_script():
    j = _jax_run_many()
    assert run_many.SEEDS == j.SEEDS
    assert run_many.DEFAULT_FINETUNING == j.DEFAULT_FINETUNING
    assert run_many.DEFAULT_TRAINING == j.DEFAULT_TRAINING
    args = run_many.parse_args(["-c", "x.yaml", "-d", "A:v2,B", "-reps", "3",
                                "--finetune"])
    assert (args.repeats, args.finetune, args.epochs, args.bpe) == (
        3, True, 0, "null")
    assert run_many.schedule("FB15k237", args) == (1, "null")
    assert run_many.schedule("Unknown", args) == (1, "null")
    args.finetune, args.train = False, True
    assert run_many.schedule("YAGO310", args) == (10, 2000)
    assert run_many.schedule("Unknown", args) == (10, 1000)


def _read_csv(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


@pytest.mark.parametrize("spec", sorted(CONFIGS))
def test_run_many_writes_the_scripts_csv(tmp_path, monkeypatch, spec):
    """``--epochs 0`` with a .pth of seeded weights (the port's export,
    which both packages read): the same CSV columns, and rows equal up to
    the metrics' last digits."""
    name = spec.partition(":")[0]
    cfg_file = os.path.join(REPO, CONFIGS[spec])
    ctx = dict(dataset=name, version="v1", epochs=0, bpe=0, gpus=[0],
               ckpt=None)
    cfg = config.load_config(cfg_file, context=ctx)[0]
    task = build.build_task(cfg["task"], build.build_dataset(cfg["dataset"]),
                            device="cpu")
    pth = str(tmp_path / "seeded.pth")
    export_torch_checkpoint(pth, task.init_params(seed=7))
    reps = 2 if spec == "SynthKG" else 1  # the seeds' rows once
    argv = ["-c", cfg_file, "-d", spec, "--epochs", "0", "--bpe", "0",
            "--ckpt", pth, "-reps", str(reps)]
    outputs = {}
    for key in ("jax", "port"):
        os.makedirs(tmp_path / key)
        monkeypatch.chdir(tmp_path / key)  # the configs write under ./output
        if key == "jax":
            monkeypatch.setattr(sys, "argv", ["run_many.py"] + argv)
            _jax_run_many().main()
            (path,) = glob.glob(str(tmp_path / key / "ultra_results_*.csv"))
        else:
            path = run_many.main(argv + ["--device", "cpu"])
            assert os.path.dirname(path) == str(tmp_path / key)
        outputs[key] = _read_csv(path)
    (j_fields, j_rows), (fields, rows) = outputs["jax"], outputs["port"]
    assert fields == j_fields
    assert "mrr" in fields and fields == sorted(fields)
    assert [(r["dataset"], r["seed"]) for r in rows] == [
        (spec, "1024"), (spec, "42")][:reps]
    for row, j_row in zip(rows, j_rows):
        for k in fields:
            if k in ("dataset", "seed"):
                assert row[k] == j_row[k]
            else:
                np.testing.assert_allclose(float(row[k]), float(j_row[k]),
                                           rtol=1e-6, err_msg=k)


def test_wandb_logger_inert_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    logger = WandbLogger(config={"lr": 0.1, "bad": object()})
    assert logger._run is None
    logger.log({"loss": 1.0}, step=3)
    logger.finish()


class _FakeRun:
    def __init__(self, calls):
        self.calls = calls

    def log(self, metrics, step=None):
        self.calls.append((sorted(metrics), step, metrics))

    def finish(self):
        self.calls.append(("finish",))


def _fake_wandb(calls, inits):
    def init(project=None, config=None):
        inits.append((project, config))
        return _FakeRun(calls)

    return types.SimpleNamespace(init=init)


def test_meter_sink_logs_the_jax_keys_and_steps(monkeypatch):
    """Two windows of two steps each (metrics and a rate), then an eval
    dict: the port's sink gets the JAX sink's keys at the same steps, the
    window means equal, and the config reaches wandb.init scrubbed."""
    records = {}
    for key, sink_cls, meter_cls in (
            ("port", WandbLogger, t_logging.Meter),
            ("jax", JWandbLogger, j_logging.Meter)):
        calls, inits = [], []
        monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls, inits))
        sink = sink_cls(project="p", config={"lr": 0.1, "bad": object(),
                                             "engine": {"batch_size": 4}})
        assert inits == [("p", {"lr": 0.1, "engine": {"batch_size": 4}})]
        meter = meter_cls(logging.getLogger("test_meter_sink"),
                          log_interval=2, sink=sink)
        for step in range(4):
            meter.update({"loss": torch.tensor(0.5 + step) if key == "port"
                          else 0.5 + step, "grad_norm": 2.0 * step},
                         rates={"edges_per_s": 100})
        meter.log_dict({"mrr": 0.25, "hits@1": 0.125}, category="valid")
        sink.finish()
        records[key] = calls
    port, jax_calls = records["port"], records["jax"]
    assert [c[:2] for c in port] == [c[:2] for c in jax_calls]
    assert [c[1] for c in port[:3]] == [2, 4, 4]
    assert port[0][0] == ["edges_per_s", "grad_norm", "it_per_s", "loss"]
    for got, want in zip(port[:3], jax_calls[:3]):
        for k in ("loss", "grad_norm", "valid/mrr", "valid/hits@1"):
            if k in want[2]:
                assert got[2][k] == pytest.approx(want[2][k], rel=1e-12)


def test_build_engine_wandb_sink(tmp_path, monkeypatch):
    """``engine.logger: wandb`` with a wandb module present: the engine's
    meter logs through it under ``engine.wandb_project``."""
    calls, inits = [], []
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls, inits))
    cfg = config.load_config(os.path.join(REPO, "config/synthetic/smoke.yaml"),
                             context={"outdir": str(tmp_path)})[0]
    cfg["engine"].update(logger="wandb", wandb_project="proj", log_interval=1)
    task = build.build_task(cfg["task"], build.build_dataset(cfg["dataset"]),
                            device="cpu")
    engine = build.build_engine(cfg, task, work_dir=str(tmp_path))
    engine.train(num_epoch=1, batch_per_epoch=2)
    assert inits[0][0] == "proj"
    assert [c[1] for c in calls] == [1, 2]
    assert "loss" in calls[0][0] and "grad_norm" in calls[0][0]


# ---------------------------------------------------------------------------
# ops/variadic.py
# ---------------------------------------------------------------------------


SIZES = [np.array([3, 0, 4, 2, 1], np.int64), np.array([6], np.int64),
         np.array([0, 0, 5], np.int64)]


def _inputs(sizes, dtype, seed):
    rng = np.random.default_rng(seed)
    n = int(sizes.sum())
    if dtype == "int":
        return rng.integers(0, 4, n).astype(np.int32)  # duplicates, ties
    vals = rng.normal(size=n).astype(np.float32)
    vals[::3] = vals[0]  # ties across and within segments
    return vals


@pytest.mark.parametrize("dtype", ["float", "int"])
@pytest.mark.parametrize("case", range(len(SIZES)))
def test_variadic_functions_match_jax(case, dtype):
    sizes = SIZES[case]
    vals = _inputs(sizes, dtype, case)
    tv, ts = torch.from_numpy(vals), torch.from_numpy(sizes)
    jv, js = jnp.asarray(vals), jnp.asarray(sizes.astype(np.int32))
    for descending in (False, True):
        got = variadic.variadic_sort(tv, ts, descending=descending)
        want = j_variadic.variadic_sort(jv, js, descending=descending)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ks = np.array([min(2, s + 1) for s in sizes], np.int64)
    for largest in (True, False):
        got = variadic.variadic_topks(tv, ts, torch.from_numpy(ks), largest)
        want = j_variadic.variadic_topks(jv, js, jnp.asarray(ks), largest)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = variadic.variadic_unique(tv, ts)
    want = j_variadic.variadic_unique(jv, js)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if dtype == "int":
        for length in (3, 7):
            np.testing.assert_array_equal(
                variadic.bincount(tv, length).numpy(),
                np.asarray(j_variadic.bincount(jv, length)))


def test_variadic_shuffle_permutes_within_segments():
    sizes = torch.tensor([4, 0, 3, 5])
    vals = torch.arange(12, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    out, new_sizes = variadic.variadic_shuffle(g, vals, sizes)
    assert torch.equal(new_sizes, sizes)
    assert set(out[:4].tolist()) == {0, 1, 2, 3}
    assert set(out[4:7].tolist()) == {4, 5, 6}
    assert set(out[7:].tolist()) == set(range(7, 12))
    # the draw is the generator's: the same seed, the same shuffle
    again, _ = variadic.variadic_shuffle(torch.Generator().manual_seed(0),
                                         vals, sizes)
    assert torch.equal(out, again)
    assert not torch.equal(out, vals)

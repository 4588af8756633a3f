"""The port's config system, builders and CLI
(``python -m ultra_torchdrug_tpu_torch.run_full``) against the JAX
package's, on the CPU: the shipped configs load to the same dicts and build
the same model and task configs; what the port does not carry raises (or,
for the memory-only options, is logged as not applied); the smoke config
trains one epoch and writes its checkpoint and log; a checkpoint round trip
reproduces the metrics; and ``--epochs 0`` on inference.yaml gives the JAX
run's metrics on the same weights.
"""

import dataclasses
import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.engine import build as j_build
from ultra_torchdrug_tpu.tasks.task import (
    DEFAULT_TRANSDUCTIVE_METRICS as J_METRICS,
)
from ultra_torchdrug_tpu.utils import config as j_config
from ultra_torchdrug_tpu_torch import run_full
from ultra_torchdrug_tpu_torch.data.datasets import JointDataset
from ultra_torchdrug_tpu_torch.engine import build
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config,
    rel_nbfnet_config,
)
from ultra_torchdrug_tpu_torch.utils import config
from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic/smoke.yaml")
INFERENCE = os.path.join(REPO, "config/transductive/inference.yaml")
SHIPPED = ["config/synthetic/smoke.yaml", "config/transductive/inference.yaml",
           "config/transductive/pretrain_3g.yaml",
           "config/inductive/inference.yaml"]
# a value for every template variable of the shipped configs
CONTEXT = {"outdir": "/tmp/out", "dataset": "SynthKG", "gpus": [0],
           "epochs": 0, "bpe": 0, "ckpt": None, "version": "v1"}


def _load(path, module=config):
    cfg_file = os.path.join(REPO, path)
    names = module.detect_variables(cfg_file)
    return names, module.load_config(
        cfg_file, context={k: CONTEXT[k] for k in names})


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_configs_load_to_the_jax_dicts(path):
    names, cfgs = _load(path)
    assert (names, cfgs) == _load(path, j_config)
    assert len(cfgs) == 1 and cfgs[0]["task"]["model"]["input_dim"] > 0


def test_parse_args_grid_and_registry(tmp_path):
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text("d: {{ dataset }}\ng: {{ gpus }}\n")
    argv = ["-c", str(cfg_file), "--dataset", "SynthKG", "--gpus", "[0]"]
    args, ctx = config.parse_args(argv)
    j_args, j_ctx = j_config.parse_args(argv)
    assert (vars(args), ctx) == (vars(j_args), j_ctx)
    assert ctx == {"dataset": "SynthKG", "gpus": [0]} and args.seed == 1024
    grid_file = tmp_path / "grid.yaml"
    grid_file.write_text("lr: [0.1, 0.2]\n---\nl: {{ lr }}\nd: {{ d }}\n")
    cfgs = config.load_config(str(grid_file), context={"d": "x"})
    assert cfgs == j_config.load_config(str(grid_file), context={"d": "x"})
    assert [c["l"] for c in cfgs] == [0.1, 0.2]
    assert list(config.meshgrid({"a": [1, 2], "b": "x"})) == list(
        j_config.meshgrid({"a": [1, 2], "b": "x"}))
    for name in ("SynthKG", "SynthInductiveKG", "SynthCompositionalKG",
                 "SynthJoint"):
        assert config.lookup(name) is not None
    with pytest.raises(KeyError, match="FB15k237"):
        config.lookup("FB15k237")  # the real-data parsers: ROADMAP item 8


@pytest.mark.parametrize("name,kwargs", [
    ("SynthKG", dict(num_nodes=40, num_edges=300, num_relations=5)),
    ("SynthInductiveKG", {}), ("SynthCompositionalKG", dict(num_nodes=50)),
    ("SynthJoint", {})])
def test_synthetic_catalog_matches_jax(name, kwargs):
    spec = {"class": name, **kwargs}
    got, want = build.build_dataset(spec), j_build.build_dataset(spec)
    if name == "SynthJoint":
        assert isinstance(got, JointDataset)
        pairs = list(zip(got.datasets, want.datasets))
    else:
        pairs = [(got, want)]
    for a, b in pairs:
        for split in ("train", "valid", "test"):
            np.testing.assert_array_equal(getattr(a, split),
                                          getattr(b, split))


def _common_fields(port_obj, jax_obj):
    """The port dataclass's fields, each beside the JAX one's value."""
    return {f.name: (getattr(port_obj, f.name), getattr(jax_obj, f.name))
            for f in dataclasses.fields(port_obj)}


@pytest.mark.parametrize("path", SHIPPED)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_model_and_task_configs_match_jax(path, compute_dtype):
    cfg = _load(path)[1][0]
    cfg_task = cfg["task"]
    cfg_task["model"]["compute_dtype"] = compute_dtype
    got = build.build_model_config(cfg_task, 7)
    want = j_build.build_model_config(cfg_task, 7)
    for tower in ("entity", "relation"):
        for name, (a, b) in _common_fields(getattr(got, tower),
                                           getattr(want, tower)).items():
            assert tuple(a) == tuple(b) if name == "hidden_dims" else a == b, (
                tower, name)
    assert got.remove_one_hop == want.remove_one_hop
    assert got.entity.compute_dtype == compute_dtype
    for name, (a, b) in _common_fields(
            build.build_task_config(cfg_task),
            j_build.build_task_config(cfg_task, J_METRICS)).items():
        assert a == b, name


def test_entity_nbfnet_config_raises_on_what_it_does_not_honour(caplog):
    # the ROADMAP Queue 3 repro: concat_hidden=True used to build a model
    # without the concat
    with pytest.raises(NotImplementedError, match="concat_hidden.*item 6"):
        entity_nbfnet_config(concat_hidden=True)
    with pytest.raises(TypeError, match="unknown option 'activation'"):
        entity_nbfnet_config(activation="gelu")
    with pytest.raises(NotImplementedError, match="item 9"):
        entity_nbfnet_config(edge_axis="edge")
    with pytest.raises(NotImplementedError, match="item 9"):
        entity_nbfnet_config(ring_exchange="rdma")
    with pytest.raises(NotImplementedError, match="rspmm_impl='xla'"):
        entity_nbfnet_config(rspmm_impl="xla")
    with pytest.raises(ValueError, match="compute_dtype"):
        entity_nbfnet_config(compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="learn_query.*item 7"):
        rel_nbfnet_config(learn_query=True)
    # inert values build the same config as no value at all
    plain = entity_nbfnet_config()
    assert entity_nbfnet_config(concat_hidden=False, edge_axis="",
                                ring_exchange="ppermute",
                                rspmm_impl="pallas") == plain
    with caplog.at_level(logging.WARNING):
        cfg = entity_nbfnet_config(remat="auto", micro_batch=8, stack="scan",
                                   score_chunk=0)
    assert cfg == plain
    logged = " ".join(r.getMessage() for r in caplog.records)
    for key in ("remat", "micro_batch", "stack"):
        assert f"{key}=" in logged
    assert "score_chunk" not in logged and "item 5" in logged


def _smoke_cfg(tmp_path):
    return config.load_config(SMOKE, context={"outdir": str(tmp_path)})[0]


@pytest.mark.parametrize("edit,match", [
    (lambda c: c.update(parallel={"data": 2}), "item 9"),
    (lambda c: c["engine"].update(data_parallel=2), "item 9"),
    (lambda c: c["engine"].update(logger="wandb"), "item 8"),
    (lambda c: c["engine"].update(steps_per_call=4), "item 7"),
])
def test_build_engine_raises_on_what_the_port_lacks(tmp_path, edit, match):
    cfg = _smoke_cfg(tmp_path)
    edit(cfg)
    with pytest.raises(NotImplementedError, match=match):
        build.build_engine(cfg, None)


@pytest.mark.parametrize("edit,match", [
    (lambda t: t.update({"class": "InductiveKnowledgeGraphCompletionAdapted"}),
     "item 3"),
    (lambda t: t.update({"class": "MultiGraphPreTraining"}), "item 4"),
    (lambda t: t.update(metric_per_rel=True), "item 3"),
    (lambda t: t.update(toy_eval=True), "item 3"),
    (lambda t: t.update(eval_batch_size=8), "item 3"),
    (lambda t: t["rel_models"].update(num_rel_models=2), "item 7"),
    (lambda t: t["rel_models"]["rel_model"].update(class_str="CustomNBFNet"),
     "item 7"),
    (lambda t: t["model"].update(concat_hidden=True), "item 6"),
])
def test_build_task_raises_on_what_the_port_lacks(tmp_path, edit, match):
    cfg = _smoke_cfg(tmp_path)
    edit(cfg["task"])
    dataset = build.build_dataset(cfg["dataset"])
    with pytest.raises(NotImplementedError, match=match):
        build.build_task(cfg["task"], dataset, device="cpu")


def test_run_full_cli_smoke(tmp_path):
    engine = run_full.main(["-c", SMOKE, "--outdir", str(tmp_path),
                            "--device", "cpu"])
    assert engine.epoch == 1
    files = os.listdir(engine.work_dir)
    assert any(f.endswith(".ckpt") for f in files)
    assert "log.txt" in files
    assert engine.task.device.type == "cpu"
    assert set(engine.metrics) == {"valid", "test"}
    assert 0 < engine.metrics["test"]["mrr"] <= 1


def test_checkpoint_round_trip_reproduces_metrics(tmp_path):
    cfg = _smoke_cfg(tmp_path)
    dataset = build.build_dataset(cfg["dataset"])

    def engine(seed):
        task = build.build_task(cfg["task"], dataset, seed=0, device="cpu")
        return build.build_engine(cfg, task, work_dir=str(tmp_path),
                                  seed=seed)

    trained = engine(1)
    trained.train(num_epoch=1, batch_per_epoch=3)
    want = trained.evaluate("valid")
    path = str(tmp_path / "model.ckpt")
    trained.save(path)
    fresh = engine(2)
    assert fresh.evaluate("valid") != want
    fresh.load(path)
    assert fresh.evaluate("valid") == want and fresh.epoch == 0
    fresh.load(path, drop_optimizer=False)
    assert fresh.epoch == 1
    for a, b in zip(trained.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 2"):
        fresh.load(path, fix_reasoner=True)
    with pytest.raises(NotImplementedError, match="item 2"):
        fresh.load(str(tmp_path / "model.pth"))


def test_inference_epochs_0_matches_the_jax_run(tmp_path, monkeypatch):
    """``--epochs 0`` on inference.yaml with SynthKG: the JAX run_full with
    its own seeded weights, then the port's run_full on those weights (carried
    across by load_jax_params and Engine.save, read back by the config's
    ``checkpoint``). Both rank the same triples on the same graph; the
    rankings, and so the metrics, must agree."""
    monkeypatch.chdir(tmp_path)  # inference.yaml writes under ./output
    sys.path.insert(0, os.path.join(REPO, "script"))
    try:
        import run_full as j_run_full
    finally:
        sys.path.remove(os.path.join(REPO, "script"))
    flags = ["-c", INFERENCE, "--dataset", "SynthKG", "--epochs", "0",
             "--bpe", "0", "--gpus", "[0]"]
    j_engine = j_run_full.main(flags + ["--ckpt", "null"])
    want = {split: j_engine.evaluate(split) for split in ("valid", "test")}

    cfg = config.load_config(INFERENCE, context=dict(
        dataset="SynthKG", epochs=0, bpe=0, gpus=[0], ckpt=None))[0]
    task = build.build_task(cfg["task"], build.build_dataset(cfg["dataset"]),
                            device="cpu")
    carrier = build.build_engine(cfg, task, work_dir=str(tmp_path))
    load_jax_params(carrier.model,
                    jax.tree_util.tree_map(np.asarray, j_engine.params))
    ckpt = str(tmp_path / "jax_weights.ckpt")
    carrier.save(ckpt)
    engine = run_full.main(flags + ["--ckpt", ckpt, "--device", "cpu"])
    assert engine.epoch == 0
    for split in ("valid", "test"):
        got = engine.metrics[split]
        assert set(got) == set(want[split])
        for name, value in want[split].items():
            np.testing.assert_allclose(got[name], value, rtol=1e-6,
                                       err_msg=f"{split} {name}")

"""The port's config system, builders and CLI
(``python -m ultra_torchdrug_tpu_torch.run_full``) against the JAX
package's, on the CPU: the shipped configs load to the same dicts and build
the same model and task configs; what the port does not carry raises; the
smoke config
trains one epoch and writes its checkpoint and log; a checkpoint round trip
(native, ``fix_reasoner`` and ``.pth``) reproduces the metrics; every
shipped config builds its task; and ``--epochs 0`` on both inference
configs, from a native checkpoint or a ``.pth``, gives the JAX run's
metrics on the same weights.
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
from ultra_torchdrug_tpu.utils import checkpoint as j_checkpoint
from ultra_torchdrug_tpu.utils import config as j_config
from ultra_torchdrug_tpu_torch import run_full
from ultra_torchdrug_tpu_torch.data.datasets import JointDataset
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.engine import build
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config,
    rel_nbfnet_config,
)
from ultra_torchdrug_tpu_torch.models.rel_inputs import build_initial_features
from ultra_torchdrug_tpu_torch.ops.rspmm import generalized_rspmm
from ultra_torchdrug_tpu_torch.utils import config
from ultra_torchdrug_tpu_torch.utils.checkpoint import export_torch_checkpoint
from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic/smoke.yaml")
INFERENCE = os.path.join(REPO, "config/transductive/inference.yaml")
INDUCTIVE = os.path.join(REPO, "config/inductive/inference.yaml")
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
                 "SynthJoint", "FB15k237"):
        assert config.lookup(name) is not None
    # every public name is registered, as in the JAX catalog; an unknown
    # one raises
    assert config.registered_names() == j_config.registered_names()
    with pytest.raises(KeyError, match="NoSuchKG"):
        config.lookup("NoSuchKG")


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
            if name == "rspmm_impl":
                # the JAX package resolves "auto" to its backend's impl
                # ("xla" on the CPU); the port's "auto" takes its kernels
                assert a == ("ring" if b == "ring" else "auto"), (tower, b)
                continue
            assert tuple(a) == tuple(b) if name == "hidden_dims" else a == b, (
                tower, name)
    assert got.remove_one_hop == want.remove_one_hop
    assert got.entity.compute_dtype == compute_dtype
    for name, (a, b) in _common_fields(
            build.build_task_config(cfg_task),
            j_build.build_task_config(cfg_task, J_METRICS)).items():
        assert a == b, name


def test_entity_nbfnet_config_raises_on_what_it_does_not_honour(caplog):
    with pytest.raises(TypeError, match="unknown option 'activation'"):
        entity_nbfnet_config(activation="gelu")
    # an edge axis needs the ring: the partitioned path is not ported
    with pytest.raises(NotImplementedError, match="item 9"):
        entity_nbfnet_config(edge_axis="edge")
    with pytest.raises(ValueError, match="ring_exchange"):
        entity_nbfnet_config(ring_exchange="nccl")
    ring = entity_nbfnet_config(edge_axis="edge", rspmm_impl="ring",
                                ring_exchange="rdma")
    assert (ring.edge_axis, ring.rspmm_impl, ring.ring_exchange) == (
        "edge", "ring", "rdma")
    # xla builds the O(E) route; with an edge axis it would select the
    # partitioned path, which is not ported
    assert entity_nbfnet_config(rspmm_impl="xla").rspmm_impl == "xla"
    with pytest.raises(NotImplementedError, match="item 9"):
        entity_nbfnet_config(rspmm_impl="xla", edge_axis="edge")
    with pytest.raises(ValueError, match="rspmm_impl must be one of"):
        entity_nbfnet_config(rspmm_impl="triton")
    with pytest.raises(ValueError, match="compute_dtype"):
        entity_nbfnet_config(compute_dtype="float16")
    assert rel_nbfnet_config(learn_query=True).learn_query
    with pytest.raises(TypeError, match="unknown option 'learnable_q'"):
        rel_nbfnet_config(learnable_q=True)
    with pytest.raises(ValueError, match="remat"):
        entity_nbfnet_config(remat="sometimes")
    with pytest.raises(ValueError, match="stack"):
        rel_nbfnet_config(stack="loop")
    # inert values build the same config as no value at all
    plain = entity_nbfnet_config()
    assert entity_nbfnet_config(concat_hidden=False, edge_axis="",
                                ring_exchange="ppermute",
                                rspmm_impl="pallas") == plain
    # concat_hidden and the memory policies build the configs they name,
    # and nothing is logged as not applied
    with caplog.at_level(logging.WARNING):
        cfg = entity_nbfnet_config(concat_hidden=True, remat="auto",
                                   micro_batch=8, stack="scan",
                                   score_chunk=4)
        rel = rel_nbfnet_config(remat="save_rspmm", stack="unroll")
    assert cfg == dataclasses.replace(plain, concat_hidden=True, remat="auto",
                                      micro_batch=8, stack="scan",
                                      score_chunk=4)
    assert (rel.remat, rel.stack) == ("save_rspmm", "unroll")
    assert not caplog.records


def _smoke_cfg(tmp_path):
    return config.load_config(SMOKE, context={"outdir": str(tmp_path)})[0]


@pytest.mark.parametrize("edit,match", [
    (lambda c: c.update(parallel={"data": 2}), "2 processes"),
    (lambda c: c["engine"].update(data_parallel=2), "2 processes"),
    (lambda c: c["engine"].update(logger="wandb"), None),
    (lambda c: c.update(parallel={"data": 2, "edge": 2}), "2 processes"),
])
def test_build_engine_raises_on_what_the_port_lacks(tmp_path, edit, match):
    """A data axis needs a process group of its size (one process here:
    the message names both numbers and the launch command); ``engine.logger:
    wandb`` builds an engine whose meter has an inert WandbLogger sink."""
    cfg = _smoke_cfg(tmp_path)
    edit(cfg)
    if match is None:
        dataset = build.build_dataset(cfg["dataset"])
        task = build.build_task(cfg["task"], dataset, device="cpu")
        engine = build.build_engine(cfg, task, work_dir=str(tmp_path))
        assert type(engine.meter.sink).__name__ == "WandbLogger"
        assert engine.meter.sink._run is None
        return
    with pytest.raises(ValueError, match=match + ".*group has 1: launch "
                       "`torchrun --nproc_per_node 2"):
        build.build_engine(cfg, None)


@pytest.mark.parametrize("kwargs,match", [
    (dict(rel_edge_axis="edge"), "item 9"),
    (dict(edge_axis="edge"), "item 9"),
    (dict(edge_axis="edge", rspmm_impl="xla"), "item 9"),
])
def test_build_task_raises_on_what_the_port_lacks(tmp_path, kwargs, match):
    """An edge-sharded relation tower, and an edge axis on any route but
    the ring (the partitioned path), are Queue 1 item 9."""
    cfg = _smoke_cfg(tmp_path)
    dataset = build.build_dataset(cfg["dataset"])
    with pytest.raises(NotImplementedError, match=match):
        build.build_task(cfg["task"], dataset, device="cpu", **kwargs)


def test_op_raises_name_their_roadmap_items():
    """Gradients to the edge weights (classic NBFNet's path tools) take the
    O(E) route, through the max op too, and agree with a central finite
    difference. Relation-graph input types build their features; an
    unknown part raises, as in the JAX package."""
    rng = np.random.default_rng(0)
    V, R, E, F = 9, 2, 30, 4
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1)
    g = Graph.from_triplets(tri, V, R).prepare_csr(backward=True)
    rel = torch.from_numpy(rng.normal(size=(R, F))).double()
    x = torch.from_numpy(rng.normal(size=(V, F))).double()
    cot = torch.from_numpy(rng.normal(size=(V, F))).double()

    def f(w):
        return (generalized_rspmm(g.edge_index, g.edge_type, w, rel, x,
                                  msg="mul", agg="max", num_nodes=V,
                                  csr=g.csr) * cot).sum()

    w = torch.from_numpy(rng.uniform(0.5, 1.5, E)).requires_grad_()
    (grad,) = torch.autograd.grad(f(w), w)
    eps = 1e-6
    with torch.no_grad():
        fd = torch.stack([(f(w + eps * e) - f(w - eps * e)) / (2 * eps)
                          for e in torch.eye(E, dtype=w.dtype)])
    torch.testing.assert_close(grad, fd, rtol=1e-6, atol=1e-6)
    assert grad.abs().sum() > 0
    assert build_initial_features(g, "ones", 3).eq(1).all()
    assert build_initial_features(g, "ones__zeros", 3).eq(1).all()
    with pytest.raises(ValueError, match="unknown input type component "
                       "'rwse'"):
        build_initial_features(g, "ones__rwse", 3)


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
    # fix_reasoner on the native file: the current relation projections and
    # relation embeddings stay, every other weight is the file's
    other = engine(3)
    current = {k: v.clone() for k, v in other.model.state_dict().items()}
    other.load(path, fix_reasoner=True)
    kept = 0
    for k, v in other.model.state_dict().items():
        reasoner = "relation_projection" in k or k.endswith("relation.weight")
        kept += reasoner
        source = current if reasoner else trained.model.state_dict()
        assert torch.equal(v, source[k]), k
    assert kept == 2 * 4 + 2  # smoke.yaml: 2 layers a tower
    # the .pth route: the reference layout reproduces the metrics
    pth = str(tmp_path / "model.pth")
    export_torch_checkpoint(pth, trained.model)
    fresh = engine(4)
    fresh.load(pth)
    assert fresh.evaluate("valid") == want


def _jax_run_full():
    """The JAX package's script/run_full.py as a module."""
    sys.path.insert(0, os.path.join(REPO, "script"))
    try:
        import run_full as j_run_full
    finally:
        sys.path.remove(os.path.join(REPO, "script"))
    return j_run_full


def test_inference_epochs_0_matches_the_jax_run(tmp_path, monkeypatch):
    """``--epochs 0`` on inference.yaml with SynthKG: the JAX run_full with
    its own seeded weights, then the port's run_full on those weights (carried
    across by load_jax_params and Engine.save, read back by the config's
    ``checkpoint``). Both rank the same triples on the same graph; the
    rankings, and so the metrics, must agree."""
    monkeypatch.chdir(tmp_path)  # inference.yaml writes under ./output
    j_run_full = _jax_run_full()
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
    # the same weights as the JAX package's own reference-layout export
    pth = str(tmp_path / "jax_weights.pth")
    j_checkpoint.export_torch_checkpoint(
        pth, jax.tree_util.tree_map(np.asarray, j_engine.params))
    for path in (ckpt, pth):
        engine = run_full.main(flags + ["--ckpt", path, "--device", "cpu"])
        assert engine.epoch == 0
        for split in ("valid", "test"):
            got = engine.metrics[split]
            assert set(got) == set(want[split])
            for name, value in want[split].items():
                np.testing.assert_allclose(got[name], value, rtol=1e-6,
                                           err_msg=f"{path} {split} {name}")


# each shipped config's dataset section replaced by its synthetic
# counterpart (the real graphs are not in the repository)
SYNTHETIC = {"config/synthetic/smoke.yaml": None,
             "config/transductive/inference.yaml": {"class": "SynthKG"},
             "config/transductive/pretrain_3g.yaml": {"class": "SynthJoint"},
             "config/inductive/inference.yaml": {"class": "SynthInductiveKG"}}


@pytest.mark.parametrize("path", SHIPPED)
def test_every_shipped_config_builds_its_task(path):
    """build_task on each shipped config's task section and its synthetic
    dataset gives the JAX package's task class, model and task config."""
    cfg = _load(path)[1][0]
    if SYNTHETIC[path]:
        cfg["dataset"] = SYNTHETIC[path]
    dataset = build.build_dataset(cfg["dataset"])
    task = build.build_task(cfg["task"], dataset, device="cpu")
    want = j_build.build_task(cfg["task"], j_build.build_dataset(
        cfg["dataset"]))
    assert type(task).__name__ == type(want).__name__
    assert task.num_relations == want.num_relations
    for name, (a, b) in _common_fields(task.cfg, want.cfg).items():
        assert a == b, name
    assert task.model_cfg.entity.num_relations == (
        want.model_cfg.entity.num_relations)


def test_inductive_inference_from_a_pth_matches_the_jax_run(tmp_path,
                                                             monkeypatch):
    """config/inductive/inference.yaml as shipped, rendered for
    SynthInductiveKG with ``--epochs 0`` and a .pth of seeded weights (the
    port's export) as its checkpoint: the port's run_full and the JAX
    package's read the same file and give the same valid and test metrics,
    the default inductive ones (hits@10_50 among them)."""
    monkeypatch.chdir(tmp_path)  # the config writes under ./output
    ctx = dict(dataset="SynthInductiveKG", version="v1", epochs=0, bpe=0,
               gpus=[0], ckpt=None)
    cfg = config.load_config(INDUCTIVE, context=ctx)[0]
    task = build.build_task(cfg["task"], build.build_dataset(cfg["dataset"]),
                            device="cpu")
    pth = str(tmp_path / "seeded.pth")
    export_torch_checkpoint(pth, task.init_params(seed=7))
    flags = ["-c", INDUCTIVE, "--dataset", "SynthInductiveKG", "--version",
             "v1", "--epochs", "0", "--bpe", "0", "--gpus", "[0]", "--ckpt",
             pth]
    j_engine = _jax_run_full().main(flags)
    engine = run_full.main(flags + ["--device", "cpu"])
    assert engine.epoch == 0
    for split in ("valid", "test"):
        got, want = engine.metrics[split], j_engine.evaluate(split)
        assert set(got) == set(want) and "hits@10_50" in got
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value, rtol=1e-6,
                                       err_msg=f"{split} {name}")

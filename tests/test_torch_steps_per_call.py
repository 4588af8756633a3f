"""``engine.steps_per_call`` against the JAX engine on the CPU: the
(graph, batch) schedule of ``Engine._epoch_chunks`` equals the JAX
engine's for K = 1-4, on one graph (an epoch that is not a whole number
of chunks wraps into the start of its permutation) and on three graphs
(one mixture draw per chunk); K = 4 trains the parameters that K = 1 does
when the epoch is a whole number of chunks (tests/test_engine.py::
test_steps_per_call_matches_per_step_loop); pre-training on three graphs
with K = 3 and 5 batches an epoch takes 6 steps; and the key builds from a
config. Batches are compared exactly, and the parameters bitwise (the same
steps in the same order).
"""

import os

import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import JointDataset as JJoint
from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.engine.engine import Engine as JEngine
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.tasks.task import MultiGraphPretrainTask as JPretrain
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import TransductiveKGTask as JTask
from ultra_torchdrug_tpu_torch.data.datasets import JointDataset
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.engine import build
from ultra_torchdrug_tpu_torch.engine.engine import Engine
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.tasks.task import (
    MultiGraphPretrainTask,
    TaskConfig,
    TransductiveKGTask,
)
from ultra_torchdrug_tpu_torch.utils import config
from ultra_torchdrug_tpu_torch.utils.logging import get_root_logger

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config/synthetic/smoke.yaml")
BATCH, DIM, NUM_REL = 16, 8, 7
GRAPHS = (("g0", 40, 300, 5), ("g1", 45, 200, 3), ("g2", 30, 150, 7))


def _configs():
    return (JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * 2,
                         num_relations=2 * NUM_REL),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2)),
        TUltraConfig(
            entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * 2,
                             num_relations=2 * NUM_REL),
            relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2)))


@pytest.fixture(scope="module")
def tasks():
    jcfg, tcfg = _configs()
    cfg = dict(num_negative=8)
    joint = [(name, v, e, r, i) for i, (name, v, e, r) in enumerate(GRAPHS)]
    return dict(
        single=(JTask(j_synth("SynthKG", 40, 300, 5, seed=0), jcfg,
                      JTaskConfig(**cfg)),
                TransductiveKGTask(t_synth("SynthKG", 40, 300, 5, seed=0),
                                   tcfg, TaskConfig(**cfg), device="cpu")),
        multi=(JPretrain(JJoint("joint", [j_synth(n, v, e, r, seed=s)
                                         for n, v, e, r, s in joint]),
                         jcfg, JTaskConfig(**cfg)),
               MultiGraphPretrainTask(
                   JointDataset("joint", [t_synth(n, v, e, r, seed=s)
                                          for n, v, e, r, s in joint]),
                   tcfg, TaskConfig(**cfg), device="cpu")))


def _engine(task, K, seed=5):
    return Engine(task, batch_size=BATCH, seed=seed, log_interval=10**9,
                  logger=get_root_logger(None), steps_per_call=K)


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("kind,bpe", [("single", 6), ("single", None),
                                      ("multi", 5)])
def test_schedule_matches_jax(tasks, kind, bpe, K):
    jtask, ttask = tasks[kind]
    jeng = JEngine(jtask, batch_size=BATCH, seed=5, log_interval=10**9,
                   logger=get_root_logger(None), steps_per_call=K)
    want = [(gid, np.asarray(b).reshape(k, BATCH, 3))
            for gid, k, b, _ in jeng._epoch_chunks(bpe)]
    got = list(_engine(ttask, K)._epoch_chunks(bpe))
    assert len(got) == len(want)
    for (gid, chunk), (j_gid, j_chunk) in zip(got, want):
        assert gid == j_gid
        assert chunk.shape == (K, BATCH, 3)
        np.testing.assert_array_equal(chunk, j_chunk)
    if kind == "single" and bpe:
        assert len(got) * K == -(-bpe // K) * K


def test_four_steps_a_call_train_as_one(tasks):
    _, task = tasks["single"]
    params = []
    for K in (1, 4):
        engine = _engine(task, K, seed=7)
        engine.train(num_epoch=1, batch_per_epoch=8)
        assert engine.meter.global_step == 8
        params.append([p.detach().clone() for p in engine.model.parameters()])
    for a, b in zip(*params):
        assert torch.equal(a, b)


def test_pretraining_rounds_up_to_whole_chunks(tasks):
    """Three graphs, K = 3, 5 batches an epoch: two chunks of 3 steps,
    each chunk on one graph, as the JAX engine runs them."""
    _, task = tasks["multi"]
    engine = _engine(task, 3)
    chunks = list(_engine(task, 3)._epoch_chunks(5))
    engine.train(num_epoch=1, batch_per_epoch=5)
    assert engine.meter.global_step == 6 == 3 * len(chunks)
    assert all(np.isfinite(m["loss"]) for m in engine.meter.last_window)
    assert engine._warmed == {gid for gid, _ in chunks}


def test_steps_per_call_builds_from_a_config(tmp_path):
    cfg = config.load_config(SMOKE, context={"outdir": str(tmp_path)})[0]
    cfg["engine"]["steps_per_call"] = 4
    task = build.build_task(cfg["task"], build.build_dataset(cfg["dataset"]),
                            device="cpu")
    engine = build.build_engine(cfg, task, work_dir=str(tmp_path))
    assert engine.steps_per_call == 4
    engine.train(num_epoch=1, batch_per_epoch=5)
    assert engine.meter.global_step == 8  # 5 rounded up to 2 chunks of 4

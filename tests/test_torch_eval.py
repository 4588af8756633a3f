"""Zero-shot evaluation end to end: ``TransductiveKGTask.evaluate`` in the
JAX package and in the PyTorch port, on the data of
config/synthetic/smoke.yaml (SynthKG 40/300/5, 2x8 layers), the same
weights, and eval batch 16 with a ragged last batch. Filtered rankings must
be identical, up to candidates tied in exact arithmetic (see TIE_BAND), and
the metrics equal to 1e-6."""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_scores
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu.ops.match import head_truth_mask as j_head_mask
from ultra_torchdrug_tpu.ops.match import tail_truth_mask as j_tail_mask
from ultra_torchdrug_tpu.tasks.task import TaskConfig as JTaskConfig
from ultra_torchdrug_tpu.tasks.task import TransductiveKGTask as JTask
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import ultra_eval_scores
from ultra_torchdrug_tpu_torch.ops.match import (
    head_truth_mask,
    tail_truth_mask,
)
from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask as TTask
from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

BATCH = 16
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tasks():
    # config/synthetic/smoke.yaml: SynthKG 40/300/5, input 8, 2 layers of 8
    jds = j_synth("SynthKG", 40, 300, 5, seed=0)
    tds = t_synth("SynthKG", 40, 300, 5, seed=0)
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=8, hidden_dims=(8, 8), num_relations=10),
        relation=j_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=8, hidden_dims=(8, 8), num_relations=10),
        relation=t_rel_cfg(input_dim=8, hidden=8, num_layers=2))
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    # pin the JAX eval batch: its auto policy would pick its own
    jtask = JTask(jds, jcfg, JTaskConfig(eval_batch_size=BATCH))
    ttask = TTask(tds, tcfg, device="cpu")
    return jtask, ttask, params, model


# Two candidates that are tied in exact arithmetic are ordered by rounding,
# which differs between the packages by an ulp or two. The smoke KG makes
# such ties: its relation graph is complete, so every relation but the
# query's is interchangeable and the relation tower gives them one vector;
# two entities with as many in-edges then sum equal multisets of messages,
# in other orders.
# A rank may differ only through such candidates: each must lie within
# TIE_BAND of the target's score in both packages (the scores themselves
# agree to ~2e-7, test_torch_ultra.py). Every such row is reported with its
# score gaps.
TIE_BAND = 1e-6


def _chunks(triples):
    for start in range(0, len(triples), BATCH):
        chunk = triples[start:start + BATCH]
        keep = len(chunk)
        chunk = np.concatenate(
            [chunk, np.repeat(chunk[:1], BATCH - keep, 0)], 0)
        yield start, keep, chunk


def _both_scores(jtask, ttask, params, model, chunk):
    """[B, V] tail and head scores of one eval chunk from both packages, on
    the graphs their eval functions use."""
    jrel = jtask.rel_graph.prepare_dense()
    jt, jh = j_scores(params, jtask.model_cfg, jtask.fact_graph, jrel,
                      *(jnp.asarray(chunk[:, i]) for i in range(3)))
    b = torch.from_numpy(chunk.astype(np.int64))
    with torch.inference_mode():
        tt, th = ultra_eval_scores(
            model, ttask.fact_graph, ttask.rel_graph.prepare_dense(),
            b[:, 0], b[:, 1], b[:, 2])
    return (np.asarray(jt), np.asarray(jh)), (tt.numpy(), th.numpy())


def _assert_rankings_match(tasks, triples, label):
    """Both packages' filtered rankings of ``triples``; they must be equal
    except where a rank is decided by candidates tied in exact arithmetic
    (TIE_BAND), and every such row is reported with its score gaps. Returns
    the port's ranking."""
    jtask, ttask, params, model = tasks
    jrank, _ = jtask._run_eval(jtask._eval_fn, params, triples, BATCH)
    jrank = np.asarray(jrank)
    trank = ttask._run_eval(ttask._eval_fn, model, triples, BATCH)
    assert trank.shape == jrank.shape == (len(triples), 2)
    assert trank.dtype.kind == "i"
    V = ttask.fact_graph.num_nodes
    filt = ttask.graph.edge_list
    ties = []
    for start, keep, chunk in _chunks(triples):
        rows = np.nonzero((trank[start:start + keep]
                           != jrank[start:start + keep]).any(axis=1))[0]
        if not len(rows):
            continue
        (jt, jh), (tt, th) = _both_scores(jtask, ttask, params, model, chunk)
        b = torch.from_numpy(chunk.astype(np.int64))
        masks = (tail_truth_mask(filt, b[:, 0], b[:, 2], V).numpy(),
                 head_truth_mask(filt, b[:, 1], b[:, 2], V).numpy())
        for i in rows:
            for col, (js, ts, truth, target) in enumerate((
                    (jt, tt, masks[0], chunk[i, 1]),
                    (jh, th, masks[1], chunk[i, 0]))):
                j_geq = (js[i] >= js[i, target]) & ~truth[i]
                t_geq = (ts[i] >= ts[i, target]) & ~truth[i]
                assert j_geq.sum() + 1 == jrank[start + i, col]
                assert t_geq.sum() + 1 == trank[start + i, col]
                flipped = np.nonzero(j_geq != t_geq)[0]
                gaps = [(int(v), float(js[i, v] - js[i, target]),
                         float(ts[i, v] - ts[i, target])) for v in flipped]
                assert all(abs(gj) <= TIE_BAND and abs(gt) <= TIE_BAND
                           for _, gj, gt in gaps), (
                    f"row {start + i} {'tail' if col == 0 else 'head'}: "
                    f"rank {trank[start + i, col]} vs {jrank[start + i, col]}, "
                    f"(candidate, jax gap, port gap) {gaps}")
                if gaps:
                    ties.append((start + i, col, gaps))
    if ties:
        warnings.warn(f"{label}: ranks decided by rounding at exact ties "
                      f"(row, direction, [(candidate, jax gap, port gap)]): "
                      f"{ties}")
    return trank


@pytest.mark.parametrize("split", ["test", "valid"])
def test_filtered_rankings_identical(tasks, split):
    triples = tasks[0].eval_triples(split)
    assert len(triples) % BATCH != 0  # the last batch is ragged
    _assert_rankings_match(tasks, triples, split)


@pytest.mark.parametrize("split", ["test", "valid"])
def test_metrics_equal(tasks, split):
    """The port's metrics against the JAX package's metric code on the same
    rankings (the rankings themselves are held by the test above), and
    directly against the JAX evaluate() where the rankings are identical."""
    jtask, ttask, params, model = tasks
    triples = jtask.eval_triples(split)
    trank = ttask._run_eval(ttask._eval_fn, model, triples, BATCH)
    jrank, cand = jtask._run_eval(jtask._eval_fn, params, triples, BATCH)
    rel = np.stack([triples[:, 2], triples[:, 2] + jtask.num_relations], 1)
    want = jtask._metrics_from_rankings(trank.astype(np.int32), cand, rel)
    got = ttask.evaluate(model, split, BATCH)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    if np.array_equal(trank, np.asarray(jrank)):
        want = jtask.evaluate(params, split, BATCH)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_truth_masks_identical(tasks):
    jtask, ttask, _, _ = tasks
    V = ttask.fact_graph.num_nodes
    triples = np.concatenate([jtask.eval_triples("test"),
                              jtask.eval_triples("valid")])
    b = torch.from_numpy(triples.astype(np.int64))
    jel = jtask.graph.edge_list
    for t_fn, j_fn, anchor in ((tail_truth_mask, j_tail_mask, 0),
                               (head_truth_mask, j_head_mask, 1)):
        got = t_fn(ttask.graph.edge_list, b[:, anchor], b[:, 2], V).numpy()
        want = np.asarray(j_fn(jel, jnp.asarray(triples[:, anchor]),
                               jnp.asarray(triples[:, 2]), V))
        np.testing.assert_array_equal(got, want)
        # every query's own answer is a known true triple
        other = triples[:, 1 - anchor]
        assert got[np.arange(len(triples)), other].all()


def test_fast_test_subset_matches(tasks):
    """fast_test keeps the same seeded subset in both packages: the port's
    metrics equal the JAX metric code on the subset's rankings, and those
    rankings match the JAX package's under the tie rule above."""
    jtask, ttask, params, model = tasks
    triples = jtask.eval_triples("test")
    subset = triples[np.random.default_rng(1024).permutation(
        len(triples))[:20]]
    trank = _assert_rankings_match(tasks, subset, "fast_test")
    _, cand = jtask._run_eval(jtask._eval_fn, params, subset, BATCH)
    want = jtask._metrics_from_rankings(trank.astype(np.int32), cand, None)
    got = ttask.evaluate(model, "test", BATCH, fast_test=20)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_port_never_imports_jax():
    code = ("import ultra_torchdrug_tpu_torch, sys; "
            "import ultra_torchdrug_tpu_torch.tasks.task, "
            "ultra_torchdrug_tpu_torch.utils.convert; "
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'ultra_torchdrug_tpu.')) or m == 'ultra_torchdrug_tpu' "
            "for m in sys.modules), sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_entry_point_defaults_to_cuda(tasks):
    """Without a device the task runs on the card; with no card it raises
    instead of falling back to the CPU."""
    _, ttask, _, _ = tasks
    if torch.cuda.is_available():
        assert TTask(ttask.dataset, ttask.model_cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TTask(ttask.dataset, ttask.model_cfg)

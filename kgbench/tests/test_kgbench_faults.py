"""A run with its timed path broken underneath comes out not correct: the
cell's driver at a tiny size on the CPU, past the harness's look for a
chip, with the program patched."""

import pytest
import torch

from kgbench.drivers import rank, train
from kgbench.lib import check
from kgbench.tests.conftest import cpu_run, tiny_cell


def correct(out, cell):
    return check.judge(out["numbers"], cell.limits)[0]


def test_sound_eval_run_is_correct(one_thread):
    cell = tiny_cell("ultra.eval.fb237-skew")
    assert correct(rank.run(cell, cpu_run(21)), cell)


def test_altered_answer_fails(one_thread, monkeypatch):
    from ultra_torchdrug_tpu_torch.tasks import task

    ranking = task.filtered_ranking
    monkeypatch.setattr(task, "filtered_ranking",
                        lambda *a, **k: ranking(*a, **k) + (a[1] % 2 == 0))
    cell = tiny_cell("ultra.eval.fb237-skew")
    assert not correct(rank.run(cell, cpu_run(21)), cell)


def test_half_of_the_requests_left_out_fails(one_thread, monkeypatch):
    from ultra_torchdrug_tpu_torch.tasks.task import TransductiveKGTask

    scores = TransductiveKGTask._eval_scores

    def half(self, model, fact, rel, h, t, r, *a, **k):
        n = h.shape[0] // 2
        out = scores(self, model, fact, rel, h[:n], t[:n], r[:n], *a, **k)
        return tuple(torch.cat([s, s]) for s in out)

    monkeypatch.setattr(TransductiveKGTask, "_eval_scores", half)
    cell = tiny_cell("ultra.eval.fb237-skew")
    assert not correct(rank.run(cell, cpu_run(21)), cell)


@pytest.mark.parametrize("name", ["ultra.train.fb237-skew",
                                  "nbfnet.train.fb237-skew"])
def test_state_left_unchanged_fails(name, one_thread, monkeypatch):
    from ultra_torchdrug_tpu_torch.engine.engine import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self, flat: [
        flat[:0]] * len(self.params))
    cell = tiny_cell(name, steps_per_call=1)
    assert not correct(train.run(cell, cpu_run(23)), cell)


@pytest.mark.parametrize("name", ["ultra.train.fb237-skew",
                                  "nbfnet.train.fb237-skew"])
def test_half_of_the_batch_left_out_fails(name, one_thread, monkeypatch):
    from ultra_torchdrug_tpu_torch.tasks import task

    loss = task._criterion_loss
    monkeypatch.setattr(task, "_criterion_loss", lambda cfg, scores, w=None:
                        loss(cfg, scores[: scores.shape[0] // 2], w))
    cell = tiny_cell(name, steps_per_call=1)
    assert not correct(train.run(cell, cpu_run(23)), cell)

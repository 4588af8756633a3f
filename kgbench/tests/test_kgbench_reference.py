"""The plain reference against the program's CPU path at a tiny size, and
the control's lower precision against the reference: a run's own
comparison on the CPU (the program's kernels run on the card only; on the
CPU the program takes their plain versions)."""

import pytest

from kgbench import control
from kgbench.drivers import rank, train
from kgbench.lib import check
from kgbench.tests.conftest import cpu_run, tiny_cell


@pytest.mark.parametrize("name", ["ultra.eval.fb237-skew"])
def test_eval_scores_ranks_and_candidates_match(name, one_thread):
    cell = tiny_cell(name)
    out = rank.run(cell, cpu_run(2**31 + 3))
    assert out["numbers"]["score_gap"] < 1e-5
    assert out["numbers"]["rank_off"] == 0
    assert out["numbers"]["cand_off"] == 0
    assert check.judge(out["numbers"], cell.limits)[0]


@pytest.mark.parametrize("name", ["ultra.train.fb237-skew",
                                  "nbfnet.train.fb237-skew"])
def test_first_training_step_matches(name, one_thread):
    """The first step's loss and gradient, and the negatives' strictness;
    the later steps' numbers follow the order of the sums (PERF.md)."""
    cell = tiny_cell(name, steps_per_call=1)
    out = train.run(cell, cpu_run(11))
    numbers = out["numbers"]
    assert numbers["loss1_gap"] < 1e-6
    assert numbers["grad_gap_median"] < 1e-5
    assert numbers["neg_bad"] == 0 and numbers["loss_nonfinite"] == 0


@pytest.mark.parametrize("name", ["ultra.eval.fb237-skew",
                                  "ultra.train.fb237-skew",
                                  "nbfnet.train.fb237-skew"])
def test_control_fails_its_cell(name, one_thread):
    """The reference in the precision below fp32 (TF32 operands) in the
    program's place fails the cell's limits; the program passes them."""
    cell = tiny_cell(name)
    readings = (control.eval_readings if "eval" in name
                else control.train_readings)(cell, 5, ["program", "tf32"],
                                             cpu_run(5).device)
    limits = {k: v for k, v in cell.limits.items()
              if k in readings["program"]}
    assert check.judge(readings["program"], limits)[0]
    assert not check.judge(readings["tf32"], limits)[0]

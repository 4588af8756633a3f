"""run.py's own refusals: no result without the chips a cell asks for."""

import json
import subprocess
import sys

import pytest

from kgbench.run import ROOT


def test_no_chip_no_result(cuda_absent):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "kgbench" / "run.py"), "--workload",
         "ultra.eval.fb237-skew", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""


def test_cells_load_with_their_readers():
    from kgbench import run

    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        cell = run.load_cell(w["name"])
        assert "setup_s" in cell.end_to_end and cell.limits
        assert all(hasattr(r, "read") for r, _ in cell.per_layer.values())


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")

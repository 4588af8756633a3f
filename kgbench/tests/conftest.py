"""Fixtures of the benchmark's tests: a cell of BENCHMARK.json cut to a
tiny graph for the CPU, and the ``cuda`` marker (tests that need the card
skip here, decided inside the ``cuda_device`` fixture)."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_GRAPH = dict(entities=300, relations=6, train=3000, valid=200, test=200)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where "
        "there is none")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: none here")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny ops run beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# cells whose files are kept, and which BENCHMARK.json leaves out until
# the port can run them as published (PERF.md, Open questions)
LATER = [
    {"name": "nbfnet.train.fb237-skew", "config": "nbfnet_6x32_pna",
     "traffic": "train.fb237-skew", "chips": 1},
    {"name": "ultra.pretrain3g.dp4", "config": "ultra_6x64",
     "traffic": "pretrain3g", "chips": 4},
]


def tiny_cell(name: str, **traffic):
    """Cell ``name`` of BENCHMARK.json, or of LATER, on a 300-entity
    graph."""
    from kgbench import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] + LATER if w["name"] == name)
    cell = run.cell_from(bench, entry)
    tr = cell.traffic
    for g in [tr["graph"]] if "graph" in tr else tr["graphs"]:
        g.update(TINY_GRAPH)
    tr.update(checked_requests=3, traced_requests=2, traced_steps=2,
              **traffic)
    return cell


def cpu_run(seed: int, seconds: float = 0.3, trace: bool = False):
    from kgbench.lib import runtime

    return runtime.Run(seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter())

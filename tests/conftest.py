"""Test fixtures. Platform setup (8-device CPU) happens in the repo-root
conftest.py, which re-execs pytest with a cleaned environment before JAX
initializes."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1024)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's kernels); skips "
        "with a reason where there is none")

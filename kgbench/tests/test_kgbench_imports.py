"""No module of the benchmark imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference imports nothing of the program either."""

import ast

import pytest

from kgbench.run import KGBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "ultra_torchdrug_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(p for p in KGBENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(KGBENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((KGBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    names = top_level_imports(path)
    assert "ultra_torchdrug_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch"}


def test_the_check_compares_whole_names():
    from kgbench.lib import runtime

    assert "ultra_torchdrug_tpu" in runtime.FORBIDDEN
    assert not {"ultra_torchdrug_tpu_torch"} & set(runtime.FORBIDDEN)

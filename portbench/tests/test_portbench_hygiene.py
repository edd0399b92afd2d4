"""No module of the benchmark imports JAX or the JAX package, and the
yardstick (reference, traffic, counts) imports nothing of the program.
Imports are read with ``ast`` and compared by their top-level name, whole:
``deflow_tpu_torch`` is not ``deflow_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "optax", "deflow_tpu"}
YARDSTICK = ("reference", "traffic", "counts")


def _tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_tops(path)) & NEVER


@pytest.mark.parametrize("part", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(part):
    for path in (BENCH / part).rglob("*.py"):
        assert "deflow_tpu_torch" not in set(_tops(path)), path


def test_whole_names_are_compared():
    assert "deflow_tpu_torch".split(".", 1)[0] not in NEVER

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


HEAD_DIRS = (BENCH / "reference" / "heads", BENCH / "counts" / "heads")


def _mentions_the_head(node) -> bool:
    return any(isinstance(n, ast.Constant) and n.value == "decoder_option"
               for n in ast.walk(node))


def _is_literal(node) -> bool:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return bool(node.elts) and all(_is_literal(e) for e in node.elts)
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def head_comparisons(source: str):
    """The lines on which ``decoder_option`` is compared with a literal."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            literal = [_is_literal(s) for s in sides]
            named = [_mentions_the_head(s) and not lit for s, lit in zip(sides, literal)]
            if any(named) and any(literal):
                yield node.lineno


@pytest.mark.parametrize("path", [p for p in MODULES if not any(d in p.parents for d in HEAD_DIRS)],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_only_the_heads_name_a_head(path):
    """A head is found by its name (``lib/heads.py``), never by a branch."""
    assert not list(head_comparisons(path.read_text())), path


@pytest.mark.parametrize("source, lines", [
    ('if cfg["decoder_option"] == "gru":\n    pass', [1]),
    ('x = cfg.get("decoder_option") in ("gru", "linear")', [1]),
    ('y = 1\nz = "linear" != model["decoder_option"]', [2]),
    ('head = heads.of(cfg)\nname = cfg["decoder_option"]', []),
    ('ok = cfg["decoder_option"] == other', []),
])
def test_the_head_check_sees_a_comparison(source, lines):
    assert list(head_comparisons(source)) == lines

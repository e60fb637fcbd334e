"""Nothing of the benchmark imports JAX or the JAX package, and nothing of
its reference imports the port: the top-level name of every import (the
part before the first dot) compared whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pyspeedy_tpu"}
MODULES = sorted(BENCH.rglob("*.py"))


def imported_tops(path: Path) -> set:
    """Top-level names of the absolute imports of a source, and '..' for a
    relative import that leaves the reference package."""
    tops = set()
    tree = ast.parse(path.read_text())
    depth = len(path.relative_to(BENCH / "reference").parts) - 1 \
        if (BENCH / "reference") in path.parents else None
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                tops.add(node.module.split(".")[0])
            elif depth is not None and node.level > depth + 1:
                tops.add("..")
    return tops


def test_modules_found():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


REFERENCE = [p for p in MODULES if (BENCH / "reference") in p.parents]


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert not tops & (FORBIDDEN | {"pyspeedy_tpu_torch", "speedy_bench",
                                    ".."})


def test_whole_names():
    # The port's name begins with the JAX package's: a prefix test would
    # count it, the whole-name test does not.
    assert "pyspeedy_tpu_torch".split(".")[0] not in FORBIDDEN

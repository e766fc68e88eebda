"""What the benchmark's files import: no top-level ``jax``, ``jaxlib``,
``flax`` or ``ams_tpu`` anywhere (compared whole: ``ams_tpu_torch`` is
the program), and nothing of the program under ``perfbench/reference/``
and ``perfbench/counts/``."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ams_tpu"}
FILES = sorted(PB.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name in ("reference", "counts")],
    ids=lambda p: str(p.relative_to(PB)))
def test_reference_imports_no_program(path):
    names = set(top_level_imports(path))
    assert "ams_tpu_torch" not in names and not names & FORBIDDEN


def test_the_walk_sees_the_program():
    """The walk finds the entries' imports of the program, so the two
    tests above read real import lists."""
    names = set(top_level_imports(PB / "entries" / "round_batched.py"))
    assert "ams_tpu_torch" in names and "torch" in names


def test_whole_name_comparison():
    """The run's check of loaded modules takes ``ams_tpu_torch`` and other
    names that begin alike for what they are."""
    from perfbench.harness import forbidden_modules

    assert forbidden_modules(["ams_tpu_torch.parallel", "jaxish.sub",
                              "torch", "flaxen"]) == []
    assert forbidden_modules(["ams_tpu.models", "jax", "jaxlib.xla",
                              "flax.linen", "ams_tpu_torch"]) == \
        ["ams_tpu", "flax", "jax", "jaxlib"]

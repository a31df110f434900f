"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the program's name begins with the JAX package's),
and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from benchmark.core import harness

BENCH = Path(__file__).resolve().parent.parent
SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(top_names(path)) & set(harness.BANNED)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert harness.PROGRAM not in set(top_names(path)), path


def test_whole_names_are_compared():
    assert harness.banned_modules(["det3d_tpu_torch.ops.sparse", "torch",
                                   "jaxtyping", "flaxen.x"]) == []
    assert harness.banned_modules(["det3d_tpu.ops", "jax.numpy",
                                   "optax"]) == ["det3d_tpu", "jax",
                                                 "optax"]

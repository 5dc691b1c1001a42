"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package, and the reference imports nothing of the program either: the
top-level name of every import (the part before the first dot),
compared whole."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.main import BANNED
from benchmark.tests.helpers import BENCH, REPO

RUNS = [p for p in BENCH.rglob("*.py")
        if "tests" not in p.relative_to(BENCH).parts
        and p.name != "conftest.py"]


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", RUNS, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_anywhere_the_benchmark_runs(path):
    assert not top_level_imports(path) & set(BANNED)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        found = top_level_imports(path)
        assert "centermask2_tpu_torch" not in found, path
        assert "benchmark" not in found, path
        assert not found & set(BANNED), path


def test_names_are_compared_whole():
    """The port's name begins with the JAX package's: it is not banned."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness.main as m, benchmark.harness.spec as s, "
            "benchmark.reference.model, centermask2_tpu_torch.models.meta; "
            "s.Spec(%r).runner('serve'); "
            "print(m.banned_modules())" % (str(REPO), str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert out.strip() == "[]"

"""No module of the benchmark imports JAX, Flax or the JAX package (top
-level names compared whole; the port's own name begins with the JAX
package's), the reference imports nothing of the program, and no file
names the JAX package's old benchmark files."""

import ast

import pytest

from portbench.core.harness import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "landiff_tpu"}
PROGRAM = "landiff_tpu_torch"
FILES = sorted(BENCH.rglob("*.py"))


def top_names(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_imports(path):
    names = set(top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert PROGRAM not in names


def test_the_guard_compares_whole_names():
    from portbench.core import harness
    import sys
    sys.modules["landiff_tpu_torch_fake"] = object()
    try:
        assert "landiff_tpu_torch_fake" not in harness.forbidden_modules()
    finally:
        del sys.modules["landiff_tpu_torch_fake"]


def test_no_file_names_the_old_benchmark():
    banned = ["bench" + "marks/", "bench" + ".py", "BENCH" + "_"]
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".txt"):
            text = path.read_text()
            assert not any(b in text for b in banned), path

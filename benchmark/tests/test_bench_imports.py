"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under `benchmark/`, and nothing of the program in its reference.
A module is named by its top-level name, the part before the first dot,
compared whole: `gcdlss_tpu_torch` is not `gcdlss_tpu`."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "optax", "gcdlss_tpu"}
PROGRAM = {"gcdlss_tpu_torch"}


def imported(path: Path) -> set:
    """Top-level names of every module a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert not names & (PROGRAM | JAX)
    # and nothing of the benchmark outside the reference (relative imports
    # stay inside it)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, f"{path.name} reaches out of the reference"


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import gcdlss_tpu_torch.train\nfrom jax.numpy import zeros\n")
    assert imported(f) == {"gcdlss_tpu_torch", "jax"}

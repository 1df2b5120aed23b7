"""Import hygiene of the benchmark: no file it runs imports JAX, the JAX
package, the repo's JAX-era benchmarks or chip_smoke (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
FILES = sorted(p for p in HOME.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax_imports(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HOME / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"repro_torch", "h100bench"}), names


def test_forbidden_is_whole_names():
    from h100bench import harness
    assert "repro" in harness.FORBIDDEN
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN

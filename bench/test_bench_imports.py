"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names
compared whole (``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

from bench.harness import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parent


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def relative_imports(path: Path) -> set:
    """Modules of the benchmark a file imports relatively (``from ..x``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {(n.level, n.module or "") for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level > 0}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names and "bench" not in names, names
    # relative imports stay inside reference/
    assert all(level == 1 for level, _ in relative_imports(path)), path
    assert names <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_forbidden_modules_compares_whole_names():
    assert forbidden_modules(["repro_torch", "repro_torch.models",
                              "jaxtyping", "reproducible"]) == []
    assert forbidden_modules(["jax.numpy", "repro.core", "flax",
                              "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]

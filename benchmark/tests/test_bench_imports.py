"""What the benchmark may import: no module under benchmark/ names jax,
jaxlib, flax or the JAX package, and the reference names nothing of the
program either. Each import is compared by its top-level name, the part
before the first dot, whole: the port's name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "go_curdleproofs_tpu"}
PROGRAM = "go_curdleproofs_tpu_torch"


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(_top_level_imports(path)) & NEVER


@pytest.mark.parametrize(
    "path", [p for p in MODULES if "reference" in p.relative_to(BENCH).parts],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_top_level_imports(path))
    assert "torch" not in set(_top_level_imports(path))


def test_the_program_is_imported_by_its_whole_name():
    """The check is by whole name: the program's own name passes it."""
    assert PROGRAM.split(".")[0] not in NEVER
    assert PROGRAM.startswith("go_curdleproofs_tpu")

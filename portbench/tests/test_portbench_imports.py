"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared
whole (``pinn_torch`` is not ``pinn``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "pinn", "experiments", "datagen"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not _top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "pinn_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "portbench"}


def test_names_are_compared_whole():
    assert "pinn_torch".split(".")[0] not in BANNED
    assert "pinn.models".split(".")[0] in BANNED


def test_reference_uses_only_the_reference():
    for path in (BENCH / "reference").rglob("*.py"):
        src = path.read_text()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), path

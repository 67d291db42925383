"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference and the data recipes import nothing of the port."""

import ast
from pathlib import Path

import pytest

from port_bench import harness

BENCH = Path(harness.HERE)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    list((BENCH / "reference").rglob("*.py"))
    + list((BENCH / "recipes").rglob("*.py"))),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "convex_dim_red_tpu_torch" not in top_level_imports(path)


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        {"convex_dim_red_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert harness.forbidden_modules(
        {"convex_dim_red_tpu.ops": 1, "jax.numpy": 1}) == [
            "convex_dim_red_tpu.ops", "jax.numpy"]


def test_top_level_imports_sees_every_form(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("import jax.numpy as jnp\nfrom flax import linen\n"
                    "from . import x\nimport importlib\n"
                    "importlib.import_module('convex_dim_red_tpu.ops')\n")
    assert top_level_imports(path) == {"jax", "flax", "importlib",
                                       "convex_dim_red_tpu"}

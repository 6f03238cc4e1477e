"""Import hygiene of the benchmark, by each module's top-level import
name compared whole: nothing imports JAX or the JAX package, and the
yardstick (reference, judges, counts, traffic, weights, readers) imports
nothing of the port either."""

import ast
import os

import pytest

from portbench import harness

FILES = sorted(os.path.relpath(os.path.join(d, f), harness.HERE)
               for d, _, fs in os.walk(harness.HERE) for f in fs if f.endswith(".py"))
# What may import the port: the runners (the system under test), the entry
# points that call them, and the tests that hold the reference against it.
DRIVE_THE_PORT = ("runners/", "run.py", "calibrate.py", "tests/")


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(os.path.join(harness.HERE, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES)
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "onepose_tpu"}


@pytest.mark.parametrize("path", [f for f in FILES if not f.startswith(DRIVE_THE_PORT)])
def test_yardstick_imports_nothing_of_the_port(path):
    assert "onepose_tpu_torch" not in top_level_imports(path)


def test_forbidden_is_compared_whole():
    assert "onepose_tpu" in harness.FORBIDDEN and "onepose_tpu_torch" not in harness.FORBIDDEN
    found = harness.forbidden_modules()
    assert "onepose_tpu_torch" not in found

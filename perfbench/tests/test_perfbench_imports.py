"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: the program's name begins with the JAX package's."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "ceph_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ceph_tpu_torch" not in set(_imports(path))
    assert "torch" not in set(_imports(path))

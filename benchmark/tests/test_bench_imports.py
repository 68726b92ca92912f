"""Nothing under benchmark/ imports JAX, flax, optax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hrviton_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    found = {n for n in _imports(path) if n == "hrviton_tpu_torch" or n in FORBIDDEN}
    assert not found, f"{path} imports {found}"


def test_names_compared_whole():
    # the port's top-level name begins with the JAX package's and is allowed
    assert "hrviton_tpu_torch" not in FORBIDDEN
    assert "hrviton_tpu_torch".split(".")[0] != "hrviton_tpu"

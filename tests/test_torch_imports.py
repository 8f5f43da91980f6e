"""The port imports neither JAX nor the reference package.

Every module of ``src/repro_torch/``, the port's benchmarks
(``benchmarks/port_*.py``) and ``chip_smoke.py`` is parsed with
``ast``; an import of ``jax``, ``jaxlib`` or ``repro`` anywhere in it (at
top level or inside a function) fails. Only the tests import both.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    [p.relative_to(ROOT).as_posix()
     for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
               *(ROOT / "benchmarks").glob("port_*.py")]]
    + ["chip_smoke.py"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_never_imports_jax_or_reference(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_the_port_is_all_there():
    assert "chip_smoke.py" in PORT_FILES
    assert len(PORT_FILES) >= 20

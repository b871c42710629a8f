"""The port stands alone: no module of it, and not chip_smoke.py, imports
JAX, its libraries or anything of the JAX package (checked on the sources,
so a lazy import inside a function counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "quantized_spectrum_cartography_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "quantized_spectrum_cartography_tpu", "tests")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_found():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.name} imports {bad}"

"""The PyTorch port stands alone: a static scan of its sources (and of
chip_smoke.py) finds no import of JAX, optax, flax or the JAX package.

A ``sys.modules`` check cannot show this here: the test environment
imports JAX at start-up (tests/conftest.py).
"""

import ast
import importlib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "hashmodnffbanks_idr_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^(jax|jaxlib|optax|flax)(\.|$)|^hashmodnffbanks_idr_tpu(\.|$)")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if FORBIDDEN.search(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_pattern_spares_the_port():
    assert FORBIDDEN.search("hashmodnffbanks_idr_tpu.ops.fused_mlp")
    assert FORBIDDEN.search("jax.numpy") and FORBIDDEN.search("optax")
    assert not FORBIDDEN.search("hashmodnffbanks_idr_tpu_torch.ops.fused_mlp")


def test_every_module_imports_without_cuda():
    """Importing builds nothing and needs neither triton nor the kernel
    library (both are reached only inside the launching function)."""
    for path in sorted(PORT.rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))

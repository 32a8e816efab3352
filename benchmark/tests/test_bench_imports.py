"""Nothing under ``benchmark/`` imports JAX or the JAX package, and nothing
under ``benchmark/reference/`` imports the port: top-level module names
compared whole (the port's name begins with the JAX package's)."""

import ast

import pytest

from bench_helpers import BENCH

FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "hashmodnffbanks_idr_tpu"}
PORT = "hashmodnffbanks_idr_tpu_torch"
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_does_not_import_the_port(path):
    assert PORT not in top_level_imports(path)


def test_scan_compares_names_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import hashmodnffbanks_idr_tpu_torch.ops\nfrom jax import numpy\n")
    assert top_level_imports(f) == {PORT, "jax"}


def test_run_refuses_loaded_jax_names(monkeypatch):
    import sys
    import types

    import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hashmodnffbanks_idr_tpu.models", types.ModuleType("x"))
    assert run.forbidden_modules() == ["hashmodnffbanks_idr_tpu"]

"""The port stands alone: no JAX and nothing of the JAX package.

A subprocess that blocks ``jax`` and ``repro`` imports every module of
``repro_torch`` and ``chip_smoke.py``; an AST scan finds no such import
in their sources.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules if sys.modules[m] is not None)
print(len(names))
"""


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    for mod in _imported(ast.parse(path.read_text())):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"

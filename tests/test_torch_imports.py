"""The port stands alone: every ``pilosa_tpu_torch`` module imports with
``jax`` and ``pilosa_tpu`` blocked, and no module (nor ``chip_smoke.py``)
names either in an import statement."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import pilosa_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(pilosa_tpu_torch.__file__)
MODULES = sorted(
    ["pilosa_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="pilosa_tpu_torch.")])
SOURCES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(PKG_DIR)
    if "_build" not in os.path.relpath(root, PKG_DIR).split(os.sep)
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]

_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "pilosa_tpu"):
            raise ImportError(f"blocked import: {name}")
        return None
sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    __import__(name)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu")
               for m in sys.modules)
print("OK", len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _BLOCKER, *MODULES],
                         capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["OK", str(len(MODULES))]


def _imported_names(path: str) -> list[str]:
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_reference_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "pilosa_tpu"), (path, name)


def test_module_list_is_complete():
    assert {"pilosa_tpu_torch.executor", "pilosa_tpu_torch.carry",
            "pilosa_tpu_torch.device", "pilosa_tpu_torch.ops.cuda_kernels",
            "pilosa_tpu_torch.ops.build", "pilosa_tpu_torch.parallel.mesh",
            "pilosa_tpu_torch.parallel.residency",
            "pilosa_tpu_torch.bench"} <= set(MODULES)

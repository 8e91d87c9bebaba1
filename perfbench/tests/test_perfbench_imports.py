"""What the benchmark loads: never JAX or the JAX package (compared by
whole top-level names), the reference nothing of the program, the
clients neither torch nor the program; and no result without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "pilosa_tpu", "benchmarks"}
# The plain reference and everything it and the clients import,
# the call and law modules with them.
PLAIN = ("reference.py", "datagen.py", "traffic.py", "stats.py", "peaks.py",
         "client.py") + tuple(
    os.path.join(d, f) for d in ("calls", "laws")
    for f in sorted(os.listdir(os.path.join(HERE, d))) if f.endswith(".py"))


def _modules():
    for dirpath, _dirs, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_names_jax_or_the_jax_package(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_the_reference_imports_nothing_of_the_program(name):
    names = set(_top_names(os.path.join(HERE, name)))
    assert "pilosa_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_clients_load_neither_torch_nor_the_program():
    code = ("import sys; sys.argv = ['x']; import runpy; "
            "runpy.run_path('perfbench/client.py', run_name='client'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'pilosa_tpu_torch', 'pilosa_tpu', 'jax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result; so it
    does from a directory holding only BENCHMARK.json and perfbench/."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    cell = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))[
        "workloads"][0]["name"]
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for cwd in (ROOT, str(tmp_path)):
        r = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             cell, "--seed", "3", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert r.returncode != 0
        assert r.stdout.strip() == ""

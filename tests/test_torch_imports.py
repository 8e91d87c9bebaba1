"""The port stands alone: every ``pilosa_tpu_torch`` module imports with
``jax``, ``pilosa_tpu`` and ``google.protobuf`` blocked (the card machine
has no protobuf library), and no module (nor ``chip_smoke.py``) names
any of them in an import statement."""

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
def blocked(name):
    return (name.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu")
            or name == "google.protobuf"
            or name.startswith("google.protobuf."))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import: {name}")
        return None
sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    __import__(name)
assert not any(blocked(m) for m in sys.modules)
print("OK", len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax():
    # Also without google.protobuf: the blocker refuses both.
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
        assert not name.startswith("google.protobuf"), (path, name)


def test_module_list_is_complete():
    assert {"pilosa_tpu_torch.executor", "pilosa_tpu_torch.carry",
            "pilosa_tpu_torch.device", "pilosa_tpu_torch.ops.cuda_kernels",
            "pilosa_tpu_torch.ops.build", "pilosa_tpu_torch.parallel.mesh",
            "pilosa_tpu_torch.parallel.residency",
            "pilosa_tpu_torch.bench", "pilosa_tpu_torch.proto",
            "pilosa_tpu_torch.proto.internal",
            "pilosa_tpu_torch.proto.rawimport",
            "pilosa_tpu_torch.utils.timequantum",
            "pilosa_tpu_torch.utils.streams",
            "pilosa_tpu_torch.utils.logger",
            "pilosa_tpu_torch.storage.attrs",
            "pilosa_tpu_torch.storage.bsi",
            "pilosa_tpu_torch.models.holder",
            "pilosa_tpu_torch.models.index",
            "pilosa_tpu_torch.models.frame",
            "pilosa_tpu_torch.server.codec",
            "pilosa_tpu_torch.server.handler",
            "pilosa_tpu_torch.server.httpd",
            "pilosa_tpu_torch.server.server",
            "pilosa_tpu_torch.cli", "pilosa_tpu_torch.cli.__main__",
            "pilosa_tpu_torch.cli.commands",
            "pilosa_tpu_torch.storage.wal",
            "pilosa_tpu_torch.storage.native_ext",
            "pilosa_tpu_torch.plan", "pilosa_tpu_torch.plan.record",
            "pilosa_tpu_torch.plan.planner",
            "pilosa_tpu_torch.cluster",
            "pilosa_tpu_torch.cluster.generations"} | set(
                LIFECYCLE) | set(CLUSTER) | set(INTEGRITY) | set(
                    OPERATOR) | set(SURFACE) | set(BACKUP) | set(
                        POD) <= set(MODULES)


# The query lifecycle's modules, each at the path of its JAX
# counterpart (utils.config holds only the lifecycle's part).
LIFECYCLE = ("pilosa_tpu_torch.utils.stats", "pilosa_tpu_torch.obs",
             "pilosa_tpu_torch.obs.metrics",
             "pilosa_tpu_torch.obs.accounting",
             "pilosa_tpu_torch.obs.trace", "pilosa_tpu_torch.sched",
             "pilosa_tpu_torch.sched.context",
             "pilosa_tpu_torch.sched.registry",
             "pilosa_tpu_torch.utils.config",
             "pilosa_tpu_torch.sched.tenants",
             "pilosa_tpu_torch.sched.admission",
             "pilosa_tpu_torch.plan.store",
             "pilosa_tpu_torch.parallel.costmodel",
             "pilosa_tpu_torch.sched.warmup")


@pytest.mark.parametrize("module", LIFECYCLE)
def test_lifecycle_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert (os.path.exists(os.path.join(REPO, rel + ".py"))
            or os.path.exists(os.path.join(REPO, rel, "__init__.py")))


# The static cluster's modules, each at the path of its JAX counterpart.
CLUSTER = ("pilosa_tpu_torch.fault", "pilosa_tpu_torch.fault.failpoints",
           "pilosa_tpu_torch.fault.health", "pilosa_tpu_torch.fault.breaker",
           "pilosa_tpu_torch.cluster.topology",
           "pilosa_tpu_torch.cluster.broadcast",
           "pilosa_tpu_torch.cluster.client",
           "pilosa_tpu_torch.storage.iterators",
           "pilosa_tpu_torch.server.syncer")


@pytest.mark.parametrize("module", CLUSTER)
def test_cluster_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert (os.path.exists(os.path.join(REPO, rel + ".py"))
            or os.path.exists(os.path.join(REPO, rel, "__init__.py")))


# Storage integrity, disk-full degradation and tail sampling, each at
# the path of its JAX counterpart.
INTEGRITY = ("pilosa_tpu_torch.storage.integrity",
             "pilosa_tpu_torch.storage.scrub",
             "pilosa_tpu_torch.server.repair",
             "pilosa_tpu_torch.fault.diskfull",
             "pilosa_tpu_torch.obs.sampler",
             "pilosa_tpu_torch.obs.diskring")


@pytest.mark.parametrize("module", INTEGRITY)
def test_integrity_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert os.path.exists(os.path.join(REPO, rel + ".py"))


# Gossip membership, readiness and the configuration, each at the path of
# its JAX counterpart.
OPERATOR = ("pilosa_tpu_torch.cluster.gossip", "pilosa_tpu_torch.obs.slo",
            "pilosa_tpu_torch.utils.config")


@pytest.mark.parametrize("module", OPERATOR)
def test_operator_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert os.path.exists(os.path.join(REPO, rel + ".py"))


# The operator surface (workload capture and replay, the profiler, the
# flight recorder, the watchdog, the metric history, the sentinel, statsd,
# ``top`` and the web console), each at the path of its JAX counterpart.
SURFACE = ("pilosa_tpu_torch.obs.capture", "pilosa_tpu_torch.obs.replay",
           "pilosa_tpu_torch.obs.profile", "pilosa_tpu_torch.obs.history",
           "pilosa_tpu_torch.obs.blackbox", "pilosa_tpu_torch.obs.watchdog",
           "pilosa_tpu_torch.obs.sentinel",
           "pilosa_tpu_torch.utils.profiling",
           "pilosa_tpu_torch.utils.statsd", "pilosa_tpu_torch.cli.top",
           "pilosa_tpu_torch.server.webui")


@pytest.mark.parametrize("module", SURFACE)
def test_surface_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert os.path.exists(os.path.join(REPO, rel + ".py"))


# Disaster recovery (the archive, the WAL archiver, the journaled
# coordinator, restore, verify and retention), each at the path of its
# JAX counterpart.
BACKUP = ("pilosa_tpu_torch.backup", "pilosa_tpu_torch.backup.archive",
          "pilosa_tpu_torch.backup.walarchive",
          "pilosa_tpu_torch.backup.coordinator",
          "pilosa_tpu_torch.backup.restore",
          "pilosa_tpu_torch.backup.verify",
          "pilosa_tpu_torch.backup.retention")


@pytest.mark.parametrize("module", BACKUP)
def test_backup_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert (os.path.exists(os.path.join(REPO, rel + ".py"))
            or os.path.exists(os.path.join(REPO, rel, "__init__.py")))


# The multi-host pod (the torch.distributed layer and the work-item
# broadcast), each at the path of its JAX counterpart; both import with
# jax and pilosa_tpu blocked (test_every_module_imports_without_jax).
POD = ("pilosa_tpu_torch.parallel.multihost",
       "pilosa_tpu_torch.parallel.pod")


@pytest.mark.parametrize("module", POD)
def test_pod_module_mirrors_the_jax_path(module):
    rel = module.replace("pilosa_tpu_torch", "pilosa_tpu", 1).replace(
        ".", os.sep)
    assert os.path.exists(os.path.join(REPO, rel + ".py"))
    assert module in MODULES

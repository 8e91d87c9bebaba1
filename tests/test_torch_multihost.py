"""parallel.multihost of the port against the JAX package's.

The same seeded numpy shards go through the JAX ``multihost`` entry
points at ``process_count() == 1`` (as tests/test_multihost.py runs
them) and through the port's inside a torch.distributed gloo group of
one rank in this process; and through the port's in two gloo ranks in
subprocesses, each feeding its half of the slices, whose reduced totals
must equal the JAX one-process result over the whole. Unequal shard
dims raise ``ValueError`` with the JAX text in both ranks, neither
parked in the reduce. Tolerance: exact (equal integers).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu.parallel import multihost as jmulti

from pilosa_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("PILOSA_TPU_DIST_COORDINATOR", "PILOSA_TPU_DIST_NUM_PROCS",
            "PILOSA_TPU_DIST_PROC_ID", "PILOSA_TPU_DIST_BACKEND")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shards(seed: int, n_leaves: int, s: int, r: int, w: int):
    rng = np.random.default_rng(seed)
    leaves = rng.integers(0, 2**32, size=(n_leaves, s, w), dtype=np.uint32)
    rows = rng.integers(0, 2**32, size=(s, r, w), dtype=np.uint32)
    # Sparse rows too, so the threshold and Tanimoto masks bite.
    rows[:, ::2] &= rng.integers(0, 2**32, size=(s, (r + 1) // 2, w),
                                 dtype=np.uint32)
    return leaves, rows


EXPRS = (("leaf", 0),
         ("and", ("leaf", 0), ("leaf", 1)),
         ("or", ("leaf", 1), ("leaf", 2)),
         ("andnot", ("xor", ("leaf", 0), ("leaf", 2)), ("leaf", 1)))
FILTERS = ((1, 0), (3, 0), (130, 0), (1, 40), (1, 75))


@pytest.fixture
def one_rank_group(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PILOSA_TPU_DIST_COORDINATOR",
                       f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("PILOSA_TPU_DIST_NUM_PROCS", "1")
    monkeypatch.setenv("PILOSA_TPU_DIST_PROC_ID", "0")
    assert multihost.initialize_from_env("cpu") is True
    assert multihost.initialize_from_env("cpu") is True  # idempotent
    assert multihost.backend() == "gloo"
    yield
    multihost.shutdown()
    assert multihost.backend() is None


def test_initialize_without_env_is_noop(monkeypatch):
    monkeypatch.delenv("PILOSA_TPU_DIST_COORDINATOR", raising=False)
    assert multihost.initialize_from_env("cpu") is False
    assert jmulti.initialize_from_env() is False
    assert multihost.process_count() == 1


@pytest.mark.parametrize("n", [16, 8, 1])
def test_process_slice_range_whole_axis(n):
    assert multihost.process_slice_range(n) == jmulti.process_slice_range(n)
    assert multihost.process_slice_range(n) == (0, n)


def test_backend_key_is_checked(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_DIST_COORDINATOR",
                       f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("PILOSA_TPU_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError, match="PILOSA_TPU_DIST_BACKEND"):
        multihost.initialize_from_env("cuda:0")
    assert multihost.backend() is None


def test_counts_equal_jax_in_a_one_rank_group(one_rank_group):
    mesh = jmulti.pod_mesh()
    s = mesh.shape[jmesh.AXIS_SLICES] * 2
    leaves, _ = _shards(0, 3, s, 1, 256)
    for expr in EXPRS:
        assert (multihost.count_expr("cpu", expr, leaves)
                == jmulti.count_expr(mesh, expr, leaves)), expr
    got = multihost.count_exprs("cpu", EXPRS, leaves)
    assert got == jmulti.count_exprs(mesh, EXPRS, leaves)
    assert multihost.stats()["reduces"] >= len(EXPRS) + 1


@pytest.mark.parametrize("threshold,tanimoto", FILTERS)
def test_topn_equal_jax_in_a_one_rank_group(one_rank_group, threshold,
                                            tanimoto):
    mesh = jmulti.pod_mesh()
    s = mesh.shape[jmesh.AXIS_SLICES] * 2
    leaves, rows = _shards(1, 1, s, 5, 128)
    got = multihost.topn_exact("cpu", ("leaf", 0), rows, leaves,
                               threshold=threshold, tanimoto=tanimoto)
    assert got == jmulti.topn_exact(mesh, ("leaf", 0), rows, leaves,
                                    threshold=threshold, tanimoto=tanimoto)


_RANK = r"""
import json, os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
from pilosa_tpu_torch.parallel import multihost
leaves = np.load(%(leaves)r)
rows = np.load(%(rows)r)
assert multihost.initialize_from_env("cpu") is True
assert multihost.process_count() == 2
lo, hi = multihost.process_slice_range(leaves.shape[1])
if %(skew)r and multihost.process_index() == 1:
    hi -= 1  # a shard one slice short: the dims check must catch it
out = {}
try:
    out["counts"] = multihost.count_exprs("cpu", %(exprs)r,
                                          leaves[:, lo:hi])
    out["topn"] = [multihost.topn_exact("cpu", ("leaf", 0), rows[lo:hi],
                                        leaves[:1, lo:hi], threshold=t,
                                        tanimoto=k) for t, k in %(filters)r]
except ValueError as e:
    out["error"] = str(e)
multihost.shutdown()
print("RANK " + json.dumps(out), flush=True)
"""


def _two_ranks(tmp_path, skew: bool) -> list[dict]:
    leaves, rows = _shards(2, 3, 16, 6, 64)
    np.save(tmp_path / "leaves.npy", leaves)
    np.save(tmp_path / "rows.npy", rows)
    code = _RANK % {"repo": REPO, "leaves": str(tmp_path / "leaves.npy"),
                    "rows": str(tmp_path / "rows.npy"), "skew": skew,
                    "exprs": EXPRS, "filters": FILTERS}
    port = _free_port()
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
            env.update({"PILOSA_TPU_DIST_COORDINATOR": f"127.0.0.1:{port}",
                        "PILOSA_TPU_DIST_NUM_PROCS": "2",
                        "PILOSA_TPU_DIST_PROC_ID": str(rank),
                        "PILOSA_TPU_POD_TIMEOUT": "30",
                        "OMP_NUM_THREADS": "1"})
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = []
        t_end = time.monotonic() + 100  # the test's budget for both ranks
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, t_end - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
            outs.append(json.loads(line[0][5:]))
        return outs, leaves, rows
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_two_gloo_ranks_equal_jax_over_the_whole(tmp_path):
    outs, leaves, rows = _two_ranks(tmp_path, skew=False)
    mesh = jmulti.pod_mesh()
    want_counts = jmulti.count_exprs(mesh, EXPRS, leaves)
    want_topn = [jmulti.topn_exact(mesh, ("leaf", 0), rows, leaves[:1],
                                   threshold=t, tanimoto=k)
                 for t, k in FILTERS]
    for out in outs:
        assert out["counts"] == want_counts
        assert out["topn"] == want_topn


def test_unequal_shards_raise_in_both_ranks(tmp_path):
    outs, _, _ = _two_ranks(tmp_path, skew=True)
    for out in outs:
        assert "counts" not in out
        assert out["error"].startswith(
            "pod shard shapes differ across processes:"), out
        assert "every process must pass the same local slice/row counts" \
            in out["error"]

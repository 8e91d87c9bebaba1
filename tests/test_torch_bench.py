"""The port's op count and its benchmark of record against the JAX
package's, on the same seeded numpy input.

The port's ``ops.kernels.op_count`` and ``cuda_kernels.op_count_rows``
(their plain versions on the CPU) are held against the Pallas kernel
``op_count_rows_pallas`` in interpret mode (as tests/test_ops.py runs it)
and against the JAX ``ops.kernels.op_count``; counts are integers, so
every comparison is exact. ``python -m pilosa_tpu_torch.bench --device
cpu`` is run at a small width and its counts held to the JAX package's
host ``popcnt_and``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as root_bench
from pilosa_tpu.ops import kernels as jax_kernels
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.storage import native as jax_native

from pilosa_tpu_torch import bench
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import kernels as tk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ["and", "or", "xor", "andnot"]

# name → (shape, every word with bit 31 set)
SHAPES = {
    "1d": ((3000,), False),
    "rows": ((5, 2048), False),
    "w_not_128": ((3, 1000), False),
    "fold_1x8x128k": ((1, 8 * 128 * 3), False),
    "bit31": ((4, 515), True),
}


def _t(words: np.ndarray) -> torch.Tensor:
    """u32 numpy words → the port's int32 view on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _operands(shape, bit31, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    if bit31:
        a |= np.uint32(1 << 31)
        b |= np.uint32(1 << 31)
    return a, b


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("op", OPS)
def test_op_count_matches_jax(op, shape_name):
    shape, bit31 = SHAPES[shape_name]
    a, b = _operands(shape, bit31)
    want = np.asarray(pk.op_count_rows_pallas(op, a, b, interpret=True))
    assert np.array_equal(want, np.asarray(jax_kernels.op_count(op, a, b)))
    for got in (tk.op_count(op, _t(a), _t(b)),
                ck.op_count_rows(op, _t(a), _t(b)),
                ck.op_count_rows_torch(op, _t(a), _t(b))):
        assert got.dtype == torch.int32
        assert tuple(got.shape) == want.shape
        assert got.numpy().tolist() == want.tolist()


def test_all_ones_words_count_every_bit():
    a = np.full((2, 96), 0xFFFFFFFF, dtype=np.uint32)
    for op, want in (("and", 96 * 32), ("or", 96 * 32), ("xor", 0),
                     ("andnot", 0)):
        assert tk.op_count(op, _t(a), _t(a)).tolist() == [want, want]


def test_cpu_calls_launch_nothing():
    a, b = _operands((3, 256), True)
    before = dict(ck.LAUNCHES)
    tk.op_count("and", _t(a), _t(b))
    ck.op_count_rows("xor", _t(a), _t(b))
    assert ck.LAUNCHES == before
    assert ck.LAUNCHES["op_count_rows"] == before["op_count_rows"]


@pytest.mark.parametrize("case", ["uint32", "shapes", "3d", "op",
                                  "too_wide", "non_contiguous"])
def test_op_count_rows_rejects(case):
    a = torch.zeros((2, 8), dtype=torch.int32)
    args = {
        "uint32": ("and", a.to(torch.int64), a.to(torch.int64)),
        "shapes": ("and", a, torch.zeros((2, 4), dtype=torch.int32)),
        "3d": ("and", a.view(2, 2, 4), a.view(2, 2, 4)),
        "op": ("nand", a, a),
        # Never touched: the width check comes before any read.
        "too_wide": ("and", torch.empty((1, 1 << 26), dtype=torch.int32),
                     torch.empty((1, 1 << 26), dtype=torch.int32)),
        "non_contiguous": ("and", a.t(), a.t()),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        ck.op_count_rows(*args)


@pytest.mark.parametrize("bits,k", [(4096, 3), (65536, 2)])
def test_bench_operands_match_root_bench(bits, k):
    a, b = bench.rows(bits, k)
    ra, rb = root_bench._rows(bits, k)
    assert a.dtype == ra.dtype and a.shape == ra.shape
    assert a.tobytes() == ra.tobytes() and b.tobytes() == rb.tobytes()


def test_bench_knobs_match_root_bench(monkeypatch):
    assert bench.params() == root_bench._params()
    for key, val in (("PILOSA_BENCH_BITS", "131072"),
                     ("PILOSA_BENCH_ROWS", "3"),
                     ("PILOSA_BENCH_ITERS", "5"),
                     ("PILOSA_BENCH_TRIALS", "1")):
        monkeypatch.setenv(key, val)
    assert bench.params() == root_bench._params() == (131072, 3, 5, 1)
    monkeypatch.setenv("PILOSA_BENCH_BITS", str(1 << 31))
    with pytest.raises(SystemExit):
        bench.params()


def test_bench_cpu_line():
    bits, k = 65536, 4
    env = dict(os.environ, PILOSA_BENCH_BITS=str(bits),
               PILOSA_BENCH_ROWS=str(k), PILOSA_BENCH_ITERS="2",
               PILOSA_BENCH_TRIALS="1", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.bench", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    # bench.py's rule for the metric name (bench.py main)
    assert line["metric"] == f"intersect_count_{bits // (1 << 20)}Mbit_rows"
    assert line["bits"] == bits and line["rows"] == k
    assert line["platform"] == "cpu" and line["card"] is None
    assert line["unit"] == "ops/sec" and line["value"] > 0
    assert line["vs_baseline"] > 0 and line["host_ops_this_run"] > 0
    a, b = root_bench._rows(bits, k)
    want = [jax_native.popcnt_and(a[i].view(np.uint64),
                                  b[i].view(np.uint64)) for i in range(k)]
    assert line["counts"] == want


def test_bench_bound_is_the_memory_ceiling():
    # Two 2^30-bit rows (256 MiB) a row-op at 3.35 TB/s.
    assert bench.bound_ops(1 << 30) == pytest.approx(12479.7, abs=0.1)
    assert bench.metric_name(1 << 30) == "intersect_count_1024Mbit_rows"

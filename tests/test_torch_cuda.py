"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the executor on ``cuda`` against the executor on ``cpu``.

Every test here is marked ``cuda`` and skips where there is no card (the
decision is made in a fixture, never at import). The file imports
neither JAX nor the JAX package, so it also runs on a machine without
them; there, skip the JAX-bound tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Results are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import packed
from pilosa_tpu_torch.parallel import residency

pytestmark = pytest.mark.cuda

MIXED = ("or", ("and", ("leaf", 0), ("leaf", 1)),
         ("andnot", ("xor", ("leaf", 2), ("leaf", 0)), ("leaf", 1)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    yield torch.device("cuda:0")
    residency.device_cache().clear()


def _words(rng, shape, device):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w[..., ::5] |= np.uint32(1 << 31)
    return torch.from_numpy(w.view(np.int32)).to(device)


def _fold(op, n):
    e = ("leaf", 0)
    for i in range(1, n):
        e = (op, e, ("leaf", i))
    return e


def _balanced(lo, hi):
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    op = ("and", "or", "xor", "andnot")[(lo * 7 + hi) % 4]
    return (op, _balanced(lo, mid), _balanced(mid, hi))


@pytest.mark.parametrize("name,expr,n,shape", [
    ("mixed", MIXED, 3, (9, 2048)),
    ("serving", ("and", ("leaf", 0), ("leaf", 1)), 2, (256, 32768)),
    ("mixed64", _balanced(0, 64), 64, (16, 2048)),
    ("union1000", _fold("or", 1000), 1000, (2, 2048)),
])
def test_expr_count(cuda_device, name, expr, n, shape):
    leaves = _words(np.random.default_rng(1), (n,) + shape, cuda_device)
    before = ck.LAUNCHES["expr_count_rows"]
    got = ck.expr_count_rows(expr, leaves)
    assert ck.LAUNCHES["expr_count_rows"] == before + 1
    assert torch.equal(got, ck.expr_count_rows_torch(expr, leaves))


@pytest.mark.parametrize("expr", [MIXED, None, _fold("andnot", 40)])
def test_topn_block_count(cuda_device, expr):
    rng = np.random.default_rng(2)
    n = 40 if expr is not None and expr[0] == "andnot" else 3
    leaves = list(_words(rng, (n, 9, 2048), cuda_device))
    if expr is None:
        leaves = []
    rows = _words(rng, (9, 5, 2048), cuda_device)
    assert torch.equal(ck.topn_block_count(expr, rows, leaves),
                       ck.topn_block_count_torch(expr, rows, leaves))


@pytest.mark.parametrize("per_row", [0, 7, 300])
def test_densify(cuda_device, per_row):
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(11):
        idx = np.sort(rng.choice(2048, size=per_row, replace=False))
        val = rng.integers(1, 2**32, size=per_row, dtype=np.uint32)
        pairs.append((idx.astype(np.int32), val))
    lanes, vals = packed.bucket_prepared(pairs, 16)
    lane = torch.from_numpy(lanes.view(np.int32)).to(cuda_device)
    val = torch.from_numpy(vals.view(np.int32)).to(cuda_device)
    assert torch.equal(ck.densify(lane, val, 2048),
                       ck.densify_torch(lane, val, 2048))


def test_wrapper_raises_on_misaligned_words(cuda_device):
    leaf = torch.zeros((2, 6), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ck.expr_count_rows(("leaf", 0), [leaf])


def test_executor_card_matches_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(4)
    holder = Holder(str(tmp_path))
    holder.open()
    f = holder.create_index("i").create_frame("f")
    for row in range(6):
        n = (4000, 200000)[row % 2]
        cols = rng.choice(4 * SLICE_WIDTH, size=n, replace=False)
        f.import_bits(np.full(n, row, np.uint64), cols.astype(np.uint64))
    card = Executor(holder, device=cuda_device)
    cpu = Executor(holder, device="cpu")
    queries = [
        "Count(Intersect(Bitmap(rowID=0, frame=f), Bitmap(rowID=1,"
        " frame=f)))",
        "Count(Difference(Union(Bitmap(rowID=2, frame=f), Bitmap(rowID=3,"
        " frame=f)), Bitmap(rowID=1, frame=f)))",
        "TopN(Bitmap(rowID=1, frame=f), frame=f, n=3, ids=[0,1,2,3,4,5])",
    ]
    before = dict(ck.LAUNCHES)
    for q in queries:
        got = [r if isinstance(r, int) else [(p.id, p.count) for p in r]
               for r in card.execute("i", q)]
        want = [r if isinstance(r, int) else [(p.id, p.count) for p in r]
                for r in cpu.execute("i", q)]
        assert got == want, q
    assert ck.LAUNCHES["expr_count_rows"] > before["expr_count_rows"]
    assert ck.LAUNCHES["topn_block_count"] > before["topn_block_count"]
    assert ck.LAUNCHES["densify"] > before["densify"]
    holder.close()


# op_count_rows: every op at the odd shapes — W = 4k+1..3 (rows start
# off the 16-byte grid), W below one CTA's chunk, W < 4, one long row and
# a 1-D row.
OP_SHAPES = [(16, 1 << 20), (1, 1 << 22), (100003,), (3, 4 * 8193 + 1),
             (3, 4 * 8193 + 2), (3, 4 * 8193 + 3), (5, 37), (4, 1), (4, 2),
             (4, 3), (70000, 4)]


@pytest.mark.parametrize("shape", OP_SHAPES)
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_op_count_rows(cuda_device, op, shape):
    rng = np.random.default_rng(5)
    a, b = _words(rng, shape, cuda_device), _words(rng, shape, cuda_device)
    before = ck.LAUNCHES["op_count_rows"]
    got = ck.op_count_rows(op, a, b)
    assert ck.LAUNCHES["op_count_rows"] == before + 1
    assert torch.equal(got, ck.op_count_rows_torch(op, a, b))
    assert got.shape == torch.Size(shape[:-1])


@pytest.mark.parametrize("word", [-1, -2**31])
def test_op_count_rows_all_ones_and_bit31(cuda_device, word):
    a = torch.full((3, 4099), word, dtype=torch.int32, device=cuda_device)
    bits = 32 if word == -1 else 1
    assert ck.op_count_rows("and", a, a).tolist() == [4099 * bits] * 3
    assert ck.op_count_rows("xor", a, a).tolist() == [0] * 3


def test_op_count_rows_at_word_offsets(cuda_device):
    rng = np.random.default_rng(6)
    base_a = _words(rng, (8 * 1001 + 3,), cuda_device)
    base_b = _words(rng, (8 * 1001 + 3,), cuda_device)
    for off in (1, 2, 3):
        a = base_a[off:off + 8 * 1001].view(8, 1001)
        b = base_b[off:off + 8 * 1001].view(8, 1001)
        assert torch.equal(ck.op_count_rows("andnot", a, b),
                           ck.op_count_rows_torch("andnot", a, b))
    with pytest.raises(ValueError, match="modulo 16"):
        ck.op_count_rows("and", base_a[1:1 + 8 * 1001],
                         base_b[2:2 + 8 * 1001])


def test_ops_op_count_launches_the_kernel(cuda_device):
    from pilosa_tpu_torch.ops import kernels
    a = _words(np.random.default_rng(7), (2, 4096), cuda_device)
    before = ck.LAUNCHES["op_count_rows"]
    got = kernels.op_count("or", a, a.flip(0).contiguous())
    assert ck.LAUNCHES["op_count_rows"] == before + 1
    assert torch.equal(got, kernels.op_count_rows("or", a,
                                                  a.flip(0).contiguous()))


def test_bench_on_the_card(cuda_device, monkeypatch):
    from pilosa_tpu_torch import bench
    for key, val in (("PILOSA_BENCH_BITS", str(1 << 22)),
                     ("PILOSA_BENCH_ROWS", "4"), ("PILOSA_BENCH_ITERS", "4"),
                     ("PILOSA_BENCH_TRIALS", "2")):
        monkeypatch.setenv(key, val)
    before = ck.LAUNCHES["op_count_rows"]
    line = bench.run()
    assert ck.LAUNCHES["op_count_rows"] == before + 1 + 2 * 4
    assert line["platform"] == "gpu" and line["value"] > 0
    assert line["metric"] == "intersect_count_4Mbit_rows"

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
from pilosa_tpu_torch.ops import kernel_ab
from pilosa_tpu_torch.ops import packed
from pilosa_tpu_torch.parallel import mesh as torch_mesh
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


def _dirty_call(name, out_shape, call, device):
    """``call()`` once to warm the wrapper's caches, then again into the
    memory of a freed all-ones tensor of the output's size (what
    ``torch.empty`` hands back next); asserts that second call made one
    launch and returns its result."""
    call()
    junk = torch.full(out_shape, -1, dtype=torch.int32, device=device)
    del junk
    before = ck.LAUNCHES[name]
    got = call()
    assert ck.LAUNCHES[name] == before + 1
    return got


# Densify at any G (the sparse gate sends G up to 32), T × subs groups that
# the kernel's 32-group tile does not divide, lanes 0 and 127 of one group,
# bit-31 values and all-padding rows, into dirty memory.
@pytest.mark.parametrize("t_rows,subs,g_slots,empty", [
    (5, 33, 1, ()), (11, 16, 8, (3,)), (3, 47, 32, (2,)), (2, 16, 40, ()),
    (3, 64, 33, (0,)), (4, 16, 0, ()), (2, 1, 32, (1,)), (1, 256, 8, ()),
])
def test_densify_any_shape_dirty_output(cuda_device, t_rows, subs, g_slots,
                                        empty):
    lanes, vals = kernel_ab.odd_slots(np.random.default_rng(8), t_rows,
                                      subs, g_slots, empty)
    lane = torch.from_numpy(lanes.view(np.int32)).to(cuda_device)
    val = torch.from_numpy(vals.view(np.int32)).to(cuda_device)
    n_words = subs * 128
    want = ck.densify_torch(lane, val, n_words)
    got = _dirty_call("densify", (t_rows, n_words),
                      lambda: ck.densify(lane, val, n_words), cuda_device)
    assert torch.equal(got, want)


# The expression count at S = 1, 10 and 256 rows of 32,768 words, at
# W = 4, and over a 1000-child Union (longer than the program the kernel
# stages in shared memory), the 64-leaf mixed tree and a tree that needs
# seven spill slots, into dirty memory.
@pytest.mark.parametrize("name,expr,n,shape", [
    ("s1", ("and", ("leaf", 0), ("leaf", 1)), 2, (1, 32768)),
    ("s10", MIXED, 3, (10, 32768)),
    ("s256", ("and", ("leaf", 0), ("leaf", 1)), 2, (256, 32768)),
    ("w4", MIXED, 3, (9, 4)),
    ("union1000", _fold("or", 1000), 1000, (3, 2048)),
    ("mixed64", _balanced(0, 64), 64, (5, 2048)),
    ("spill256", _balanced(0, 256), 256, (3, 2048)),
])
def test_expr_count_dirty_output(cuda_device, name, expr, n, shape):
    leaves = _words(np.random.default_rng(9), (n,) + shape, cuda_device)
    want = ck.expr_count_rows_torch(expr, leaves)
    got = _dirty_call("expr_count_rows", shape[:1],
                      lambda: ck.expr_count_rows(expr, leaves), cuda_device)
    assert torch.equal(got, want)


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


def test_server_counts_over_http_on_the_card(cuda_device, tmp_path):
    import json
    import urllib.request

    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server.server import Server

    srv = Server(str(tmp_path / "d"), host="127.0.0.1:0")  # the card
    srv.open()

    def post(path, body, headers=None):
        req = urllib.request.Request(f"http://{srv.host}{path}", data=body,
                                     method="POST", headers=headers or {})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            return resp.read()

    try:
        assert srv.executor.device.type == "cuda"
        post("/index/i", b"{}")
        post("/index/i/frame/f", b"{}")
        rng = np.random.default_rng(10)
        cols = {}
        for row, n in ((1, 60000), (2, 3000)):
            cols[row] = np.unique(rng.integers(0, 3 * SLICE_WIDTH, size=n,
                                               dtype=np.uint64))
            body = pb.ImportRequest(
                Index="i", Frame="f", RowIDs=np.full(len(cols[row]), row,
                                                     np.uint64),
                ColumnIDs=cols[row]).SerializeToString()
            post("/import", body, {"Content-Type": "application/x-protobuf",
                                   "Accept": "application/x-protobuf"})
        before = ck.LAUNCHES["expr_count_rows"]
        out = post("/index/i/query", b"Count(Intersect(Bitmap(rowID=1,"
                   b" frame=f), Bitmap(rowID=2, frame=f)))")
        assert json.loads(out) == {"results": [
            len(np.intersect1d(cols[1], cols[2]))]}
        assert ck.LAUNCHES["expr_count_rows"] == before + 1
    finally:
        srv.close()


def test_server_verb_serves_on_the_card(cuda_device, tmp_path):
    """``python -m pilosa_tpu_torch.cli server`` with no ``--device``
    serves on the card: a write, then a Count over HTTP."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d",
         str(tmp_path / "d"), "-b", f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=repo)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"pilosa-tpu serving at http://127.0.0.1:"
                               f"{port}"), proc.stderr.read()
        base = f"http://127.0.0.1:{port}"

        def post(path, body):
            req = urllib.request.Request(base + path, data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.read()

        post("/index/i", b"{}")
        post("/index/i/frame/f", b"{}")
        post("/index/i/query", b"SetBit(frame=f, rowID=1, columnID=3)"
             b" SetBit(frame=f, rowID=2, columnID=3)"
             b" SetBit(frame=f, rowID=1, columnID=4)")
        out = post("/index/i/query", b"Count(Intersect(Bitmap(rowID=1,"
                   b" frame=f), Bitmap(rowID=2, frame=f)))")
        assert json.loads(out) == {"results": [1]}
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    assert "on cuda:0" in err, err


# -- TopN: the device pruning, the device top-k and every executor form -----

@pytest.mark.parametrize("s,r,w", [(1, 1, 4), (3, 7, 1028), (5, 33, 68),
                                   (10, 163, 32768)])
def test_topn_block_count_no_program(cuda_device, s, r, w):
    """The empty program (``n_ins == 0``): plain row popcounts, at odd
    row counts and odd numbers of 16-byte word groups."""
    rows = _words(np.random.default_rng(s * r), (s, r, w), cuda_device)
    before = ck.LAUNCHES["topn_block_count"]
    got = ck.topn_block_count(None, rows, [])
    assert ck.LAUNCHES["topn_block_count"] == before + 1
    assert torch.equal(got, ck.topn_block_count_torch(None, rows, []))


def _bit_words(bits, n_words):
    arr = np.zeros(n_words * 32, dtype=bool)
    arr[np.asarray(bits, dtype=np.int64)] = True
    return np.packbits(arr, bitorder="little").view(np.uint32)


# Per slice, the source's size: the boundaries of every inequality sit
# at different counts on each slice, and one slice's source is empty.
SRC_SIZES = (100, 0, 37)
BOUNDARY_CNT = (1, 2, 36, 37, 49, 50, 51, 99, 100, 101, 102, 110, 199, 200,
                201, 3700, 9999, 10000, 10001)
BOUNDARY_INTER = (0, 1, 2, 3, 18, 19, 36, 37, 69, 70, 71, 100)


def _boundary_block(n_words=1028):
    """Rows whose (row count, intersection count) pairs sit on and
    beside every bound of the Tanimoto and threshold inequalities, over
    ``SRC_SIZES`` sources. Returns (rows [S, R, W], leaf [S, W],
    [(cnt, inter)] per slice and row)."""
    pairs = [(c, i) for c in BOUNDARY_CNT for i in BOUNDARY_INTER if i <= c]
    rows = np.zeros((len(SRC_SIZES), len(pairs), n_words), np.uint32)
    leaf = np.zeros((len(SRC_SIZES), n_words), np.uint32)
    truth = []
    for si, s_n in enumerate(SRC_SIZES):
        leaf[si] = _bit_words(range(s_n), n_words)
        per = []
        for ri, (c, i) in enumerate(pairs):
            i = min(i, s_n)
            bits = list(range(i)) + list(range(200, 200 + c - i))
            rows[si, ri] = _bit_words(bits, n_words)
            per.append((c, i))
        truth.append(per)
    return rows, leaf, truth


def _keep(cnt, inter, s_n, threshold, tanimoto):
    if tanimoto:
        return (100 * cnt > s_n * tanimoto and cnt * tanimoto < 100 * s_n
                and inter > 0
                and 100 * inter > tanimoto * (cnt + s_n - inter))
    return cnt >= threshold and inter >= threshold


@pytest.mark.parametrize("threshold,tanimoto", [
    (1, 1), (1, 50), (1, 100), (2, 0), (37, 0), (100, 0), (3, 50)])
def test_topn_filtered_on_the_card(cuda_device, threshold, tanimoto):
    """``topn_filtered_sharded`` on the card equals its CPU result and
    the integer inequalities written out here, row by row, slice by
    slice."""
    rows, leaf, truth = _boundary_block()
    want = np.array([[inter if _keep(c, inter, SRC_SIZES[si], threshold,
                                      tanimoto) else 0
                      for c, inter in per] for si, per in enumerate(truth)])
    expr = ("leaf", 0)
    out = {}
    for key, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        r = torch.from_numpy(rows.view(np.int32)).to(dev)
        lv = [torch.from_numpy(leaf.view(np.int32)).to(dev)]
        per_slice = torch_mesh._filtered_counts(expr, r, lv, threshold,
                                                tanimoto)
        assert np.array_equal(per_slice.cpu().numpy(), want)
        out[key] = torch_mesh.topn_filtered_sharded(
            expr, r, lv, threshold, tanimoto)
    assert out["card"] == out["cpu"] == want.sum(axis=0).tolist()


@pytest.mark.parametrize("k", [1, 5, 163, 170])
def test_topn_topk_on_the_card(cuda_device, k):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, size=(10, 163, 1028), dtype=np.uint32)
    words[:, ::4] &= np.uint32(0xF)  # ties among the small rows
    words[:, 7] = words[:, 3]
    got = {}
    for key, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        rows = torch.from_numpy(words.view(np.int32)).to(dev)
        got[key] = torch_mesh.topn_topk_sharded(None, rows, [], k)
    assert got["card"] == got["cpu"]
    counts, idx = got["cpu"]
    assert len(idx) == min(k, 163)
    assert sorted(zip(counts, idx), key=lambda p: (-p[0], p[1])) == \
        list(zip(counts, idx))


def test_topn_forms_card_matches_cpu(cuda_device, tmp_path):
    """Every TopN form through the executor on the card equals the
    executor on the CPU, on an LRU and a ranked frame."""
    from pilosa_tpu_torch.models.frame import FrameOptions
    rng = np.random.default_rng(8)
    holder = Holder(str(tmp_path))
    holder.open()
    idx = holder.create_index("i")
    src = idx.create_frame("src")
    for row, n in ((1, 300000), (2, 600)):
        cols = rng.choice(3 * SLICE_WIDTH, size=n, replace=False)
        src.import_bits(np.full(n, row, np.uint64), cols.astype(np.uint64))
    for name, opts in (("f", FrameOptions()),
                       ("fr", FrameOptions(cache_type="ranked"))):
        fr = idx.create_frame(name, opts)
        for row in range(40):
            n = 20000 // (row + 1) + 3
            cols = rng.choice(3 * SLICE_WIDTH, size=n, replace=False)
            fr.import_bits(np.full(n, row, np.uint64),
                           cols.astype(np.uint64))
        near = holder.fragment("i", "src", "standard", 0).row(2).bits()
        fr.import_bits(np.full(len(near), 77, np.uint64),
                       near.astype(np.uint64))
    card = Executor(holder, device=cuda_device)
    cpu = Executor(holder, device="cpu")
    s1, s2 = "Bitmap(rowID=1, frame=src)", "Bitmap(rowID=2, frame=src)"
    forms = ["TopN(frame={F}, n=5)", "TopN(frame={F})",
             "TopN(frame={F}, n=4, threshold=9)",
             "TopN(frame={F}, ids=[1, 2, 3, 77, 99])",
             f"TopN({s1}, frame={{F}}, n=6)",
             f"TopN({s1}, frame={{F}}, n=6, threshold=40)",
             f"TopN(Union({s1}, {s2}), frame={{F}}, ids=[0, 5, 77],"
             " threshold=2)",
             f"TopN({s2}, frame={{F}}, tanimotoThreshold=1)",
             f"TopN({s2}, frame={{F}}, tanimotoThreshold=50)",
             f"TopN(Intersect({s1}, {s2}), frame={{F}}, n=3,"
             " tanimotoThreshold=10)"]
    before = dict(ck.LAUNCHES)
    for frame in ("f", "fr"):
        for form in forms:
            q = form.format(F=frame)
            got = [(p.id, p.count) for p in card.execute("i", q)[0]]
            want = [(p.id, p.count) for p in cpu.execute("i", q)[0]]
            assert got == want, q
    assert ck.LAUNCHES["topn_block_count"] > before["topn_block_count"]
    assert ck.LAUNCHES["expr_count_rows"] > before["expr_count_rows"]
    holder.close()


# -- BSI fields, time views and the inverse view on the card -----------------

@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    """A frame with a 21-bit field (one column in 16 valued), a filter
    row, and a YMDH time frame with inverse storage, built once."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    import datetime as dt

    from pilosa_tpu_torch.models.frame import Field, FrameOptions
    rng = np.random.default_rng(11)
    n_slices = 3
    holder = Holder(str(tmp_path_factory.mktemp("fields")))
    holder.open()
    idx = holder.create_index("i")
    v = idx.create_frame("v")
    v.create_field(Field("amount", -1_000_000, 1_000_000))
    cols = (np.arange(0, n_slices * SLICE_WIDTH, 16, dtype=np.uint64)
            + rng.integers(0, 16, n_slices * SLICE_WIDTH // 16
                           ).astype(np.uint64))
    vals = rng.integers(-1_000_000, 1_000_001, size=len(cols))
    v.import_field_values("amount", cols, vals)
    keep = cols[rng.random(len(cols)) < 0.25]
    idx.create_frame("seg").import_bits(np.full(len(keep), 1, np.uint64),
                                        keep)
    t = idx.create_frame("t", FrameOptions(time_quantum="YMDH",
                                           inverse_enabled=True))
    stamps = [dt.datetime(2017, m, d, h) for m, d in
              ((1, 3), (2, 9), (2, 10), (6, 1), (11, 20), (12, 31))
              for h in (8, 16)]
    n = 20000
    t.import_bits(rng.integers(0, 5, size=n).astype(np.uint64),
                  rng.integers(0, n_slices * SLICE_WIDTH, size=n,
                               dtype=np.uint64),
                  [stamps[i] for i in rng.integers(len(stamps), size=n)])
    yield holder, vals
    holder.close()
    residency.device_cache().clear()


@pytest.mark.parametrize("cond", ["== {x}", "!= {x}", "< {x}", "<= {x}",
                                  "> {x}", ">= {x}", ">< [{lo}, {x}]",
                                  "< 2000000", "> 1000000"])
def test_count_range_card_matches_cpu(cuda_device, fields, cond):
    holder, vals = fields
    card = Executor(holder, device=cuda_device)
    cpu = Executor(holder, device="cpu")
    x, lo = int(vals[7]), int(vals[7]) - 300_000
    q = f"Count(Range(frame=v, amount {cond.format(x=x, lo=lo)}))"
    before = ck.LAUNCHES["expr_count_rows"]
    got = card.execute("i", q)
    assert got == cpu.execute("i", q)
    ops = {"==": np.equal, "!=": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
    op, arg = cond.split(" ", 1)
    want = (int(((vals >= lo) & (vals <= x)).sum()) if op == "><"
            else int(ops[op](vals, int(arg.format(x=x))).sum()))
    assert got == [want]
    if cond != "> 1000000":  # clamped to none: the host answers 0
        assert ck.LAUNCHES["expr_count_rows"] == before + 1


def test_sum_and_views_card_matches_cpu(cuda_device, fields):
    holder, vals = fields
    card = Executor(holder, device=cuda_device)
    cpu = Executor(holder, device="cpu")
    before = ck.LAUNCHES["expr_count_rows"]
    got = card.execute("i", "Sum(frame=v, field=amount)")[0]
    assert ck.LAUNCHES["expr_count_rows"] == before + 22
    assert (got.value, got.count) == (int(vals.sum()), len(vals))
    for q in ["Sum(Bitmap(frame=seg, rowID=1), frame=v, field=amount)",
              "Sum(Range(frame=v, amount > 0), frame=v, field=amount)",
              "Min(frame=v, field=amount)", "Max(frame=v, field=amount)",
              "Count(Range(frame=t, rowID=1, start=\"2017-02-03T08:00\","
              " end=\"2017-11-20T16:00\"))",
              "Count(Range(frame=t, rowID=2, start=\"2017-01-01T00:00\","
              " end=\"2018-01-01T00:00\"))",
              "Count(Intersect(Bitmap(columnID=5, frame=t),"
              " Bitmap(columnID=9, frame=t)))"]:
        a, b = card.execute("i", q)[0], cpu.execute("i", q)[0]
        assert (getattr(a, "value", a), getattr(a, "count", a)) == \
            (getattr(b, "value", b), getattr(b, "count", b)), q


def test_bsi_fold_programs_on_the_card(cuda_device):
    from pilosa_tpu_torch.storage import bsi
    rng = np.random.default_rng(13)
    planes = _words(rng, (64, 8, 2048), cuda_device)

    def leaf(p):
        return ("leaf", 0 if p == bsi.EXISTS_PLANE else p + 1)

    for op, upred in (("<", 0x2AAAAAAAAAAAAAAA), (">=", 12345),
                      ("==", 2**62 + 5), ("!=", 7),
                      ("><", (2**40, 2**61 + 3))):
        expr = bsi.compare_fold_expr(op, upred, 63, leaf)
        assert torch.equal(ck.expr_count_rows(expr, planes),
                           ck.expr_count_rows_torch(expr, planes)), op

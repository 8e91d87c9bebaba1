"""BSI integer fields and ``Range`` in the port against the JAX package.

- The comparison fold (``storage.bsi.compare_fold_expr``) that the port
  sends to the expression-count kernel, held word for word to the JAX
  package's numpy twin of its circuit (``ops.kernels.
  bsi_compare_words_host``) for every operator at depths 1-63 over
  random planes, random predicates and the clamp edges; its program is
  at most depth+2 instructions with no spill slot (``><``: 2·(depth+1)+2
  with one).
- The same seeded writes (``import_field_values`` and
  ``SetFieldValue``) into a JAX ``Holder`` and a port ``Holder``; then
  ``Range``, ``Count(Range)``, ``Sum``, ``Min`` and ``Max`` (filtered,
  clamped, on an empty field and on a 63-bit field) through both
  executors, the JAX one on the virtual CPU mesh
  (``use_mesh=True, mesh_min_slices=1``) and the port's on
  ``device="cpu"``: identical answers, or identical error texts.
- Assignment semantics of ``SetFieldValue`` and the field import.
- A resident plane slab is keyed on the field view's fragments: a write
  between two Counts changes the second answer.
- The field routes over HTTP against a JAX ``Handler``.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.frame import Field as JaxField
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.ops.kernels import bsi_compare_words_host
from pilosa_tpu.proto import internal_pb2 as jpb
from pilosa_tpu.server.handler import Handler as JaxHandler
from pilosa_tpu.storage import bsi as jax_bsi

from pilosa_tpu_torch.errors import PilosaError
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.frame import Field
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import cuda_kernels
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.proto import internal as tpb
from pilosa_tpu_torch.server.handler import Handler
from pilosa_tpu_torch.storage import bsi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = (1, 2, 7, 21, 32, 63)
OPS = ("==", "!=", "<", "<=", ">", ">=", "><")
N_SLICES = 4
PB = "application/x-protobuf"


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


# -- the fold against the JAX circuit's numpy twin ---------------------------

def _predicates(rng, depth):
    top = (1 << depth) - 1
    edges = {e for e in (0, 1, top - 1, top) if 0 <= e <= top}
    return sorted(edges | {int(rng.integers(0, top + 1))
                           for _ in range(24)})


def _fold_words(expr, planes):
    leaves = [torch.from_numpy(p.view(np.int32).copy()) for p in planes]
    if expr is None:
        return np.zeros(planes.shape[1:], np.uint32)
    return cuda_kernels.eval_expr_torch(expr, leaves).numpy().view(np.uint32)


def _leaf(plane):
    return ("leaf", 0 if plane == bsi.EXISTS_PLANE else plane + 1)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_fold_matches_the_jax_circuit(depth, op):
    rng = np.random.default_rng(depth * 31 + OPS.index(op))
    # [exists + depth planes, 2 slices, 16 words] of arbitrary bits.
    planes = rng.integers(0, 2**32, size=(depth + 1, 2, 16),
                          dtype=np.uint32)
    preds = _predicates(rng, depth)
    if op == "><":
        cases = [(lo, hi) for lo in preds for hi in preds if lo <= hi][::7]
        cases += [(0, preds[-1]), (preds[-1], preds[-1]), (0, 0)]
    else:
        cases = preds
    for upred in cases:
        if op == "><":
            want = (bsi_compare_words_host(">=", upred[0], planes)
                    & bsi_compare_words_host("<=", upred[1], planes))
        else:
            want = bsi_compare_words_host(op, upred, planes)
        expr = bsi.compare_fold_expr(op, upred, depth, _leaf)
        ref = jax_bsi.compare_expr(op, upred, depth, _leaf)
        assert (expr is None) == (ref is None), (op, upred)
        assert np.array_equal(_fold_words(expr, planes), want), (op, upred)
        if expr is None:
            continue
        prog, slots = cuda_kernels.compile_program(expr)
        assert len(prog) <= 2 * (depth + 1) + 2 and slots <= 1
        if op != "><":
            assert len(prog) <= depth + 2 and slots == 0, (op, len(prog))
        leaves = [torch.from_numpy(p.view(np.int32).copy()) for p in planes]
        counts = cuda_kernels.expr_count_rows(expr, leaves)
        assert counts.tolist() == [int(np.unpackbits(w.view(np.uint8)).sum())
                                   for w in want]


@pytest.mark.parametrize("depth", range(1, 64))
def test_fold_at_every_depth_and_clamp_edge(depth):
    """Every depth 1-63: predicates from ``bsi.clamp`` at the edges of a
    field whose range is not a power of two, and the offset-space edges,
    word for word against the JAX circuit's numpy twin, within the
    program bounds."""
    rng = np.random.default_rng(1000 + depth)
    planes = rng.integers(0, 2**32, size=(depth + 1, 1, 8), dtype=np.uint32)
    top = (1 << depth) - 1
    lo = -(1 << (depth - 1))
    hi = lo + top - (top // 3)
    cases = []
    for op in OPS[:-1]:
        for p in (lo - 1, lo, lo + 1, hi - 1, hi, hi + 1):
            clamped = bsi.clamp(op, p, lo, hi)
            assert clamped == jax_bsi.clamp(op, p, lo, hi)
            if isinstance(clamped, tuple):
                cases.append(clamped)
        cases += [(op, 0), (op, top), (op, int(rng.integers(0, top + 1)))]
    for bounds in ((lo, hi), (lo - 5, lo + 3), (hi - 2, hi + 9),
                   (lo + 1, hi - 1)):
        clamped = bsi.clamp("><", bounds, lo, hi)
        if isinstance(clamped, tuple):
            cases.append(clamped)
    cases.append(("><", (0, top)))
    for op, upred in cases:
        if op == "><":
            want = (bsi_compare_words_host(">=", upred[0], planes)
                    & bsi_compare_words_host("<=", upred[1], planes))
        else:
            want = bsi_compare_words_host(op, upred, planes)
        expr = bsi.compare_fold_expr(op, upred, depth, _leaf)
        assert np.array_equal(_fold_words(expr, planes), want), (op, upred)
        if expr is not None:
            prog, slots = cuda_kernels.compile_program(expr)
            assert len(prog) <= 2 * (depth + 1) + 2 and slots <= 1


def test_tree_form_is_quadratic_and_the_fold_is_not():
    """Why the port compiles the fold: the JAX tree re-emits its shared
    ``eq`` subtree once for each use in the postfix program."""
    upred = 0x2AAAAAAAAAAAAAAA
    tree = jax_bsi.compare_expr("<", upred, 63, _leaf)
    fold = bsi.compare_fold_expr("<", upred, 63, _leaf)
    assert len(cuda_kernels.compile_program(tree)[0]) > 512
    assert len(cuda_kernels.compile_program(fold)[0]) <= 64


# -- both executors on the same writes ---------------------------------------

def _write_both(jh, th, rng):
    """The same field data through each package's own API."""
    for h, F in ((jh, JaxField), (th, Field)):
        idx = h.create_index("i")
        f = idx.create_frame("f")
        f.create_field(F("v", -50, 1000))
        f.create_field(F("e", 0, 7))
        f.create_field(F("wide", 0, 2**63 - 1))
        f.create_field(F("one", 4, 4))
        idx.create_frame("g")
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=3000,
                        dtype=np.uint64)
    vals = rng.integers(-50, 1001, size=3000)
    cols[:40] = cols[40:80]  # duplicates: the last value wins
    wcols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=300,
                         dtype=np.uint64)
    wvals = rng.integers(0, 2**63 - 1, size=300, dtype=np.int64)
    wvals[:3] = (0, 2**63 - 1, 2**62)
    gcols = np.concatenate([cols[::3], rng.integers(
        0, N_SLICES * SLICE_WIDTH, size=500, dtype=np.uint64)])
    for h in (jh, th):
        f = h.frame("i", "f")
        f.import_field_values("v", cols, vals)
        f.import_field_values("wide", wcols, wvals)
        f.import_field_values("one", cols[:9], np.full(9, 4))
        g = h.frame("i", "g")
        g.import_bits(np.full(len(gcols), 1, np.uint64), gcols)
        g.import_bits(np.full(50, 2, np.uint64), cols[100:150])
    writes = [f"SetFieldValue(frame=f, columnID={int(c)}, v={int(v)})"
              for c, v in zip(rng.integers(0, N_SLICES * SLICE_WIDTH, 20),
                              rng.integers(-50, 1001, 20))]
    writes += [f"SetFieldValue(frame=f, columnID={int(cols[5])}, v=-50)",
               f"SetFieldValue(frame=f, columnID={int(cols[6])}, v=1000)",
               f"SetFieldValue(frame=f, columnID={int(cols[6])}, v=1000)"]
    return writes


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    th = Holder(str(tmp_path_factory.mktemp("port")))
    th.open()
    writes = _write_both(jh, th, np.random.default_rng(77))
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1)
    tex = Executor(th, device="cpu", mesh_min_slices=1)
    for w in writes:
        assert tex.execute("i", w) == jex.execute("i", w), w
    yield jex, tex
    assert jex.device_fallbacks == 0
    jex.close()
    jh.close()
    th.close()


def _norm(results):
    out = []
    for r in results:
        if hasattr(r, "bits"):
            out.append(("bits", [int(b) for b in r.bits()]))
        elif hasattr(r, "count") and hasattr(r, "value"):
            out.append(("valcount", r.value, r.count))
        elif isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        else:
            out.append(r)
    return out


def _range_queries():
    qs = []
    for op in ("==", "!=", "<", "<=", ">", ">="):
        for p in (-51, -50, -49, 0, 17, 500, 999, 1000, 1001):
            qs.append(f"Count(Range(frame=f, v {op} {p}))")
    for lo, hi in ((-50, 1000), (-60, 2000), (0, 0), (10, 42),
                   (-50, -50), (999, 1000), (5, 4), (1001, 1200)):
        qs.append(f"Count(Range(frame=f, v >< [{lo}, {hi}]))")
    for op, p in (("<", 2**62), (">=", 2**62), ("==", 0),
                  ("!=", 2**63 - 1), (">", 2**63 - 2), ("<=", 1)):
        qs.append(f"Count(Range(frame=f, wide {op} {p}))")
    qs += ["Count(Range(frame=f, one == 4))", "Count(Range(frame=f, one != 4))",
           "Count(Range(frame=f, one >< [3, 9]))",
           "Count(Range(frame=f, e < 3))"]
    return qs


QUERIES = _range_queries() + [
    "Range(frame=f, v > 990)", "Range(frame=f, v == 17)",
    "Range(frame=f, v >< [100, 104])", "Range(frame=f, v < -50)",
    "Sum(frame=f, field=v)", "Min(frame=f, field=v)",
    "Max(frame=f, field=v)",
    "Sum(Bitmap(frame=g, rowID=1), frame=f, field=v)",
    "Min(Bitmap(frame=g, rowID=1), frame=f, field=v)",
    "Max(Bitmap(frame=g, rowID=2), frame=f, field=v)",
    "Sum(Range(frame=f, v > 500), frame=f, field=v)",
    "Sum(Intersect(Bitmap(frame=g, rowID=1), Range(frame=f, v < 0)),"
    " frame=f, field=v)",
    "Sum(Bitmap(frame=g, rowID=9), frame=f, field=v)",
    "Sum(frame=f, field=e)", "Min(frame=f, field=e)",
    "Max(frame=f, field=e)",
    "Sum(frame=f, field=wide)", "Min(frame=f, field=wide)",
    "Max(frame=f, field=wide)", "Sum(frame=f, field=one)",
    "Max(frame=f, field=one)",
    "Count(Union(Range(frame=f, v == 0), Range(frame=f, v >= 977)))",
    "Count(Intersect(Range(frame=f, v >= 10), Bitmap(frame=g, rowID=1)))",
    "Count(Difference(Bitmap(frame=g, rowID=1), Range(frame=f, v < 300)))",
    "Intersect(Range(frame=f, v >= 10), Bitmap(frame=g, rowID=2))",
    "TopN(Range(frame=f, v > 100), frame=g, n=2)",
    "TopN(Range(frame=f, v > 100), frame=g, ids=[1, 2, 3])",
    "Count(Range(frame=f, v > 3)) Sum(frame=f, field=v)"
    " Count(Range(frame=f, v <= 3))",
]


@pytest.mark.parametrize("q", QUERIES)
def test_answers_match_jax(pair, q):
    jex, tex = pair
    assert _norm(tex.execute("i", q)) == _norm(jex.execute("i", q))


def test_answers_are_not_all_trivial(pair):
    _, tex = pair
    counts = [tex.execute("i", q)[0] for q in _range_queries()]
    assert len(set(counts)) > 20 and max(counts) > 2000
    s = tex.execute("i", "Sum(frame=f, field=wide)")[0]
    assert s.count > 250 and s.value > 2**63


ERRORS = [
    "Range(frame=f, nope > 3)", "Count(Range(frame=f, nope > 3))",
    "Range(frame=nope, v > 3)", "Count(Range(frame=nope, v > 3))",
    "Sum(frame=f, field=nope)", "Sum(frame=f)", "Min(frame=nope, field=v)",
    "Max(Bitmap(frame=g, rowID=1), Bitmap(frame=g, rowID=2), frame=f,"
    " field=v)",
    "Sum(Bitmap(frame=nope, rowID=1), frame=f, field=v)",
    "SetFieldValue(frame=f, columnID=1, v=1001)",
    "SetFieldValue(frame=f, columnID=1, v=-51)",
    "SetFieldValue(frame=f, columnID=1)",
    "SetFieldValue(frame=f, columnID=1, v=3, e=2)",
    "SetFieldValue(columnID=1, v=3)", "SetFieldValue(frame=f, v=3)",
    "SetFieldValue(frame=nope, columnID=1, v=3)",
    "SetFieldValue(frame=f, columnID=1, nope=3)",
    "SetFieldValue(frame=f, columnID=1, v=\"x\")",
    "SetFieldValue(frame=f, columnID=1, v=true)",
]


@pytest.mark.parametrize("q", ERRORS)
def test_error_texts_match_jax(pair, q):
    jex, tex = pair
    with pytest.raises(Exception) as want:
        jex.execute("i", q)
    with pytest.raises(PilosaError) as got:
        tex.execute("i", q)
    assert str(got.value) == str(want.value)


def test_set_field_value_overwrites_and_import_last_wins(tmp_path):
    frames = {}
    for name, (H, F) in {"jax": (JaxHolder, JaxField),
                         "port": (Holder, Field)}.items():
        h = H(str(tmp_path / name))
        h.open()
        f = h.create_index("i").create_frame("f")
        f.create_field(F("v", -5, 127))
        frames[name] = (h, f)
    ops = [("set", 1, 127), ("set", 1, 0), ("set", 1, 0), ("set", 2, -5),
           ("import", [1, 2, 1, SLICE_WIDTH + 3, 2], [7, -5, 50, 12, 99]),
           ("import", [1], [0]), ("set", SLICE_WIDTH + 3, 12),
           ("import", [9, 9, 9], [1, 2, 3])]
    for op in ops:
        got = []
        for name in ("jax", "port"):
            f = frames[name][1]
            if op[0] == "set":
                got.append(f.set_field_value("v", op[1], op[2]))
            else:
                f.import_field_values("v", np.array(op[1], np.uint64),
                                      np.array(op[2], np.int64))
        assert got[:1] == got[1:]
        for col in (1, 2, 3, 9, SLICE_WIDTH + 3):
            assert (frames["port"][1].field_value("v", col)
                    == frames["jax"][1].field_value("v", col)), (op, col)
    assert frames["port"][1].field_value("v", 1) == (0, True)
    assert frames["port"][1].field_value("v", 9) == (3, True)
    for name in ("jax", "port"):
        f = frames[name][1]
        with pytest.raises(Exception, match="out of range"):
            f.import_field_values("v", [9], [128])
        frames[name] = {
            (fr.view, fr.slice): (fr.positions() if name == "port"
                                  else fr.storage.all_positions()).tolist()
            for fr in frames[name][0].iter_fragments()}
    assert frames["port"] == frames["jax"]


def test_write_between_counts_changes_the_answer(tmp_path):
    """The resident plane slabs are keyed on the field view's fragments
    (the frame has no standard view at all)."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    f = h.create_index("i").create_frame("f")
    f.create_field(Field("v", 0, 100))
    f.import_field_values("v", np.arange(0, 3 * SLICE_WIDTH, 999,
                                         dtype=np.uint64),
                          np.arange(0, 3 * SLICE_WIDTH, 999) % 101)
    ex = Executor(h, device="cpu", mesh_min_slices=1)
    q = "Count(Range(frame=f, v > 90))"
    before = ex.execute("i", q)[0]
    s_before = ex.execute("i", "Sum(frame=f, field=v)")[0]
    assert residency.device_cache().snapshot()["entries"] > 0
    assert ex.execute("i", "SetFieldValue(frame=f, columnID=5, v=95)") \
        == [True]
    assert ex.execute("i", q)[0] == before + 1
    s = ex.execute("i", "Sum(frame=f, field=v)")[0]
    assert (s.value, s.count) == (s_before.value + 95, s_before.count + 1)
    f.import_field_values("v", [5, 2 * SLICE_WIDTH + 2], [3, 99])
    assert ex.execute("i", q)[0] == before + 1
    assert "standard" not in f.views
    h.close()


_CRASH_PROBE = """
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
pkg, path, step = sys.argv[1:4]
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pilosa_tpu.models.frame import Field
    from pilosa_tpu.models.holder import Holder
    from pilosa_tpu.storage import wal
else:
    from pilosa_tpu_torch.models.frame import Field
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.storage import wal
h = Holder(path)
h.open()
cols = np.arange(0, 3 * (1 << 20), 4099, dtype=np.uint64)
if step == "write":
    f = h.create_index("i").create_frame("f")
    f.create_field(Field("v", 0, 1023))
    f.import_field_values("v", cols, np.full(len(cols), 1023))
    f.import_field_values("v", cols[::2], (cols[::2] % 1024).astype(np.int64))
    f.set_field_value("v", int(cols[1]), 0)
    wal.barrier_all()
    os._exit(0)
f = h.frame("i", "f")
print(json.dumps([f.field_value("v", int(c)) for c in cols[:40]]))
os._exit(0)
"""


def test_field_reimport_survives_a_crash(tmp_path):
    """A re-import clears stale planes through the WAL'd batch lane: after
    the commit barrier and a process exit with nothing closed, the reopen
    reads the last assignment of every column, as the JAX package's
    does."""
    script = _CRASH_PROBE.format(repo=REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    got = {}
    for pkg in ("jax", "port"):
        data = str(tmp_path / pkg)
        for step in ("write", "read"):
            out = subprocess.run([sys.executable, "-c", script, pkg, data,
                                  step], capture_output=True, text=True,
                                 timeout=120, env=env, cwd=REPO)
            assert out.returncode == 0, out.stderr
        got[pkg] = json.loads(out.stdout)
    assert got["port"] == got["jax"]
    cols = list(range(0, 3 * (1 << 20), 4099))[:40]
    want = [[c % 1024, True] if i % 2 == 0 else [1023, True]
            for i, c in enumerate(cols)]
    want[1] = [0, True]
    assert got["port"] == want


# -- the field routes over HTTP ----------------------------------------------

def _call(app, method, path, body=b"", content_type="", accept=""):
    path, _, qs = path.partition("?")
    if isinstance(body, str):
        body = body.encode()
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    if content_type:
        environ["CONTENT_TYPE"] = content_type
    if accept:
        environ["HTTP_ACCEPT"] = accept
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])
        out["type"] = dict(headers)["Content-Type"]

    return out, b"".join(app(environ, start_response))


@pytest.fixture
def handlers(tmp_path):
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "port"))
    th.open()
    jex = JaxExecutor(jh, host="local")
    yield JaxHandler(jh, jex, host="local"), Handler(th, Executor(
        th, device="cpu", mesh_min_slices=1))
    jex.close()
    jh.close()
    th.close()


def _same(handlers, method, path, body=b"", content_type="", accept=""):
    (jo, jb), (to, tb) = (_call(h, method, path, body, content_type, accept)
                          for h in handlers)
    assert (to["status"], to["type"]) == (jo["status"], jo["type"]), \
        (path, body, tb, jb)
    if to["type"] == "application/json":
        assert json.loads(tb) == json.loads(jb), (path, body)
    else:
        assert tb == jb, (path, body)
    return to["status"], tb


def test_field_lifecycle_over_http(handlers):
    s = _same(handlers, "POST", "/index/i", "{}")[0]
    assert s == 200
    body = json.dumps({"options": {"fields": [
        {"name": "qty", "min": 0, "max": 1000}]}})
    assert _same(handlers, "POST", "/index/i/frame/f", body)[0] == 200
    assert _same(handlers, "POST", "/index/i/frame/f/field/price",
                 json.dumps({"min": -100, "max": 100}))[0] == 200
    assert _same(handlers, "POST", "/index/i/frame/f/field/price",
                 json.dumps({"min": -100, "max": 100}))[0] == 200
    _, out = _same(handlers, "GET", "/index/i/frame/f/fields")
    assert json.loads(out)["fields"][1] == {"name": "price", "min": -100,
                                            "max": 100}
    s, out = _same(handlers, "POST", "/index/i/frame/f/field/price/import",
                   json.dumps({"columns": [1, 2, SLICE_WIDTH + 3],
                               "values": [-50, 10, 99]}))
    assert s == 200, out
    msg = dict(Index="i", Frame="f", Field="qty", Slice=0,
               ColumnIDs=[1, 2, 2], Values=[5, 7, 700])
    pbody = tpb.ImportValueRequest(**msg).SerializeToString()
    assert pbody == jpb.ImportValueRequest(**msg).SerializeToString()
    assert _same(handlers, "POST", "/index/i/frame/f/field/qty/import",
                 pbody, PB, PB)[0] == 200
    for q in ('Range(frame="f", price > 0)', 'Sum(frame="f", field="price")',
              'Max(frame="f", field="qty")', 'Min(frame="f", field="qty")',
              'Count(Range(frame="f", qty >< [6, 800]))',
              'SetFieldValue(frame="f", columnID=3, qty=1000)'
              ' Sum(frame="f", field="qty")',
              'Sum(frame="f", field="nope")'):
        for accept in ("", PB):
            _same(handlers, "POST", "/index/i/query", q, accept=accept)
    _, out = _same(handlers, "POST", "/index/i/query",
                   'Sum(frame="f", field="qty")', accept=PB)
    res = tpb.QueryResponse.FromString(out).Results[0].ValCount
    assert (res.Val, res.Count) == (1705, 3)
    _same(handlers, "GET", "/schema")
    _same(handlers, "GET", "/index/i/frame/f/views")


@pytest.mark.parametrize("method,path,body,ctype", [
    ("POST", "/index/i/frame/f/field/b", '{"min": 5, "max": 1}', ""),
    ("POST", "/index/i/frame/f/field/b", '{"bogus": 1}', ""),
    ("POST", "/index/i/frame/f/field/b", '{"min": 0, "max": 18446744073709551615}', ""),
    ("POST", "/index/i/frame/f/field/qty", '{"min": 0, "max": 3}', ""),
    ("POST", "/index/i/frame/nope/field/x", '{}', ""),
    ("POST", "/index/i/frame/nope/field/x/import", "{}", ""),
    ("POST", "/index/i/frame/f/field/nope/import",
     '{"columns": [1], "values": [1]}', ""),
    ("POST", "/index/i/frame/f/field/qty/import",
     '{"columns": [1, 2], "values": [1]}', ""),
    ("POST", "/index/i/frame/f/field/qty/import",
     '{"columns": [1], "values": [1001]}', ""),
    ("GET", "/index/i/frame/nope/fields", "", ""),
    ("POST", "/index/i/frame/f/field/qty/import", "import-target", PB),
])
def test_field_error_statuses(handlers, method, path, body, ctype):
    _same(handlers, "POST", "/index/i", "{}")
    _same(handlers, "POST", "/index/i/frame/f", json.dumps(
        {"options": {"fields": [{"name": "qty", "min": 0, "max": 1000}]}}))
    if body == "import-target":
        body = tpb.ImportValueRequest(Index="i", Frame="g", Field="qty",
                                      ColumnIDs=[1], Values=[2]
                                      ).SerializeToString()
    status, _ = _same(handlers, method, path, body, ctype, ctype)
    assert status in (400, 404, 409)

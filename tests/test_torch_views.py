"""Time views and the inverse view in the port against the JAX package.

- ``utils.timequantum``: the port's copy gives the JAX module's view
  names for every quantum over seeded times and windows.
- One seeded request sequence goes to a JAX ``Handler`` (in-process
  WSGI, its executor on the virtual CPU mesh) and to the port's
  ``Handler`` over an ``Executor(device="cpu")``: timestamped ``SetBit``
  and ``/import`` (protobuf with ``Timestamps``, raw v1 and raw v2
  positions) into a frame with a time quantum and inverse storage, a
  run of SetBits that takes the batch lane, the two time-quantum
  ``PATCH`` routes. Every answer must be the same, and each package
  must hold the same views and the same bits in every fragment.
- Then ``Count(Range(...))`` and ``Range`` over windows whose cover
  mixes Y, M, D and H views, ``Bitmap(columnID=...)`` over the inverse
  slices (row ids past the first slice), Counts of inverse leaves (over
  the column slices, as the JAX package counts them) and the errors.
"""

import datetime as dt
import io
import json

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.proto import internal_pb2 as jpb
from pilosa_tpu.server.handler import Handler as JaxHandler
from pilosa_tpu.utils import timequantum as jax_tq

from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.proto import internal as tpb
from pilosa_tpu_torch.proto import rawimport
from pilosa_tpu_torch.server.handler import Handler
from pilosa_tpu_torch.utils import timequantum as tq

PB = "application/x-protobuf"
N_SLICES = 3
N_ROWS = 12
# Row ids of the inverse frame reach past the first slice, so its
# inverse view has slices of its own.
WIDE_ROW = 2 * SLICE_WIDTH + 17
EPOCH = dt.datetime(2017, 1, 1)


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


def _rand_time(rng, days=365):
    return EPOCH + dt.timedelta(minutes=int(rng.integers(0, days * 1440)))


@pytest.mark.parametrize("q", sorted(tq.VALID_QUANTUMS))
def test_time_quantum_views_match_jax(q):
    assert tq.VALID_QUANTUMS == jax_tq.VALID_QUANTUMS
    assert tq.parse_time_quantum(q.lower()) == jax_tq.parse_time_quantum(
        q.lower())
    rng = np.random.default_rng(len(q) * 7 + sum(map(ord, q)))
    for _ in range(200):
        t = _rand_time(rng, days=800)
        for name in ("standard", "inverse"):
            assert tq.views_by_time(name, t, q) == \
                jax_tq.views_by_time(name, t, q)
        a, b = sorted((_rand_time(rng, days=800), _rand_time(rng, days=800)))
        assert tq.views_by_time_range("standard", a, b, q) == \
            jax_tq.views_by_time_range("standard", a, b, q)
    for a, b in ((EPOCH, EPOCH), (EPOCH, dt.datetime(2019, 3, 1, 5)),
                 (dt.datetime(2017, 12, 31, 23), dt.datetime(2018, 1, 1, 1)),
                 (dt.datetime(2017, 2, 28, 22), dt.datetime(2017, 3, 2, 2))):
        assert tq.views_by_time_range("standard", a, b, q) == \
            jax_tq.views_by_time_range("standard", a, b, q)


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

    body = b"".join(app(environ, start_response))
    return out, body


def _same(apps, method, path, body=b"", content_type="", accept=""):
    (jo, jb), (to, tb) = (_call(a, method, path, body, content_type, accept)
                          for a in apps)
    assert (to["status"], to["type"]) == (jo["status"], jo["type"]), \
        (path, body, tb, jb)
    if to["type"] == "application/json":
        assert json.loads(tb) == json.loads(jb), (path, body)
    else:
        assert tb == jb, (path, body)
    return to["status"], tb


def _ts(t):
    return t.strftime("%Y-%m-%dT%H:%M")


def _ns(t):
    return int((t - dt.datetime(1970, 1, 1)).total_seconds()) * 10**9


def _seed(apps, rng):
    _same(apps, "POST", "/index/i", "{}")
    _same(apps, "POST", "/index/i/frame/t",
          '{"options": {"timeQuantum": "YMDH", "inverseEnabled": true}}')
    _same(apps, "POST", "/index/i/frame/m",
          '{"options": {"timeQuantum": "MD"}}')
    _same(apps, "POST", "/index/i/frame/inv",
          '{"options": {"inverseEnabled": true}}')
    _same(apps, "POST", "/index/i/frame/plain", "{}")
    days = [int(d) for d in rng.choice(365, size=12, replace=False)]
    times = [EPOCH + dt.timedelta(days=d, hours=int(rng.integers(24)),
                                  minutes=int(rng.integers(60)))
             for d in days]
    writes = []
    for k in range(40):
        t = times[k % len(times)]
        row = int(rng.integers(N_ROWS))
        col = int(rng.integers(N_SLICES * SLICE_WIDTH))
        frame = ("t", "m")[k % 2]
        writes.append(f'SetBit(frame={frame}, rowID={row}, columnID={col},'
                      f' timestamp="{_ts(t)}")')
    writes.append(f'ClearBit(frame=t, rowID=0, columnID=5,'
                  f' timestamp="{_ts(times[0])}")')
    writes.append(f'SetBit(frame=t, rowID=3, columnID=8, view=inverse,'
                  f' timestamp="{_ts(times[1])}")')
    for q in writes:
        _same(apps, "POST", "/index/i/query", q)
    for k in range(4):  # protobuf /import with Timestamps
        n = 400
        sl = k % N_SLICES
        cols = sl * SLICE_WIDTH + rng.integers(0, 2048, size=n)
        ts = [_ns(times[int(i)]) for i in rng.integers(len(times), size=n)]
        ts[:7] = [0] * 7  # untimed bits of the same request
        msg = dict(Index="i", Frame=("t", "m")[k % 2], Slice=sl,
                   RowIDs=rng.integers(N_ROWS, size=n).tolist(),
                   ColumnIDs=cols.tolist(), Timestamps=ts)
        body = tpb.ImportRequest(**msg).SerializeToString()
        assert body == jpb.ImportRequest(**msg).SerializeToString()
        _same(apps, "POST", "/import", body, PB, PB)
    # The inverse frame: row ids past the first slice, every import form.
    rows = np.concatenate([rng.integers(N_ROWS, size=300),
                           np.full(40, WIDE_ROW)]).astype(np.uint64)
    cols = rng.integers(0, 600, size=len(rows)).astype(np.uint64) + \
        np.uint64(SLICE_WIDTH)
    msg = dict(Index="i", Frame="inv", Slice=1, RowIDs=rows.tolist(),
               ColumnIDs=cols.tolist())
    _same(apps, "POST", "/import",
          tpb.ImportRequest(**msg).SerializeToString(), PB, PB)
    _same(apps, "POST", "/import",
          rawimport.encode("i", "inv", 0, rows, cols - np.uint64(
              SLICE_WIDTH), None), rawimport.CONTENT_TYPE, PB)
    pos = np.unique(rng.integers(0, 40 * SLICE_WIDTH, size=500,
                                 dtype=np.uint64))
    _same(apps, "POST", "/import",
          rawimport.encode_positions("i", "inv", 2, pos),
          rawimport.CONTENT_TYPE, PB)
    run = " ".join(f"SetBit(frame=inv, rowID={int(r)}, columnID={int(c)})"
                   for r, c in zip(rng.integers(N_ROWS, size=12),
                                   rng.integers(0, 900, size=12)))
    run += f" SetBit(frame=inv, rowID={WIDE_ROW}, columnID=3)"
    _same(apps, "POST", "/index/i/query", run)
    run = " ".join(f"ClearBit(frame=inv, rowID={int(r)}, columnID={int(c)},"
                   f" view=inverse)" for r, c in zip(
                       rng.integers(0, 900, size=9),
                       rng.integers(N_ROWS, size=9)))
    _same(apps, "POST", "/index/i/query", run)
    _same(apps, "POST", "/index/i/query",
          "SetBit(frame=inv, rowID=4, columnID=77, view=standard)"
          " SetBit(frame=inv, rowID=5, columnID=78, view=inverse)")
    return times


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    th = Holder(str(tmp_path_factory.mktemp("port")))
    th.open()
    # The JAX result cache keys a Union/Intersect/Difference on its
    # expression's shape and its fragments' generations, not on its
    # leaves' rows: two Unions of two rows of one view share a key, and
    # the second answers the first's bits. The port has no result cache;
    # the reference runs without one here (no result fits -1 bits).
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1,
                      result_cache_bits=-1)
    pair = (JaxHandler(jh, jex, host="local"),
            Handler(th, Executor(th, device="cpu",
                                          mesh_min_slices=1)))
    times = _seed(pair, np.random.default_rng(88))
    yield pair, jh, th, times
    assert jex.device_fallbacks == 0
    jex.close()
    jh.close()
    th.close()


def _fragments(holder, port):
    return {(f.frame, f.view, f.slice):
            (f.positions() if port else f.storage.all_positions()).tolist()
            for f in holder.iter_fragments()}


def test_writes_give_the_same_views_and_bits(apps):
    _, jh, th, _ = apps
    for name in ("t", "m", "inv", "plain"):
        assert sorted(th.frame("i", name).views) == \
            sorted(jh.frame("i", name).views), name
    views = set(th.frame("i", "t").views)
    assert {"standard_2017", "inverse_2017"} <= views
    assert any(len(v) == len("standard_2017010100") for v in views)
    assert _fragments(th, True) == _fragments(jh, False)
    assert th.index("i").max_inverse_slice() == WIDE_ROW // SLICE_WIDTH
    assert th.index("i").max_slice() == N_SLICES - 1


def _windows(rng, times):
    out = [(EPOCH, dt.datetime(2018, 1, 1)), (times[0], times[0]),
           (dt.datetime(2016, 5, 1), dt.datetime(2017, 3, 1)),
           (dt.datetime(2018, 1, 1), dt.datetime(2019, 1, 1))]
    for _ in range(14):
        a, b = sorted(times[int(i)] + dt.timedelta(
            hours=int(rng.integers(-30, 30))) for i in rng.integers(
                len(times), size=2))
        out.append((a, b))
    return out


def test_range_over_time_views_matches_jax(apps):
    pair, _, _, times = apps
    rng = np.random.default_rng(89)
    covers = set()
    for a, b in _windows(rng, times):
        covers |= {len(v) for v in tq.views_by_time_range(
            "standard", a, b, "YMDH")}
        for frame in ("t", "m", "plain"):
            for row in (0, 3, int(rng.integers(N_ROWS))):
                r = (f'Range(frame={frame}, rowID={row}, start="{_ts(a)}",'
                     f' end="{_ts(b)}")')
                _same(pair, "POST", "/index/i/query", f"Count({r})")
                _same(pair, "POST", "/index/i/query", r)
        _same(pair, "POST", "/index/i/query",
              f'Count(Intersect(Range(frame=t, rowID=1, start="{_ts(a)}",'
              f' end="{_ts(b)}"), Bitmap(frame=t, rowID=2)))', accept=PB)
    # The covers mixed year, month, day and hour views.
    assert covers >= {len("standard_2017"), len("standard_201701"),
                      len("standard_20170101"), len("standard_2017010100")}


@pytest.mark.parametrize("q", [
    "Bitmap(columnID={c}, frame=inv)",
    "Count(Bitmap(columnID={c}, frame=inv))",
    "Count(Intersect(Bitmap(columnID={c}, frame=inv),"
    " Bitmap(columnID={d}, frame=inv)))",
    "Union(Bitmap(columnID={c}, frame=inv), Bitmap(columnID={d},"
    " frame=inv))",
    "Bitmap(columnID={c}, frame=t)",
    "Count(Range(frame=t, rowID={c}, start=\"2017-01-01T00:00\","
    " end=\"2018-01-01T00:00\"))",
    "TopN(Bitmap(columnID={c}, frame=inv), frame=inv, n=3)",
    "Bitmap(columnID={c}, frame=plain)",
    "Count(Bitmap(columnID={c}, frame=plain))",
    "Bitmap(columnID={c}, rowID=1, frame=inv)",
    "Bitmap(frame=inv)",
    "Bitmap(columnID={c}, frame=nope)",
    "SetBit(frame=plain, rowID=1, columnID=2, view=inverse)",
    "SetBit(frame=inv, rowID=1, columnID=2, view=other)",
    "Range(frame=t, rowID=1, start=\"2017-01-01T00:00\")",
    "Range(frame=t, rowID=1, end=\"2017-01-01T00:00\")",
    "Range(frame=t, start=\"2017-01-01T00:00\", end=\"2017-01-01T00:00\")",
    "Range(frame=t, rowID=1, start=\"yesterday\", end=\"2017-01-01T00:00\")",
    "SetBit(frame=t, rowID=1, columnID=2, timestamp=\"soon\")",
])
def test_inverse_and_range_calls_match_jax(apps, q):
    pair = apps[0]
    for c, d in ((SLICE_WIDTH + 5, SLICE_WIDTH + 17), (3, 8), (77, 78)):
        for accept in ("", PB):
            _same(pair, "POST", "/index/i/query", q.format(c=c, d=d),
                  accept=accept)


def test_bitmap_of_a_column_reads_the_inverse_slices(apps):
    pair = apps[0]
    for c in range(SLICE_WIDTH, SLICE_WIDTH + 600, 7):
        _, out = _same(pair, "POST", "/index/i/query",
                       f"Bitmap(columnID={c}, frame=inv)")
        if WIDE_ROW in json.loads(out)["results"][0]["bits"]:
            return
    raise AssertionError("no column holds the row past the first slice")


def test_time_quantum_patch_routes(apps):
    pair, _, th, _ = apps
    for path, body in (("/index/i/time-quantum", '{"timeQuantum": "YM"}'),
                       ("/index/i/frame/plain/time-quantum",
                        '{"timeQuantum": "D"}'),
                       ("/index/i/frame/plain/time-quantum",
                        '{"timeQuantum": "X"}'),
                       ("/index/nope/time-quantum", '{"timeQuantum": "Y"}'),
                       ("/index/i/frame/nope/time-quantum",
                        '{"timeQuantum": "Y"}')):
        _same(pair, "PATCH", path, body)
    assert th.index("i").time_quantum() == "YM"
    assert th.frame("i", "plain").time_quantum() == "D"
    q = 'SetBit(frame=plain, rowID=1, columnID=2, timestamp="2017-04-05T06:07")'
    _same(pair, "POST", "/index/i/query", q)
    assert "standard_20170405" in th.frame("i", "plain").views
    _same(pair, "POST", "/index/i/query",
          'Count(Range(frame=plain, rowID=1, start="2017-04-05T00:00",'
          ' end="2017-04-06T00:00"))')
    _same(pair, "POST", "/index/i/frame/later", "{}")
    _same(pair, "GET", "/schema")


@pytest.mark.parametrize("q", [
    "Count(Union(Bitmap(columnID=77, frame=inv)))",
    "Count(Intersect(Bitmap(columnID=78, frame=inv),"
    " Bitmap(columnID=77, frame=inv)))",
    "Count(Union(Range(frame=t, rowID=99, start=\"2017-01-01T00:00\","
    " end=\"2018-01-01T00:00\"), Bitmap(columnID=78, frame=inv)))",
    "Count(Intersect(Range(frame=t, rowID=1, start=\"2017-01-01T00:00\","
    " end=\"2018-01-01T00:00\"), Bitmap(columnID=78, frame=t)))",
])
def test_planner_keeps_range_and_inverse_leaves_opaque(apps, q):
    """The standard rows 77, 78 and 99 are empty: a plan that estimated
    an inverse leaf or a Range from the standard view would prove these
    trees empty, or drop an operand, and could answer 0."""
    pair = apps[0]
    plan = pair[1].executor.explain("i", q)
    assert "short_circuit" not in plan.get("decisions", {})
    _same(pair, "POST", "/index/i/query", q)

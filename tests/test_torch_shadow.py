"""The north-star check: the port's HTTP answers against a JAX server's
on a captured workload.

A JAX ``Holder`` writes a data directory (LRU and ranked TopN frames
with row attributes, and a source frame) and closes it; the directory
is copied. A ``pilosa_tpu`` ``Server`` with workload capture on
(``CaptureConfig(mode="full")``) serves the original, a
``pilosa_tpu_torch`` ``Server(device="cpu")`` the copy. The workload
the port serves goes to both — SetBit/ClearBit, SetRowAttrs and
SetColumnAttrs queries, protobuf ``/import``, Count trees of
Intersect/Union/Difference, every TopN form of
``tests/test_torch_topn.py``, Bitmap calls, and the query whose
proven-empty branch beside a missing frame the JAX planner answers
with 0; and on two frames the test adds (a BSI field, a time quantum
with inverse storage) SetFieldValue, the protobuf field import,
timestamped SetBit and ``/import``, time and field ``Range``, ``Sum``,
``Min``, ``Max`` and ``Bitmap(columnID=...)``. Then ``pilosa_tpu.obs.replay.shadow`` replays the JAX server's
captured records against both: every write again, in recorded order,
then every read, whose result digests must match.

``shadow`` drops every pair where either side is not 200, so the test
also requires that it compared exactly as many reads as the capture
recorded: a port 400 cannot pass unseen.
"""

import shutil
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import replay as obs_replay
from pilosa_tpu.proto import internal_pb2 as jax_pb
from pilosa_tpu.server.server import Server as JaxServer
from pilosa_tpu.utils.config import CaptureConfig

from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.server.server import Server as PortServer

from test_torch_topn import FORMS, N_ROWS, N_SLICES, _fill_jax

# Frames the workload writes to: LRU caches only. A rank cache re-ranks
# on a write at most every 10 s of wall time, so two servers opened a
# moment apart could rank the same writes differently.
WRITE_FRAMES = ("f", "fs", "src")
TOPN_FRAMES = ("f", "fr", "fs", "frs")


def _post(host, path, body, headers=None, timeout=60):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _rand_tree(rng, depth):
    if depth == 0 or rng.random() < 0.35:
        frame = rng.choice(["f", "fs", "fr", "src"])
        return f"Bitmap(rowID={int(rng.integers(N_ROWS + 6))}, frame={frame})"
    op = rng.choice(["Intersect", "Union", "Difference"])
    k = int(rng.integers(2, 4))
    return (f"{op}(" + ", ".join(_rand_tree(rng, depth - 1)
                                 for _ in range(k)) + ")")


def _import_body(rng, frame, n):
    cols = rng.integers(N_SLICES * SLICE_WIDTH, size=n)
    slice_ = int(cols[0]) // SLICE_WIDTH
    cols = slice_ * SLICE_WIDTH + cols % SLICE_WIDTH
    rows = rng.integers(N_ROWS + 4, size=n)
    return jax_pb.ImportRequest(Index="d", Frame=frame, Slice=slice_,
                                RowIDs=rows.tolist(),
                                ColumnIDs=cols.tolist()
                                ).SerializeToString()


def _ts(day, hour):
    return (f"2017-{1 + day // 28:02d}-{1 + day % 28:02d}T{hour:02d}:"
            f"{(day * 7) % 60:02d}")


def _ns(day, hour):
    import datetime as dt
    t = dt.datetime(2017, 1 + day // 28, 1 + day % 28, hour, (day * 7) % 60)
    return int((t - dt.datetime(1970, 1, 1)).total_seconds()) * 10**9


def _views_workload(rng):
    """Steps on the frames ``bsi`` (field ``amt``) and ``tq`` (time
    quantum YMD, inverse storage): ("query", pql), ("import", body) or
    ("field_import", body)."""
    steps = []
    n_cols = N_SLICES * SLICE_WIDTH
    for i in range(20):
        steps.append(("query", f"SetFieldValue(frame=bsi,"
                               f" columnID={int(rng.integers(n_cols))},"
                               f" amt={int(rng.integers(-100, 5001))})"))
        day, hour = int(rng.integers(300)), int(rng.integers(24))
        steps.append(("query", f"SetBit(frame=tq, rowID={i % 7},"
                               f" columnID={int(rng.integers(n_cols))},"
                               f' timestamp="{_ts(day, hour)}")'))
    for s in range(N_SLICES):
        cols = s * SLICE_WIDTH + rng.choice(SLICE_WIDTH, 400, replace=False)
        steps.append(("field_import", jax_pb.ImportValueRequest(
            Index="d", Frame="bsi", Field="amt", Slice=s,
            ColumnIDs=cols.tolist(),
            Values=rng.integers(-100, 5001, 400).tolist()
        ).SerializeToString()))
        days = rng.integers(300, size=500)
        hours = rng.integers(24, size=500)
        steps.append(("import", jax_pb.ImportRequest(
            Index="d", Frame="tq", Slice=s,
            RowIDs=rng.integers(7, size=500).tolist(),
            ColumnIDs=(s * SLICE_WIDTH + rng.integers(
                SLICE_WIDTH, size=500)).tolist(),
            Timestamps=[_ns(int(d), int(h)) for d, h in zip(days, hours)]
        ).SerializeToString()))
    steps.append(("query", "SetBit(frame=tq, rowID=3, columnID=11)"))
    reads = [
        "Count(Range(frame=bsi, amt > 100))",
        "Count(Range(frame=bsi, amt >< [-50, 2500]))",
        "Count(Range(frame=bsi, amt == 7))",
        "Count(Range(frame=bsi, amt != 7))",
        "Range(frame=bsi, amt < -90)",
        "Sum(frame=bsi, field=amt)", "Min(frame=bsi, field=amt)",
        "Max(frame=bsi, field=amt)",
        "Sum(Bitmap(frame=tq, rowID=2), frame=bsi, field=amt)",
        "Max(Range(frame=tq, rowID=1, start=\"2017-01-01T00:00\","
        " end=\"2017-07-01T00:00\"), frame=bsi, field=amt)",
        "Bitmap(columnID=11, frame=tq)",
        "Count(Bitmap(columnID=11, frame=tq))",
    ]
    for _ in range(8):
        a, b = sorted(int(d) for d in rng.integers(300, size=2))
        r = int(rng.integers(7))
        rq = (f'Range(frame=tq, rowID={r}, start="{_ts(a, 3)[:-3]}:00",'
              f' end="{_ts(b, 20)[:-3]}:00")')
        reads += [f"Count({rq})", rq]
    steps += [("query", q) for q in reads]
    return steps


def _workload(rng):
    """(kind, payload) steps: ("query", pql), ("import", body) or
    ("field_import", body)."""
    steps = []
    for i in range(60):
        frame = WRITE_FRAMES[i % 3]
        row, col = int(rng.integers(N_ROWS + 4)), int(
            rng.integers(N_SLICES * SLICE_WIDTH))
        op = "ClearBit" if i % 4 == 3 else "SetBit"
        steps.append(("query", f'{op}(frame="{frame}", rowID={row},'
                               f' columnID={col})'))
        if i % 10 == 0:
            steps.append(("import", _import_body(rng, frame, 300)))
        if i % 15 == 0:
            steps.append(("query", f'SetRowAttrs(frame="{frame}",'
                                   f' rowID={row}, cat={i % 3})'))
            steps.append(("query", f'SetColumnAttrs(id={col},'
                                   f' region="r{i}")'))
    # Reads after the writes (shadow replays reads after every write).
    steps.append(("query", 'SetBit(frame="f", rowID=1, columnID=3)'))
    steps.append(("query", 'Count(Intersect(Bitmap(rowID=77, frame="f"),'
                           ' Bitmap(rowID=1, frame="nope")))'))
    for _ in range(30):
        steps.append(("query", f"Count({_rand_tree(rng, 3)})"))
    for frame in TOPN_FRAMES:
        for name, form in FORMS.items():
            if name == "tanimoto101":
                continue  # a 400 in both: shadow compares only 200s
            steps.append(("query", form.format(F=frame)))
    for q in ('Bitmap(rowID=1, frame="src")', 'Bitmap(rowID=3, frame="f")',
              'Union(Bitmap(rowID=2, frame="src"), '
              'Bitmap(rowID=5, frame="fs"))',
              'Intersect(Bitmap(rowID=1, frame="f"), Union())'):
        steps.append(("query", q))
    return steps + _views_workload(rng)


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


def test_port_answers_the_captured_workload(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jh = JaxHolder(str(jax_dir))
    jh.open()
    _fill_jax(jh, np.random.default_rng(606))
    jh.close()
    shutil.copytree(jax_dir, port_dir)

    js = JaxServer(str(jax_dir), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0,
                   capture_config=CaptureConfig(mode="full"))
    js.open()
    ps = PortServer(str(port_dir), host="127.0.0.1:0", device="cpu")
    try:
        ps.open()
        steps = _workload(np.random.default_rng(607))
        proto = {"Content-Type": "application/x-protobuf",
                 "Accept": "application/x-protobuf"}
        for host in (js.host, ps.host):
            for path, body in (
                    ("/index/d/frame/bsi", b'{"options": {"fields": [{"name":'
                                           b' "amt", "min": -100, "max":'
                                           b' 5000}]}}'),
                    ("/index/d/frame/tq", b'{"options": {"timeQuantum": "YMD",'
                                          b' "inverseEnabled": true}}')):
                assert _post(host, path, body)[0] == 200
        for kind, payload in steps:
            for host in (js.host, ps.host):
                if kind == "import":
                    assert _post(host, "/import", payload, proto)[0] == 200
                elif kind == "field_import":
                    assert _post(host, "/index/d/frame/bsi/field/amt/import",
                                 payload, proto)[0] == 200
                else:
                    status, _ = _post(host, "/index/d/query",
                                      payload.encode())
                    assert status == 200, (host, payload)
        records = obs_replay.fetch_records(js.host, limit=100000)
        queries = [r for r in records if r.get("kind") == "query"]
        reads = [r for r in queries if r.get("lane") == "read"]
        writes = [r for r in queries if r.get("lane") != "read"]
        n_query_steps = sum(1 for k, _ in steps if k == "query")
        assert len(queries) == n_query_steps
        assert len(reads) > 100 and len(writes) > 60

        out = obs_replay.shadow(records, js.host, ps.host, senders=1)
        assert out["writes_replayed"] == len(writes)
        assert out["mismatches"] == 0, out["dumps"][:2]
        assert out["reads_compared"] == len(reads)
    finally:
        ps.close()
        js.close()

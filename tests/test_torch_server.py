"""The port's one-node HTTP server against the JAX package's handler.

One seeded request sequence goes to a JAX ``Handler`` (in-process WSGI,
as tests/test_handler.py drives it, its executor on the CPU) and to the
port's ``Handler`` over an ``Executor(device="cpu")``. Each answer must
have the same status, the same JSON (parsed), the same protobuf bytes
and the same plain-text error. Then the port alone: a real-socket
``Server`` (pipelined requests on one connection), a write seen by the
next Count through the residency keys, the calls this slice refuses,
and the ``server`` verb in a subprocess.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.proto import internal_pb2 as jpb
from pilosa_tpu.proto import rawimport as jax_rawimport
from pilosa_tpu.server.handler import Handler as JaxHandler

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import cuda_kernels
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.proto import internal as tpb
from pilosa_tpu_torch.proto import rawimport
from pilosa_tpu_torch.server.handler import Handler
from pilosa_tpu_torch.server.server import Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = "application/x-protobuf"
N_SLICES = 3
NARROW = 4096  # the columns of a slice that the seeded rows use


def call(app, method, path, body=b"", content_type="", accept=""):
    """Invoke a WSGI app in-process → (status, content type, body)."""
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

    chunks = app(environ, start_response)
    return out["status"], out["type"], b"".join(chunks)


@pytest.fixture
def pair(tmp_path):
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "torch"))
    th.open()
    yield (JaxHandler(jh, JaxExecutor(jh, host="local")),
           Handler(th, Executor(th, device="cpu")))
    jh.close()
    th.close()
    residency.device_cache().clear()


def same(pair, method, path, body=b"", content_type="", accept="",
         decode=None):
    """Send one request to both handlers; require the same answer.
    ``decode`` compares a protobuf body after decoding (a map field has
    no defined order on the wire)."""
    jax_handler, handler = pair
    want = call(jax_handler, method, path, body, content_type, accept)
    got = call(handler, method, path, body, content_type, accept)
    assert got[0] == want[0], (method, path, body, got, want)
    assert got[1] == want[1], (method, path, got[1], want[1])
    if got[1] == "application/json":
        assert json.loads(got[2]) == json.loads(want[2]), (path, body)
    elif decode is not None:
        assert decode(got[2]) == decode(want[2]), (path, body)
    else:
        assert got[2] == want[2], (method, path, body, got[2], want[2])
    return got


def _import_request(rng, frame, slice, rows):
    cols = rng.choice(NARROW, size=len(rows), replace=False)
    msg = dict(Index="i", Frame=frame, Slice=slice, RowIDs=list(rows),
               ColumnIDs=[int(c) + slice * SLICE_WIDTH for c in cols])
    body = tpb.ImportRequest(**msg).SerializeToString()
    assert body == jpb.ImportRequest(**msg).SerializeToString()
    return body


def _seed(pair, rng):
    """Schema and data through the HTTP routes, each answer compared."""
    same(pair, "POST", "/index/i", "{}")
    same(pair, "POST", "/index/j",
         '{"options": {"columnLabel": "col", "timeQuantum": "YM"}}')
    same(pair, "POST", "/index/i/frame/f", "{}")
    same(pair, "POST", "/index/i/frame/g",
         '{"options": {"rowLabel": "r", "cacheType": "ranked",'
         ' "cacheSize": 5000}}')
    same(pair, "POST", "/index/i/frame/t", "{}")
    same(pair, "POST", "/index/j/frame/v",
         '{"options": {"fields": [{"name": "n", "min": -5, "max": 90}]}}')
    for slice in range(N_SLICES):  # protobuf form, rows 0-5 of f
        rows = rng.integers(0, 6, size=300)
        same(pair, "POST", "/import", _import_request(rng, "f", slice, rows),
             PB, PB)
    for slice in (0, 2):  # raw v2 positions into g
        pos = np.unique(rng.integers(0, 4 * SLICE_WIDTH, size=500,
                                     dtype=np.uint64))
        body = rawimport.encode_positions("i", "g", slice, pos)
        assert body == jax_rawimport.encode_positions("i", "g", slice, pos)
        same(pair, "POST", "/import", body, rawimport.CONTENT_TYPE, PB)
    rows = rng.integers(0, 40, size=6000).astype(np.uint64)  # raw v1 into t
    cols = (rng.integers(0, NARROW, size=6000, dtype=np.uint64)
            + rng.integers(0, N_SLICES, size=6000).astype(np.uint64)
            * np.uint64(SLICE_WIDTH))
    same(pair, "POST", "/import",
         rawimport.encode("i", "t", 0, rows, cols, None),
         rawimport.CONTENT_TYPE, rawimport.CONTENT_TYPE)


def test_schema_and_import_routes(pair):
    rng = np.random.default_rng(11)
    _seed(pair, rng)
    for path in ("/schema", "/index", "/index/i", "/index/j", "/hosts",
                 "/version", "/slices/max", "/slices/max?inverse=true",
                 "/index/i/frame/f/views", "/index/i/frame/g/views"):
        same(pair, "GET", path)
    same(pair, "GET", "/slices/max", accept=PB,
         decode=lambda b: tpb.MaxSlicesResponse.FromString(b).MaxSlices)
    for slice in range(N_SLICES + 1):
        same(pair, "GET", f"/export?index=i&frame=f&view=standard&slice="
             f"{slice}", accept="text/csv")
    same(pair, "GET", "/export?index=i&frame=g&view=standard&slice=2",
         accept="text/csv")


def test_query_routes(pair):
    rng = np.random.default_rng(12)
    _seed(pair, rng)
    q = lambda body, *a, **k: same(  # noqa: E731
        pair, "POST", "/index/i/query", body, *a, **k)
    for accept in ("", PB):
        q("SetBit(frame=f, rowID=1, columnID=5) SetBit(frame=f, rowID=1,"
          " columnID=5) ClearBit(frame=f, rowID=3, columnID=9)"
          f" SetBit(frame=g, r=2, columnID={2 * SLICE_WIDTH + 7})",
          accept=accept)
    q("SetRowAttrs(frame=f, rowID=1, name=\"one\", score=-7, on=true)"
      " SetRowAttrs(frame=t, rowID=3, category=0)"
      " SetRowAttrs(frame=t, rowID=5, category=1, w=2.5)"
      " SetRowAttrs(frame=t, rowID=7, category=2)"
      " SetRowAttrs(frame=t, rowID=9, category=1)")
    q("SetRowAttrs(frame=f, rowID=1, score=null) SetBit(frame=f, rowID=2,"
      " columnID=11) SetRowAttrs(frame=f, rowID=2, x=\"y\")")
    q("SetColumnAttrs(id=5, city=\"Austin\") SetColumnAttrs(columnID=11,"
      " n=3)")
    reads = [
        "Bitmap(rowID=1, frame=f)", "Bitmap(rowID=2, frame=f)",
        "Bitmap(r=2, frame=g)",
        "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2,"
        " frame=f)))",
        "Count(Union(Bitmap(rowID=1, frame=f), Bitmap(r=2, frame=g),"
        " Bitmap(rowID=4, frame=f)))",
        "Count(Difference(Bitmap(rowID=0, frame=f), Bitmap(rowID=1,"
        " frame=f)))",
        "Count(Bitmap(rowID=99, frame=f))",
        "TopN(Bitmap(rowID=1, frame=f), frame=t, n=5, ids=[3,5,7,9,11])",
        "TopN(Bitmap(rowID=1, frame=f), frame=t, n=5, ids=[3,5,7,9,11],"
        " field=\"category\", filters=[1, 2])",
        "TopN(Bitmap(rowID=1, frame=f), frame=t, n=5, ids=[3,5,7],"
        " field=\"category\", filters=[9])",
        "Count(Bitmap(rowID=1, frame=f)) Bitmap(rowID=0, frame=f)"
        " TopN(Union(Bitmap(rowID=0, frame=f), Bitmap(rowID=5, frame=f)),"
        " frame=t, ids=[1,2,3,4])",
        # Every TopN form over the count caches of frame t.
        "TopN(frame=t, n=3)", "TopN(frame=t)",
        "TopN(frame=t, n=5, field=\"category\", filters=[1, 2])",
        "TopN(Bitmap(rowID=1, frame=f), frame=t, n=4)",
        "TopN(Bitmap(rowID=1, frame=f), frame=t, n=4, threshold=2)",
        "TopN(Bitmap(rowID=1, frame=f), frame=t, tanimotoThreshold=5)",
    ]
    for body in reads:
        for accept in ("", PB):
            q(body, accept=accept)
            q(body + f" SetBit(frame=f, rowID=0, columnID={int(rng.integers(N_SLICES * SLICE_WIDTH))})",
              accept=accept)
    for accept in ("", PB):
        same(pair, "POST", "/index/i/query?columnAttrs=true",
             "Bitmap(rowID=1, frame=f) Bitmap(rowID=2, frame=f)",
             accept=accept)
        same(pair, "POST", "/index/i/query?slices=0,2",
             "Count(Bitmap(rowID=1, frame=f))", accept=accept)
        req = tpb.QueryRequest(Query="Bitmap(rowID=2, frame=f)", Slices=[0, 1],
                               ColumnAttrs=True).SerializeToString()
        same(pair, "POST", "/index/i/query", req, PB, accept)


def _rand_tree(rng, depth):
    if depth == 0 or rng.random() < 0.35:
        if rng.random() < 0.3:
            return f"Bitmap(r={int(rng.integers(4))}, frame=g)"
        return f"Bitmap(rowID={int(rng.integers(7))}, frame=f)"
    op = rng.choice(["Intersect", "Union", "Difference"])
    return (f"{op}(" + ", ".join(_rand_tree(rng, depth - 1)
                                 for _ in range(int(rng.integers(2, 4))))
            + ")")


@pytest.mark.parametrize("seed", [1, 2])
def test_random_queries(pair, seed):
    """Seeded Count trees, TopNs and bitmap calls, JSON and protobuf."""
    rng = np.random.default_rng(100 + seed)
    _seed(pair, rng)
    for _ in range(10):
        tree = _rand_tree(rng, 3)
        ids = sorted(rng.choice(40, size=int(rng.integers(1, 12)),
                                replace=False).tolist())
        for body in (f"Count({tree})", tree,
                     f"TopN({tree}, frame=t, ids={ids})"):
            for accept in ("", PB):
                same(pair, "POST", "/index/i/query", body, accept=accept)


def test_attr_diff_and_deletes(pair):
    _seed(pair, np.random.default_rng(13))
    same(pair, "POST", "/index/i/query",
         "SetRowAttrs(frame=f, rowID=1, a=1) SetRowAttrs(frame=f,"
         " rowID=250, b=\"x\")")
    same(pair, "POST", "/index/i/query", "SetColumnAttrs(id=3, c=true)")
    for path in ("/index/i/attr/diff", "/index/i/frame/f/attr/diff",
                 "/index/nope/attr/diff", "/index/i/frame/nope/attr/diff"):
        same(pair, "POST", path, '{"blocks": []}')
    same(pair, "POST", "/index/i/frame/f/attr/diff",
         '{"blocks": [{"id": 0, "checksum": "AAAA"}]}')
    same(pair, "DELETE", "/index/i/frame/g")
    same(pair, "DELETE", "/index/nope/frame/g")
    same(pair, "GET", "/schema")
    same(pair, "POST", "/index/i/query", "Count(Bitmap(r=1, frame=g))")
    same(pair, "DELETE", "/index/i")
    same(pair, "GET", "/schema")
    same(pair, "GET", "/slices/max")
    same(pair, "POST", "/index/i/query", "Count(Bitmap(rowID=1, frame=f))")


def test_errors(pair):
    _seed(pair, np.random.default_rng(14))
    for method, path, body, ctype, accept in [
        ("POST", "/index/i", "{}", "", ""),                     # 409
        ("POST", "/index/i/frame/f", "{}", "", ""),             # 409
        ("POST", "/index/nope/frame/f", "{}", "", ""),          # 404
        ("POST", "/index/Bad!", "{}", "", ""),                  # 400
        ("POST", "/index/k", '{"foo": 1}', "", ""),
        ("POST", "/index/k", '{"options": {"bogus": 1}}', "", ""),
        ("POST", "/index/k", '{"options": 3}', "", ""),
        ("POST", "/index/k", "{not json", "", ""),
        ("POST", "/index/k", '{"options": {"timeQuantum": "XX"}}', "", ""),
        ("POST", "/index/i/frame/h", '{"options": {"cacheType": "x"}}',
         "", ""),
        ("POST", "/index/i/frame/h", '{"options": {"fields": 3}}', "", ""),
        ("POST", "/index/i/frame/h",
         '{"options": {"fields": [{"name": "n", "max": -1}]}}', "", ""),
        ("GET", "/index/nope", "", "", ""),                      # 404
        ("GET", "/index/i/frame/nope/views", "", "", ""),
        ("GET", "/nope", "", "", ""),                            # 404
        ("GET", "/import", "", "", ""),                          # 405
        ("PUT", "/index/i", "", "", ""),                         # 405
        ("POST", "/import", b"x", "text/plain", PB),            # 415
        ("POST", "/import", b"x", PB, "application/json"),      # 406
        ("GET", "/export?index=i&frame=f&view=standard&slice=0", "", "",
         "application/json"),                                    # 406
        ("GET", "/export?index=i&frame=f&view=standard", "", "",
         "text/csv"),                                            # 400
        ("POST", "/index/i/query", "Count(Bitmap(rowID=1, frame=nope))",
         "", ""),
        ("POST", "/index/i/query", "Count(Bitmap(rowID=1, frame=nope))",
         "", PB),
        ("POST", "/index/i/query", "Bitmap(rowID=1", "", ""),
        ("POST", "/index/i/query", "Bitmap(rowID=1", "", PB),
        ("POST", "/index/nope/query", "Count(Bitmap(rowID=1, frame=f))",
         "", ""),
        ("POST", "/index/i/query?slices=0,x", "Count(Bitmap(rowID=1,"
         " frame=f))", "", ""),
        ("POST", "/index/i/query", "SetRowAttrs(rowID=1, a=1)", "", ""),
        ("POST", "/index/i/query", "SetRowAttrs(frame=f, a=1)", "", PB),
        ("POST", "/index/i/query", "SetColumnAttrs(a=1)", "", ""),
        ("POST", "/index/i/query", "SetBit(frame=f, rowID=1)", "", ""),
    ]:
        same(pair, method, path, body, ctype, accept)
    # Import bodies that reach the decoder.
    same(pair, "POST", "/import", tpb.ImportRequest(
        Index="nope", Frame="f", RowIDs=[1], ColumnIDs=[2])
        .SerializeToString(), PB, PB)                            # 404
    same(pair, "POST", "/import", tpb.ImportRequest(
        Index="i", Frame="nope", RowIDs=[1], ColumnIDs=[2])
        .SerializeToString(), PB, PB)                            # 404
    same(pair, "POST", "/import", tpb.ImportRequest(
        Index="i", Frame="f", RowIDs=[1, 2], ColumnIDs=[2])
        .SerializeToString(), PB, PB)                            # 400
    same(pair, "POST", "/import", b"PRAW\x09", rawimport.CONTENT_TYPE,
         PB)                                                     # 400
    unsorted = np.array([5, 3], np.uint64)
    same(pair, "POST", "/import", rawimport.encode_positions(
        "i", "f", 0, unsorted), rawimport.CONTENT_TYPE, PB)     # 400


# -- the port alone -----------------------------------------------------------

@pytest.fixture
def server(tmp_path):
    srv = Server(str(tmp_path / "data"), host="127.0.0.1:0", device="cpu")
    srv.open()
    yield srv
    srv.close()
    residency.device_cache().clear()


def http(srv, method, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{srv.host}{path}", data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_socket_and_pipelining(server):
    assert server.host.startswith("127.0.0.1:") and \
        not server.host.endswith(":0")
    assert http(server, "POST", "/index/i", b"{}")[0] == 200
    assert http(server, "POST", "/index/i/frame/f", b"{}")[0] == 200
    body = tpb.ImportRequest(Index="i", Frame="f", RowIDs=[1, 1, 2],
                             ColumnIDs=[3, SLICE_WIDTH + 4, 3])
    status, out = http(server, "POST", "/import", body.SerializeToString(),
                       {"Content-Type": PB, "Accept": PB})
    assert (status, out) == (200, b"")
    status, out = http(server, "GET", "/status")
    got = json.loads(out)
    assert status == 200 and got["status"] == {"nodes": [
        {"host": server.host, "state": "UP", "indexes": [
            {"name": "i", "maxSlice": 1, "slices": [0, 1],
             "frames": [{"name": "f"}]}]}]}
    # The JAX build, warmup and runtime blocks: no kernel to warm on
    # the CPU; the collector counts the two fragments written above.
    assert set(got) == {"status", "build", "warmup", "runtime"}
    assert got["warmup"]["state"] == "disabled"
    assert got["build"]["jax"] == "unloaded"
    assert got["runtime"]["holder"]["fragments"] == 2
    assert json.loads(http(server, "GET", "/hosts")[1]) == [
        {"host": server.host, "internalHost": ""}]
    # Three requests pipelined on one connection, answered in order.
    q = b"Count(Bitmap(rowID=1, frame=f))"
    raw = b"".join(
        b"POST /index/i/query HTTP/1.1\r\nHost: x\r\nContent-Length: "
        + str(len(q)).encode() + b"\r\n\r\n" + q for _ in range(2))
    raw += b"GET /version HTTP/1.1\r\nConnection: close\r\n\r\n"
    host, port = server.host.split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(raw)
        got = b""
        while chunk := s.recv(65536):
            got += chunk
    parts = got.split(b"HTTP/1.1 200 OK\r\n")
    assert len(parts) == 4 and parts[0] == b""
    assert parts[1].endswith(b'{"results": [2]}\n')
    assert parts[2].endswith(b'{"results": [2]}\n')
    assert b'"version"' in parts[3]


def test_write_then_count_over_http(server):
    http(server, "POST", "/index/i", b"{}")
    http(server, "POST", "/index/i/frame/f", b"{}")
    q = b"Count(Bitmap(rowID=1, frame=f))"
    assert http(server, "POST", "/index/i/query", q)[1] == \
        b'{"results": [0]}\n'
    http(server, "POST", "/index/i/query",
         f"SetBit(frame=f, rowID=2, columnID=0) SetBit(frame=f, rowID=2,"
         f" columnID={SLICE_WIDTH})".encode())
    for n, col in enumerate((7, 8, SLICE_WIDTH + 9), 1):
        frag = server.holder.fragment("i", "f", "standard",
                                      col // SLICE_WIDTH)
        key = (frag.device.uid, frag.device.generation)
        status, out = http(server, "POST", "/index/i/query",
                           f"SetBit(frame=f, rowID=1, columnID={col})"
                           .encode())
        assert (status, out) == (200, b'{"results": [true]}\n')
        assert (frag.device.uid, frag.device.generation) != key
        # The next Count sees the write: the fragment's (uid,
        # generation) is part of the resident slab's key.
        assert json.loads(http(server, "POST", "/index/i/query", q)[1]) == \
            {"results": [n]}
    assert cuda_kernels.LAUNCHES == {k: 0 for k in cuda_kernels.LAUNCHES}


def test_calls_of_later_slices_answer_400(server):
    """Calls an earlier slice refused with a 400 answer 200 now: writes
    to an inverse frame and to time views, a Bitmap of a column, and
    timestamped and inverse ``/import`` in both wire forms."""
    http(server, "POST", "/index/i", b"{}")
    http(server, "POST", "/index/i/frame/inv",
         b'{"options": {"inverseEnabled": true}}')
    http(server, "POST", "/index/i/frame/tq",
         b'{"options": {"timeQuantum": "YMD"}}')
    for q, want in ((b"SetBit(frame=inv, rowID=1, columnID=2)",
                     b'{"results": [true]}\n'),
                    (b"Bitmap(columnID=2, frame=inv)",
                     b'{"results": [{"attrs": {}, "bits": [1]}]}\n'),
                    (b"SetBit(frame=tq, rowID=1, columnID=2,"
                     b" timestamp=\"2017-01-02T03:04\")",
                     b'{"results": [true]}\n')):
        status, out = http(server, "POST", "/index/i/query", q)
        assert (status, out) == (200, want)
    body = tpb.ImportRequest(Index="i", Frame="tq", RowIDs=[1], ColumnIDs=[3],
                             Timestamps=[10**18]).SerializeToString()
    status, out = http(server, "POST", "/import", body,
                       {"Content-Type": PB, "Accept": PB})
    assert status == 200
    status, out = http(server, "POST", "/import", rawimport.encode(
        "i", "inv", 0, np.array([1], np.uint64), np.array([5], np.uint64),
        None), {"Content-Type": rawimport.CONTENT_TYPE, "Accept": PB})
    assert status == 200
    status, out = http(server, "POST", "/index/i/query",
                       b"Bitmap(columnID=5, frame=inv)"
                       b" Count(Range(frame=tq, rowID=1,"
                       b" start=\"2001-09-09T00:00\","
                       b" end=\"2001-09-10T00:00\"))")
    assert json.loads(out) == {"results": [{"attrs": {}, "bits": [1]}, 1]}
    assert sorted(server.holder.frame("i", "tq").views) == [
        "standard", "standard_2001", "standard_200109", "standard_20010909",
        "standard_2017", "standard_201701", "standard_20170102"]
    # Untimed writes to the time-quantum frame land in its standard view.
    assert http(server, "POST", "/index/i/query",
                b"SetBit(frame=tq, rowID=1, columnID=4)")[0] == 200


@pytest.mark.parametrize("stop", [signal.SIGINT, signal.SIGTERM])
def test_server_verb_subprocess(tmp_path, stop):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--device",
         "cpu", "-d", str(tmp_path / "d"), "-b", f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line == (f"pilosa-tpu serving at http://127.0.0.1:{port}"
                        f" (data: {tmp_path / 'd'})\n"), proc.stderr.read()
        base = f"http://127.0.0.1:{port}"
        for path, body in (("/index/i", b"{}"), ("/index/i/frame/f", b"{}"),
                           ("/index/i/query",
                            b"SetBit(frame=f, rowID=3, columnID=4)")):
            urllib.request.urlopen(urllib.request.Request(
                base + path, data=body, method="POST"), timeout=30).read()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/index/i/query", data=b"Bitmap(rowID=3, frame=f)",
                method="POST"), timeout=30) as resp:
            assert json.loads(resp.read()) == {
                "results": [{"attrs": {}, "bits": [4]}]}
    finally:
        proc.send_signal(stop)
        assert proc.wait(timeout=30) == 0
        proc.stdout.close()
        proc.stderr.close()
    # Closed cleanly: the bit is in the fragment file.
    holder = Holder(str(tmp_path / "d"))
    holder.open()
    assert holder.fragment("i", "f", "standard", 0).row(3).bits().tolist() \
        == [4]
    holder.close()


def test_server_verb_without_a_card_exits_nonzero(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine with one
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d",
         str(tmp_path / "d"), "-b", "127.0.0.1:0"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=60)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and out.stdout == ""


def test_concurrent_clients_lose_no_write(server):
    """More client threads than cores, each on its own connection,
    interleave SetBit and Count through one server: every write lands
    and the final Count sees all of them."""
    import threading
    import time

    http(server, "POST", "/index/i", b"{}")
    http(server, "POST", "/index/i/frame/f", b"{}")
    n_threads, per_thread = 2 * (os.cpu_count() or 2) + 2, 12
    errors = []

    def client(t):
        try:
            for k in range(per_thread):
                col = (t * per_thread + k) * 37 % (2 * SLICE_WIDTH)
                status, out = http(
                    server, "POST", "/index/i/query",
                    f"SetBit(frame=f, rowID=1, columnID={col})"
                    " Count(Bitmap(rowID=1, frame=f))".encode())
                assert status == 200, out
                changed, count = json.loads(out)["results"]
                assert changed is True and count >= 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 120
        for th in threads:
            th.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    status, out = http(server, "POST", "/index/i/query",
                       b"Count(Bitmap(rowID=1, frame=f))")
    assert json.loads(out) == {"results": [n_threads * per_thread]}


def test_open_on_a_port_in_use_releases_the_holder(tmp_path):
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        port = busy.getsockname()[1]
        srv = Server(str(tmp_path / "d"), host=f"127.0.0.1:{port}",
                     device="cpu")
        with pytest.raises(OSError):
            srv.open()
        assert srv.holder is None
    srv = Server(str(tmp_path / "d"), host="127.0.0.1:0", device="cpu")
    srv.open()
    try:
        assert http(srv, "POST", "/index/i", b"{}")[0] == 200
    finally:
        srv.close()

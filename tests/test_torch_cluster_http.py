"""The port's static cluster over real sockets, on the CPU.

1. Three port nodes (``python -m pilosa_tpu_torch.cli server --device
   cpu --cluster.type http --cluster.replicas 2``, subprocesses) take a
   seeded stream of schema calls, writes (SetBit/ClearBit through every
   coordinator, SetFieldValue, attributes, protobuf and raw ``/import``
   through the cluster client) and answer its reads — Count trees, TopN
   forms, Bitmap with attributes, a field Range, Sum/Min/Max, a time
   Range — from every coordinator exactly as one ``pilosa_tpu`` node
   answers the same stream. Then one node is SIGKILLed and the reads
   are asked again of the survivors.
2. A mixed cluster of one JAX node and one port node (replicas 2, both
   in this process) answers Count, TopN and Bitmap alike from either
   node, puts a SetBit sent to either on both owners, and converges
   after one anti-entropy round of the port node: the wire is the JAX
   protocol in both directions.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cluster.broadcast import HTTPBroadcaster as JHTTPBroadcaster
from pilosa_tpu.cluster.topology import Cluster as JCluster
from pilosa_tpu.cluster.topology import Node as JNode
from pilosa_tpu.server.server import Server as JaxServer

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cluster.client import Client
from pilosa_tpu_torch.cluster.topology import Cluster, Node, new_cluster
from pilosa_tpu_torch.proto import internal as pb
from pilosa_tpu_torch.server import codec
from pilosa_tpu_torch.server.server import Server as PortServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLICES = 5
PB = "application/x-protobuf"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(host, method, path, body=None, headers=None, timeout=60):
    r = urllib.request.Request(f"http://{host}{path}", data=body,
                               method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _query(host, q):
    return _req(host, "POST", "/index/i/query", q.encode())


def _remote_bits(host, frame, row, slice):
    body = codec.encode_query_request(f"Bitmap(rowID={row}, frame={frame})",
                                      [slice], remote=True)
    status, raw = _req(host, "POST", "/index/i/query", body,
                       {"Content-Type": PB, "Accept": PB})
    assert status == 200, raw
    bm = codec.decode_query_results(pb.QueryResponse.FromString(raw),
                                    ["Bitmap"])[0]
    return set(bm.bits().tolist())


def _wait(pred, deadline_s=60.0, what=""):
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _up(host) -> bool:
    try:
        return _req(host, "GET", "/version", timeout=5)[0] == 200
    except OSError:
        return False


def _max_slice(host):
    try:
        status, raw = _req(host, "GET", "/slices/max", timeout=5)
    except OSError:
        return -1
    return json.loads(raw)["maxSlices"].get("i", -1) if status == 200 \
        else -1


def _schema(host):
    for path, body in (
            ("/index/i", {"options": {"timeQuantum": "YMD"}}),
            ("/index/i/frame/f", {}),
            ("/index/i/frame/g", {"options": {"inverseEnabled": True}}),
            ("/index/i/frame/v", {"options": {
                "fields": [{"name": "x", "min": -50,
                            "max": 1000}]}})):
        status, raw = _req(host, "POST", path, json.dumps(body).encode())
        assert status == 200, (path, raw)


def _writes(rng):
    """The seeded write stream: (kind, payload)."""
    W = SLICE_WIDTH
    out = []
    for _ in range(120):
        col = int(rng.integers(0, N_SLICES * W))
        row = int(rng.integers(0, 12))
        kind = int(rng.integers(0, 10))
        if kind < 6:
            out.append(("q", f"SetBit(frame=f, rowID={row},"
                             f" columnID={col})"))
        elif kind == 6:
            out.append(("q", f"ClearBit(frame=f, rowID={row},"
                             f" columnID={col})"))
        elif kind == 7:
            out.append(("q", f"SetBit(frame=g, rowID={row},"
                             f" columnID={col % (2 * W)})"))
        elif kind == 8:
            out.append(("q", f"SetFieldValue(frame=v, columnID={col},"
                             f" x={int(rng.integers(-50, 1000))})"))
        else:
            day = int(rng.integers(1, 28))
            out.append(("q", f"SetBit(frame=f, rowID={row}, columnID={col},"
                             f" timestamp=\"2017-01-{day:02d}T00:00\")"))
    out.append(("q", 'SetRowAttrs(frame=f, rowID=3, color="red")'))
    out.append(("q", 'SetRowAttrs(frame=f, rowID=4, color="blue", n=2)'))
    out.append(("q", 'SetColumnAttrs(id=7, tag="z")'))
    rows = rng.integers(0, 12, size=3000).astype(np.uint64)
    cols = rng.integers(0, N_SLICES * W, size=3000).astype(np.uint64)
    out.append(("import", (rows, cols)))
    return out


def _reads(rng):
    qs = [
        "Count(Bitmap(rowID=1, frame=f))",
        "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2,"
        " frame=f)))",
        "Count(Union(Bitmap(rowID=1, frame=f), Bitmap(rowID=5, frame=f),"
        " Bitmap(rowID=9, frame=g)))",
        "Count(Difference(Bitmap(rowID=2, frame=f), Bitmap(rowID=3,"
        " frame=f)))",
        "Count(Union(" + ", ".join(f"Bitmap(rowID={r}, frame=f)"
                                   for r in range(9)) + "))",
        "Bitmap(rowID=3, frame=f)",
        "Union(Bitmap(rowID=4, frame=f), Bitmap(rowID=6, frame=f))",
        "Bitmap(columnID=7, frame=g)",
        "TopN(frame=f, n=5)",
        "TopN(frame=f)",
        "TopN(frame=f, n=3, ids=[1,2,3,4,11])",
        "TopN(Bitmap(rowID=1, frame=f), frame=f, n=4)",
        "TopN(Bitmap(rowID=2, frame=f), frame=f, n=3, threshold=2)",
        "TopN(frame=f, n=5, field=\"color\", filters=[\"red\", \"blue\"])",
        "Count(Range(frame=v, x > 100))",
        "Count(Range(frame=v, x >< [-10, 500]))",
        "Range(frame=v, x < 0)",
        "Sum(frame=v, field=x)",
        "Sum(Bitmap(rowID=1, frame=f), frame=v, field=x)",
        "Min(frame=v, field=x)",
        "Max(frame=v, field=x)",
        "Count(Range(rowID=1, frame=f, start=\"2017-01-03T00:00\","
        " end=\"2017-01-20T00:00\"))",
        "Count(Bitmap(rowID=1, frame=f)) TopN(frame=f, n=2)"
        " Count(Bitmap(rowID=2, frame=f))",
    ]
    return qs


@pytest.fixture
def jax_ref(tmp_path):
    srv = JaxServer(str(tmp_path / "ref"), host="127.0.0.1:0",
                    anti_entropy_interval=0, polling_interval=0)
    srv.open()
    yield srv
    srv.close()


def _spawn(tmp_path, i, host, hosts):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "--device", "cpu", "-d", str(tmp_path / f"n{i}"), "-b", host,
         "--cluster.hosts", ",".join(hosts), "--cluster.replicas", "2",
         "--cluster.type", "http", "--cluster.poll-interval", "1s"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=open(tmp_path / f"n{i}.log", "wb"))


def test_three_port_nodes_answer_as_one_jax_node(tmp_path, jax_ref):
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    procs = [_spawn(tmp_path, i, h, hosts) for i, h in enumerate(hosts)]
    ref = jax_ref.host
    try:
        _wait(lambda: all(_up(h) for h in hosts), 60, "the nodes")
        _schema(hosts[0])
        _schema(ref)
        _wait(lambda: all(_req(h, "GET", "/index/i/frame/v/fields")[0]
                          == 200 for h in hosts), 30, "the schema")
        rng = np.random.default_rng(11)
        for k, (kind, payload) in enumerate(_writes(rng)):
            if kind == "q":
                got = _query(hosts[k % 3], payload)
                want = _query(ref, payload)
                assert got == want, payload
            else:
                rows, cols = payload
                c = Client(hosts[1])
                c.import_arrays("i", "f", rows, cols)
                c.close()
                c = Client(ref)
                c.import_arrays("i", "f", rows, cols)
                c.close()
        want_max = _max_slice(ref)
        _wait(lambda: all(_max_slice(h) >= want_max for h in hosts), 30,
              "slice knowledge")
        wants = {q: _query(ref, q) for q in _reads(rng)}
        for q, want in wants.items():
            assert want[0] == 200, (q, want)
            for h in hosts:
                assert _query(h, q) == want, (h, q)
        # An acked write is on both owners of its slice.
        cl = new_cluster(hosts, replica_n=2)
        col = 3 * SLICE_WIDTH + 77
        assert _query(hosts[0], f"SetBit(frame=f, rowID=40,"
                                f" columnID={col})")[0] == 200
        _query(ref, f"SetBit(frame=f, rowID=40, columnID={col})")
        for n in cl.fragment_nodes("i", 3):
            assert col in _remote_bits(n.host, "f", 40, 3)
        # SIGKILL one node: the survivors answer the same.
        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(30)
        wants = {q: _query(ref, q) for q in wants}
        for q, want in wants.items():
            for h in hosts[:2]:
                assert _query(h, q) == want, ("after SIGKILL", h, q)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_mixed_jax_and_port_nodes(tmp_path):
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    js = JaxServer(str(tmp_path / "jax"), host=hosts[0],
                   cluster=JCluster(nodes=[JNode(h) for h in hosts],
                                    replica_n=2),
                   anti_entropy_interval=0, polling_interval=0)
    ps = PortServer(str(tmp_path / "port"), host=hosts[1], device="cpu",
                    cluster=Cluster(nodes=[Node(h) for h in hosts],
                                    replica_n=2),
                    cluster_type="http", warmup=False,
                    polling_interval=0, anti_entropy_interval=0)
    js.open()
    js.broadcaster = JHTTPBroadcaster(js)
    js.handler.broadcaster = js.broadcaster
    ps.open()
    try:
        # Schema through the JAX node reaches the port node, and back.
        assert _req(hosts[0], "POST", "/index/i", b"{}")[0] == 200
        assert _req(hosts[0], "POST", "/index/i/frame/f", b"{}")[0] == 200
        assert _req(hosts[1], "POST", "/index/i/frame/h", b"{}")[0] == 200
        assert ps.holder.frame("i", "f") is not None
        assert js.holder.frame("i", "h") is not None
        rng = np.random.default_rng(5)
        rows = rng.integers(0, 20, size=4000).astype(np.uint64)
        cols = rng.integers(0, 3 * SLICE_WIDTH, size=4000).astype(np.uint64)
        c = Client(hosts[1])
        c.import_arrays("i", "f", rows, cols)   # to both owners
        c.close()
        for k in range(30):
            col = int(rng.integers(0, 3 * SLICE_WIDTH))
            status, _ = _query(hosts[k % 2], f"SetBit(frame=f, rowID=30,"
                                             f" columnID={col})")
            assert status == 200
            for h in hosts:
                assert col in _remote_bits(h, "f", 30, col // SLICE_WIDTH)
        reads = ["Count(Bitmap(rowID=1, frame=f))",
                 "Count(Intersect(Bitmap(rowID=1, frame=f),"
                 " Bitmap(rowID=2, frame=f)))",
                 "TopN(frame=f, n=5)",
                 "TopN(Bitmap(rowID=3, frame=f), frame=f, n=4)",
                 "Bitmap(rowID=30, frame=f)"]
        for q in reads:
            a, b = _query(hosts[0], q), _query(hosts[1], q)
            assert a[0] == 200 and a == b, q
        # A host reference for the Count.
        want = len(np.unique(cols[rows == 1]))
        assert json.loads(_query(hosts[1], reads[0])[1])["results"] == \
            [want]
        # Diverge both ways, then one anti-entropy round of the port node.
        for host, col in ((hosts[0], 5), (hosts[1], SLICE_WIDTH + 6)):
            body = codec.encode_query_request(
                f"SetBit(frame=f, rowID=50, columnID={col})", None,
                remote=True)
            assert _req(host, "POST", "/index/i/query", body,
                        {"Content-Type": PB, "Accept": PB})[0] == 200
        assert 5 not in _remote_bits(hosts[1], "f", 50, 0)
        ps.sync_holder()
        for s in range(3):
            path = (f"/fragment/blocks?index=i&frame=f&view=standard"
                    f"&slice={s}")
            a, b = _req(hosts[0], "GET", path), _req(hosts[1], "GET", path)
            assert a[0] == 200 and a == b, s
        for h in hosts:
            assert 5 in _remote_bits(h, "f", 50, 0)
            assert SLICE_WIDTH + 6 in _remote_bits(h, "f", 50, 1)
    finally:
        ps.close()
        js.close()

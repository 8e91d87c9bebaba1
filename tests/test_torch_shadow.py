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
``Min``, ``Max`` and ``Bitmap(columnID=...)``; bitmap calls of 8 or
more leaves and multi-call bodies of Counts and TopNs; and reads and a
write sent with the query lifecycle's options (a generous
``?timeout=``, ``?profile=1``, ``X-Pilosa-Tenant``). Then
``pilosa_tpu.obs.replay.shadow`` replays the JAX server's
captured records against both: every write again, in recorded order,
then every read, whose result digests must match.

``shadow`` drops every pair where either side is not 200, so the test
also requires that it compared exactly as many reads as the capture
recorded: a port 400 cannot pass unseen.

The other direction: the port server captures the same workload itself
(``CaptureConfig(mode="full")`` of ``pilosa_tpu_torch``), and the
port's own ``obs.replay.shadow`` replays the port's records against the
JAX server as the baseline and the port server as the candidate.

Tiered reads: with the tier manager on in both servers, the fragments
of the ranked and counted frames go to the blob tier after the workload,
and the replay's reads fetch them back.
"""

import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import replay as obs_replay
from pilosa_tpu.proto import internal_pb2 as jax_pb
from pilosa_tpu.server.server import Server as JaxServer
from pilosa_tpu.utils.config import CaptureConfig

from pilosa_tpu_torch.obs import replay as port_replay
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.server.server import Server as PortServer
from pilosa_tpu_torch.utils.config import CaptureConfig as PortCaptureConfig

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


def _post_headers(host, path, body):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read(), dict(r.headers)


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
        "Count(Range(frame=bsi, amt > 10)) Count(Range(frame=bsi,"
        " amt >< [0, 100])) Count(Intersect(Range(frame=bsi, amt < 0),"
        " Bitmap(frame=tq, rowID=2)))",
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
    return (steps + _wide_and_batched(rng) + _views_workload(rng)
            + _lifecycle_requests(rng))


def _lifecycle_requests(rng):
    """Requests with the query lifecycle's options: a generous
    ``?timeout=``, ``?profile=1``, a degraded read (``?partial=1``,
    whole while every node is up) and a named tenant
    (``X-Pilosa-Tenant``), on reads and on a write."""
    tenant = {"X-Pilosa-Tenant": "acme"}
    steps = []
    for suffix, headers in (("?timeout=30s", {}), ("?profile=1", {}),
                            ("?partial=1", {}), ("", tenant),
                            ("?timeout=1m&profile=1", tenant)):
        steps.append(("query_opts", (f"Count({_rand_tree(rng, 3)})",
                                     suffix, headers)))
        steps.append(("query_opts", ('TopN(Bitmap(rowID=1, frame="src"),'
                                     ' frame="f", n=5)', suffix, headers)))
    col = int(rng.integers(N_SLICES * SLICE_WIDTH))
    steps.append(("query_opts", (f'SetBit(frame="f", rowID=2,'
                                 f' columnID={col})', "?timeout=30s",
                                 tenant)))
    steps.append(("query_opts", ('Count(Bitmap(rowID=2, frame="f"))',
                                 "?timeout=30s", tenant)))
    return steps


def _wide_and_batched(rng):
    """Bitmap calls of 8 or more leaves (the device materialize leg)
    and multi-call bodies of Counts and TopNs (the fused batch). No two
    of the bitmap calls share a shape: the JAX server's result cache
    answers a second call of one shape with the first's bits (ROADMAP
    fault 3.5)."""
    def bm(r, frame="f"):
        return f'Bitmap(rowID={r}, frame="{frame}")'

    ids = sorted(rng.choice(N_ROWS, size=24, replace=False).tolist())
    reads = [
        "Union(" + ", ".join(bm(r) for r in range(8)) + ")",
        "Difference(" + ", ".join([bm(1, "src")] + [bm(r) for r in
                                                    range(2, 11)]) + ")",
        "Intersect(Union(" + ", ".join(bm(r) for r in range(6)) + "),"
        " Union(" + ", ".join(bm(r, "fs") for r in range(4)) + "))",
        " ".join(f"Count(Union({bm(r)}, {bm(r + 1, 'fs')}))"
                 for r in range(5)),
        f"Count({bm(1, 'src')}) TopN({bm(1, 'src')}, frame=\"f\","
        f" ids={ids}) Count(Intersect({bm(2)}, {bm(3, 'src')}))"
        f" TopN(Intersect({bm(1, 'src')}, {bm(3, 'src')}), frame=\"fs\","
        f" ids={ids[:9]})",
        " ".join(f"Count({_rand_tree(rng, 2)})" for _ in range(17)),
    ]
    return [("query", q) for q in reads]


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
                elif kind == "query_opts":
                    pql, suffix, headers = payload
                    status, _ = _post(host, "/index/d/query" + suffix,
                                      pql.encode(), headers)
                    assert status == 200, (host, payload)
                else:
                    status, _ = _post(host, "/index/d/query",
                                      payload.encode())
                    assert status == 200, (host, payload)
        records = obs_replay.fetch_records(js.host, limit=100000)
        queries = [r for r in records if r.get("kind") == "query"]
        reads = [r for r in queries if r.get("lane") == "read"]
        writes = [r for r in queries if r.get("lane") != "read"]
        n_query_steps = sum(1 for k, _ in steps
                            if k in ("query", "query_opts"))
        assert len(queries) == n_query_steps
        assert len(reads) > 100 and len(writes) > 60

        out = obs_replay.shadow(records, js.host, ps.host, senders=1)
        assert out["writes_replayed"] == len(writes)
        assert out["mismatches"] == 0, out["dumps"][:2]
        assert out["reads_compared"] == len(reads)
    finally:
        ps.close()
        js.close()


def test_port_answers_alike_over_a_corrupted_fragment(tmp_path):
    """One fragment of the directory is corrupted on disk before either
    server opens it. Both quarantine the same fragment at open (the same
    ``/debug/integrity`` entry, the same ``.corrupt`` bytes) and answer
    the workload's requests alike: the same status and body for every
    write and every read — a read over the quarantined slice is a 503
    in both — and, for reads over the other slices, the same 200s."""
    import json

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jh = JaxHolder(str(jax_dir))
    jh.open()
    _fill_jax(jh, np.random.default_rng(606))
    jh.close()
    rel = "d/f/views/standard/fragments/1"
    raw = bytearray((jax_dir / rel).read_bytes())
    raw[len(raw) // 2] ^= 0x10
    (jax_dir / rel).write_bytes(bytes(raw))
    shutil.copytree(jax_dir, port_dir)

    js = JaxServer(str(jax_dir), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    js.open()
    ps = PortServer(str(port_dir), host="127.0.0.1:0", device="cpu")

    def call(host, path, body):
        req = urllib.request.Request(f"http://{host}{path}", data=body,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        ps.open()
        entries = []
        for host in (js.host, ps.host):
            with urllib.request.urlopen(f"http://{host}/debug/integrity",
                                        timeout=30) as r:
                entries.append([{k: v for k, v in e.items()
                                 if k not in ("since", "path")}
                                for e in json.loads(r.read())
                                ["quarantined"]])
        assert entries[0] == entries[1]
        assert [(e["frame"], e["slice"]) for e in entries[1]] == [("f", 1)]
        assert ((port_dir / (rel + ".corrupt")).read_bytes()
                == (jax_dir / (rel + ".corrupt")).read_bytes())
        others = ",".join(str(s) for s in range(N_SLICES) if s != 1)
        statuses = set()
        steps = [p for k, p in _workload(np.random.default_rng(607))
                 if k == "query"]
        for pql in steps[:120]:
            paths = ["/index/d/query"]
            if not pql.startswith(("Set", "Clear")):
                paths.append(f"/index/d/query?slices={others}")
            for path in paths:
                got = [call(h, path, pql.encode())
                       for h in (js.host, ps.host)]
                assert got[0] == got[1], (path, pql)
                statuses.add((path == "/index/d/query", got[1][0]))
        assert {(True, 503), (True, 200), (False, 200)} <= statuses
    finally:
        ps.close()
        js.close()


def test_port_cluster_answers_the_captured_workload(tmp_path):
    """The same captured workload at the coordinator of three port nodes
    (``cluster_type="http"``, replicas 2, in this process): each node
    opens a copy of the seeded directory (a non-owner's copy is never
    read), queries go to the coordinator, which forwards every write to
    the slice's owners, and ``/import`` and field-import bodies to every
    owner of their slice, as the cluster client sends them. Zero
    mismatches against the JAX server, every captured read compared."""
    from pilosa_tpu_torch.cluster.topology import Cluster, Node
    from podenv import free_port

    jax_dir = tmp_path / "jax"
    jh = JaxHolder(str(jax_dir))
    jh.open()
    _fill_jax(jh, np.random.default_rng(606))
    jh.close()
    hosts = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    nodes = []
    for i, h in enumerate(hosts):
        shutil.copytree(jax_dir, tmp_path / f"port{i}")
        nodes.append(PortServer(
            str(tmp_path / f"port{i}"), host=h, device="cpu", warmup=False,
            cluster=Cluster(nodes=[Node(x) for x in hosts], replica_n=2),
            cluster_type="http", polling_interval=0,
            anti_entropy_interval=0))
    cluster = nodes[0].cluster
    js = JaxServer(str(jax_dir), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0,
                   capture_config=CaptureConfig(mode="full"))
    js.open()
    coord = hosts[0]
    proto = {"Content-Type": "application/x-protobuf",
             "Accept": "application/x-protobuf"}
    try:
        for n in nodes:
            n.open()
        for host in (js.host, coord):
            for path, body in (
                    ("/index/d/frame/bsi", b'{"options": {"fields": [{"name":'
                                           b' "amt", "min": -100, "max":'
                                           b' 5000}]}}'),
                    ("/index/d/frame/tq", b'{"options": {"timeQuantum": "YMD",'
                                          b' "inverseEnabled": true}}')):
                assert _post(host, path, body)[0] == 200
        steps = _workload(np.random.default_rng(607))
        for kind, payload in steps:
            if kind in ("import", "field_import"):
                path, msg = (("/import", jax_pb.ImportRequest)
                             if kind == "import" else
                             ("/index/d/frame/bsi/field/amt/import",
                              jax_pb.ImportValueRequest))
                assert _post(js.host, path, payload, proto)[0] == 200
                slice_ = msg.FromString(payload).Slice
                for owner in cluster.fragment_nodes("d", slice_):
                    assert _post(owner.host, path, payload,
                                 proto)[0] == 200
                continue
            if kind == "query_opts":
                pql, suffix, headers = payload
            else:
                pql, suffix, headers = payload, "", None
            for host in (js.host, coord):
                status, _ = _post(host, "/index/d/query" + suffix,
                                  pql.encode(), headers)
                assert status == 200, (host, pql)
        # A degraded read with every node up is whole: 200, no
        # X-Pilosa-Partial, the JAX server's answer.
        got = [_post_headers(h, "/index/d/query?partial=1",
                             b'Count(Bitmap(rowID=1, frame="f"))'
                             b' TopN(frame="f", n=5)')
               for h in (js.host, coord)]
        assert got[0][:2] == got[1][:2] and got[1][0] == 200
        assert not any("X-Pilosa-Partial" in hs for _, _, hs in got)
        records = obs_replay.fetch_records(js.host, limit=100000)
        queries = [r for r in records if r.get("kind") == "query"]
        reads = [r for r in queries if r.get("lane") == "read"]
        writes = [r for r in queries if r.get("lane") != "read"]
        out = obs_replay.shadow(records, js.host, coord, senders=1)
        assert out["writes_replayed"] == len(writes)
        assert out["mismatches"] == 0, out["dumps"][:2]
        assert out["reads_compared"] == len(reads) > 100
    finally:
        for n in nodes:
            n.close()
        js.close()


def test_jax_answers_the_port_captured_workload(tmp_path):
    """The port captures the workload; the port's replay shadows it
    with the JAX server as the baseline: every write replayed, every
    captured read compared, no mismatch, and the port's capture holds
    one record for every query sent, a digest on each."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jh = JaxHolder(str(jax_dir))
    jh.open()
    _fill_jax(jh, np.random.default_rng(606))
    jh.close()
    shutil.copytree(jax_dir, port_dir)
    js = JaxServer(str(jax_dir), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    js.open()
    ps = PortServer(str(port_dir), host="127.0.0.1:0", device="cpu",
                    capture_config=PortCaptureConfig(mode="full"))
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
                elif kind == "query_opts":
                    pql, suffix, headers = payload
                    assert _post(host, "/index/d/query" + suffix,
                                 pql.encode(), headers)[0] == 200
                else:
                    assert _post(host, "/index/d/query",
                                 payload.encode())[0] == 200
        records = port_replay.fetch_records(ps.host, limit=100000)
        queries = [r for r in records if r.get("kind") == "query"]
        reads = [r for r in queries if r.get("lane") == "read"]
        writes = [r for r in queries if r.get("lane") != "read"]
        assert len(queries) == sum(1 for k, _ in steps
                                   if k in ("query", "query_opts"))
        assert sum(1 for r in records if r.get("kind") == "import") == sum(
            1 for k, _ in steps if k == "import")
        assert all(len(r["digest"]) == 16 for r in queries)
        out = port_replay.shadow(records, js.host, ps.host, senders=1)
        assert out["writes_replayed"] == len(writes)
        assert out["mismatches"] == 0, out["dumps"][:2]
        assert out["reads_compared"] == len(reads)
    finally:
        ps.close()
        js.close()


def _send(hosts, steps):
    """The frames the workload adds, then its steps, to every host."""
    proto = {"Content-Type": "application/x-protobuf",
             "Accept": "application/x-protobuf"}
    for host in hosts:
        for path, body in (
                ("/index/d/frame/bsi", b'{"options": {"fields": [{"name":'
                                       b' "amt", "min": -100, "max":'
                                       b' 5000}]}}'),
                ("/index/d/frame/tq", b'{"options": {"timeQuantum": "YMD",'
                                      b' "inverseEnabled": true}}')):
            assert _post(host, path, body)[0] == 200
    for kind, payload in steps:
        for host in hosts:
            if kind == "import":
                assert _post(host, "/import", payload, proto)[0] == 200
            elif kind == "field_import":
                assert _post(host, "/index/d/frame/bsi/field/amt/import",
                             payload, proto)[0] == 200
            elif kind == "query_opts":
                pql, suffix, headers = payload
                assert _post(host, "/index/d/query" + suffix,
                             pql.encode(), headers)[0] == 200
            else:
                assert _post(host, "/index/d/query",
                             payload.encode())[0] == 200


def test_port_answers_the_captured_workload_from_the_blob_tier(tmp_path):
    """Both servers run the tier manager with a local blob store. After
    the workload every fragment of the ranked and counted frames goes to
    the blob tier, so the replayed reads fault them back from the blob
    store (the replayed writes promote theirs first); the shadow
    compares every captured read with no mismatch."""
    from pilosa_tpu.utils.config import TierConfig
    from pilosa_tpu_torch.utils.config import TierConfig as PortTierConfig
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jh = JaxHolder(str(jax_dir))
    jh.open()
    _fill_jax(jh, np.random.default_rng(606))
    jh.close()
    shutil.copytree(jax_dir, port_dir)
    tier = dict(enabled=True, idle=999.0, blob_idle=999.0, interval=999.0,
                blob="dir", pace=0.0)
    js = JaxServer(str(jax_dir), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0,
                   capture_config=CaptureConfig(mode="full"),
                   tier_config=TierConfig(**tier))
    js.open()
    ps = PortServer(str(port_dir), host="127.0.0.1:0", device="cpu",
                    tier_config=PortTierConfig(**tier))
    try:
        ps.open()

        def to_blob():
            """Demote and push the standard-view fragments of every
            frame the TopN and Count reads rank and count."""
            out = []
            for s in (js, ps):
                s.tier.sync()
                for frame in TOPN_FRAMES + ("src",):
                    for sl in range(N_SLICES):
                        frag = s.holder.fragment("d", frame, "standard",
                                                 sl)
                        if frag is None:
                            continue
                        s.tier._demote(frag, "idle")
                        assert s.tier.push_blob(frag)
                out.append(s.tier.state()["tiers"])
            assert out[0] == out[1]
            assert out[1]["blob"]["fragments"] >= N_SLICES

        steps = _workload(np.random.default_rng(607))
        _send((js.host, ps.host), steps)
        records = obs_replay.fetch_records(js.host, limit=100000)
        queries = [r for r in records if r.get("kind") == "query"]
        reads = [r for r in queries if r.get("lane") == "read"]
        writes = [r for r in queries if r.get("lane") != "read"]
        assert len(reads) > 100
        to_blob()
        out = obs_replay.shadow(records, js.host, ps.host, senders=1)
        assert out["writes_replayed"] == len(writes)
        assert out["mismatches"] == 0, out["dumps"][:2]
        assert out["reads_compared"] == len(reads)
        assert ps.tier.blob_fetches >= N_SLICES
    finally:
        ps.close()
        js.close()

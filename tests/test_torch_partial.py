"""Degraded reads (``?partial=1``): the port against the JAX package.

The port's counterparts of the JAX package's partial-result tests
(``tests/test_fault.py::TestExecutorFailover`` and
``TestFailpointHTTP::test_partial_header_rides_the_response``): the
same seeded holder and placement go to both executors, each coordinator
``local`` in a cluster whose unreachable peers raise through one
scripted transport, and both must give the same answer and the same
missing-slice list — which must also be exactly the slices no reachable
node owns. Then over HTTP: a one-node server with a quarantined slice,
one of each package over copies of one directory, answers 200 with
``X-Pilosa-Partial`` under ``?partial=1`` and 503 without; a partial
read leaves no entry in the coordinator's cluster result cache; and
``?partial=1`` requests pipelined on one connection keep their option
(the batch lane does not take them).
"""

import io
import json
import shutil
import socket
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import pilosa_tpu.cluster.client as jclient
import pilosa_tpu.cluster.generations as jgens
import pilosa_tpu.cluster.topology as jtop
import pilosa_tpu.executor as jexec
import pilosa_tpu.models.holder as jholder
import pilosa_tpu.obs.metrics as jmetrics
import pilosa_tpu.server.handler as jhandler
import pilosa_tpu.storage.bitmap as jbitmap
import pilosa_tpu.storage.cache as jcache

import pilosa_tpu_torch.cluster.client as tclient
import pilosa_tpu_torch.cluster.generations as tgens
import pilosa_tpu_torch.cluster.topology as ttop
import pilosa_tpu_torch.executor as texec
import pilosa_tpu_torch.models.holder as tholder
import pilosa_tpu_torch.obs.metrics as tmetrics
import pilosa_tpu_torch.server.handler as thandler
import pilosa_tpu_torch.storage.bitmap as tbitmap
import pilosa_tpu_torch.storage.cache as tcache

from pilosa_tpu_torch import SLICE_WIDTH

JAX = types.SimpleNamespace(
    name="jax", Holder=jholder.Holder, exec=jexec, top=jtop,
    ClientError=jclient.ClientError, metrics=jmetrics, gens=jgens,
    handler=jhandler, Bitmap=jbitmap.Bitmap, Pair=jcache.Pair)
TORCH = types.SimpleNamespace(
    name="torch", Holder=tholder.Holder, exec=texec, top=ttop,
    ClientError=tclient.ClientError, metrics=tmetrics, gens=tgens,
    handler=thandler, Bitmap=tbitmap.Bitmap, Pair=tcache.Pair)

N_SLICES = 12
ROWS = range(1, 6)


def _seed_data(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for s in range(N_SLICES):
        for row in ROWS:
            k = int(rng.integers(0, 10))
            cols = rng.choice(SLICE_WIDTH, size=k, replace=False)
            out[(row, s)] = sorted(int(c) + s * SLICE_WIDTH for c in cols)
    return out


def _load(h, data: dict) -> None:
    idx = h.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("general")
    for (row, _s), cols in data.items():
        for col in cols:
            f.set_bit("standard", row, col)


class DownClient:
    """Scripted transport: a host in ``down`` refuses every leg (as the
    real client's ClientError); the others answer from the seeded
    truth."""

    def __init__(self, pkg, data, down=()):
        self.pkg = pkg
        self.data = data
        self.down = set(down)
        self.calls = []

    def execute_query(self, node, index, query, slices, remote, **kw):
        self.calls.append((node.host, query, tuple(slices or ())))
        if node.host in self.down:
            raise self.pkg.ClientError(f"{node.host}: connection refused")
        if query.startswith("Count("):
            return [sum(len(self.data[(1, s)]) for s in slices)]
        if query.startswith("Union("):
            bm = self.pkg.Bitmap()
            for s in slices:
                for row in (1, 2):
                    for col in self.data[(row, s)]:
                        bm.set_bit(col)
            return [bm]
        assert query.startswith("TopN("), query
        counts = {r: sum(len(self.data[(r, s)]) for s in slices)
                  for r in ROWS}
        if "ids=" in query:
            ids = query.split("ids=[")[1].split("]")[0]
            want = {int(x) for x in ids.split(",") if x}
            counts = {r: n for r, n in counts.items() if r in want}
        return [[self.pkg.Pair(r, n) for r, n in sorted(counts.items())
                 if n]]


def _executor(pkg, h, hosts, replica_n, client, **kw):
    cluster = pkg.top.new_cluster(hosts, replica_n=replica_n)
    kw.update(host="local", cluster=cluster, client=client)
    if pkg is JAX:
        return pkg.exec.Executor(h, use_mesh=False, **kw), cluster
    return pkg.exec.Executor(h, device="cpu", **kw), cluster


def _norm(r):
    if hasattr(r, "segments"):
        return r.bits().tolist()
    if isinstance(r, list) and r and hasattr(r[0], "count"):
        return [(p.id, p.count) for p in r]
    return r


def _both(tmp_path, case, seed):
    data = _seed_data(seed)
    out = []
    for pkg in (JAX, TORCH):
        h = pkg.Holder(str(tmp_path / pkg.name))
        h.open()
        try:
            _load(h, data)
            out.append(case(pkg, h, data))
        finally:
            h.close()
    assert out[0] == out[1]
    return out[1], data


def _owned_only_by(hosts_down, hosts, replica_n) -> list[int]:
    cl = ttop.new_cluster(hosts, replica_n=replica_n)
    return [s for s in range(N_SLICES)
            if {n.host for n in cl.fragment_nodes("i", s)} <= hosts_down]


QUERIES = {
    "count": "Count(Bitmap(rowID=1, frame=general))",
    "bitmap": "Union(Bitmap(rowID=1, frame=general),"
              " Bitmap(rowID=2, frame=general))",
    "topn": "TopN(frame=general, n=3)",
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("layout", [
    (("local", "remotehost"), 1, {"remotehost"}),
    (("local", "b", "c"), 2, {"b", "c"}),
    (("local", "b", "c"), 1, {"c"}),
])
@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_partial_skips_unreachable_slices(tmp_path, seed, layout, kind):
    hosts, replica_n, down = layout
    query = QUERIES[kind]

    def case(pkg, h, data):
        client = DownClient(pkg, data, down)
        e, _ = _executor(pkg, h, list(hosts), replica_n, client)
        if kind == "count":
            # Strict (default): the unreachable owners fail the query.
            with pytest.raises(pkg.ClientError):
                e.execute("i", query)
        opt = pkg.exec.ExecOptions(partial=True, missing_slices=[])
        res = e.execute("i", query, opt=opt)
        return [_norm(r) for r in res], sorted(opt.missing_slices)

    (res, missing), data = _both(tmp_path, case, seed)
    want_missing = _owned_only_by(down, list(hosts), replica_n)
    assert want_missing, "the placement leaves every slice reachable"
    # Each fan-out of the query notes its own: the two-phase TopN lists
    # every missing slice twice, in both packages.
    assert missing == sorted(want_missing * (2 if kind == "topn" else 1))
    kept = [s for s in range(N_SLICES) if s not in want_missing]
    if kind == "count":
        assert res == [sum(len(data[(1, s)]) for s in kept)]
    elif kind == "bitmap":
        assert res == [sorted(c for s in kept for r in (1, 2)
                              for c in data[(r, s)])]


def test_partial_with_no_owner_at_all(tmp_path):
    """The JAX case: the remote node dropped from the node list. The
    placement is then over the survivor alone, which owns every slice:
    nothing is missing and the count is whole."""
    def case(pkg, h, data):
        e, cluster = _executor(pkg, h, ["local", "gone"], 1, None)
        cluster.nodes = [n for n in cluster.nodes if n.host == "local"]
        opt = pkg.exec.ExecOptions(partial=True, missing_slices=[])
        res = e.execute("i", QUERIES["count"], opt=opt)
        return res, sorted(opt.missing_slices)

    (res, missing), data = _both(tmp_path, case, seed=3)
    assert missing == []
    assert res == [sum(len(data[(1, s)]) for s in range(N_SLICES))]


def test_partial_reads_skip_the_cluster_cache(tmp_path):
    class ProbeClient(DownClient):
        generation_aware = True

        def generations(self, index, slices=None, host=None,
                        deadline_s=None):
            return {}

    def case(pkg, h, data):
        gens = (pkg.gens.GenerationMap(staleness_s=60.0) if pkg is JAX
                else pkg.gens.GenerationMap())
        client = ProbeClient(pkg, data, down={"remotehost"})
        e, _ = _executor(pkg, h, ["local", "remotehost"], 1, client,
                         gens=gens)
        q = pkg.exec.parse_pql(QUERIES["count"])
        slices = list(range(N_SLICES))
        keys = [e._cluster_cache_key("i", q, slices,
                                     pkg.exec.ExecOptions(partial=p))
                is not None for p in (False, True)]
        misses = pkg.metrics.CLUSTER_CACHE_REQUESTS.labels("miss").value
        for _ in range(2):
            opt = pkg.exec.ExecOptions(partial=True, missing_slices=[])
            res = e.execute("i", QUERIES["count"], opt=opt)
        looked = (pkg.metrics.CLUSTER_CACHE_REQUESTS.labels("miss").value
                  - misses)
        return keys, res, len(e._cluster_cache), looked

    (keys, _res, entries, looked), _ = _both(tmp_path, case, seed=4)
    assert keys == [True, False]
    assert entries == 0 and looked == 0


# -- over HTTP ----------------------------------------------------------------


def _wsgi(app, method, path, body=b""):
    path, _, qs = path.partition("?")
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])
        out["headers"] = dict(headers)

    chunks = app(environ, start_response)
    return out["status"], out["headers"], b"".join(chunks)


def test_partial_header_rides_the_response(tmp_path):
    """The JAX package's handler case: an executor that reports missing
    slices under ``partial`` gives the sorted header; without
    ``?partial=1`` the option is off and no header rides."""
    class StubExecutor:
        def execute(self, index, query, slices=None, opt=None):
            if opt is not None and opt.partial:
                opt.missing_slices.extend([3, 1])
            return [0]

    outs = []
    for pkg in (JAX, TORCH):
        h = pkg.Holder(str(tmp_path / pkg.name))
        h.open()
        try:
            app = pkg.handler.Handler(h, StubExecutor(), host="local")
            before = pkg.metrics.PARTIAL_RESULTS.value
            got = []
            for path in ("/index/i/query?partial=1", "/index/i/query"):
                st, hs, _ = _wsgi(app, "POST", path,
                                  b'Count(Bitmap(rowID=1, frame="general"))')
                got.append((st, hs.get("X-Pilosa-Partial")))
            outs.append((got, pkg.metrics.PARTIAL_RESULTS.value - before))
        finally:
            h.close()
    assert outs[0] == outs[1] == ([(200, "1,3"), (200, None)], 1)


def _post(host, path, body=b""):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture
def solo_pair(tmp_path, monkeypatch):
    """A JAX server and a port server, each over a copy of one seeded
    one-node data directory (three slices), with no background repair."""
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    from pilosa_tpu.server.server import Server as JServer
    from pilosa_tpu.utils.config import ScrubConfig as JScrub
    from pilosa_tpu_torch.server.server import Server as TServer
    from pilosa_tpu_torch.utils.config import ScrubConfig as TScrub
    seed = TServer(str(tmp_path / "seed"), host="127.0.0.1:0",
                   device="cpu", warmup=False)
    seed.open()
    _post(seed.host, "/index/it", b"{}")
    _post(seed.host, "/index/it/frame/f", b"{}")
    rng = np.random.default_rng(7)
    for col in rng.choice(3 * SLICE_WIDTH, size=40, replace=False):
        _post(seed.host, "/index/it/query",
              f'SetBit(frame="f", rowID=1, columnID={int(col)})'.encode())
    seed.close()
    shutil.copytree(tmp_path / "seed", tmp_path / "j")
    shutil.copytree(tmp_path / "seed", tmp_path / "t")
    js = JServer(str(tmp_path / "j"), host="127.0.0.1:0",
                 anti_entropy_interval=0, polling_interval=0,
                 scrub_config=JScrub(interval=999.0, pace=0.0,
                                     repair=False))
    ts = TServer(str(tmp_path / "t"), host="127.0.0.1:0", device="cpu",
                 warmup=False, anti_entropy_interval=0,
                 polling_interval=0,
                 scrub_config=TScrub(interval=999.0, pace=0.0,
                                     repair=False))
    js.open()
    ts.open()
    yield js, ts
    ts.close()
    js.close()


COUNT = b'Count(Bitmap(frame="f", rowID=1))'


@pytest.mark.parametrize("bad", [0, 1])
def test_quarantined_one_node_slice(solo_pair, bad):
    outs = []
    for s in solo_pair:
        full = json.loads(_post(s.host, "/index/it/query", COUNT)[2])
        frag = s.holder.fragment("it", "f", "standard", bad)
        frag._set_quarantined("test corruption", site="scrub")
        strict = _post(s.host, "/index/it/query", COUNT)
        part = _post(s.host, "/index/it/query?partial=1", COUNT)
        outs.append((full, strict[0], part[0], json.loads(part[2]),
                     part[1].get("X-Pilosa-Partial"),
                     "X-Pilosa-Partial" in strict[1]))
    assert outs[0] == outs[1]
    full, strict, status, body, header, strict_header = outs[1]
    assert (strict, status, header, strict_header) == (503, 200, str(bad),
                                                       False)
    frag = solo_pair[1].holder.fragment("it", "f", "standard", bad)
    assert body["results"] == [full["results"][0] - frag.row_count(1)]


def test_pipelined_partial_requests_keep_their_option(solo_pair):
    ts = solo_pair[1]
    batched = []
    inner = ts._httpd.query_batcher

    def spy(index, bodies):
        batched.append(len(bodies))
        return inner(index, bodies)

    ts._httpd.query_batcher = spy
    ts.holder.fragment("it", "f", "standard", 2)._set_quarantined(
        "test corruption", site="scrub")

    def pipeline(path):
        raw = b"".join(
            b"POST " + path + b" HTTP/1.1\r\nHost: x\r\nContent-Length: "
            + str(len(COUNT)).encode() + b"\r\n\r\n" + COUNT
            for _ in range(3))
        raw += b"GET /version HTTP/1.1\r\nConnection: close\r\n\r\n"
        host, port = ts.host.split(":")
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(raw)
            got = b""
            while chunk := s.recv(65536):
                got += chunk
        return got

    got = pipeline(b"/index/it/query?partial=1")
    assert got.count(b"HTTP/1.1 200 OK") == 4
    assert got.count(b"X-Pilosa-Partial: 2\r\n") == 3
    assert batched == []
    # Without the option the run still reaches the batch lane, whose
    # answers are the 503s of the quarantined slice.
    got = pipeline(b"/index/it/query")
    assert batched == [3]
    assert b"X-Pilosa-Partial" not in got
    assert got.count(b"503") >= 3

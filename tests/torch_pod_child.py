"""One process of a port pod on the CPU (tests/test_torch_pod.py).

Runs ``pilosa_tpu_torch.server.server.Server`` on the CPU under the pod
environment contract (``PILOSA_TPU_DIST_*``, ``PILOSA_TPU_POD_PEERS``;
tests/podenv.py). A worker serves pod legs until its launcher stops
it; the coordinator drives the sequence of the JAX pod test's child
(tests/pod_child.py) over HTTP — SetBits across 4 slices, Counts (one
pod collective each), a multi-Count body (ONE ``count_exprs``
dispatch), Bitmaps over podLocal legs, every TopN form, inverse views,
a protobuf import split within the pod, a time Range, SetRowAttrs and a
TopN filtered on them, SetFieldValue and Sum, and a seeded random
parity check — and writes every request and its answer to
``$POD_TRANSCRIPT`` (JSON), which the test replays against a JAX server.

Modes (argv): ``pod <pid> <data_dir>`` (the sequence above; with
``POD_TEST_POISON=1`` also a forced partial dispatch, then the poisoned
pod under concurrent load), ``kill <pid> <data_dir>`` (data in slices
the last process does not own; after ``READY_FOR_KILL`` the launcher
SIGKILLs that process and writes ``$POD_KILL_SENTINEL``), ``cluster
<role> <data_dir>`` (role ``b0``/``b1``: a pod node of a two-node
cluster whose other node is ``$POD_CLUSTER_A``), ``serve <pid>
<data_dir>`` (serve only; the test drives the coordinator).
"""

import base64
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from podenv import http  # noqa: E402

from pilosa_tpu_torch import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.parallel import costmodel  # noqa: E402
from pilosa_tpu_torch.parallel.pod import PodError  # noqa: E402
from pilosa_tpu_torch.proto import internal as pb  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402

_TRANSCRIPT: list = []


def _server(data_dir: str, host: str, **kw) -> Server:
    srv = Server(data_dir, host=host, device="cpu", warmup=False,
                 anti_entropy_interval=0,
                 executor_options={"mesh_min_slices": 1,
                                   "cost_model": costmodel.pinned(0.0)},
                 **kw)
    srv.open()
    print(f"pod process serving on {srv.host}", flush=True)
    return srv


def rec(host: str, method: str, path: str, body: bytes = b"",
        ctype: str = "application/json"):
    """One request; recorded with its answer for the JAX replay."""
    raw = http(method, host, path, body, ctype)
    ans = json.loads(raw) if ctype == "application/json" and raw else None
    _TRANSCRIPT.append({"method": method, "path": path,
                        "body": base64.b64encode(body).decode(),
                        "ctype": ctype, "answer": ans})
    return ans


def q(host: str, pql: str):
    return rec(host, "POST", "/index/i/query", pql.encode())["results"]


def _dump() -> None:
    path = os.environ.get("POD_TRANSCRIPT")
    if path:
        with open(path, "w") as f:
            json.dump(_TRANSCRIPT, f)


def _pairs(r):
    return [(p["id"], p["count"]) for p in r]


def pod_main(pid: int, data_dir: str) -> None:
    host = os.environ["PILOSA_TPU_POD_PEERS"].split(",")[pid]
    srv = _server(data_dir, host, polling_interval=0)
    if pid != 0:
        while True:  # worker: serve pod legs until stopped
            time.sleep(0.5)
    coord = srv.host
    pod = srv.pod
    assert pod is not None and pod.is_coordinator, pod
    rec(coord, "POST", "/index/i", b"{}")
    rec(coord, "POST", "/index/i/frame/f", b"{}")
    for s in range(4):
        for j in range(3):
            q(coord, f"SetBit(frame=f, rowID=1,"
                     f" columnID={s * SLICE_WIDTH + j})")
        for j in range(2):
            q(coord, f"SetBit(frame=f, rowID=2,"
                     f" columnID={s * SLICE_WIDTH + j})")
        q(coord, f"SetBit(frame=f, rowID=3, columnID={s * SLICE_WIDTH})")

    before = dict(pod.dispatch_counts)
    assert q(coord, "Count(Bitmap(frame=f, rowID=1))") == [12]
    assert q(coord, "Count(Intersect(Bitmap(frame=f, rowID=1),"
                    " Bitmap(frame=f, rowID=2)))") == [8]
    assert q(coord, "Count(Difference(Bitmap(frame=f, rowID=1),"
                    " Bitmap(frame=f, rowID=2)))") == [4]
    assert pod.dispatch_counts.get("count_expr", 0) \
        == before.get("count_expr", 0) + 3, pod.dispatch_counts
    n0 = pod.dispatch_counts.get("count_exprs", 0)
    res = q(coord, "Count(Bitmap(frame=f, rowID=1))"
                   " Count(Bitmap(frame=f, rowID=2))"
                   " Count(Intersect(Bitmap(frame=f, rowID=1),"
                   " Bitmap(frame=f, rowID=2)))")
    assert res == [12, 8, 8], res
    assert pod.dispatch_counts.get("count_exprs", 0) == n0 + 1

    bits = q(coord, "Bitmap(frame=f, rowID=3)")[0]["bits"]
    assert bits == [s * SLICE_WIDTH for s in range(4)], bits
    assert _pairs(q(coord, "TopN(frame=f, n=2)")[0]) == [(1, 12), (2, 8)]
    t0 = pod.dispatch_counts.get("topn_exact", 0)
    got = _pairs(q(coord, "TopN(Bitmap(frame=f, rowID=2), frame=f,"
                          " ids=[1, 3])")[0])
    assert got == [(1, 8), (3, 4)], got
    assert pod.dispatch_counts.get("topn_exact", 0) == t0 + 1
    got = _pairs(q(coord, "TopN(Bitmap(frame=f, rowID=2), frame=f,"
                          " ids=[1, 3], threshold=2)")[0])
    assert got == [(1, 8)], got
    q(coord, "TopN(Bitmap(frame=f, rowID=2), frame=f, ids=[1, 2, 3],"
             " tanimotoThreshold=50)")
    q(coord, "TopN(Bitmap(frame=f, rowID=1), frame=f, n=2)")

    # Inverse views route by ROW slice inside the pod.
    rec(coord, "POST", "/index/i/frame/inv",
        b'{"options": {"inverseEnabled": true}}')
    for s in range(4):
        q(coord, f"SetBit(frame=inv, rowID={s * SLICE_WIDTH + 7},"
                 f" columnID={2 * SLICE_WIDTH + 1})")
    bits = q(coord, f"Bitmap(frame=inv, columnID={2 * SLICE_WIDTH + 1})"
             )[0]["bits"]
    assert bits == [s * SLICE_WIDTH + 7 for s in range(4)], bits

    # A protobuf /import through the coordinator splits within the pod.
    rec(coord, "POST", "/index/i/frame/imp",
        b'{"options": {"inverseEnabled": true}}')
    rows_i = [s * SLICE_WIDTH + 3 for s in range(4)]
    cols_i = [1 * SLICE_WIDTH + 9] * 4
    body = pb.ImportRequest(Index="i", Frame="imp", Slice=1, RowIDs=rows_i,
                            ColumnIDs=cols_i,
                            Timestamps=[0] * 4).SerializeToString()
    rec(coord, "POST", "/import", body, "application/x-protobuf")
    bits = q(coord, f"Bitmap(frame=imp, columnID={cols_i[0]})")[0]["bits"]
    assert bits == rows_i, bits
    assert q(coord, f"Count(Bitmap(frame=imp, rowID={rows_i[2]}))") == [1]

    # A time Range runs the podLocal host legs with view names.
    rec(coord, "POST", "/index/i/frame/tq",
        b'{"options": {"timeQuantum": "YMD"}}')
    for s in range(4):
        q(coord, f"SetBit(frame=tq, rowID=1, columnID={s * SLICE_WIDTH},"
                 f' timestamp="2017-01-0{s + 1}T00:00")')
    assert q(coord, 'Count(Range(rowID=1, frame=tq,'
                    ' start="2017-01-01T00:00",'
                    ' end="2017-01-03T00:00"))') == [2]

    # Row attributes replicate to every process; a filtered TopN reads
    # them on each.
    q(coord, 'SetRowAttrs(frame=f, rowID=1, category="a")')
    q(coord, 'SetRowAttrs(frame=f, rowID=3, category="a")')
    got = _pairs(q(coord, 'TopN(Bitmap(frame=f, rowID=2), frame=f,'
                          ' ids=[1, 2, 3], field="category",'
                          ' filters=["a"])')[0])
    assert got == [(1, 8), (3, 4)], got
    # A BSI field: SetFieldValue goes to the column slice's owner.
    rec(coord, "POST", "/index/i/frame/v",
        b'{"options": {"fields": [{"name": "amt", "min": -100,'
        b' "max": 1000}]}}')
    for s in range(4):
        q(coord, f"SetFieldValue(frame=v, columnID={s * SLICE_WIDTH + 1},"
                 f" amt={10 * s - 5})")
    q(coord, "Sum(frame=v, field=amt)")
    q(coord, "Count(Range(frame=v, amt > 4))")
    q(coord, "Min(frame=v, field=amt) Max(frame=v, field=amt)")

    # Seeded parity against a host model.
    import random
    rng = random.Random(7)
    model = {1: set(), 2: set()}
    for _ in range(60):
        row = rng.choice((1, 2))
        col = rng.randrange(4 * SLICE_WIDTH)
        q(coord, f"SetBit(frame=f, rowID={row}, columnID={col})")
        model[row].add(col)
    for s in range(4):
        model[1].update(s * SLICE_WIDTH + j for j in range(3))
        model[2].update(s * SLICE_WIDTH + j for j in range(2))
    assert q(coord, "Count(Union(Bitmap(frame=f, rowID=1),"
                    " Bitmap(frame=f, rowID=2)))") == [len(model[1]
                                                          | model[2])]
    assert q(coord, "Count(Intersect(Bitmap(frame=f, rowID=1),"
                    " Bitmap(frame=f, rowID=2)))") == [len(model[1]
                                                          & model[2])]
    bits = q(coord, "Bitmap(frame=f, rowID=2)")[0]["bits"]
    assert bits == sorted(model[2]), (len(bits), len(model[2]))
    q(coord, "TopN(frame=f, n=3)")
    assert srv.executor.pod_fallbacks == 0, srv.executor.pod_fallbacks
    _dump()
    if os.environ.get("POD_TEST_POISON") == "1":
        poison_phase(srv, coord, model)
    print("POD_TEST_OK " + json.dumps(pod.dispatch_counts), flush=True)
    srv.close()


def poison_phase(srv, coord, model) -> None:
    """A real partial-dispatch failure, then the poisoned pod serving
    correct answers through the host fan-out under concurrent load."""
    import concurrent.futures
    try:
        srv.pod._dispatch({"kind": "bogus", "index": "i",
                           "slices": [0, 1, 2, 3], "leaves": []})
        raise AssertionError("bogus dispatch must raise")
    except PodError:
        pass
    assert srv.pod._poisoned, "partial dispatch failure must poison"
    want_union = len(model[1] | model[2])
    want_r1, want_r2 = len(model[1]), len(model[2])

    def check(_):
        got = json.loads(http("POST", coord, "/index/i/query", (
            b"Count(Union(Bitmap(frame=f, rowID=1),"
            b" Bitmap(frame=f, rowID=2)))")))["results"]
        assert got == [want_union], (got, want_union)
        bits = json.loads(http("POST", coord, "/index/i/query",
                               b"Bitmap(frame=f, rowID=2)"))["results"]
        assert bits[0]["bits"] == sorted(model[2]), len(bits[0]["bits"])
        pairs = json.loads(http("POST", coord, "/index/i/query",
                                b"TopN(frame=f, n=2)"))["results"][0]
        assert _pairs(pairs) == [(1, want_r1), (2, want_r2)], pairs
        return True

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        assert all(ex.map(check, range(24)))
    assert srv.executor.pod_fallbacks > 0
    try:
        srv.pod._dispatch({"kind": "count_expr", "index": "i",
                           "expr": [], "leaves": [], "slices": [0]})
        raise AssertionError("poisoned pod must refuse collectives")
    except PodError:
        pass


def kill_main(pid: int, data_dir: str) -> None:
    """The worker-death form: data in the slices below ``n_procs - 1``
    (the victim, the last process, owns none of them); after the kill
    the next collective fails within the pod timeout, the pod is
    poisoned, and the host fan-out answers exactly under load."""
    host = os.environ["PILOSA_TPU_POD_PEERS"].split(",")[pid]
    srv = _server(data_dir, host, polling_interval=0)
    if pid != 0:
        while True:
            time.sleep(0.5)
    coord = srv.host
    n_slices = srv.pod.n_procs - 1
    rec(coord, "POST", "/index/i", b"{}")
    rec(coord, "POST", "/index/i/frame/f", b"{}")
    for s in range(n_slices):
        for j in range(3):
            q(coord, f"SetBit(frame=f, rowID=1,"
                     f" columnID={s * SLICE_WIDTH + j})")
        for j in range(2):
            q(coord, f"SetBit(frame=f, rowID=2,"
                     f" columnID={s * SLICE_WIDTH + j})")
    assert q(coord, "Count(Bitmap(frame=f, rowID=1))") == [3 * n_slices]
    assert srv.pod.dispatch_counts.get("count_expr", 0) >= 1
    _dump()
    sentinel = os.environ["POD_KILL_SENTINEL"]
    print("READY_FOR_KILL", flush=True)
    deadline = time.time() + 60
    while not os.path.exists(sentinel):
        if time.time() > deadline:
            raise RuntimeError("launcher never wrote the kill sentinel")
        time.sleep(0.1)
    budget = float(os.environ["PILOSA_TPU_POD_TIMEOUT"])
    t0 = time.time()
    try:
        srv.pod.count_expr("i", ("leaf", 0), [("f", "standard", 1)],
                           list(range(n_slices + 1)))
        raise AssertionError("a collective with a dead process must fail")
    except PodError as e:
        elapsed = time.time() - t0
        assert elapsed < budget + 5, (elapsed, str(e))
    assert srv.pod._poisoned, "a dead process must poison the pod"
    # The next Count through the HTTP route: the host fan-out, exact.
    t0 = time.time()
    got = json.loads(http("POST", coord, "/index/i/query",
                          b"Count(Bitmap(frame=f, rowID=1))"))["results"]
    first_s = time.time() - t0
    assert got == [3 * n_slices], got
    assert first_s < budget + 5, first_s

    import concurrent.futures

    def check(_):
        got = json.loads(http("POST", coord, "/index/i/query", (
            b"Count(Intersect(Bitmap(frame=f, rowID=1),"
            b" Bitmap(frame=f, rowID=2)))")))["results"]
        assert got == [2 * n_slices], got
        pairs = json.loads(http("POST", coord, "/index/i/query",
                                b"TopN(frame=f, n=2)"))["results"][0]
        assert _pairs(pairs) == [(1, 3 * n_slices), (2, 2 * n_slices)], \
            pairs
        return True

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        assert all(ex.map(check, range(24)))
    t0 = time.time()
    try:
        srv.pod._dispatch({"kind": "count_expr", "index": "i",
                           "expr": ["leaf", 0],
                           "leaves": [["f", "standard", 1]],
                           "slices": [0]})
        raise AssertionError("a poisoned pod must refuse collectives")
    except PodError:
        assert time.time() - t0 < 5
    # A Count that needs the dead process's slice: its podLocal leg is
    # refused, and the query answers 400 with the transport error (the
    # JAX executor's re-map finds no other owner and raises the leg's
    # ClientError; the handlers map it to 400), within the budget.
    from pilosa_tpu_torch.server import codec
    body = codec.encode_query_request("Count(Bitmap(frame=f, rowID=1))",
                                      [n_slices], remote=False)
    t0 = time.time()
    try:
        http("POST", coord, "/index/i/query", body,
             "application/x-protobuf")
        raise AssertionError("a read of a dead owner's slice answered")
    except RuntimeError as e:
        assert ": 400: " in str(e), str(e)
    assert time.time() - t0 < budget + 5
    print("POD_KILL_TEST_OK", flush=True)
    srv.close()


def cluster_main(role: str, data_dir: str) -> None:
    """A pod node of a static two-node cluster: b0 the coordinator (a
    cluster node beside ``$POD_CLUSTER_A``), b1 its worker (no cluster
    member)."""
    from pilosa_tpu_torch.cluster.topology import Cluster, Node
    peers = os.environ["PILOSA_TPU_POD_PEERS"].split(",")
    if role == "b0":
        nodes = [Node(os.environ["POD_CLUSTER_A"]), Node(peers[0])]
        srv = _server(data_dir, peers[0], cluster=Cluster(nodes=nodes),
                      cluster_type="http", polling_interval=0.3)
    else:
        srv = _server(data_dir, peers[1], polling_interval=0)
    while True:
        time.sleep(0.5)


def serve_main(pid: int, data_dir: str) -> None:
    """A pod process that only serves (its test drives the coordinator)."""
    host = os.environ["PILOSA_TPU_POD_PEERS"].split(",")[pid]
    _server(data_dir, host, polling_interval=0)
    while True:
        time.sleep(0.5)


def main() -> None:
    mode, arg, data_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    if mode == "pod":
        pod_main(int(arg), data_dir)
    elif mode == "serve":
        serve_main(int(arg), data_dir)
    elif mode == "kill":
        kill_main(int(arg), data_dir)
    else:
        cluster_main(arg, data_dir)


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)

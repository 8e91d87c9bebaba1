"""parallel.pod of the port against the JAX package's, without a
process group: the nine cases of tests/test_pod_unit.py (placement,
shard balancing, poisoning, divergence) run on the JAX ``Pod`` and on
the port's, built through ``Pod._init_state`` with the same inputs and
the same stub transports; and the work-item bodies that a JAX and a
port coordinator post for the same Count, batched Count, field Range
Count and TopN forms over the same data are byte-equal (the wire is the
JAX item). Tolerance: exact (equal lists, equal bytes).
"""

import json

import numpy as np
import pytest

from pilosa_tpu.errors import PilosaError as JPilosaError
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.models.frame import Field as JField
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.parallel import pod as jpod_mod

from pilosa_tpu_torch.errors import PilosaError as TPilosaError
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.models.frame import Field as TField
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.parallel import costmodel
from pilosa_tpu_torch.parallel import pod as tpod_mod

PKGS = [pytest.param((jpod_mod, JPilosaError), id="jax"),
        pytest.param((tpod_mod, TPilosaError), id="port")]
W = 1 << 20


def make_pod(mod, pid=0, n=2, peers=None, holder=None):
    p = mod.Pod.__new__(mod.Pod)
    p._init_state(holder, pid, n, peers or [f"h{i}:1" for i in range(n)])
    p.timeout = 1.0
    return p


@pytest.mark.parametrize("pkg", PKGS)
class TestPlacement:
    def test_owner_round_robin(self, pkg):
        p = make_pod(pkg[0], n=3)
        assert [p.owner_pid(s) for s in range(6)] == [0, 1, 2, 0, 1, 2]

    def test_owned_filters_and_sorts(self, pkg):
        p = make_pod(pkg[0], pid=1, n=2)
        assert p.owned([5, 3, 0, 1, 7]) == [1, 3, 5, 7]

    def test_max_shard_balances_unbalanced_lists(self, pkg):
        p = make_pod(pkg[0], n=2)
        assert p.max_shard_slices([1, 3, 5, 7]) == 4
        assert p._local_slices([1, 3, 5, 7]) == [-1, -1, -1, -1]
        p1 = make_pod(pkg[0], pid=1, n=2)
        assert p1._local_slices([1, 3, 5, 7]) == [1, 3, 5, 7]
        assert p.max_shard_slices([0, 2, 3]) == 2
        assert p._local_slices([0, 2, 3]) == [0, 2]
        assert p1._local_slices([0, 2, 3]) == [3, -1]

    def test_empty(self, pkg):
        assert make_pod(pkg[0]).max_shard_slices([]) == 0


ITEM = {"kind": "count_expr", "index": "i", "expr": [], "leaves": [],
        "slices": [0, 1]}


@pytest.mark.parametrize("pkg", PKGS)
class TestDispatchFailureSemantics:
    def test_unreachable_worker_before_any_delivery_not_poisoned(self, pkg):
        mod, err = pkg
        p = make_pod(mod, n=2)

        def never_delivers(pid, method, path, body, ctype, sent=None):
            raise OSError("connection refused")

        p._request = never_delivers
        with pytest.raises(err, match="not reachable"):
            p._dispatch(dict(ITEM))
        assert not p._poisoned
        with pytest.raises(err, match="not reachable"):
            p._dispatch(dict(ITEM))

    def test_partial_delivery_poisons(self, pkg):
        mod, err = pkg
        p = make_pod(mod, n=3)

        def one_delivers(pid, method, path, body, ctype, sent=None):
            if pid == 1:
                if sent is not None:
                    sent.set()
                return b'{"total": 0}'
            raise OSError("connection refused")

        p._request = one_delivers
        with pytest.raises(err, match="disabled"):
            p._dispatch(dict(ITEM))
        assert p._poisoned
        with pytest.raises(err, match="disabled"):
            p._dispatch(dict(ITEM))

    def test_collective_failure_poisons(self, pkg):
        p = make_pod(pkg[0], n=2)

        def delivers(pid, method, path, body, ctype, sent=None):
            if sent is not None:
                sent.set()
            return b'{"total": 7}'

        p._request = delivers

        def boom(item):
            raise RuntimeError("gloo timeout")

        p.run_item = boom
        with pytest.raises(RuntimeError, match="gloo timeout"):
            p._dispatch(dict(ITEM, slices=[0]))
        assert p._poisoned

    def test_divergent_worker_result_raises(self, pkg):
        mod, err = pkg
        p = make_pod(mod, n=2)

        def delivers(pid, method, path, body, ctype, sent=None):
            if sent is not None:
                sent.set()
            return b'{"total": 999}'

        p._request = delivers
        p.run_item = lambda item: {"total": 7}
        with pytest.raises(err, match="divergence"):
            p._dispatch(dict(ITEM, slices=[0]))

    def test_agreeing_results_succeed(self, pkg):
        p = make_pod(pkg[0], n=2)

        def delivers(pid, method, path, body, ctype, sent=None):
            if sent is not None:
                sent.set()
            return b'{"total": 7}'

        p._request = delivers
        p.run_item = lambda item: {"total": 7}
        assert p._dispatch(dict(ITEM, slices=[0])) == {"total": 7}
        assert not p._poisoned
        assert p.dispatch_counts == {"count_expr": 1}


def test_a_refused_worker_fails_the_dispatch_at_once():
    """ROADMAP fault 3.25: a worker whose connection is refused is
    undelivered at once in the port; the JAX dispatcher waits out its
    delivery timeout (min(pod timeout, 15 s)) on every such dispatch.
    The outcome is the same: "not reachable", not poisoned."""
    import time

    def refused(pid, method, path, body, ctype, sent=None):
        raise OSError("connection refused")

    took = {}
    for name, mod, err in (("jax", jpod_mod, JPilosaError),
                           ("port", tpod_mod, TPilosaError)):
        p = make_pod(mod, n=2)
        p.timeout = 1.5
        p._request = refused
        t0 = time.perf_counter()
        with pytest.raises(err, match="not reachable"):
            p._dispatch(dict(ITEM))
        took[name] = time.perf_counter() - t0
        assert not p._poisoned
    assert took["jax"] >= 1.4, took
    assert took["port"] < 0.5, took


# -- the wire: work-item bodies of both coordinators --------------------------

QUERIES = [
    "Count(Bitmap(frame=f, rowID=1))",
    "Count(Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))",
    "Count(Difference(Union(Bitmap(frame=f, rowID=1),"
    " Bitmap(frame=f, rowID=3)), Bitmap(frame=f, rowID=2)))",
    "Count(Bitmap(frame=f, rowID=1)) Count(Bitmap(frame=f, rowID=2))"
    " Count(Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=3)))",
    "Count(Range(frame=v, amt > 17))",
    "Count(Range(frame=v, amt >< [-20, 40]))",
    "TopN(Bitmap(frame=f, rowID=2), frame=f, ids=[1, 2, 3])",
    "TopN(Bitmap(frame=f, rowID=2), frame=f, ids=[1, 3], threshold=2)",
    "TopN(Bitmap(frame=f, rowID=1), frame=f, ids=[2, 3],"
    " tanimotoThreshold=30)",
]


def _fill(holder, rng):
    idx = holder.create_index("i")
    f = idx.create_frame("f")
    for row in (1, 2, 3):
        cols = np.unique(rng.integers(0, 4 * W, size=400, dtype=np.uint64))
        f.import_bits(np.full(len(cols), row, dtype=np.uint64), cols)
    return idx


def _recording_pod(mod, holder, bodies: list):
    p = make_pod(mod, pid=0, n=2, holder=holder)
    p.timeout = 30.0

    def stub(pid, method, path, body, ctype, sent=None):
        bodies.append(body)
        if sent is not None:
            sent.set()
        return json.dumps(p.run_item(json.loads(body))).encode()

    p._request = stub
    return p


def test_work_item_bodies_are_byte_equal(tmp_path):
    jh, th = JHolder(str(tmp_path / "j")), THolder(str(tmp_path / "t"))
    jh.open()
    th.open()
    try:
        for h, field in ((jh, JField), (th, TField)):
            idx = _fill(h, np.random.default_rng(5))
            v = idx.create_frame("v")
            v.create_field(field("amt", -50, 100))
            for s in range(4):
                v.set_field_value("amt", s * W + 3, 11 * s - 7)
        jbodies, tbodies = [], []
        jex = JExecutor(jh, use_mesh=True, mesh_min_slices=1,
                        pod=_recording_pod(jpod_mod, jh, jbodies))
        tex = TExecutor(th, device="cpu", mesh_min_slices=1,
                        cost_model=costmodel.pinned(0.0),
                        pod=_recording_pod(tpod_mod, th, tbodies))
        for q in QUERIES:
            n0 = len(jbodies)
            jex.execute("i", q)
            tex.execute("i", q)
            assert len(jbodies) == n0 + 1, q
            assert tbodies[n0:] == jbodies[n0:], (q, jbodies[n0:],
                                                  tbodies[n0:])
        kinds = [json.loads(b)["kind"] for b in tbodies]
        assert kinds.count("count_exprs") == 1
        assert kinds.count("topn_exact") == 3
        tex.close()
    finally:
        jh.close()
        th.close()


def _wsgi(app, method, path, body=b"", content_type="application/json"):
    import io
    path, _, qs = path.partition("?")
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(body)),
               "CONTENT_TYPE": content_type,
               "HTTP_ACCEPT": content_type,
               "wsgi.input": io.BytesIO(body)}
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])

    body = b"".join(app(environ, start_response))
    return out["status"], body


def test_pod_exec_route_without_and_with_a_pod(tmp_path):
    """``POST /pod/exec``: 404 "not a pod process" on both handlers
    without a pod; with one, the port's route runs the work item on its
    pod (here a one-process pod over the same data as the JAX one) and
    answers what the JAX route answers."""
    from pilosa_tpu.server.handler import Handler as JHandler
    from pilosa_tpu_torch.server.handler import Handler as THandler
    jh, th = JHolder(str(tmp_path / "j")), THolder(str(tmp_path / "t"))
    jh.open()
    th.open()
    try:
        for h in (jh, th):
            _fill(h, np.random.default_rng(9))
        item = json.dumps({"kind": "count_exprs", "index": "i",
                           "exprs": [["leaf", 0],
                                     ["and", ["leaf", 0], ["leaf", 1]]],
                           "leaves": [["f", "standard", 1],
                                      ["f", "standard", 2]],
                           "slices": [0, 1, 2, 3]}).encode()
        jex, tex = JExecutor(jh), TExecutor(th, device="cpu")
        bare = [JHandler(jh, jex, host="local"),
                THandler(th, tex, host="local")]
        got = [_wsgi(h, "POST", "/pod/exec", item) for h in bare]
        assert got[0] == got[1]
        assert got[1][0] == 404 and b"not a pod process" in got[1][1]
        pods = [make_pod(jpod_mod, n=1, holder=jh),
                make_pod(tpod_mod, n=1, holder=th)]
        with_pod = [JHandler(jh, jex, host="local", pod=pods[0]),
                    THandler(th, tex, host="local", pod=pods[1])]
        got = [_wsgi(h, "POST", "/pod/exec", item) for h in with_pod]
        assert got[0][0] == got[1][0] == 200
        assert json.loads(got[0][1]) == json.loads(got[1][1])
        assert json.loads(got[1][1])["totals"][0] > 0
        tex.close()
    finally:
        jh.close()
        th.close()

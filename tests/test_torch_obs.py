"""The port's observability (``pilosa_tpu_torch.obs``, ``utils.stats``,
``plan.store``) and its query lifecycle over HTTP against the JAX
package.

- metrics: two fresh registries fed the same seeded events render
  byte-identical 0.0.4 text (and OpenMetrics without exemplars); the
  port declares a subset of the JAX families with the same types,
  labels and help texts, and every JAX family it leaves out is named
  below with the reason; the StatsClient bridge and the expvar and
  fan-out clients give the same output;
- accounting and tracing: the same notes give the same cost tree,
  summary and wire JSON; the same spans the same Chrome trace;
- the plan store: the same rows for the same records;
- the HTTP lifecycle: a JAX ``Handler`` and the port's ``Handler``,
  each with one admission slot, over copies of one data directory,
  under ``?timeout=`` (a deadline while queued), ``DELETE
  /debug/queries/{id}`` (a cancel while queued), a full queue and
  ``?profile=1``: the same status codes, error texts, headers and JSON
  keys (ids and times may differ), and the debug routes' keys.
"""

import io
import json
import re
import shutil
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.obs import accounting as jax_accounting
from pilosa_tpu.obs import metrics as jax_metrics
from pilosa_tpu.obs import trace as jax_trace
from pilosa_tpu.plan import store as jax_store
from pilosa_tpu.sched import AdmissionController as JaxAdmission
from pilosa_tpu.sched import TenantRegistry as JaxTenants
from pilosa_tpu.server.handler import Handler as JaxHandler
from pilosa_tpu.utils import stats as jax_stats

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.obs import accounting, metrics, trace
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.plan import store
from pilosa_tpu_torch.sched import AdmissionController, TenantRegistry
from pilosa_tpu_torch.server.handler import Handler
from pilosa_tpu_torch.utils import stats

# JAX families the port does not declare: no event of the port raises
# them (their subsystems have no counterpart).
LEFT_OUT = {
    "pilosa_build_info": "its labels name jax, which the port lacks",
    **{name: "no XLA programs: the kernel build is charged per query as"
             " compileMs in the cost ledger" for name in (
        "pilosa_compile_cache_build_seconds_total",
        "pilosa_compile_cache_hits_total",
        "pilosa_compile_cache_misses_total",
        "pilosa_compile_cache_programs_live")},
}


def _shape(fam) -> tuple:
    return (fam.type, fam.labelnames, fam.help,
            getattr(fam, "buckets", None))


def test_family_set_matches():
    jax_fams = {n: f for n, f in
                jax_metrics.default_registry().families().items()
                if not n.startswith("pilosa_stats_")}
    port_fams = {n: f for n, f in
                 metrics.default_registry().families().items()
                 if not n.startswith("pilosa_stats_")}
    assert set(port_fams) <= set(jax_fams)
    for name, fam in port_fams.items():
        assert _shape(fam) == _shape(jax_fams[name]), name
    assert set(jax_fams) - set(port_fams) == set(LEFT_OUT)


def _feed(mod, seed: int) -> str:
    reg = mod.Registry()
    c = reg.counter("pilosa_test_events_total", "events, by kind",
                    labels=("kind",))
    g = reg.gauge("pilosa_test_depth_items", "depth \\ with a \"quote\"")
    h = reg.histogram("pilosa_test_wait_seconds", "waits",
                      labels=("lane",))
    hb = reg.histogram("pilosa_test_size_items", buckets=(1, 2, 4, 8))
    capped = reg.counter("pilosa_test_capped_total", labels=("peer",),
                         max_label_sets=3)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        k = int(rng.integers(5))
        if k == 0:
            c.labels(kind=["a", "b\n", 'c"'][int(rng.integers(3))]).inc(
                float(rng.integers(1, 4)))
        elif k == 1:
            g.set(float(rng.integers(-5, 50)) / 4)
        elif k == 2:
            h.labels(["read", "write"][int(rng.integers(2))]).observe(
                float(rng.exponential(0.05)))
        elif k == 3:
            hb.observe(int(rng.integers(0, 12)))
        else:
            capped.labels(f"p{int(rng.integers(6))}").inc()
    return reg.render() + "\n" + reg.render(openmetrics=True)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_registry_render_identical(seed):
    assert _feed(metrics, seed) == _feed(jax_metrics, seed)


def _stats_run(stats_mod, metrics_mod):
    reg = metrics_mod.Registry()
    expvar = stats_mod.ExpvarStatsClient()
    multi = stats_mod.MultiStatsClient(
        [expvar, metrics_mod.RegistryStatsClient(reg)])
    child = multi.with_tags("index:i", "frame:f")
    for i in range(20):
        child.count("setN", i % 3)
        multi.gauge("maxSlice", i)
        child.histogram("slowQueryNs", 1e6 * (i + 1))
        multi.timing("queryNs", 5e5 * (i % 4 + 1))
        multi.set("state", f"s{i}")
    return reg.render(), multi.snapshot()


def test_stats_clients_identical():
    assert _stats_run(stats, metrics) == _stats_run(jax_stats, jax_metrics)


def _cost_run(mod, seed: int):
    rng = np.random.default_rng(seed)
    cost = mod.QueryCost(node="n1")
    for _ in range(100):
        k = int(rng.integers(6))
        if k == 0:
            cost.note_container_op(
                ["intersect", "union"][int(rng.integers(2))],
                ["array_array", "bitmap_bitmap"][int(rng.integers(2))],
                int(rng.integers(0, 2048)))
        elif k == 1:
            cost.note_bits_written(int(rng.integers(1, 9)))
        elif k == 2:
            cost.note_device_dispatch(int(rng.integers(0, 1 << 20)))
        elif k == 3:
            cost.note_compile(float(rng.integers(1, 1000)) / 1e6)
        elif k == 4:
            cost.note_result_cache_hit()
        else:
            cost.note_wal_wait(float(rng.integers(1, 50)) / 1e5)
    stages = {"parse": 0.001, "admission": 0.0025, "execute": 0.0125}
    return (cost.to_tree(stages), cost.summary(), cost.wire_json(stages),
            cost.wire_json(stages, max_bytes=64))


@pytest.mark.parametrize("seed", [5, 6])
def test_cost_ledger_identical(seed):
    assert _cost_run(accounting, seed) == _cost_run(jax_accounting, seed)


def _trace_run(mod):
    tracer = mod.Tracer(enabled=False, max_traces=2, max_spans=5)

    class Ctx:
        id = "q1"
        node = "n1"
        pql = "Count(Bitmap(rowID=1))"

    t = tracer.start(Ctx(), node="n1")
    t.started = 1000.0
    for i in range(7):  # past max_spans: two dropped
        t.add_span(f"s{i}", 1000.0 + i / 1e3, 0.0005 * i,
                   tags={"kind": "count_expr"} if i % 2 else None,
                   tid=7 + i % 2)
    kept = tracer.keep(t, reason="requested")
    again = tracer.keep(t, reason="requested")
    summary = tracer.traces()
    return (kept, again, summary, t.to_chrome(), t.spans_json(),
            tracer.get("q1") is t, tracer.get("nope"))


def test_trace_identical():
    assert _trace_run(trace) == _trace_run(jax_trace)


def _store_run(mod):
    s = mod.PlanStore(max_fingerprints=3)
    rng = np.random.default_rng(9)
    for i in range(40):
        fp = f"fp{int(rng.integers(5))}"
        est = int(rng.integers(0, 100))
        s.record(fp, {"calls": [{"op": "Count", "i": i}]},
                 float(rng.integers(1, 100)) / 1e3, pql=f"Count({fp})",
                 est_rows=est, actual_rows=int(est * rng.uniform(0, 3)))
    snap = s.snapshot(limit=2)
    for row in snap["plans"]:
        row.pop("lastSeen")
    return snap


def test_plan_store_rows_identical():
    assert _store_run(store) == _store_run(jax_store)


# -- the HTTP lifecycle, both handlers ----------------------------------------

N_SLICES = 2


def call(app, method, path, body=b"", headers=None):
    """Invoke a WSGI app in-process → (status, headers, body)."""
    path, _, qs = path.partition("?")
    if isinstance(body, str):
        body = body.encode()
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    for k, v in (headers or {}).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    out = {}

    def start_response(status, hdrs):
        out["status"] = int(status.split()[0])
        out["headers"] = dict(hdrs)

    chunks = app(environ, start_response)
    return out["status"], out["headers"], b"".join(chunks)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One data directory written by the JAX package."""
    root = tmp_path_factory.mktemp("lifecycle")
    jh = JaxHolder(str(root / "jax"))
    jh.open()
    rng = np.random.default_rng(21)
    f = jh.create_index("i").create_frame("f")
    for row in range(4):
        cols = rng.choice(N_SLICES * SLICE_WIDTH, size=500, replace=False)
        f.import_bits(np.full(len(cols), row, np.uint64),
                      cols.astype(np.uint64))
    jh.close()
    return root


@pytest.fixture
def make_handlers(data_dir, tmp_path):
    """make(depth) → (JAX handler, port handler), each with one slot and
    a queue of ``depth``, over copies of the directory."""
    opened = []

    def make(depth: int):
        shutil.copytree(data_dir / "jax", tmp_path / "jax")
        shutil.copytree(data_dir / "jax", tmp_path / "port")
        jh = JaxHolder(str(tmp_path / "jax"))
        jh.open()
        th = Holder(str(tmp_path / "port"))
        th.open()
        jex = JaxExecutor(jh, host="local")
        opened.extend([jex, jh, th])
        jt, tt = JaxTenants(), TenantRegistry()
        return (JaxHandler(jh, jex, host="local",
                           admission=JaxAdmission(1, depth, tenants=jt),
                           tenants=jt),
                Handler(th, Executor(th, device="cpu", mesh_min_slices=1),
                        host="local",
                        admission=AdmissionController(1, depth,
                                                      tenants=tt),
                        tenants=tt))

    yield make
    for obj in opened:
        obj.close()
    residency.device_cache().clear()


@pytest.fixture
def handlers(make_handlers):
    return make_handlers(1)


COUNT = "Count(Intersect(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f)))"


def _keys(obj):
    """The key structure of a JSON value (nested dict keys; a list by its
    first element's)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return None


def _both(handlers, method, path, body=b"", headers=None):
    return [call(h, method, path, body, headers) for h in handlers]


def test_profile_and_headers(handlers):
    want, got = _both(handlers, "POST", "/index/i/query?profile=1", COUNT,
                      {"X-Pilosa-Query-Id": "p1"})
    assert got[0] == want[0] == 200
    jw, jg = json.loads(want[2]), json.loads(got[2])
    assert jg["results"] == jw["results"]
    assert set(jg) == set(jw) == {"results", "profile", "plan"}
    assert set(jg["profile"]) == set(jw["profile"])
    assert set(jg["plan"]) == set(jw["plan"])
    for k in ("X-Pilosa-Query-Id", "X-Pilosa-Stats", "Content-Type"):
        assert k in got[1] and k in want[1], k
    assert got[1]["X-Pilosa-Query-Id"] == want[1]["X-Pilosa-Query-Id"] \
        == "p1"
    assert set(json.loads(got[1]["X-Pilosa-Stats"])) == \
        set(json.loads(want[1]["X-Pilosa-Stats"]))


def _hold(handler):
    return handler.admission.acquire("read", tenant="holder")


def _queued(handler, qid, within_s=10.0):
    t_end = time.monotonic() + within_s
    while time.monotonic() < t_end:
        qs = json.loads(call(handler, "GET", "/debug/queries")[2])
        if any(q["id"] == qid and q["state"] == "queued"
               for q in qs["queries"]):
            return
        time.sleep(0.005)
    raise AssertionError(f"{qid} never queued")


def test_deadline_while_queued(handlers):
    outs = []
    for h in handlers:
        slot = _hold(h)
        try:
            outs.append(call(h, "POST", "/index/i/query?timeout=50ms", COUNT,
                             {"X-Pilosa-Query-Id": "d1"}))
        finally:
            slot.release()
    (sw, hw, bw), (sg, hg, bg) = outs
    assert sg == sw == 504
    pat = r"query d1: deadline exceeded after 0\.\d{3}s"
    assert re.fullmatch(pat, json.loads(bg)["error"])
    assert re.fullmatch(pat, json.loads(bw)["error"])
    assert hg["X-Pilosa-Query-Id"] == hw["X-Pilosa-Query-Id"] == "d1"


def test_cancel_while_queued(handlers):
    outs = []
    for h in handlers:
        slot = _hold(h)
        res = {}
        th = threading.Thread(target=lambda: res.setdefault("r", call(
            h, "POST", "/index/i/query", COUNT,
            {"X-Pilosa-Query-Id": "c1"})))
        th.start()
        try:
            _queued(h, "c1")
            deleted = call(h, "DELETE", "/debug/queries/c1")
            th.join(10)
        finally:
            slot.release()
        outs.append((deleted, res["r"]))
    (dw, rw), (dg, rg) = outs
    assert dg[0] == dw[0] == 200
    assert json.loads(dg[2]) == json.loads(dw[2]) == \
        {"id": "c1", "cancelled": 1}
    assert rg[0] == rw[0] == 409
    assert json.loads(rg[2]) == json.loads(rw[2]) == \
        {"error": "query c1 cancelled: cancelled via API"}
    # The next query answers as before.
    want, got = _both(handlers, "POST", "/index/i/query", COUNT)
    assert got[0] == want[0] == 200 and got[2] == want[2]


@pytest.mark.parametrize("depth", [0, 1])
def test_full_queue_answers_429(make_handlers, depth):
    handlers = make_handlers(depth)
    outs = []
    for h in handlers:
        slot = _hold(h)
        waiter = None
        if h.admission.queue_depth:
            res = {}
            waiter = threading.Thread(target=lambda: res.setdefault(
                "r", call(h, "POST", "/index/i/query?timeout=2s", COUNT,
                          {"X-Pilosa-Query-Id": "w1"})))
            waiter.start()
            _queued(h, "w1")
        try:
            outs.append(call(h, "POST", "/index/i/query", COUNT))
        finally:
            slot.release()
            if waiter is not None:
                waiter.join(10)
    (sw, hw, bw), (sg, hg, bg) = outs
    assert sg == sw == 429
    assert bg == bw
    assert bg.decode().startswith("too many requests: admission queue full")
    assert hg["Retry-After"] == hw["Retry-After"]
    assert hg["Content-Type"] == hw["Content-Type"]


@pytest.mark.parametrize("path", ["/index/i/query?timeout=abc",
                                  "/index/i/query?timeout=5"])
def test_bad_timeout(handlers, path):
    want, got = _both(handlers, "POST", path, COUNT,
                      {"X-Pilosa-Deadline": "soon"}
                      if path.endswith("5") else None)
    assert got[0] == want[0] == 400
    assert got[2] == want[2]


def test_debug_routes(handlers):
    # A traced query under a named tenant, then every debug route.
    for h in handlers:
        status, hdrs, _ = call(h, "POST", "/index/i/query?trace=1", COUNT,
                               {"X-Pilosa-Query-Id": "t1",
                                "X-Pilosa-Tenant": "acme"})
        assert status == 200
    for path, keys_only in (("/debug/queries", True),
                            ("/debug/queries/slow", False),
                            ("/debug/traces", True),
                            ("/debug/traces?source=disk", True),
                            ("/debug/traces/summary", False),
                            ("/debug/traces/t1?format=spans", True),
                            ("/debug/traces/nope", False),
                            ("/debug/tenants", True),
                            ("/debug/plans", True)):
        want, got = _both(handlers, "GET", path)
        assert got[0] == want[0], path
        if got[0] != 200:
            assert got[2] == want[2], path
            continue
        jw, jg = json.loads(want[2]), json.loads(got[2])
        if keys_only:
            assert set(jg) == set(jw), path
        else:
            assert jg == jw, path
    tenants = [json.loads(call(h, "GET", "/debug/tenants")[2])["tenants"]
               for h in handlers]
    assert "acme" in tenants[0] and "acme" in tenants[1]
    assert set(tenants[1]["acme"]) == set(tenants[0]["acme"])
    chrome = [json.loads(call(h, "GET", "/debug/traces/t1")[2])
              for h in handlers]
    assert set(chrome[1]) == set(chrome[0])
    names = [{e["name"] for e in c["traceEvents"]} for c in chrome]
    # The handler's spans in both; the executors' own spans differ (the
    # JAX map-reduce legs, the port's mesh dispatches).
    stages = {"parse", "admission", "execute", "query_cost"}
    assert stages <= names[0] and stages <= names[1]
    plans = [json.loads(call(h, "GET", "/debug/plans")[2])
             for h in handlers]
    rows = [{p["fingerprint"]: (p["count"], p["examplePql"])
             for p in pl["plans"]} for pl in plans]
    assert rows[1] == rows[0]
    want, got = _both(handlers, "GET", "/metrics")
    assert got[0] == want[0] == 200
    assert got[1]["Content-Type"] == want[1]["Content-Type"]
    assert b'pilosa_query_requests_total{call="Count",lane="read",' \
           b'status="200"}' in got[2]


def _hist_count(fam, **labels) -> int:
    return sum(child.snapshot()[2] for lbl, child in fam._label_dicts()
               if all(lbl.get(k) == v for k, v in labels.items()))


def test_write_path_families_move_alike(handlers):
    """The WAL's three families, the import stages and the apply gate's
    depth, and the per-tenant cache share move alike in both packages:
    a SetBit's commit barrier is one group-commit leader flush, a
    protobuf ``/import`` observes its decode and apply stages and
    leaves the depth at 0 (its answer's ``X-Pilosa-Stats`` has the JAX
    keys), and a cached Union shows the same bytes for its tenant."""
    from pilosa_tpu.proto import internal_pb2 as jpb
    mods = (jax_metrics, metrics)
    before = [(_hist_count(m.WAL_GROUP_BATCH_SIZE),
               _hist_count(m.WAL_GROUP_FLUSH_SECONDS),
               _hist_count(m.IMPORT_STAGE_SECONDS, stage="decode"),
               _hist_count(m.IMPORT_STAGE_SECONDS, stage="apply"))
              for m in mods]
    for st, _, _ in _both(handlers, "POST", "/index/i/query",
                          "SetBit(frame=f, rowID=7, columnID=9)"):
        assert st == 200
    body = jpb.ImportRequest(Index="i", Frame="f", Slice=0,
                             RowIDs=[8, 8, 9],
                             ColumnIDs=[1, 2, 3]).SerializeToString()
    got = []
    for h in handlers:
        environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/import",
                   "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
                   "CONTENT_TYPE": "application/x-protobuf",
                   "HTTP_ACCEPT": "application/x-protobuf",
                   "wsgi.input": io.BytesIO(body)}
        out = {}

        def start_response(status, hdrs, out=out):
            out["status"] = int(status.split()[0])
            out["headers"] = dict(hdrs)

        b"".join(h(environ, start_response))
        got.append((out["status"], out["headers"]))
    assert [g[0] for g in got] == [200, 200]
    stats = [json.loads(g[1]["X-Pilosa-Stats"]) for g in got]
    assert set(stats[1]) == set(stats[0])
    assert stats[1]["bits"] == stats[0]["bits"] == 3
    after = [(_hist_count(m.WAL_GROUP_BATCH_SIZE),
              _hist_count(m.WAL_GROUP_FLUSH_SECONDS),
              _hist_count(m.IMPORT_STAGE_SECONDS, stage="decode"),
              _hist_count(m.IMPORT_STAGE_SECONDS, stage="apply"))
             for m in mods]
    for b, a in zip(before, after):
        assert a[0] > b[0] and a[1] > b[1]
        assert a[2] == b[2] + 1 and a[3] == b[3] + 1
    assert [m.IMPORT_PIPELINE_DEPTH.value for m in mods] == [0, 0]
    union = "Union(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f))"
    for _ in range(2):
        assert [g[0] for g in _both(handlers, "POST", "/index/i/query",
                                    union)] == [200, 200]
    shares = []
    for h, m in zip(handlers, mods):
        st, _, out = call(h, "GET", "/metrics")
        assert st == 200
        line = [ln for ln in out.decode().splitlines()
                if ln.startswith('pilosa_tenant_cache_bytes{tenant="i"}')]
        shares.append(line)
        usage = h.executor.tenant_cache_usage()
        assert usage["i"]["bytes"] > 0
    assert shares[1] == shares[0] and shares[1]
    rows = [json.loads(call(h, "GET", "/debug/tenants")[2])["tenants"]
            for h in handlers]
    assert rows[1]["i"]["cache"] == rows[0]["i"]["cache"]

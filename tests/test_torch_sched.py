"""The port's query lifecycle (``pilosa_tpu_torch.sched``) against the
JAX package's (``pilosa_tpu.sched``) on the same seeded input.

- the Go-style duration parser behind ``?timeout=``: the same seconds
  and the same error texts;
- ``AdmissionController``: the grant order of a seeded script of
  arrivals over lanes and tenants (one slot, every waiter queued in the
  script's order, then drained), the rejections with their Retry-After
  and tenant scope, a deadline and a cancel while queued;
- ``TenantRegistry``: the kill decision on a seeded cost ledger, the
  penalty box and the snapshot;
- ``QueryContext`` and ``QueryRegistry``: the check order (cancel,
  deadline, cost policy), the JSON view, cancel by id and the slow log;
- the port server's pipelined batch lane: one admission slot (declined
  when admission is full) and one context, whose cancel between calls
  leaves the earlier requests' answers as they would be alone.

Answers are exact.
"""

import threading
import time

import numpy as np
import pytest

from pilosa_tpu import errors as jax_errors
from pilosa_tpu.obs import accounting as jax_accounting
from pilosa_tpu.sched import admission as jax_admission
from pilosa_tpu.sched import context as jax_context
from pilosa_tpu.sched import registry as jax_registry
from pilosa_tpu.sched import tenants as jax_tenants
from pilosa_tpu.utils import config as jax_config

from pilosa_tpu_torch import errors
from pilosa_tpu_torch.obs import accounting
from pilosa_tpu_torch.sched import admission
from pilosa_tpu_torch.sched import context
from pilosa_tpu_torch.sched import registry
from pilosa_tpu_torch.sched import tenants
from pilosa_tpu_torch.utils import config

# The two packages side by side: (JAX module, port module).
PAIRS = {"jax": (jax_admission, jax_tenants, jax_context, jax_registry,
                 jax_errors, jax_accounting),
         "port": (admission, tenants, context, registry, errors,
                  accounting)}

DURATIONS = ["10m", "1h30m", "45s", "100ms", "1.5s", "2us", "3ns", "0s",
             "1h2m3s4ms", "250ms", "90m", 5, 2.5, 0, "", "abc", "10x",
             "ms", "-5s", "1d"]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("value", DURATIONS)
def test_parse_duration(value):
    assert _outcome(config.parse_duration, value) == \
        _outcome(jax_config.parse_duration, value)


@pytest.mark.parametrize("table", [
    {"default": {"weight": 2}, "bulk": {"weight": "0.5",
                                        "max-wall": "250ms"}},
    {"bulk": {"weight": 1}},
    {"default": {"weight": 0}},
    {"default": {"queue-depth": -1}},
    {"default": {"cache-share": 1.5}},
    {"default": {"colour": "red"}},
    {"default": {}, "x": "not a table"},
])
def test_tenant_table_validation(table):
    assert _outcome(config.parse_tenant_table, table) == \
        _outcome(jax_config.parse_tenant_table, table)


def _script(seed: int, n: int = 24):
    """A seeded arrival script: (lane, tenant) pairs."""
    rng = np.random.default_rng(seed)
    lanes = ["read", "write", "admin"]
    tens = ["a", "b", "c"]
    return [(lanes[int(rng.integers(3))], tens[int(rng.integers(3))])
            for _ in range(n)]


def _grant_order(pkg: str, script, table) -> list:
    adm_mod, ten_mod = PAIRS[pkg][:2]
    reg = ten_mod.TenantRegistry(table)
    ac = adm_mod.AdmissionController(concurrency=1, queue_depth=len(script),
                                     tenants=reg)
    held = ac.acquire("read", tenant="hold")
    order: list = []
    threads = []
    for i, (lane, tenant) in enumerate(script):
        def run(i=i, lane=lane, tenant=tenant):
            slot = ac.acquire(lane, tenant=tenant)
            order.append(i)
            slot.release()
        th = threading.Thread(target=run)
        th.start()
        threads.append(th)
        # Wait until this waiter sits in the queue: the script's order
        # is the arrival order.
        t_end = time.monotonic() + 10
        while sum(ac.snapshot()["queued"].values()) < i + 1:
            assert time.monotonic() < t_end, "waiter never queued"
            time.sleep(0.001)
    held.release()
    for th in threads:
        th.join(10)
    return order


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_admission_grant_order(seed):
    table = config.parse_tenant_table(
        {"default": {}, "a": {"weight": 3}, "b": {"weight": 1},
         "c": {"weight": 0.5}})
    script = _script(seed)
    got = _grant_order("port", script, table)
    want = _grant_order("jax", script, table)
    assert sorted(got) == list(range(len(script)))
    assert got == want


def _rejections(pkg: str) -> list:
    adm_mod, ten_mod, _, _, _, _ = PAIRS[pkg]
    reg = ten_mod.TenantRegistry({"default": {}, "bulk": {"queue_depth": 1}})
    ac = adm_mod.AdmissionController(concurrency=1, queue_depth=2,
                                     tenants=reg)
    held = ac.acquire("read", tenant="hold")
    out = []
    waiters = []

    def wait(lane, tenant):
        th = threading.Thread(target=lambda: ac.acquire(
            lane, tenant=tenant).release())
        th.start()
        waiters.append(th)
        t_end = time.monotonic() + 10
        n = len(waiters)
        while sum(ac.snapshot()["queued"].values()) < n:
            assert time.monotonic() < t_end
            time.sleep(0.001)

    def reject(lane, tenant):
        try:
            ac.acquire(lane, tenant=tenant)
        except adm_mod.AdmissionFullError as e:
            out.append((str(e), e.retry_after_s, e.tenant))
        else:
            out.append(None)

    wait("write", "bulk")
    reject("write", "bulk")         # the tenant's own quota
    wait("read", "x")
    reject("read", "y")             # the global queue
    reject("admin", "bulk")         # quota is per lane: the global one
    snap = ac.snapshot()
    held.release()
    for th in waiters:
        th.join(10)
    out.append({k: snap[k] for k in ("concurrency", "queueDepth",
                                     "inFlight", "queued", "rejected",
                                     "weights")})
    out.append(snap["tenants"])
    return out


def test_admission_rejections():
    got = _rejections("port")
    assert got == _rejections("jax")
    assert got[0][2] == "bulk" and got[1][2] == ""


@pytest.mark.parametrize("how", ["deadline", "cancel"])
def test_waiter_leaves_the_queue(how):
    outs = {}
    for pkg in ("jax", "port"):
        adm_mod, _, ctx_mod, _, err_mod, _ = PAIRS[pkg]
        ac = adm_mod.AdmissionController(concurrency=1, queue_depth=4)
        held = ac.acquire("read")
        ctx = ctx_mod.QueryContext(pql="Count()", index="i", id="q1",
                                   timeout_s=0.05 if how == "deadline"
                                   else None)
        if how == "cancel":
            threading.Timer(0.05, ctx.cancel, args=("by test",)).start()
        with pytest.raises((err_mod.QueryDeadlineError,
                            err_mod.QueryCancelledError)) as ei:
            ac.acquire("read", ctx)
        snap = ac.snapshot()
        held.release()
        msg = str(ei.value)
        if how == "deadline":
            msg = msg.rsplit(" ", 1)[0]  # drop the elapsed seconds
        outs[pkg] = (type(ei.value).__name__, msg, snap["queued"],
                     snap["inFlight"], ctx.state)
    assert outs["port"] == outs["jax"]


def _kill_run(pkg: str, seed: int) -> dict:
    _, ten_mod, ctx_mod, _, err_mod, acc_mod = PAIRS[pkg]
    reg = ten_mod.TenantRegistry(
        {"default": {}, "t": {"max_container_ops": 60,
                              "max_device_bytes": 5000}},
        penalty_half_life_s=3600.0)
    rng = np.random.default_rng(seed)
    ctx = ctx_mod.QueryContext(pql="Count()", index="t", id="k1")
    reg.install(ctx)
    cost = acc_mod.attach(ctx)
    steps = []
    killed_at = None
    for step in range(200):
        kind = int(rng.integers(3))
        if kind == 0:
            cost.note_container_op("intersect", "array_array",
                                   int(rng.integers(1, 9)))
        elif kind == 1:
            cost.note_device_dispatch(int(rng.integers(1, 400)))
        else:
            cost.note_bits_written(int(rng.integers(1, 5)))
        try:
            ctx.check()
        except err_mod.QueryKilledError as e:
            killed_at = (step, str(e))
            break
        steps.append(cost.summary())
    other = ctx_mod.QueryContext(index="quiet", id="k2")
    reg.install(other)
    other.check()  # no ceiling: never killed
    snap = reg.snapshot()
    return {"killed": killed_at, "steps": steps,
            "killed_by": ctx.killed_by, "state": ctx.state,
            "cancel_reason": ctx.cancel_reason,
            "tenant": ctx.tenant, "other_policy": other.cost_policy,
            "snapshot": {k: {kk: (round(vv, 3) if isinstance(vv, float)
                                  else vv) for kk, vv in v.items()}
                         for k, v in snap.items()},
            "weight": round(reg.effective_weight("t"), 3)}


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_tenant_kill_decision(seed):
    got = _kill_run("port", seed)
    assert got == _kill_run("jax", seed)
    assert got["killed"] is not None and got["killed_by"] == "cost-policy"


def test_context_and_registry():
    outs = {}
    for pkg in ("jax", "port"):
        _, _, ctx_mod, reg_mod, err_mod, _ = PAIRS[pkg]
        reg = reg_mod.QueryRegistry(slow_threshold_s=1e-9)
        a = ctx_mod.QueryContext(pql="Count(Bitmap(rowID=1))", index="i",
                                 id="same", tenant="t")
        b = ctx_mod.QueryContext(pql="TopN(frame=f)", index="i",
                                 id="same", lane="write")
        for c in (a, b):
            reg.register(c)
            c.state = "running"
        active = [{k: v for k, v in j.items()
                   if k not in ("startedAt", "elapsedS")}
                  for j in reg.active()]
        n = reg.cancel_local("same", reason="by test")
        errs = []
        for c in (a, b):
            try:
                with ctx_mod.use(c):
                    ctx_mod.check_current()
            except err_mod.QueryCancelledError as e:
                errs.append(str(e))
        for c in (a, b):
            reg.finish(c, error=None)
        slow = [{k: v for k, v in e.items()
                 if k not in ("startedAt", "elapsedS", "stages")}
                for e in reg.slow_queries()]
        outs[pkg] = (active, n, errs, [a.state, b.state], len(reg),
                     reg.cancel_local("nope"), slow,
                     ctx_mod.current() is None)
    assert outs["port"] == outs["jax"]


# -- the pipelined batch lane: one slot, one context ---------------------------

@pytest.fixture
def port_server(tmp_path):
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.utils.config import QueryConfig
    srv = Server(str(tmp_path / "d"), host="127.0.0.1:0", device="cpu",
                 query_config=QueryConfig(concurrency=1, queue_depth=0))
    srv.open()
    srv.holder.create_index("i").create_frame("f")
    yield srv
    srv.close()


def test_batch_lane_declines_when_admission_is_full(port_server):
    bodies = ["SetBit(frame=f, rowID=1, columnID=1)",
              "Count(Bitmap(rowID=1, frame=f))"]
    slot = port_server.admission.acquire("read")
    try:
        # Declined: per-request dispatch answers the 429s.
        assert port_server._query_batcher("i", bodies) is None
    finally:
        slot.release()
    assert port_server._query_batcher("i", bodies) == [
        b'{"results": [true]}\n', b'{"results": [1]}\n']
    assert port_server.admission.in_flight == 0


def test_batch_lane_cancel_keeps_earlier_answers(port_server, monkeypatch):
    """A cancel of the batch's context between its calls: the requests
    before answer as sent alone, the one holding the cancelled call 409
    with the JAX text, the ones after run on their own."""
    bodies = ["SetBit(frame=f, rowID=1, columnID=1)",
              "SetBit(frame=f, rowID=1, columnID=2)",
              "Count(Bitmap(rowID=1, frame=f))",
              "Count(Bitmap(rowID=1, frame=f))"]
    seen = []
    check = context.QueryContext.check

    def cancel_at_third_call(self):
        if self.pql.startswith("<pipelined batch"):
            seen.append(self)
            if len(seen) == 4:  # the up-front check + one per call
                self.cancel("cancelled via API")
        check(self)

    monkeypatch.setattr(context.QueryContext, "check", cancel_at_third_call)
    out = port_server._query_batcher("i", bodies)
    qid = seen[0].id
    assert out[:2] == [b'{"results": [true]}\n'] * 2
    assert out[2] == (409, (
        f'{{"error": "query {qid} cancelled: cancelled via API"}}\n'
    ).encode())
    assert out[3] == b'{"results": [2]}\n'
    assert port_server.admission.in_flight == 0
    assert len(port_server.query_registry) == 0


def test_stopped_query_leaves_no_slab_or_result(tmp_path, monkeypatch):
    """A query cancelled mid slab build (between row extractions) and
    one cancelled mid host fold leave no slab in residency and no
    result in the bitmap-result cache; the same queries then answer as
    a fresh executor does."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import ExecOptions, Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.parallel import residency
    holder = Holder(str(tmp_path / "d"))
    holder.open()
    try:
        rng = np.random.default_rng(3)
        f = holder.create_index("i").create_frame("f")
        for row in range(9):
            cols = rng.choice(4 * SLICE_WIDTH, size=2000, replace=False)
            f.import_bits(np.full(len(cols), row, np.uint64),
                          cols.astype(np.uint64))
        residency.device_cache().clear()
        count_q = ("Count(Intersect(Bitmap(rowID=0, frame=f),"
                   " Bitmap(rowID=1, frame=f)))")
        union_q = "Union(" + ", ".join(
            f"Bitmap(rowID={r}, frame=f)" for r in range(9)) + ")"
        # The device legs pinned; the Union's fold on the host.
        ex = Executor(holder, device="cpu", mesh_min_slices=1,
                      materialize_device_bytes=0)
        check = context.QueryContext.check
        for q, stop_at in ((count_q, 4), (union_q, 3)):
            ctx = context.QueryContext(pql=q, index="i", id="stop")
            calls = []

            def stop(self, calls=calls, stop_at=stop_at):
                calls.append(1)
                if len(calls) == stop_at:
                    self.cancel("cancelled via API")
                check(self)

            monkeypatch.setattr(context.QueryContext, "check", stop)
            with pytest.raises(errors.QueryCancelledError):
                ex.execute("i", q, opt=ExecOptions(ctx=ctx))
            monkeypatch.setattr(context.QueryContext, "check", check)
            assert residency.device_cache().snapshot()["entries"] == 0
            assert not ex._bitmap_results
        fresh = Executor(holder, device="cpu", mesh_min_slices=1,
                         materialize_device_bytes=0)
        def norm(rs):
            return [r.bits().tolist() if hasattr(r, "bits") else r
                    for r in rs]

        for q in (count_q, union_q):
            assert norm(ex.execute("i", q)) == norm(fresh.execute("i", q))
    finally:
        holder.close()
        residency.device_cache().clear()

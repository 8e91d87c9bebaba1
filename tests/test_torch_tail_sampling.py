"""Tail-sampled tracing and its disk ring: the port against the JAX
package on the CPU (the cases of ``tests/test_tail_sampling.py``).

- the segment ring: the same appends give the same records, rotation and
  stats; a torn segment (the ``ring.write`` failpoint, or a raw torn
  tail and a flipped byte on disk) is trimmed as the JAX ring trims it,
  and the ring survives a reopen;
- the keep decision gives the same reason for the same outcome, flags,
  shed window and head sample;
- the same workload through a JAX handler and a port handler, each with
  a sampler over its own ring, keeps traces with the same reasons, and
  ``/debug/traces?source=disk`` answers with the same keys and paging;
  after a reopen both still list and serve the kept traces;
- a port server keeps tail sampling on by default (``"tail": true``).
"""

import contextlib
import io
import json
import os
import threading
import time

import pytest

from pilosa_tpu.errors import QueryCancelledError as JCancelled
from pilosa_tpu.errors import QueryDeadlineError as JDeadline
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.fault import failpoints as jfp
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.obs import diskring as jring
from pilosa_tpu.obs import metrics as jmetrics
from pilosa_tpu.obs import sampler as jsampler
from pilosa_tpu.obs import trace as jtrace
from pilosa_tpu.sched import AdmissionController as JAdmission
from pilosa_tpu.sched import QueryContext as JContext
from pilosa_tpu.server.handler import Handler as JHandler
from pilosa_tpu.storage import wal as jwal

from pilosa_tpu_torch.errors import QueryCancelledError as TCancelled
from pilosa_tpu_torch.errors import QueryDeadlineError as TDeadline
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.fault import failpoints as tfp
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.obs import diskring as tring
from pilosa_tpu_torch.obs import metrics as tmetrics
from pilosa_tpu_torch.obs import sampler as tsampler
from pilosa_tpu_torch.obs import trace as ttrace
from pilosa_tpu_torch.sched import AdmissionController as TAdmission
from pilosa_tpu_torch.sched import QueryContext as TContext
from pilosa_tpu_torch.server.handler import Handler as THandler
from pilosa_tpu_torch.storage import wal as twal

PKGS = (
    dict(name="jax", ring=jring, sampler=jsampler, metrics=jmetrics,
         trace=jtrace, fp=jfp, Context=JContext, Admission=JAdmission,
         Deadline=JDeadline, Cancelled=JCancelled, Holder=JHolder,
         Handler=JHandler, wal=jwal,
         executor=lambda h: JExecutor(h, host="local")),
    dict(name="torch", ring=tring, sampler=tsampler, metrics=tmetrics,
         trace=ttrace, fp=tfp, Context=TContext, Admission=TAdmission,
         Deadline=TDeadline, Cancelled=TCancelled, Holder=THolder,
         Handler=THandler, wal=twal,
         executor=lambda h: TExecutor(h, device="cpu", host="local")),
)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for p in PKGS:
        p["fp"].disarm_all()


def call(app, method, path, body=b""):
    path, _, qs = path.partition("?")
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    out = {}

    def start_response(status, hs):
        out["status"] = int(status.split()[0])
        out["headers"] = dict(hs)

    chunks = app(environ, start_response)
    return out["status"], out["headers"], b"".join(chunks)


# -- the segment ring ---------------------------------------------------------

def _ring_run(pkg, d):
    ring = pkg["ring"].SegmentRing(str(d), segment_bytes=4096,
                                   max_segments=3)
    oks = [ring.append({"i": i, "pad": "x" * 64}) for i in range(200)]
    scan = list(ring.scan())
    stats = {k: v for k, v in ring.stats().items() if k != "dir"}
    ring.close()
    reopened = pkg["ring"].SegmentRing(str(d))
    again = list(reopened.scan())
    reopened.append({"i": 200})
    first = next(reopened.scan())
    names = sorted(os.listdir(d))
    reopened.close()
    return oks, scan, stats, again, first, names


def test_ring_round_trip_rotation_and_reopen(tmp_path):
    outs = [_ring_run(p, tmp_path / p["name"]) for p in PKGS]
    assert outs[0] == outs[1]
    scan = outs[1][1]
    assert scan[0]["i"] == 199 and len(scan) < 200
    assert outs[1][4] == {"i": 200}


def _torn_run(pkg, d):
    ring = pkg["ring"].SegmentRing(str(d), segment_bytes=1 << 16)
    ring.append({"i": 0})
    ring.append({"i": 1})
    with pkg["fp"].injected("ring.write", "torn(7)*1"):
        torn_ok = ring.append({"i": 2})
    ring.append({"i": 3})
    live = [r["i"] for r in ring.scan()]
    counters = (ring.dropped, ring.skipped)
    ring.close()
    reopened = pkg["ring"].SegmentRing(str(d))
    after = [r["i"] for r in reopened.scan()]
    reopened.close()
    # A raw torn tail (a kill mid-write(2)), then a flipped byte in the
    # middle of a fresh segment's first record.
    segs = sorted(os.listdir(d))
    with open(os.path.join(d, segs[-1]), "ab") as f:
        f.write(b'deadbeef {"i": 4, "trunca')
    r2 = pkg["ring"].SegmentRing(str(d))
    tail = [r["i"] for r in r2.scan()]
    r2.append({"i": 5})
    r2.close()
    segs2 = sorted(os.listdir(d))
    with open(os.path.join(d, segs2[-1]), "r+b") as f:
        f.seek(12)
        f.write(b"X")
    r3 = pkg["ring"].SegmentRing(str(d))
    flipped = [r["i"] for r in r3.scan()]
    skipped = r3.skipped
    r3.close()
    raw = [open(os.path.join(d, s), "rb").read() for s in segs2]
    return torn_ok, live, counters, after, tail, flipped, skipped, raw


def test_torn_segment_trimmed_alike(tmp_path):
    outs = [_torn_run(p, tmp_path / p["name"]) for p in PKGS]
    assert outs[0] == outs[1]
    assert outs[1][0] is False and outs[1][1] == [3, 1, 0]


# -- the keep decision --------------------------------------------------------

def _decisions(pkg, tag):
    hist = pkg["metrics"].Histogram(f"pilosa_test_{tag}_seconds",
                                    buckets=(0.01, 0.1, 1.0))
    adm = pkg["Admission"](concurrency=1, queue_depth=0)
    s = pkg["sampler"].TailSampler(head_n=0, histogram=hist,
                                   admission=adm, slow_floor_s=0.001)
    C = pkg["Context"]
    out = [s.decide(C(pql="q"), err=pkg["Deadline"]("x")),
           s.decide(C(pql="q"), err=pkg["Cancelled"]("x")),
           s.decide(C(pql="q"), err=RuntimeError("x")),
           s.decide(C(pql="q"), status=504), s.decide(C(pql="q"), status=429),
           s.decide(C(pql="q"), status=500), s.decide(C(pql="q"), status=503),
           s.decide(C(pql="q"), partial=True), s.decide(C(pql="q"))]
    for flag in ("breaker", "failover", "failpoint", "partial",
                 "corruption"):
        ctx = C(pql="q")
        ctx.note_flag(flag)
        out.append(s.decide(ctx))
    out.append(s.slow_threshold_s())
    for _ in range(200):
        hist.observe(0.005)
    s._threshold = (0.0, 0.0)
    out.append(s.slow_threshold_s())
    slow = C(pql="q", lane="read")
    slow.started -= 0.05
    out.append(s.decide(slow))
    slot = adm.acquire("read")
    with pytest.raises(Exception):
        adm.acquire("read")
    out.append(s.decide(C(pql="q", lane="read")))
    slot.release()
    head = pkg["sampler"].TailSampler(head_n=10, histogram=hist)
    out.append([head.decide(C(pql="q")) for _ in range(30)])
    return out


def test_keep_decisions_alike():
    outs = [_decisions(p, f"decide_{p['name']}") for p in PKGS]
    assert outs[0] == outs[1]
    assert outs[1][:3] == ["deadline", "cancelled", "error"]
    assert outs[1][-1].count("head") == 3


def test_trace_record_shape_alike():
    outs = []
    for p in PKGS:
        tr = p["trace"].Trace("qid2", node="n1", pql="q")
        with tr.span("execute"):
            pass
        ctx = p["Context"](pql="q", index="i")
        ctx.stages["execute"] = 0.5
        rec = p["sampler"].trace_record(tr, "deadline", ctx=ctx)
        back = p["sampler"].record_to_trace(json.loads(json.dumps(rec)))
        outs.append((sorted(rec), rec["reason"], rec["stages"],
                     sorted(p["sampler"].record_summary(rec)),
                     back.keep_reason, [s.name for s in back.spans()]))
    assert outs[0] == outs[1]


# -- the handler --------------------------------------------------------------

def _handler(pkg, tmp_path, holder):
    sampler = pkg["sampler"].TailSampler(
        disk=pkg["ring"].SegmentRing(str(tmp_path / "traces")),
        head_n=0, slow_floor_s=30.0,
        histogram=pkg["metrics"].Histogram(
            f"pilosa_test_tailhandler_{pkg['name']}_seconds",
            buckets=(64.0,)))
    return pkg["Handler"](holder, pkg["executor"](holder), host="local",
                          tracer=pkg["trace"].Tracer(enabled=False),
                          sampler=sampler)


WORKLOAD = (
    ("POST", "/index/ti", b"{}"),
    ("POST", "/index/ti/frame/f", b"{}"),
    ("POST", "/index/ti/query", b'SetBit(frame="f", rowID=1, columnID=1)'),
    ("POST", "/index/ti/query", b'Count(Bitmap(frame="f", rowID=1))'),
    ("POST", "/index/ti/query", b'Plugin(frame="f")'),
    ("POST", "/index/ti/query", b'Bitmap(frame="nope", rowID=1)'),
    ("POST", "/index/ti/query?trace=1",
     b'Count(Bitmap(frame="f", rowID=1))'),
    ("FAILPOINT", "/index/ti/query",
     b'SetBit(frame="f", rowID=2, columnID=3)'),
    ("POST", "/index/ti/query", b'Count(Bitmap(frame="f", rowID=2))'),
)


class _HeldFlusherClock:
    """The WAL module's ``time`` for the block below: the background
    flusher's window sleep waits on ``gate`` first; everything else is
    the real clock."""

    def __init__(self, gate):
        self.gate = gate

    def __getattr__(self, name):
        return getattr(time, name)

    def sleep(self, s):
        if threading.current_thread().name == "wal-group-flusher":
            self.gate.wait()
        time.sleep(s)


@contextlib.contextmanager
def _request_thread_flushes(wal):
    """Hold the WAL's background flusher off for the block, so the
    request's own commit barrier leads the group flush that carries the
    ``wal.append`` failpoint. A failpoint flags the query whose thread
    hits it: when the flusher (2 ms window) leads instead — a request
    thread descheduled for longer between its append and its barrier, as
    on a loaded host — the hit lands on the flusher's thread and the
    query is not kept as "failpoint", in either package. A flusher pass
    already past its window sleep ends within the pause."""
    gate = threading.Event()
    wal.time = _HeldFlusherClock(gate)
    try:
        wal.barrier_all()
        time.sleep(0.2)
        yield
    finally:
        wal.time = time
        gate.set()


def _workload(pkg, tmp_path):
    holder = pkg["Holder"](str(tmp_path / "data"))
    holder.open()
    try:
        h = _handler(pkg, tmp_path, holder)
        statuses, ids = [], []
        for method, path, body in WORKLOAD:
            if method == "FAILPOINT":
                with _request_thread_flushes(pkg["wal"]), \
                        pkg["fp"].injected("wal.append", "delay(1ms)"):
                    st, hs, _ = call(h, "POST", path, body)
            else:
                st, hs, _ = call(h, method, path, body)
            statuses.append(st)
            ids.append(hs.get("X-Pilosa-Query-Id"))
        by_id = {i: n for n, i in enumerate(ids) if i}
        ring = json.loads(call(h, "GET", "/debug/traces")[2])
        disk = json.loads(call(h, "GET", "/debug/traces?source=disk")[2])
        pages = [json.loads(call(
            h, "GET", f"/debug/traces?source=disk&limit=2&offset={o}")[2])
            for o in (0, 2, 4)]
        errors = json.loads(call(
            h, "GET", "/debug/traces?source=disk&reason=error")[2])
        summary = json.loads(call(h, "GET", "/debug/traces/summary")[2])
        err_id = ids[4]
        chrome = json.loads(call(
            h, "GET", f"/debug/traces/{err_id}?source=disk")[2])
        h.sampler.disk.close()
        # Reopen: a fresh handler over the same ring still lists them.
        h2 = _handler(pkg, tmp_path, holder)
        again = json.loads(call(h2, "GET", "/debug/traces?source=disk")[2])
        by_disk = call(h2, "GET", f"/debug/traces/{err_id}")
        h2.sampler.disk.close()
    finally:
        holder.close()

    def kept(listing):
        return sorted((by_id[t["id"]], t["reason"])
                      for t in listing["traces"] if t["id"] in by_id)

    return dict(
        statuses=statuses, tail=ring["tail"], ring=kept(ring),
        disk=kept(disk), disk_keys=sorted(disk),
        record_keys=sorted(disk["traces"][0]),
        disk_stats=sorted(disk["disk"]), total=disk["total"],
        pages=[(p["offset"], p["limit"], p["total"], kept(p))
               for p in pages],
        errors=kept(errors), summary_disk=summary["disk"],
        summary_keys=sorted(summary),
        chrome=chrome["otherData"]["traceId"] == err_id,
        again=kept(again), by_disk=(by_disk[0], json.loads(
            by_disk[2])["otherData"]["traceId"] == err_id))


def test_same_workload_keeps_the_same_traces(tmp_path):
    outs = [_workload(p, tmp_path / p["name"]) for p in PKGS]
    assert outs[0] == outs[1]
    got = outs[1]
    assert got["tail"] is True
    reasons = dict(got["disk"])
    assert reasons[4] == "error" and reasons[6] == "requested"
    assert reasons[7] == "failpoint"
    assert 3 not in reasons  # the healthy fast Count is not kept
    assert got["again"] == got["disk"] and got["by_disk"] == (200, True)


def test_port_server_keeps_tail_sampling_on(tmp_path):
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.utils.config import TraceConfig
    outs = []
    for cfg in (None, TraceConfig(tail=False)):
        s = Server(str(tmp_path / f"d{len(outs)}"), host="127.0.0.1:0",
                   device="cpu", warmup=False, trace_config=cfg)
        s.open()
        try:
            st, _h, body = call(s.handler, "GET", "/debug/traces")
            outs.append((json.loads(body)["tail"],
                         os.path.isdir(os.path.join(s.data_dir,
                                                    "traces"))))
        finally:
            s.close()
    assert outs == [(True, True), (False, False)]

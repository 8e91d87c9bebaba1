"""Tracing: one trace per query, spans per pipeline stage.

A copy of the JAX package's ``obs/trace.py``. A trace's id IS the query
id (sched.context.QueryContext.id). Spans record wall-clock start +
duration, a name, optional tags, the owning node and the recording
thread: the handler's stages (parse, admission, execute, commit,
encode) and one ``mesh_dispatch`` span a device dispatch
(parallel.mesh), tagged with the kernel kind. ``GET /debug/traces``
lists the per-node bounded ring of kept traces; ``GET
/debug/traces/{id}`` exports one as Chrome trace-event JSON (open in
https://ui.perfetto.dev — each thread renders as a track).

Overhead contract: the *keep-everything* mode is OFF by default
(``?trace=1`` opts in per request), and a QueryContext whose ``trace``
is None allocates nothing — ``span_current()`` returns a shared no-op
context manager after two attribute reads. With the tail sampler wired
(obs.sampler, a server's default) every query gets the span buffer and
the keep decision runs at query end (``Tracer.keep(trace, reason)``); a
coordinator's legs piggyback their spans back as
``X-Pilosa-Trace-Spans`` for stitching.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

from ..sched import context as sched_context

# Wire headers (see module docstring).
TRACE_HEADER = "X-Pilosa-Trace"
SPANS_HEADER = "X-Pilosa-Trace-Spans"

# Hard caps so a pathological query can't balloon a trace or the
# piggyback header.
MAX_SPANS = 512
MAX_TRACES = 64


class Span:
    __slots__ = ("name", "start", "dur", "tags", "node", "tid")

    def __init__(self, name: str, start: float, dur: float,
                 tags: Optional[dict] = None, node: str = "",
                 tid: int = 0):
        self.name = name
        self.start = start          # wall seconds
        self.dur = dur              # seconds
        self.tags = tags
        self.node = node
        self.tid = tid

    def to_json(self) -> list:
        # Compact array form: [name, start_us, dur_us, node, tid, tags]
        return [self.name, round(self.start * 1e6),
                round(self.dur * 1e6), self.node, self.tid,
                self.tags or None]

    @staticmethod
    def from_json(row: list) -> "Span":
        return Span(row[0], row[1] / 1e6, row[2] / 1e6,
                    tags=row[5], node=row[3], tid=int(row[4]))


class _SpanCM:
    """Context manager recording one span into a trace on exit."""

    __slots__ = ("_trace", "_name", "_tags", "_t0")

    def __init__(self, trace: "Trace", name: str, tags: Optional[dict]):
        self._trace = trace
        self._name = name
        self._tags = tags

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._trace.add_span(self._name, self._t0,
                             time.time() - self._t0, self._tags)
        return False


class _NopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOP_SPAN = _NopSpan()


class Trace:
    """All spans this node recorded (or stitched) for one query."""

    def __init__(self, id: str, node: str = "", pql: str = "",
                 max_spans: int = MAX_SPANS):
        self.id = id
        self.node = node
        self.pql = pql
        self.started = time.time()
        self.max_spans = max_spans
        self.dropped = 0
        # Why the tail sampler retained this trace ("" while in
        # flight / never kept) — obs.sampler's keep-reason catalogue.
        self.keep_reason = ""
        self._mu = threading.Lock()
        self._spans: list[Span] = []

    # -- recording -----------------------------------------------------------

    def claim_keep(self, reason: str) -> bool:
        """Atomically claim the keep of this trace (first claimant
        wins): the end-of-query decision and the watchdog's force-keep
        can race, and exactly ONE of them may enter the ring/disk."""
        with self._mu:
            if self.keep_reason:
                return False
            self.keep_reason = reason
            return True

    def span(self, name: str, **tags) -> _SpanCM:
        return _SpanCM(self, name, tags or None)

    def add_span(self, name: str, start: float, dur: float,
                 tags: Optional[dict] = None, node: str = "",
                 tid: Optional[int] = None) -> None:
        s = Span(name, start, dur, tags, node or self.node,
                 threading.get_ident() if tid is None else tid)
        with self._mu:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(s)

    def add_remote_json(self, payload: str) -> None:
        """Stitch a peer's piggybacked spans (SPANS_HEADER value)."""
        try:
            rows = json.loads(payload)
        except ValueError:
            return
        with self._mu:
            for row in rows:
                if len(self._spans) >= self.max_spans:
                    self.dropped += 1
                    break
                try:
                    self._spans.append(Span.from_json(row))
                except (IndexError, TypeError, ValueError):
                    continue

    # -- export --------------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._mu:
            return list(self._spans)

    # Serialized-spans budget for the piggyback header: http.client
    # rejects header LINES over 65536 bytes (LineTooLong kills the
    # whole response), so the wire form must stay comfortably under.
    _WIRE_BYTES = 48 << 10

    def spans_json(self, max_bytes: int = _WIRE_BYTES) -> str:
        """Compact JSON of this trace's spans, capped at ``max_bytes``
        serialized — over budget, the newest spans drop (the early
        pipeline stages are the ones a stitched view can't infer)."""
        spans = self.spans()
        out = json.dumps([s.to_json() for s in spans],
                         separators=(",", ":"))
        while len(out) > max_bytes and len(spans) > 1:
            spans = spans[:max(1, len(spans) // 2)]
            out = json.dumps([s.to_json() for s in spans],
                             separators=(",", ":"))
        return out

    def summary(self) -> dict:
        spans = self.spans()
        end = max((s.start + s.dur for s in spans),
                  default=self.started)
        out = {
            "id": self.id,
            "node": self.node,
            "pql": self.pql[:200],
            "startedAt": self.started,
            "durationS": round(max(0.0, end - self.started), 6),
            "spanN": len(spans),
            "dropped": self.dropped,
            "nodes": sorted({s.node for s in spans if s.node}),
        }
        if self.keep_reason:
            out["reason"] = self.keep_reason
        return out

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (perfetto-loadable): one process
        per node, one track per recording thread, spans as complete
        ("X") events in microseconds."""
        events = []
        pids: dict[str, int] = {}
        tids: dict[tuple[int, int], int] = {}
        for s in self.spans():
            node = s.node or self.node or "?"
            pid = pids.setdefault(node, len(pids) + 1)
            tid = tids.setdefault((pid, s.tid), len(tids) + 1)
            ev = {"name": s.name, "ph": "X", "pid": pid, "tid": tid,
                  "ts": round(s.start * 1e6),
                  "dur": max(1, round(s.dur * 1e6))}
            if s.tags:
                ev["args"] = s.tags
            events.append(ev)
        for node, pid in pids.items():
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "args": {"name": node}})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"traceId": self.id, "pql": self.pql[:200],
                          "coordinator": self.node,
                          "dropped": self.dropped},
        }


class Tracer:
    """Per-node tracer: the enabled flag plus the bounded ring of
    recent traces behind /debug/traces."""

    def __init__(self, enabled: bool = False,
                 max_traces: int = MAX_TRACES,
                 max_spans: int = MAX_SPANS):
        self.enabled = enabled
        self.max_spans = max_spans
        self._mu = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=max(1, max_traces))

    def start(self, ctx, node: str = "") -> Trace:
        """Open a trace for a query context and bind it (ctx.trace) so
        every layer below can record spans through the context."""
        trace = Trace(ctx.id, node=node or getattr(ctx, "node", ""),
                      pql=getattr(ctx, "pql", ""),
                      max_spans=self.max_spans)
        ctx.trace = trace
        return trace

    def keep(self, trace: Trace, reason: str = "requested") -> bool:
        """Retain ``trace`` in the ring under ``reason``; idempotent —
        False (and no second ring entry / counter tick) when another
        keeper already claimed it."""
        from . import metrics as obs_metrics
        if not trace.claim_keep(reason):
            return False
        with self._mu:
            self._ring.append(trace)
        obs_metrics.TRACES_KEPT.labels(reason).inc()
        return True

    def traces(self) -> list[dict]:
        with self._mu:
            ring = list(self._ring)
        return [t.summary() for t in reversed(ring)]

    def get(self, id: str) -> Optional[Trace]:
        with self._mu:
            for t in reversed(self._ring):
                if t.id == id:
                    return t
        return None


# Module default, for layers constructed without explicit wiring (bare
# test handlers); the server builds its own Tracer from [trace] config.
_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def span_current(name: str, **tags):
    """A span on the current query's trace, or the shared no-op when
    the thread has no traced query — the single hook device dispatch
    and compile layers call without taking a ctx argument. The
    disabled fast path is two attribute reads and no allocation."""
    ctx = sched_context.current()
    if ctx is None:
        return NOP_SPAN
    trace = getattr(ctx, "trace", None)
    if trace is None:
        return NOP_SPAN
    return trace.span(name, **tags)

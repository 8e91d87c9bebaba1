"""Tail-based trace sampling: every query buffers spans, the
interesting ones persist.

Copy of the JAX package's ``obs/sampler.py``. The keep decision moves to
*query end*, when the outcome is known:

- every query gets the (near-free) span buffer — the handler attaches
  a Trace whenever a TailSampler is wired, and cluster legs always
  carry ``X-Pilosa-Trace: 1`` so the coordinator's keep decision
  captures the stitched remote side too;
- at the end, ``decide()`` keeps the trace if it was **slow** (dynamic
  threshold derived from the query latency histogram's p99),
  **errored**, **deadline**-exceeded, **cancelled**, answered
  **partial**, was **shed** (a 429, or its lane rejected arrivals in
  the recent window), touched an open **breaker** (failover/circuit-open
  flags on the context) or an armed **failpoint**, or hit the 1-in-N
  **head** sample;
- kept traces (spans + stitched remote spans + the cost ledger
  roll-up) go to the in-memory ring AND a size-bounded on-disk segment
  ring (obs.diskring) under the holder data dir that survives
  restarts, browsable via ``/debug/traces?source=disk&reason=...``.

The keep-reason catalogue:
``slow``, ``error``, ``deadline``, ``cancelled``, ``partial``,
``corruption`` (the query detected on-disk corruption or failed over
a quarantined fragment — storage integrity subsystem), ``shed``,
``breaker``, ``failpoint``, ``head``, ``requested`` (the explicit
[trace] enabled / ?trace=1 / coordinator-asked paths), ``watchdog``
(in-flight traces force-kept on a stall trip), and ``anomaly``
(force-kept by a regression-sentinel finding). The port has no
watchdog, sentinel or backup yet, so their force-keeps never fire.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..errors import QueryCancelledError, QueryDeadlineError
from . import metrics as obs_metrics
from .diskring import SegmentRing
from .trace import Span, Trace

# Keep reasons, in decision order (the first matching wins).
# ``watchdog``, ``anomaly``, and ``backup`` are force-keeps claimed
# mid-flight (a stall trip / a sentinel finding / a backup-window
# error), not end-of-query decisions.
REASONS = ("deadline", "cancelled", "error", "shed", "partial",
           "corruption", "breaker", "failpoint", "slow", "head",
           "requested", "watchdog", "anomaly", "backup")

DEFAULT_HEAD_N = 1000
DEFAULT_SLOW_FLOOR_S = 0.1
# Below this many histogram observations the p99 estimate is noise;
# use a conservative fixed threshold instead.
_MIN_OBSERVATIONS = 100
_COLD_SLOW_S = 0.5
_THRESHOLD_TTL_S = 5.0


class TailSampler:
    """End-of-query keep decision + disk persistence for kept traces.

    ``admission`` (sched.AdmissionController) feeds the shed-lane
    signal; the slow threshold derives from ``histogram``
    (obs.metrics.QUERY_SECONDS by default) so "slow" tracks the
    workload instead of a hand-tuned constant."""

    def __init__(self, disk: Optional[SegmentRing] = None,
                 head_n: int = DEFAULT_HEAD_N,
                 slow_floor_s: float = DEFAULT_SLOW_FLOOR_S,
                 admission=None, histogram=None,
                 quantile: float = 0.99,
                 shed_window_s: float = 10.0):
        self.disk = disk
        self.head_n = max(0, int(head_n))
        self.slow_floor_s = float(slow_floor_s)
        self.admission = admission
        self.histogram = histogram or obs_metrics.QUERY_SECONDS
        self.quantile = min(max(float(quantile), 0.5), 0.9999)
        self.shed_window_s = float(shed_window_s)
        self._mu = threading.Lock()
        self._seen = 0                      # head-sample counter
        self._threshold = (0.0, _COLD_SLOW_S)  # (computed_at, value)

    # -- dynamic slow threshold ----------------------------------------------

    def slow_threshold_s(self) -> float:
        """max(histogram p-quantile bucket bound, floor), recomputed
        at most every few seconds — the "slow" that tracks the live
        latency distribution instead of a constant."""
        now = time.monotonic()
        with self._mu:
            at, value = self._threshold
            if now - at < _THRESHOLD_TTL_S:
                return value
            # Refresh outside the lock would race harmlessly; keeping
            # it here keeps the math single-writer.
            value = self._compute_threshold()
            self._threshold = (now, value)
            return value

    def _compute_threshold(self) -> float:
        counts = [0] * (len(self.histogram.buckets) + 1)
        total = 0
        try:
            for _labels, child in self.histogram._label_dicts():
                cs, _sum, n = child.snapshot()
                total += n
                for i, c in enumerate(cs):
                    counts[i] += c
        except Exception:  # noqa: BLE001 - sampling must not raise
            return max(self.slow_floor_s, _COLD_SLOW_S)
        if total < _MIN_OBSERVATIONS:
            return max(self.slow_floor_s, _COLD_SLOW_S)
        want = total * self.quantile
        cum = 0
        bound = self.histogram.buckets[-1]
        for i, c in enumerate(counts[:-1]):
            cum += c
            if cum >= want:
                bound = self.histogram.buckets[i]
                break
        return max(bound, self.slow_floor_s)

    # -- the keep decision ----------------------------------------------------

    def decide(self, ctx, err: Optional[BaseException] = None,
               status: int = 200,
               partial: bool = False) -> Optional[str]:
        """The keep reason for this finished query, or None. Pure
        decision — persistence is ``keep()``."""
        if isinstance(err, QueryDeadlineError) or status == 504:
            return "deadline"
        if isinstance(err, QueryCancelledError) or status == 409:
            return "cancelled"
        if status == 429:
            return "shed"
        if err is not None or status >= 500:
            return "error"
        flags = getattr(ctx, "flags", None) or ()
        if partial or "partial" in flags:
            return "partial"
        if "corruption" in flags:
            # The query detected on-disk corruption or failed over a
            # quarantined fragment (storage integrity subsystem).
            return "corruption"
        if "breaker" in flags or "failover" in flags:
            return "breaker"
        if "failpoint" in flags:
            return "failpoint"
        if (self.admission is not None
                and self.admission.recent_rejection(
                    getattr(ctx, "lane", ""), self.shed_window_s)):
            return "shed"
        if ctx is not None and ctx.elapsed() >= self.slow_threshold_s():
            return "slow"
        if self.head_n:
            with self._mu:
                self._seen += 1
                # First query, then every head_n-th — exact at every
                # head_n including 1 (keep all healthy queries).
                if (self._seen - 1) % self.head_n == 0:
                    return "head"
        return None

    # -- persistence ----------------------------------------------------------

    def persist(self, trace: Trace, reason: str, ctx=None) -> None:
        """One kept trace to the disk ring (no-op without one)."""
        if self.disk is None:
            return
        record = trace_record(trace, reason, ctx=ctx)
        ok = self.disk.append(record)
        obs_metrics.TRACE_DISK_RECORDS.labels(
            "written" if ok else "dropped").inc()


def trace_record(trace: Trace, reason: str, ctx=None) -> dict:
    """The disk form of one kept trace: the summary plus the full
    compact span rows, the cost roll-up, and the stage timings."""
    out = trace.summary()
    out["reason"] = reason
    out["keptAt"] = time.time()
    out["spans"] = [s.to_json() for s in trace.spans()]
    if ctx is not None:
        cost = getattr(ctx, "cost", None)
        if cost is not None:
            try:
                out["cost"] = cost.summary()
            except Exception:  # noqa: BLE001 - advisory
                pass
        stages = getattr(ctx, "stages", None)
        if stages:
            out["stages"] = {k: round(v, 6) for k, v in
                             dict(stages).items()}
        out["index"] = getattr(ctx, "index", "")
        out["lane"] = getattr(ctx, "lane", "")
    return out


def record_to_trace(record: dict) -> Trace:
    """Rebuild a Trace from its disk record (for the Chrome/spans
    export paths of ``/debug/traces/{id}?source=disk``)."""
    t = Trace(str(record.get("id", "")),
              node=str(record.get("node", "")),
              pql=str(record.get("pql", "")))
    t.started = float(record.get("startedAt", t.started))
    t.keep_reason = str(record.get("reason", ""))
    for row in record.get("spans") or []:
        try:
            t._spans.append(Span.from_json(row))
        except (IndexError, TypeError, ValueError):
            continue
    return t


def record_summary(record: dict) -> dict:
    """The listing form (everything but the span rows)."""
    return {k: v for k, v in record.items() if k != "spans"}

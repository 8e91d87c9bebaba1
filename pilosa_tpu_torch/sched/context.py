"""QueryContext: per-query identity, deadline budget, and cancellation.

A copy of the JAX package's ``sched/context.py``. One QueryContext
rides a query from the HTTP front door through the executor, the slab
packing of the residency layer and the device dispatch layer
(parallel.mesh). It carries

- an **id** (``X-Pilosa-Query-Id`` on the request when the client
  names it, else a fresh one; it rides every response, so a client can
  find and cancel its query at /debug/queries),
- a **deadline** parsed from ``X-Pilosa-Deadline`` (remaining seconds)
  or ``?timeout=`` (Go-style duration on the request),
- a **cancel flag** set by DELETE /debug/queries/{id}, and
- **stage timings** (parse/admission/execute/commit/encode) for the
  slow-query log.

Checks are cooperative: every layer that can block or loop calls
``ctx.check()`` (or module-level ``check_current()`` from code that
does not take a ctx argument, e.g. the mesh dispatch functions) and
gets a QueryDeadlineError / QueryCancelledError the moment the budget
is gone. A check cannot stop a kernel already launched: it falls
between launches and between packing steps. The context reaches those
layers through ``use()``'s thread-local, set by the executor around
execution.
"""

from __future__ import annotations

import threading
import time
import uuid
from contextlib import contextmanager
from typing import Optional

from ..errors import (QueryCancelledError, QueryDeadlineError,
                      QueryKilledError)

# Lanes the admission controller schedules between. LANES is the
# canonical display order (the `pilosa-tpu top` per-lane table and
# any other lane-enumerating consumer read it from here instead of
# hardcoding the strings).
LANE_READ = "read"
LANE_WRITE = "write"
LANE_ADMIN = "admin"
LANES = (LANE_READ, LANE_WRITE, LANE_ADMIN)

# Wire headers for cluster fan-out propagation. The tenant header
# carries the scheduling/accounting principal (= index, today) onto
# remote legs — same pattern as the deadline: a peer inherits the
# coordinator's principal, so per-tenant cost ceilings and chargeback
# roll-ups hold cluster-wide even though forwarded legs bypass
# admission.
DEADLINE_HEADER = "X-Pilosa-Deadline"
QUERY_ID_HEADER = "X-Pilosa-Query-Id"
TENANT_HEADER = "X-Pilosa-Tenant"


class QueryContext:
    """Lifecycle state of one in-flight query."""

    def __init__(self, pql: str = "", index: str = "",
                 lane: str = LANE_READ,
                 timeout_s: Optional[float] = None,
                 id: Optional[str] = None, remote: bool = False,
                 node: str = "", tenant: str = ""):
        self.id = id or uuid.uuid4().hex[:16]
        self.pql = pql
        self.index = index
        self.lane = lane
        # Scheduling/accounting principal (sched.tenants): the index
        # by default, the X-Pilosa-Tenant header on forwarded legs.
        # Empty = the default tenant (bare contexts in tests).
        self.tenant = tenant or index
        self.remote = remote
        self.node = node
        self.started = time.monotonic()
        self.started_wall = time.time()
        self.deadline = (self.started + timeout_s
                         if timeout_s else None)
        self.state = "queued"
        self.cancel_reason = ""
        self._cancelled = threading.Event()
        self._mu = threading.Lock()
        self.stages: dict[str, float] = {}
        self.legs: list[dict] = []
        # Distributed-tracing attachment (obs.trace.Trace), bound by
        # the tracer when tracing is on. None (the default) is the
        # no-allocation fast path: stage() and span_current() check it
        # and record nothing.
        self.trace = None
        # Resource-accounting attachment (obs.accounting.QueryCost),
        # bound by the serving layer when accounting is on. Same
        # contract as trace: None means every note_* site records
        # nothing.
        self.cost = None
        # Per-tenant cost policy (sched.tenants.TenantRegistry.install):
        # a callable check() consults at every cooperative checkpoint —
        # the stage boundaries — and which raises QueryKilledError the
        # moment the ledger crosses a ceiling. None (the default) costs
        # one attribute read per check.
        self.cost_policy = None
        # Set by the cost policy when it kills this query: check()
        # then raises QueryKilledError (not the plain cancel) from
        # EVERY thread touching this context, so the HTTP layer maps
        # the distinct status deterministically whichever leg
        # surfaces first.
        self.killed_by = ""
        # Fault-event flags the tail sampler's keep decision reads at
        # query end ("breaker", "failover", "failpoint", "partial"):
        # set by the choke points that observe the event (client
        # circuit-open, executor failover, failpoints.hit). Set.add is
        # GIL-atomic; no lock needed.
        self.flags: set[str] = set()
        # Filled at query end by the serving layer: whether this
        # query's trace was kept and why — the slow log cross-links on
        # these so /debug/queries/slow points at the persisted trace.
        self.trace_kept = False
        self.keep_reason = ""
        # Query-plan attachment (plan.record.PlanRecord), bound by the
        # executor when the planner handles this query. Same contract
        # as trace/cost: None means the planner sat this one out.
        # ``profile`` is the ?profile=1 flag — it asks the executor to
        # pay for exact per-node actual cardinalities (ANALYZE).
        self.plan = None
        self.profile = False
        # Workload-capture cross-links (obs.capture), filled by the
        # serving layer at query end: the canonical result digest
        # (the X-Pilosa-Result-Digest value) and the capture-record id
        # — a slow-log line names the exact replayable record.
        self.result_digest = ""
        self.capture_id = 0

    def note_flag(self, name: str) -> None:
        """Record a fault-event flag for the tail sampler (no-op
        semantics: flags only widen the keep decision)."""
        self.flags.add(name)

    # -- budget --------------------------------------------------------------

    def remaining(self) -> Optional[float]:
        """Seconds of budget left; None means no deadline. Can go
        negative once expired (callers clamp as needed)."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        return (self.deadline is not None
                and time.monotonic() >= self.deadline)

    def elapsed(self) -> float:
        return time.monotonic() - self.started

    # -- cancellation --------------------------------------------------------

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self, reason: str = "cancelled") -> None:
        with self._mu:
            if not self._cancelled.is_set():
                self.cancel_reason = reason
                self.state = "cancelled"
            self._cancelled.set()

    def check(self) -> None:
        """Raise if this query must stop. The single cooperative
        cancellation point every lifecycle-aware layer calls — which
        makes it the per-tenant cost policy's stage-boundary hook
        too (the policy kills by cancelling, so a killed query stops
        at exactly the same points a cancelled one does)."""
        if self._cancelled.is_set():
            if self.killed_by:
                raise QueryKilledError(
                    f"query {self.id} killed by {self.killed_by}"
                    + (f": {self.cancel_reason}" if self.cancel_reason
                       else ""))
            raise QueryCancelledError(
                f"query {self.id} cancelled"
                + (f": {self.cancel_reason}" if self.cancel_reason
                   else ""))
        if self.expired():
            self.state = "expired"
            raise QueryDeadlineError(
                f"query {self.id}: deadline exceeded after"
                f" {self.elapsed():.3f}s")
        if self.cost_policy is not None:
            self.cost_policy(self)

    # -- bookkeeping ---------------------------------------------------------

    @contextmanager
    def stage(self, name: str):
        """Record wall time of one pipeline stage (accumulating —
        a stage may run more than once, e.g. per-leg encode). When a
        trace is attached, the stage doubles as a span."""
        t0 = time.perf_counter()
        t0_wall = time.time() if self.trace is not None else 0.0
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._mu:
                self.stages[name] = self.stages.get(name, 0.0) + dt
            if self.trace is not None:
                self.trace.add_span(name, t0_wall, dt)

    def add_leg(self, host: str, n_slices: int) -> None:
        """Record a map-reduce leg (node host + slice count) for
        /debug/queries visibility."""
        with self._mu:
            self.legs.append({"host": host, "slices": n_slices})

    def to_json(self) -> dict:
        rem = self.remaining()
        with self._mu:
            legs = list(self.legs)
            stages = dict(self.stages)
        out = {
            "id": self.id,
            "pql": self.pql[:200],
            "index": self.index,
            "tenant": self.tenant,
            "lane": self.lane,
            "state": self.state,
            "remote": self.remote,
            "node": self.node,
            "startedAt": self.started_wall,
            "elapsedS": round(self.elapsed(), 4),
            "remainingS": None if rem is None else round(rem, 4),
            "legs": legs,
            "stages": {k: round(v, 4) for k, v in stages.items()},
        }
        if self.cost is not None:
            # The accounting roll-up rides /debug/queries and the slow
            # log (obs.accounting.QueryCost.summary — totals only).
            out["cost"] = self.cost.summary()
        if self.plan is not None:
            # Cross-link only (the traceKept pattern): the fingerprint
            # keys into /debug/plans for the full tree; the decision
            # roll-up makes the slow log self-describing.
            out["planFingerprint"] = self.plan.fingerprint
            decisions = self.plan.decision_summary()
            if decisions:
                out["planDecisions"] = decisions
        if self.result_digest:
            # Replay cross-link (obs.capture): the digest is the
            # shadow-diff comparison key; captureId names the record
            # in /debug/capture/records that re-issues this query.
            out["resultDigest"] = self.result_digest
        if self.capture_id:
            out["captureId"] = self.capture_id
        return out


# -- thread-local propagation ------------------------------------------------

_tls = threading.local()

# Cross-thread view of the same bindings, for samplers that inspect
# OTHER threads (the continuous profiler tags each sampled stack with
# the query id bound to that thread — a thread-local is invisible from
# the sampler thread). Plain dict ops are atomic under the GIL.
_by_thread: dict[int, QueryContext] = {}


def current() -> Optional[QueryContext]:
    """The QueryContext bound to this thread, or None."""
    return getattr(_tls, "ctx", None)


def by_thread() -> dict[int, QueryContext]:
    """Snapshot of thread-id -> bound QueryContext, for cross-thread
    samplers (obs.profile)."""
    return dict(_by_thread)


@contextmanager
def use(ctx: Optional[QueryContext]):
    """Bind ``ctx`` as this thread's current query for the duration.
    Used by the executor around each worker leg so layers without a
    ctx argument (mesh dispatch) can still check the budget. ``None``
    is allowed (binds nothing-current, e.g. internal maintenance
    queries)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    tid = threading.get_ident()
    if ctx is not None:
        _by_thread[tid] = ctx
    else:
        _by_thread.pop(tid, None)
    try:
        yield ctx
    finally:
        _tls.ctx = prev
        if prev is not None:
            _by_thread[tid] = prev
        else:
            _by_thread.pop(tid, None)


def check_current() -> None:
    """check() on the thread's current query; no-op when none bound.
    The hook the device dispatch layer calls before compiling or
    dispatching a program on behalf of a query."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.check()

"""Admission control: a weighted queue in front of the executor.

The serving-quality contract under overload: a bounded number of
queries execute concurrently (``concurrency``), a bounded number wait
(``queue_depth``), and everything past that is rejected **immediately**
with enough information for the client to back off (AdmissionFullError
carries a Retry-After estimate) — the HTTP layer renders it as
``429 Too Many Requests`` instead of queueing unboundedly.

Waiting queries are scheduled by **two levels of stride scheduling**:

- between the three lanes — ``read``, ``write``, ``admin`` — by lane
  weight (each lane's virtual clock advances at 1/weight per grant),
  so a write burst cannot starve reads and admin always trickles
  through;
- **within a lane, between tenants** (sched.tenants) by the tenant's
  effective weight (configured weight, demoted while the tenant sits
  in the penalty box), so an aggressive tenant's backlog cannot starve
  a quiet tenant's queue position. Within a (lane, tenant) queue, FIFO.

Per-tenant **concurrency caps** bound how many slots one tenant may
hold (a capped tenant queues even while global slots are free); per-
tenant **queue quotas** bound its waiters — quota overflow 429s ONLY
the offending tenant, with a Retry-After computed from that
tenant-lane's own hold/backlog estimate. The per-lane hold EWMAs keep
a shed write burst from inflating the Retry-After handed to read
traffic. Without a tenant registry every caller rides one implicit
tenant and the controller behaves exactly as the single-level one did.

Deadlines compose: a waiter whose QueryContext expires or is cancelled
while queued leaves the queue with the matching error — a query that
died waiting never occupies an execution slot.

A copy of the JAX package's ``sched/admission.py``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from ..errors import PilosaError
# The implicit tenant when no registry / principal is wired — one
# bucket, so the second stride level degenerates to the old behavior.
# The ONE definition lives in utils.config (the [tenants] table's
# mandatory entry), so the implicit bucket can never drift from the
# policy the registry resolves unknown tenants to.
from ..utils.config import DEFAULT_TENANT  # noqa: F401

DEFAULT_CONCURRENCY = 16
DEFAULT_QUEUE_DEPTH = 64
# Lane weights: reads dominate a healthy serving mix, writes matter,
# admin must never starve. Overridable per controller.
DEFAULT_WEIGHTS = {"read": 4, "write": 2, "admin": 1}

# Poll tick while queued: bounds how stale a cancel/deadline can go
# unnoticed without a dedicated timer thread per waiter.
_WAIT_TICK_S = 0.05

# Seed hold estimate before any slot has released (seconds).
_HOLD_SEED_S = 0.05


class AdmissionFullError(PilosaError):
    """Queue depth exhausted; ``retry_after_s`` is the server's own
    estimate of when capacity frees (rendered as Retry-After).
    ``tenant`` names the principal when the rejection was that
    tenant's own quota (not the global backstop) — the HTTP layer's
    per-tenant shed counters key on it."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 tenant: str = ""):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.tenant = tenant


class _Waiter:
    __slots__ = ("granted", "tenant")

    def __init__(self, tenant: str):
        self.granted = False
        self.tenant = tenant


class Slot:
    """An execution slot; release() is idempotent (also a context
    manager, releasing on exit)."""

    __slots__ = ("_ac", "lane", "tenant", "_t0", "_released")

    def __init__(self, ac: "AdmissionController", lane: str,
                 tenant: str = DEFAULT_TENANT):
        self._ac = ac
        self.lane = lane
        self.tenant = tenant
        self._t0 = time.monotonic()
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ac._release(self.lane, self.tenant,
                              time.monotonic() - self._t0)

    def __enter__(self) -> "Slot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class AdmissionController:
    def __init__(self, concurrency: int = DEFAULT_CONCURRENCY,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 weights: Optional[dict[str, int]] = None,
                 tenants=None):
        self.concurrency = max(1, int(concurrency))
        self.queue_depth = max(0, int(queue_depth))
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        # sched.tenants.TenantRegistry (or None): per-tenant weights,
        # caps, quotas. Its lock is a leaf under this controller's.
        self.tenants = tenants
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._in_flight = 0
        # lane -> tenant -> FIFO of waiters.
        self._queues: dict[str, dict[str, list[_Waiter]]] = {}
        # Stride scheduling state: lane virtual clocks, and per-lane
        # tenant virtual clocks (the second level).
        self._vtime: dict[str, float] = {}
        self._tvtime: dict[str, dict[str, float]] = {}
        self._served: dict[str, int] = {}
        self._tenant_served: dict[str, int] = {}
        self._lane_inflight: dict[str, int] = {}
        self._tenant_inflight: dict[str, int] = {}
        self._rejected = 0
        self._tenant_rejected: dict[str, int] = {}
        # Hold-seconds EWMAs feeding the Retry-After estimates:
        # per lane (a shed write burst must not inflate read
        # Retry-Afters) and per (lane, tenant) for quota rejections.
        self._hold_ewma: dict[str, float] = {}
        self._tenant_hold: dict[tuple[str, str], float] = {}
        # Stall/shed observability (obs.watchdog, obs.sampler): when
        # the last slot was granted, when the wait queue last became
        # non-empty, and per-lane when the last 429 was issued.
        self._last_grant = time.monotonic()
        self._queue_since = 0.0
        self._last_reject: dict[str, float] = {}

    # -- tenant policy plumbing ----------------------------------------------

    def _tenant_of(self, ctx, tenant: Optional[str]) -> str:
        if tenant:
            return tenant
        t = getattr(ctx, "tenant", "") if ctx is not None else ""
        return t or DEFAULT_TENANT

    def _tenant_caps(self, tenant: str) -> tuple[int, int]:
        """(concurrency cap, queue quota) for this tenant; 0 = none."""
        if self.tenants is None:
            return 0, 0
        pol = self.tenants.policy(tenant)
        return pol.concurrency, pol.queue_depth

    def _tenant_weight(self, tenant: str) -> float:
        if self.tenants is None:
            return 1.0
        return max(self.tenants.effective_weight(tenant), 1e-6)

    def _under_cap_locked(self, tenant: str) -> bool:
        cap, _ = self._tenant_caps(tenant)
        return cap <= 0 or self._tenant_inflight.get(tenant, 0) < cap

    # -- acquire / release ---------------------------------------------------

    def acquire(self, lane: str, ctx=None,
                tenant: Optional[str] = None) -> Slot:
        """Block until a slot frees (respecting ``ctx``'s deadline and
        cancellation), or raise AdmissionFullError when the wait queue
        is already at depth — or this tenant's own quota is. The
        tenant defaults to the context's principal."""
        tenant = self._tenant_of(ctx, tenant)
        with self._cond:
            queued = self._queued_locked()
            if (self._in_flight < self.concurrency and queued == 0
                    and self._under_cap_locked(tenant)):
                self._grant_locked(lane, tenant)
                return Slot(self, lane, tenant)
            tq = len(self._queues.get(lane, {}).get(tenant, ()))
            _, quota = self._tenant_caps(tenant)
            if quota > 0 and tq >= quota:
                # The tenant's own quota: only IT sheds — everyone
                # else's queue positions are untouched, and the
                # Retry-After is computed from ITS backlog, not the
                # aggregate's.
                self._rejected += 1
                self._tenant_rejected[tenant] = \
                    self._tenant_rejected.get(tenant, 0) + 1
                self._last_reject[lane] = time.monotonic()
                raise AdmissionFullError(
                    f"tenant {tenant} over queue quota ({tq} waiting"
                    f" in {lane}, quota {quota})",
                    retry_after_s=self._retry_after_locked(
                        lane, tenant=tenant),
                    tenant=tenant)
            if queued >= self.queue_depth:
                self._rejected += 1
                self._last_reject[lane] = time.monotonic()
                raise AdmissionFullError(
                    f"admission queue full ({queued} waiting,"
                    f" {self._in_flight} in flight)",
                    retry_after_s=self._retry_after_locked(lane))
            w = _Waiter(tenant)
            if queued == 0:
                # The queue just became non-empty: the watchdog's
                # stall clock starts HERE, not at the last grant — a
                # fresh waiter behind legitimately long-running slot
                # holders is not a stall.
                self._queue_since = time.monotonic()
            self._queues.setdefault(lane, {}).setdefault(
                tenant, []).append(w)
            # Capacity may be grantable RIGHT NOW (e.g. slots free but
            # some other tenant's waiters are cap-blocked): the wake
            # pass keeps the controller work-conserving.
            self._wake_locked()
            try:
                while not w.granted:
                    if ctx is not None:
                        ctx.check()  # raises on cancel/expiry/kill
                    self._cond.wait(_WAIT_TICK_S)
            except BaseException:
                # Left the queue without the slot: if a grant raced in,
                # hand it to the next waiter instead of leaking it.
                if w.granted:
                    self._in_flight -= 1
                    self._lane_dec(self._lane_inflight, lane)
                    self._lane_dec(self._tenant_inflight, tenant)
                    self._wake_locked()
                else:
                    self._queues[lane][tenant].remove(w)
                    if not self._queues[lane][tenant]:
                        del self._queues[lane][tenant]
                raise
            return Slot(self, lane, tenant)

    @staticmethod
    def _lane_dec(d: dict, key: str) -> None:
        n = d.get(key, 0) - 1
        if n > 0:
            d[key] = n
        else:
            d.pop(key, None)

    def _release(self, lane: str, tenant: str, held_s: float) -> None:
        with self._cond:
            self._in_flight -= 1
            self._lane_dec(self._lane_inflight, lane)
            self._lane_dec(self._tenant_inflight, tenant)
            prev = self._hold_ewma.get(lane, _HOLD_SEED_S)
            self._hold_ewma[lane] = 0.8 * prev + 0.2 * held_s
            tkey = (lane, tenant)
            tprev = self._tenant_hold.get(tkey, _HOLD_SEED_S)
            self._tenant_hold[tkey] = 0.8 * tprev + 0.2 * held_s
            self._wake_locked()

    def _queued_locked(self) -> int:
        return sum(len(q) for tmap in self._queues.values()
                   for q in tmap.values())

    def _grant_locked(self, lane: str, tenant: str) -> None:
        self._in_flight += 1
        self._last_grant = time.monotonic()
        self._served[lane] = self._served.get(lane, 0) + 1
        self._tenant_served[tenant] = \
            self._tenant_served.get(tenant, 0) + 1
        self._lane_inflight[lane] = \
            self._lane_inflight.get(lane, 0) + 1
        self._tenant_inflight[tenant] = \
            self._tenant_inflight.get(tenant, 0) + 1
        w = self.weights.get(lane, 1) or 1
        # A lane idle for a while re-enters near the current clock
        # rather than spending banked credit starving everyone else.
        base = max(self._vtime.values(), default=0.0)
        self._vtime[lane] = max(self._vtime.get(lane, 0.0), base - 1.0) \
            + 1.0 / w
        # Second level: the tenant clock within this lane, advancing
        # at 1/effective-weight — the penalty box demotes a repeat
        # offender here without touching anyone else's schedule.
        tv = self._tvtime.setdefault(lane, {})
        tbase = max(tv.values(), default=0.0)
        tv[tenant] = max(tv.get(tenant, 0.0), tbase - 1.0) \
            + 1.0 / self._tenant_weight(tenant)

    def _pick_locked(self) -> Optional[tuple[str, str]]:
        """The next (lane, tenant) to grant: the backlogged lane with
        the smallest lane clock among lanes holding at least one
        ELIGIBLE (under-cap) tenant; within it, the eligible tenant
        with the smallest tenant clock."""
        best_lane = None
        best_tenants: list[str] = []
        for lane, tmap in self._queues.items():
            eligible = [t for t, q in tmap.items()
                        if q and self._under_cap_locked(t)]
            if not eligible:
                continue
            if (best_lane is None or self._vtime.get(lane, 0.0)
                    < self._vtime.get(best_lane, 0.0)):
                best_lane, best_tenants = lane, eligible
        if best_lane is None:
            return None
        tv = self._tvtime.get(best_lane, {})
        tenant = min(best_tenants, key=lambda t: tv.get(t, 0.0))
        return best_lane, tenant

    def _wake_locked(self) -> None:
        """Grant freed capacity to waiters via the two-level stride
        pick, skipping tenants at their concurrency cap."""
        granted = False
        while self._in_flight < self.concurrency:
            pick = self._pick_locked()
            if pick is None:
                break
            lane, tenant = pick
            q = self._queues[lane][tenant]
            waiter = q.pop(0)
            if not q:
                del self._queues[lane][tenant]
            waiter.granted = True
            self._grant_locked(lane, waiter.tenant)
            granted = True
        if granted:
            self._cond.notify_all()

    # -- introspection -------------------------------------------------------

    def _retry_after_locked(self, lane: str,
                            tenant: Optional[str] = None) -> float:
        """Seconds until the backlog likely drains enough to admit one
        more query. Per-lane: that lane's backlog × ITS hold EWMA /
        parallelism (a shed write burst leaves read Retry-Afters
        alone). Per-tenant: the tenant-lane's own backlog over the
        parallelism its cap actually allows it."""
        if tenant is not None:
            cap, _ = self._tenant_caps(tenant)
            par = min(self.concurrency, cap) if cap > 0 \
                else self.concurrency
            backlog = (self._tenant_inflight.get(tenant, 0)
                       + len(self._queues.get(lane, {})
                             .get(tenant, ())))
            hold = self._tenant_hold.get(
                (lane, tenant), self._hold_ewma.get(lane,
                                                    _HOLD_SEED_S))
        else:
            par = self.concurrency
            backlog = (self._lane_inflight.get(lane, 0)
                       + sum(len(q) for q in
                             self._queues.get(lane, {}).values()))
            hold = self._hold_ewma.get(lane, _HOLD_SEED_S)
        est = hold * max(1, backlog) / max(1, par)
        return float(max(1, math.ceil(est)))

    @property
    def in_flight(self) -> int:
        with self._mu:
            return self._in_flight

    def tenant_in_flight(self) -> dict[str, int]:
        """Slots held per tenant (scrape-time gauge refresh +
        /debug/tenants)."""
        with self._mu:
            return dict(self._tenant_inflight)

    def recent_rejection(self, lane: str, window_s: float) -> bool:
        """Did this lane answer a 429 within the last ``window_s``?
        The tail sampler's shed-lane signal: a query that finished in
        a lane that was actively shedding is evidence worth keeping."""
        with self._mu:
            t = self._last_reject.get(lane)
        return t is not None and time.monotonic() - t <= window_s

    def stall_state(self) -> tuple[int, float]:
        """(queued, stall age) for the watchdog's non-draining-queue
        detector: the age is since the LATER of the last grant and
        the moment the queue became non-empty — grants draining the
        queue reset it, and so does an empty queue refilling."""
        with self._mu:
            queued = self._queued_locked()
            if queued == 0:
                return 0, 0.0
            return queued, time.monotonic() - max(self._last_grant,
                                                  self._queue_since)

    def snapshot(self) -> dict:
        with self._mu:
            lane_queued = {ln: sum(len(q) for q in tmap.values())
                           for ln, tmap in self._queues.items()
                           if any(tmap.values())}
            tenants = {}
            names = (set(self._tenant_inflight)
                     | set(self._tenant_served)
                     | set(self._tenant_rejected)
                     | {t for tmap in self._queues.values()
                        for t, q in tmap.items() if q})
            for t in sorted(names):
                tenants[t] = {
                    "inFlight": self._tenant_inflight.get(t, 0),
                    "queued": sum(
                        len(tmap.get(t, ()))
                        for tmap in self._queues.values()),
                    "served": self._tenant_served.get(t, 0),
                    "rejected": self._tenant_rejected.get(t, 0),
                }
            return {
                "concurrency": self.concurrency,
                "queueDepth": self.queue_depth,
                "inFlight": self._in_flight,
                "queued": lane_queued,
                "served": dict(self._served),
                "rejected": self._rejected,
                "weights": dict(self.weights),
                "holdEwmaS": {ln: round(v, 4) for ln, v
                              in self._hold_ewma.items()},
                "tenants": tenants,
            }

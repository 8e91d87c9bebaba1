"""Per-peer circuit breakers: closed / open / half-open.

Copy of the JAX package's ``fault/breaker.py``.

The contract the executor and client build on:

- **closed**: requests flow; ``threshold`` CONSECUTIVE transport
  failures trip the breaker open (any completed HTTP exchange —
  whatever its status code — counts as success: the peer is alive).
- **open**: ``allow()`` answers False, so placement skips the peer and
  the client fails fast (CircuitOpenError) instead of paying the dead
  peer's socket timeout. The open window is exponential backoff with
  FULL jitter: ``uniform(0, min(cap, base·2^n))`` after the n-th trip
  (AWS full-jitter — a cluster of coordinators must not probe a
  recovering peer in lockstep).
- **half-open**: once the window lapses, exactly ONE in-flight probe
  is granted; its success closes the breaker (and resets the backoff
  exponent), its failure re-opens with a doubled window.

Transitions mirror into ``pilosa_fault_breaker_state`` /
``pilosa_fault_breaker_transitions_total`` and — when a traced query
drives the transition — a zero-length span on its trace, so a stitched
perfetto view shows WHERE the breaker tripped inside the query.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from ..obs import metrics as obs_metrics
from ..sched import context as sched_context

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

_STATE_GAUGE = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class _Breaker:
    __slots__ = ("state", "failures", "openings", "open_until",
                 "probe_inflight", "probe_granted", "opened_ts",
                 "last_reason")

    def __init__(self):
        self.state = STATE_CLOSED
        self.failures = 0        # consecutive transport failures
        self.openings = 0        # trips since last close (backoff exp)
        self.open_until = 0.0
        self.probe_inflight = False
        self.probe_granted = 0.0  # clock() when the probe was granted
        self.opened_ts = 0.0
        self.last_reason = ""


class BreakerBoard:
    """All of one node's per-peer breakers behind one lock."""

    # Seconds after which a granted-but-unreported half-open probe is
    # considered abandoned and a new probe may be granted. A probe can
    # die without an outcome (its request raised before reaching the
    # wire, the caller was interrupted); without an expiry that lost
    # slot would blacklist the peer FOREVER — every later allow() sees
    # probe_inflight and fails fast, and nothing ever reports back.
    # Sized above the client's 30 s default socket timeout so a
    # legitimately slow probe is never double-granted.
    PROBE_EXPIRY_S = 60.0

    def __init__(self, threshold: int = 3, backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0, node: str = "",
                 rng: Optional[random.Random] = None, clock=None):
        self.threshold = max(1, threshold)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.node = node
        self._rng = rng or random.Random()
        self._clock = clock or time.monotonic
        self._mu = threading.Lock()
        self._peers: dict[str, _Breaker] = {}

    def _peer(self, host: str) -> _Breaker:
        b = self._peers.get(host)
        if b is None:
            b = self._peers[host] = _Breaker()
        return b

    # -- transitions (hold _mu) ----------------------------------------------

    def _transition(self, host: str, b: _Breaker, to: str,
                    reason: str = "") -> None:
        if b.state == to:
            return
        b.state = to
        b.last_reason = reason
        obs_metrics.BREAKER_STATE.labels(host).set(_STATE_GAUGE[to])
        obs_metrics.BREAKER_TRANSITIONS.labels(host, to).inc()
        # Attribute the transition to the query that drove it, when
        # one is bound and traced (zero-length marker span).
        ctx = sched_context.current()
        trace = getattr(ctx, "trace", None) if ctx is not None else None
        if trace is not None:
            trace.add_span(f"breaker_{to}", time.time(), 0.0,
                           tags={"peer": host, "reason": reason})

    def _open(self, host: str, b: _Breaker, reason: str) -> None:
        b.openings += 1
        window = min(self.backoff_cap_s,
                     self.backoff_base_s * (2.0 ** (b.openings - 1)))
        b.open_until = self._clock() + self._rng.uniform(0.0, window)
        b.opened_ts = time.time()
        b.probe_inflight = False
        self._transition(host, b, STATE_OPEN, reason)

    # -- feeds ---------------------------------------------------------------

    def record_success(self, host: str) -> None:
        with self._mu:
            b = self._peers.get(host)
            if b is None:
                return
            b.failures = 0
            b.probe_inflight = False
            if b.state != STATE_CLOSED:
                b.openings = 0
                self._transition(host, b, STATE_CLOSED, "probe ok")

    def record_failure(self, host: str) -> None:
        with self._mu:
            b = self._peer(host)
            b.failures += 1
            if b.state == STATE_HALF_OPEN:
                # The probe failed: re-open with a doubled window.
                self._open(host, b, "probe failed")
            elif (b.state == STATE_CLOSED
                  and b.failures >= self.threshold):
                self._open(host, b,
                           f"{b.failures} consecutive failures")
            elif b.state == STATE_OPEN:
                b.probe_inflight = False

    def force_open(self, host: str, reason: str = "forced") -> None:
        """Open immediately (gossip declared the peer dead) — no
        threshold wait, so not even the FIRST query pays a timeout."""
        with self._mu:
            b = self._peer(host)
            if b.state != STATE_OPEN:
                b.failures = self.threshold
                self._open(host, b, reason)

    def note_probe_ready(self, host: str) -> None:
        """Collapse the open window (gossip says the peer is back):
        the next request becomes the half-open probe right away. A
        HALF_OPEN breaker whose probe never reported back is rescued
        too — the liveness evidence outranks a lost probe slot."""
        with self._mu:
            b = self._peers.get(host)
            if b is None:
                return
            if b.state == STATE_OPEN:
                b.open_until = self._clock()
            elif b.state == STATE_HALF_OPEN:
                b.probe_inflight = False

    # -- consults ------------------------------------------------------------

    def _probe_expired(self, b: _Breaker) -> bool:
        return (b.probe_inflight
                and self._clock() - b.probe_granted
                > self.PROBE_EXPIRY_S)

    def allow(self, host: str) -> bool:
        """May a request go to ``host``? Open→half-open happens here:
        when the window has lapsed, the FIRST caller is granted the
        probe and concurrent callers keep failing fast until the probe
        reports back (or its expiry reclaims an abandoned slot)."""
        with self._mu:
            b = self._peers.get(host)
            if b is None or b.state == STATE_CLOSED:
                return True
            now = self._clock()
            if b.state == STATE_OPEN:
                if now < b.open_until:
                    return False
                self._transition(host, b, STATE_HALF_OPEN,
                                 "backoff elapsed")
                b.probe_inflight = True
                b.probe_granted = now
                return True
            # half-open: one probe at a time
            if b.probe_inflight and not self._probe_expired(b):
                return False
            b.probe_inflight = True
            b.probe_granted = now
            return True

    def would_allow(self, host: str) -> bool:
        """allow() without the side effects (no half-open transition,
        no probe slot taken) — the consult for placement ordering and
        for pure peer FILTERS like the anti-entropy syncer (which must
        never consume the probe its own client is about to need)."""
        with self._mu:
            b = self._peers.get(host)
            if b is None or b.state == STATE_CLOSED:
                return True
            if b.state == STATE_OPEN:
                return self._clock() >= b.open_until
            return not b.probe_inflight or self._probe_expired(b)

    def state(self, host: str) -> str:
        with self._mu:
            b = self._peers.get(host)
            return STATE_CLOSED if b is None else b.state

    def snapshot(self) -> dict:
        now = self._clock()
        with self._mu:
            items = list(self._peers.items())
            out = {}
            for host, b in items:
                out[host] = {
                    "state": b.state,
                    "consecutiveFailures": b.failures,
                    "openings": b.openings,
                    "reopenInS": round(max(0.0, b.open_until - now), 3)
                    if b.state == STATE_OPEN else 0.0,
                    "reason": b.last_reason,
                }
        return out

"""Stall watchdog: detects wedged internals and triggers evidence
capture while the wedge is still observable.

Four stall detectors, each cheap enough to run every second:

- **wal_flusher** — the WAL group-commit flusher is wedged: some WAL
  has had pending (unflushed) records for longer than ``wal_stall_s``
  (storage.wal keeps a per-WAL dirty-since timestamp plus a flusher
  heartbeat; a healthy flusher drains within ~one window).
- **stuck_query** — an executor leg is still ``running`` more than
  ``deadline_grace_s`` past its deadline: cooperative cancellation
  should have surfaced QueryDeadlineError long ago, so something is
  blocked in a non-checking section (a hung syscall, a lost lock).
- **gossip_silence** — a multi-node cluster's membership layer has
  received nothing for ``gossip_silence_s``: probes, push/pull and
  rumors are all silent, so failure detection is blind.
- **admission_stall** — queries are queued but nothing has been
  granted a slot for ``queue_stall_s``: the queue is not draining
  (every slot wedged, or a lost wakeup).
- **resize_stall** — this node coordinates an elastic resize whose
  active phase has made no forward progress (no ack, no streamed
  block, no phase move) for ``resize_stall_s``: a wedged stream
  target, a partitioned flip, or a stuck control send — the window
  where the cluster is paying double-write/double-read overhead for
  nothing (docs/CLUSTER_RESIZE.md).
- **scrub_stall** — a background storage-scrub pass (storage.scrub)
  is in flight but has verified no fragment for ``scrub_stall_s``: a
  hung disk read or a wedged pacing sleep — the window where silent
  corruption detection is blind.
- **tier_stall** — the tier working-set manager (tier.manager) has
  demotion/eviction work pending but has completed no transition for
  ``tier_stall_s``: a wedged snapshot barrier or a hung blob
  transfer — the window where watermark pressure keeps building
  and cold reads stop promoting.
- **backup_stall** — the backup plane (backup.coordinator) has work in
  flight — a coordinated backup pushing fragments, or the continuous
  WAL archiver with pending segments — but has completed nothing for
  ``backup_stall_s``: a hung archive store or a wedged source fetch,
  the window where the recovery point silently stops advancing.

A trip increments ``pilosa_watchdog_trips_total{cause}``, force-keeps
every in-flight trace (reason ``watchdog`` — the wedged query's spans
so far are exactly the evidence), and triggers a blackbox dump naming
the cause. Per-cause re-trips are rate-limited (``retrip_s``) so a
persistent wedge produces a dump per window, not per tick.

Copy of the JAX package's ``obs/watchdog.py``, with every detector. The
server feeds the resize input from its coordinator's progress and the
tier input from the tier manager's ``stall_age``; this package runs no
backup yet, so that input is None, as in a JAX server that runs none.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from . import metrics as obs_metrics

DEFAULT_INTERVAL_S = 1.0
DEFAULT_WAL_STALL_S = 5.0
DEFAULT_DEADLINE_GRACE_S = 5.0
DEFAULT_GOSSIP_SILENCE_S = 60.0
DEFAULT_QUEUE_STALL_S = 10.0
DEFAULT_RESIZE_STALL_S = 60.0
DEFAULT_SCRUB_STALL_S = 300.0
DEFAULT_TIER_STALL_S = 120.0
DEFAULT_BACKUP_STALL_S = 120.0
DEFAULT_RETRIP_S = 60.0

CAUSES = ("wal_flusher", "stuck_query", "gossip_silence",
          "admission_stall", "resize_stall", "scrub_stall",
          "tier_stall", "backup_stall")


class Watchdog:
    def __init__(self, registry=None, admission=None, tracer=None,
                 sampler=None, blackbox=None,
                 gossip_age_fn: Optional[Callable[[], Optional[float]]]
                 = None,
                 resize_progress_fn: Optional[Callable] = None,
                 scrub_progress_fn: Optional[Callable] = None,
                 tier_progress_fn: Optional[Callable] = None,
                 backup_progress_fn: Optional[Callable] = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 wal_stall_s: float = DEFAULT_WAL_STALL_S,
                 deadline_grace_s: float = DEFAULT_DEADLINE_GRACE_S,
                 gossip_silence_s: float = DEFAULT_GOSSIP_SILENCE_S,
                 queue_stall_s: float = DEFAULT_QUEUE_STALL_S,
                 resize_stall_s: float = DEFAULT_RESIZE_STALL_S,
                 scrub_stall_s: float = DEFAULT_SCRUB_STALL_S,
                 tier_stall_s: float = DEFAULT_TIER_STALL_S,
                 backup_stall_s: float = DEFAULT_BACKUP_STALL_S,
                 retrip_s: float = DEFAULT_RETRIP_S, logger=None):
        from ..utils import logger as logger_mod
        self.registry = registry      # sched.QueryRegistry
        self.admission = admission    # sched.AdmissionController
        self.tracer = tracer          # obs.trace.Tracer
        self.sampler = sampler        # obs.sampler.TailSampler
        self.blackbox = blackbox      # obs.blackbox.Blackbox
        self.gossip_age_fn = gossip_age_fn
        # () -> None | (phase, seconds_without_progress): the server's
        # view of an ACTIVE resize it coordinates (cluster.resize).
        self.resize_progress_fn = resize_progress_fn
        # () -> None | seconds_without_progress of an IN-FLIGHT scrub
        # pass (storage.scrub.Scrubber.stall_age).
        self.scrub_progress_fn = scrub_progress_fn
        # () -> None | seconds_without_progress while the tier
        # manager has pending demotion/eviction work
        # (tier.manager.TierManager.stall_age).
        self.tier_progress_fn = tier_progress_fn
        # () -> None | seconds_without_progress while the backup plane
        # has in-flight work (server.BackupManager.stall_age).
        self.backup_progress_fn = backup_progress_fn
        self.interval_s = max(0.02, float(interval_s))
        self.wal_stall_s = float(wal_stall_s)
        self.deadline_grace_s = float(deadline_grace_s)
        self.gossip_silence_s = float(gossip_silence_s)
        self.queue_stall_s = float(queue_stall_s)
        self.resize_stall_s = float(resize_stall_s)
        self.scrub_stall_s = float(scrub_stall_s)
        self.tier_stall_s = float(tier_stall_s)
        self.backup_stall_s = float(backup_stall_s)
        self.retrip_s = float(retrip_s)
        self.logger = logger or logger_mod.NOP
        self.trips = 0
        self._last_trip: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the watchdog must not die
                pass

    # -- detectors ------------------------------------------------------------

    def check(self) -> list[tuple[str, str]]:
        """One pass over every detector; trips (and returns) the
        ``(cause, detail)`` pairs that fired this pass."""
        fired = []
        for cause, detail in self._stalls():
            if self._trip(cause, detail):
                fired.append((cause, detail))
        return fired

    def _stalls(self) -> list[tuple[str, str]]:
        out = []
        # Wedged WAL flusher (dirty-age past threshold).
        try:
            from ..storage import wal as storage_wal
            health = storage_wal.flusher_health()
        except Exception:  # noqa: BLE001
            health = {}
        age = health.get("oldestDirtyAgeS") or 0.0
        if self.wal_stall_s > 0 and age > self.wal_stall_s:
            worst = (health.get("wals") or [{}])[0]
            out.append(("wal_flusher",
                        f"dirty {age:.2f}s: {worst.get('file', '?')}"
                        f" ({worst.get('pendingBytes', 0)}B pending)"))
        # Executor legs stuck past deadline grace.
        if self.registry is not None and self.deadline_grace_s > 0:
            for ctx in self.registry.active_contexts():
                rem = ctx.remaining()
                if (rem is not None and -rem > self.deadline_grace_s
                        and ctx.state == "running"):
                    out.append((
                        "stuck_query",
                        f"query {ctx.id} {-rem:.2f}s past deadline"
                        f" (pql={ctx.pql[:80]!r})"))
                    break  # one trip covers the pass; the dump lists all
        # Gossip silence (multi-node only; the fn returns None when
        # silence is not observable — single node, static membership).
        if self.gossip_age_fn is not None and self.gossip_silence_s > 0:
            try:
                age = self.gossip_age_fn()
            except Exception:  # noqa: BLE001
                age = None
            if age is not None and age > self.gossip_silence_s:
                out.append(("gossip_silence",
                            f"no membership traffic for {age:.1f}s"))
        # Non-draining admission queue.
        if self.admission is not None and self.queue_stall_s > 0:
            queued, grant_age = self.admission.stall_state()
            if queued > 0 and grant_age > self.queue_stall_s:
                out.append((
                    "admission_stall",
                    f"{queued} queued, no grant for {grant_age:.1f}s"))
        # Stalled elastic resize (this node coordinating).
        if (self.resize_progress_fn is not None
                and self.resize_stall_s > 0):
            try:
                st = self.resize_progress_fn()
            except Exception:  # noqa: BLE001
                st = None
            if st is not None:
                phase, age = st
                if age > self.resize_stall_s:
                    out.append((
                        "resize_stall",
                        f"resize phase {phase}: no progress for"
                        f" {age:.1f}s"))
        # Stalled storage scrub pass (storage.scrub).
        if (self.scrub_progress_fn is not None
                and self.scrub_stall_s > 0):
            try:
                age = self.scrub_progress_fn()
            except Exception:  # noqa: BLE001
                age = None
            if age is not None and age > self.scrub_stall_s:
                out.append((
                    "scrub_stall",
                    f"scrub pass in flight, no fragment verified for"
                    f" {age:.1f}s"))
        # Stalled tier working-set manager (tier.manager).
        if (self.tier_progress_fn is not None
                and self.tier_stall_s > 0):
            try:
                age = self.tier_progress_fn()
            except Exception:  # noqa: BLE001
                age = None
            if age is not None and age > self.tier_stall_s:
                out.append((
                    "tier_stall",
                    f"tier work pending, no transition completed for"
                    f" {age:.1f}s"))
        # Stalled backup plane (the coordinator this node runs).
        if (self.backup_progress_fn is not None
                and self.backup_stall_s > 0):
            try:
                age = self.backup_progress_fn()
            except Exception:  # noqa: BLE001
                age = None
            if age is not None and age > self.backup_stall_s:
                out.append((
                    "backup_stall",
                    f"backup work in flight, no progress for"
                    f" {age:.1f}s"))
        return out

    # -- the trip --------------------------------------------------------------

    def _trip(self, cause: str, detail: str) -> bool:
        now = time.monotonic()
        last = self._last_trip.get(cause, 0.0)
        if last and now - last < self.retrip_s:
            return False
        self._last_trip[cause] = now
        self.trips += 1
        obs_metrics.WATCHDOG_TRIPS.labels(cause).inc()
        self.logger.printf("watchdog trip: %s (%s)", cause, detail)
        self._force_keep_traces(cause)
        if self.blackbox is not None:
            try:
                self.blackbox.dump(f"watchdog:{cause}")
            except Exception:  # noqa: BLE001
                pass
        return True

    def _force_keep_traces(self, cause: str) -> None:
        """Every in-flight query's trace-so-far into the ring + disk:
        the wedged query is by definition still running, and its spans
        up to the wedge are the evidence."""
        if self.registry is None or self.tracer is None:
            return
        for ctx in self.registry.active_contexts():
            trace = getattr(ctx, "trace", None)
            if trace is None or getattr(trace, "keep_reason", ""):
                continue
            try:
                # keep() claims atomically — a concurrently-finishing
                # query's own keep decision may win the race, in which
                # case this trace is already entered and we skip it.
                if self.tracer.keep(trace, reason="watchdog") \
                        and self.sampler is not None:
                    self.sampler.persist(trace, "watchdog", ctx=ctx)
            except Exception:  # noqa: BLE001
                continue

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {"trips": self.trips,
                "lastTrip": {c: round(now - t, 1)
                             for c, t in self._last_trip.items()},
                "thresholds": {"walStallS": self.wal_stall_s,
                               "deadlineGraceS": self.deadline_grace_s,
                               "gossipSilenceS": self.gossip_silence_s,
                               "queueStallS": self.queue_stall_s,
                               "resizeStallS": self.resize_stall_s,
                               "scrubStallS": self.scrub_stall_s,
                               "tierStallS": self.tier_stall_s,
                               "backupStallS": self.backup_stall_s}}

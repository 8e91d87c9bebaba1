"""Disk-full graceful degradation: ENOSPC flips the node write-unready.

Copy of the JAX package's ``fault/diskfull.py``.

A full disk used to be a 500 crash-loop: every write query hit the WAL
leader flush, got an OSError, answered 500, and the client retried
into the same wall — while reads (which need no new bytes) were
perfectly servable. This module is the one place that state lives:

- Durable-write sites (``wal.append`` leader flushes,
  ``snapshot.write`` rewrites) call :func:`note_enospc` when their
  OSError is ENOSPC. The node flips **write-unready**: ``/health``
  reports it (load balancers can drain writes), and the HTTP layer
  answers writes with ``507 Insufficient Storage`` + Retry-After
  instead of admitting them into a doomed WAL append. Reads keep
  serving throughout.
- **Auto-recovery**: while unready, :func:`write_ready` probes the
  failing directory (throttled) with a real write; the first probe
  that succeeds — an operator freed space, a retention job pruned —
  clears the state with no restart.
- Observability rings (obs.diskring) deliberately do NOT flip this
  state: diagnostics must never gate serving. They drop-and-count
  (SegmentRing.dropped) on any write failure, ENOSPC included.

Injection: the ``enospc`` failpoint mode (fault.failpoints) raises a
FailpointError carrying ``errno.ENOSPC`` at the existing
``wal.append`` / ``snapshot.write`` / ``ring.write`` sites, so the
whole degrade-and-recover loop is testable on a healthy disk.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from typing import Optional

from ..obs import metrics as obs_metrics

PROBE_INTERVAL_S = 2.0
# What a 507 tells the client to wait: the probe cadence — sooner
# retries cannot observe a recovery the probe hasn't.
RETRY_AFTER_S = 2


def is_enospc(err: BaseException) -> bool:
    return getattr(err, "errno", None) == errno.ENOSPC


class DiskFullState:
    """Process-wide write-readiness latch (one default instance via
    :func:`default`; tests may build their own)."""

    def __init__(self, probe_interval_s: float = PROBE_INTERVAL_S):
        self.probe_interval_s = probe_interval_s
        self._mu = threading.Lock()
        self._unready = False
        self._since = 0.0
        self._site = ""
        self._dir = ""
        self._events: dict[str, int] = {}
        self._last_probe = 0.0
        self._recoveries = 0
        obs_metrics.STORAGE_WRITE_READY.set(1)

    # -- flipping ------------------------------------------------------------

    def note_enospc(self, site: str, path: Optional[str] = None) -> None:
        """A durable-write site hit ENOSPC: flip write-unready and
        remember the directory so the recovery probe targets the
        filesystem that actually filled."""
        d = os.path.dirname(path) if path else ""
        with self._mu:
            self._events[site] = self._events.get(site, 0) + 1
            if not self._unready:
                self._unready = True
                self._since = time.time()
                self._site = site
                self._last_probe = 0.0  # next write_ready() probes
            if d:
                self._dir = d
        obs_metrics.STORAGE_ENOSPC.labels(site).inc()
        obs_metrics.STORAGE_WRITE_READY.set(0)

    def note_if_enospc(self, err: BaseException, site: str,
                       path: Optional[str] = None) -> bool:
        """note_enospc iff ``err`` is an ENOSPC (the one-liner the
        write sites' except-paths call); returns whether it was."""
        if is_enospc(err):
            self.note_enospc(site, path)
            return True
        return False

    def note_write_ok(self) -> None:
        """A durable write SUCCEEDED: clear the latch immediately (the
        cheapest possible recovery signal — real traffic proved the
        disk writable, no probe needed)."""
        with self._mu:
            if not self._unready:
                return
            self._clear_locked()
        obs_metrics.STORAGE_WRITE_READY.set(1)

    def _clear_locked(self) -> None:
        self._unready = False
        self._since = 0.0
        self._site = ""
        self._recoveries += 1

    # -- readiness -----------------------------------------------------------

    def write_ready(self, probe: bool = True) -> bool:
        """True while durable writes should be admitted. While
        unready, a throttled probe write to the failing directory
        auto-recovers the moment space frees."""
        with self._mu:
            if not self._unready:
                return True
            if not probe or not self._dir:
                return False
            now = time.monotonic()
            if now - self._last_probe < self.probe_interval_s:
                return False
            self._last_probe = now
            target = os.path.join(self._dir, ".enospc-probe")
        try:
            with open(target, "w") as f:
                f.write(str(time.time()))
            os.remove(target)
        except OSError:
            return False
        with self._mu:
            if self._unready:
                self._clear_locked()
        obs_metrics.STORAGE_WRITE_READY.set(1)
        return True

    def retry_after_s(self) -> int:
        return RETRY_AFTER_S

    def reset(self) -> None:
        """Test hook: back to pristine (counters included)."""
        with self._mu:
            self._unready = False
            self._since = 0.0
            self._site = ""
            self._dir = ""
            self._events = {}
            self._recoveries = 0
        obs_metrics.STORAGE_WRITE_READY.set(1)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "writeReady": not self._unready,
                "since": self._since or None,
                "site": self._site or None,
                "dir": self._dir or None,
                "events": dict(self._events),
                "recoveries": self._recoveries,
            }


_default: Optional[DiskFullState] = None
_default_mu = threading.Lock()


def default() -> DiskFullState:
    global _default
    with _default_mu:
        if _default is None:
            _default = DiskFullState()
        return _default


def note_if_enospc(err: BaseException, site: str,
                   path: Optional[str] = None) -> bool:
    return default().note_if_enospc(err, site, path)


def write_ready(probe: bool = True) -> bool:
    # Cheap when never tripped: one lock-guarded bool read.
    return _default is None or _default.write_ready(probe=probe)


def note_write_ok() -> None:
    if _default is not None:
        _default.note_write_ok()

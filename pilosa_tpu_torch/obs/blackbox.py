"""Blackbox flight recorder: periodic whole-system snapshots, dumped
in full when something dies.

An aircraft flight recorder does not wait to be asked: it records
continuously into a bounded loop and the loop is read AFTER the
incident. Same here — the recorder snapshots whole-system state
(admission queues, breaker states, generation maps, WAL dirty set +
flusher heartbeat, cache counters, a thread dump, recent slow-log
entries) on a fixed cadence into a bounded on-disk segment ring
(obs.diskring) under the holder data dir, and **dumps** the whole ring
plus one fresh snapshot to a standalone JSON file on:

- SIGTERM (the orderly-kill the operator sends before the SIGKILL
  they regret),
- an uncaught thread exception (``threading.excepthook`` chain),
- a watchdog trip (obs.watchdog calls ``dump("watchdog:<cause>")``),
- ``POST /debug/blackbox/dump``.

The state callable is injected by the server (it owns the wiring);
the recorder never raises into serving and its disk use is bounded by
the ring (snapshots) plus ``max_dumps`` dump files (oldest unlinked).

Copy of the JAX package's ``obs/blackbox.py``.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable, Optional

from . import metrics as obs_metrics
from .diskring import SegmentRing

DEFAULT_INTERVAL_S = 10.0
DEFAULT_SEGMENT_BYTES = 256 << 10
DEFAULT_MAX_SEGMENTS = 4
DEFAULT_MAX_DUMPS = 4


class Blackbox:
    """One node's flight recorder (module docstring)."""

    def __init__(self, dir: str,
                 state_fn: Callable[[], dict],
                 interval_s: float = DEFAULT_INTERVAL_S,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segments: int = DEFAULT_MAX_SEGMENTS,
                 max_dumps: int = DEFAULT_MAX_DUMPS,
                 node: str = "", logger=None):
        from ..utils import logger as logger_mod
        self.dir = dir
        self.state_fn = state_fn
        self.interval_s = max(0.05, float(interval_s))
        self.max_dumps = max(1, int(max_dumps))
        self.node = node
        self.logger = logger or logger_mod.NOP
        self.ring = SegmentRing(os.path.join(dir, "ring"),
                                segment_bytes=segment_bytes,
                                max_segments=max_segments)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dump_mu = threading.Lock()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()  # restartable (A/B harnesses stop/start)
        _register(self)
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-blackbox",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            # Join before a possible start(): a thread mid-snapshot
            # would otherwise return to wait() AFTER start() cleared
            # the flag and loop on as a leaked second recorder.
            thread.join(timeout=5.0)
        self._thread = None
        _deregister(self)
        self.ring.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.snapshot("periodic")
            except Exception:  # noqa: BLE001 - recording must not kill serving
                pass

    # -- recording ------------------------------------------------------------

    def snapshot(self, trigger: str = "manual",
                 extra: Optional[dict] = None) -> dict:
        """One whole-system state sample into the ring. ``extra``
        rides the record verbatim — the regression sentinel names the
        regressed metric there, so the snapshot self-documents WHY it
        was taken (the trigger label stays low-cardinality)."""
        snap = {"ts": time.time(), "node": self.node,
                "trigger": trigger}
        try:
            snap.update(self.state_fn() or {})
        except Exception as e:  # noqa: BLE001 - partial state beats none
            snap["stateError"] = str(e)[:200]
        if extra:
            snap.update(extra)
        self.ring.append(snap)
        obs_metrics.BLACKBOX_SNAPSHOTS.labels(trigger).inc()
        return snap

    def dump(self, cause: str) -> Optional[str]:
        """The full ring + one fresh snapshot to
        ``<dir>/dump-<unix-ms>-<cause>.json``; returns the path (None
        if the write failed). Serialized — concurrent triggers produce
        one dump each, never interleaved bytes."""
        with self._dump_mu:
            try:
                fresh = self.snapshot(f"dump:{cause}")
            except Exception:  # noqa: BLE001
                fresh = {"ts": time.time(), "error": "snapshot failed"}
            doc = {
                "cause": cause,
                "dumpedAt": time.time(),
                "node": self.node,
                "current": fresh,
                # Oldest-first so the dump reads as a timeline.
                "ring": list(self.ring.scan(newest_first=False)),
            }
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in cause)[:48]
            path = os.path.join(
                self.dir, f"dump-{int(time.time() * 1e3)}-{safe}.json")
            try:
                os.makedirs(self.dir, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, default=str)
                os.replace(tmp, path)
            except OSError:
                return None
            obs_metrics.BLACKBOX_DUMPS.labels(
                cause.split(":", 1)[0]).inc()
            self.logger.printf("blackbox dump (%s): %s", cause, path)
            self._prune_dumps()
            return path

    def dumps(self) -> list[str]:
        """Existing dump files, oldest first."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("dump-")
                           and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _prune_dumps(self) -> None:
        for path in self.dumps()[:-self.max_dumps]:
            try:
                os.unlink(path)
            except OSError:
                pass

    def stats(self) -> dict:
        return {"dir": self.dir, "intervalS": self.interval_s,
                "ring": self.ring.stats(),
                "dumps": [os.path.basename(p) for p in self.dumps()]}


# -- process-level triggers ----------------------------------------------------
# Every live recorder registers here; the (once-installed) SIGTERM and
# threading.excepthook chains dump them all. In-process multi-server
# tests each get their own dump under their own data dir.

_active_mu = threading.Lock()
_active: list[Blackbox] = []
_thread_hook_installed = False
_sigterm_installed = False
_prev_sigterm = None
_prev_thread_hook = None


def _register(bb: Blackbox) -> None:
    with _active_mu:
        if bb not in _active:
            _active.append(bb)


def _deregister(bb: Blackbox) -> None:
    with _active_mu:
        try:
            _active.remove(bb)
        except ValueError:
            pass


def dump_all(cause: str) -> list[str]:
    with _active_mu:
        boxes = list(_active)
    out = []
    for bb in boxes:
        try:
            path = bb.dump(cause)
            if path:
                out.append(path)
        except Exception:  # noqa: BLE001 - a dying process dumps best-effort
            pass
    return out


def install_process_hooks() -> bool:
    """Install the SIGTERM + uncaught-thread-exception dump triggers,
    once per process (each hook latches independently: a first call
    from a non-main thread installs only the excepthook chain, and a
    later main-thread call still gets to install the signal hook).
    Returns True once the SIGTERM hook is in place."""
    global _thread_hook_installed, _sigterm_installed
    global _prev_sigterm, _prev_thread_hook
    with _active_mu:
        if not _thread_hook_installed:
            _thread_hook_installed = True

            def _thread_hook(args):
                try:
                    dump_all("fatal:"
                             + getattr(args.exc_type, "__name__", "?"))
                except Exception:  # noqa: BLE001
                    pass
                if _prev_thread_hook is not None:
                    _prev_thread_hook(args)

            _prev_thread_hook = threading.excepthook
            threading.excepthook = _thread_hook
        if _sigterm_installed:
            return True

    def _sigterm(signum, frame):
        dump_all("sigterm")
        # Restore whatever was there and re-deliver, so process exit
        # semantics are exactly the pre-hook ones.
        prev = _prev_sigterm
        if callable(prev):
            prev(signum, frame)
            return
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # not the main thread; a later call may succeed
        return False
    with _active_mu:
        _prev_sigterm = prev
        _sigterm_installed = True
    return True

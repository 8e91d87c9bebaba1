"""Continuous profiling: an always-on low-Hz wall-clock sampler.

``utils/profiling.py``'s samplers are on-demand (a request blocks for
N seconds while the sampler runs). Production wants the opposite: a
background sampler that is ALWAYS running at a rate too low to matter
(default 10 Hz, a few microseconds of work per tick), so that when a
query is slow you already have its stacks — no reproduction required.

Samples land in a bounded ring as **query-id-tagged folded stacks**:
each sampled thread's collapsed stack is tagged with the query id
bound to that thread (sched.context.by_thread), so
``GET /debug/pprof/flame?query=<id>`` answers "where did THAT query
spend its wall time" — the continuous-profiling analogue of the
per-query cost ledger (obs.accounting).

``GET /debug/pprof/flame`` serves collapsed-stack text
(``a;b;c count`` lines — directly loadable by speedscope and
flamegraph.pl). Overhead contract mirrors tracing's: a profiler that
was never started samples nothing and the serving path never touches
it (the nop path is a None check in the handler).

Copy of the JAX package's ``obs/profile.py``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter, deque
from typing import Optional

from ..utils.profiling import _is_idle_leaf

DEFAULT_HZ = 10.0
DEFAULT_RING = 8192

# Stack-depth cap per sample: flame views past ~64 frames are noise
# and unbounded recursion must not balloon the ring's memory.
MAX_FRAMES = 64


def _collapse(frame) -> str:
    stack = []
    f = frame
    depth = 0
    while f is not None and depth < MAX_FRAMES:
        code = f.f_code
        stack.append(f"{code.co_name} "
                     f"({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
        f = f.f_back
        depth += 1
    return ";".join(reversed(stack))


class ContinuousProfiler:
    """Background low-Hz sampler with a bounded sample ring.

    Each ring entry is ``(wall_ts, query_id_or_empty, folded_stack)``.
    The ring bounds memory whatever the rate: at the default 10 Hz and
    8192 entries it holds the last ~10 minutes of a busy node.
    """

    def __init__(self, hz: float = DEFAULT_HZ,
                 ring: int = DEFAULT_RING):
        self.hz = max(0.1, min(float(hz), 100.0))
        self.interval = 1.0 / self.hz
        self._ring: deque[tuple[float, str, str]] = deque(
            maxlen=max(16, int(ring)))
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0
        self.idle_dropped = 0
        self.started_at: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self.started_at = time.time()
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-continuous-profiler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampling must not die
                pass

    # -- sampling ------------------------------------------------------------

    def sample_once(self) -> int:
        """One sampling tick: collapse every non-idle thread stack,
        tagged with the query id bound to that thread (if any).
        Returns how many stacks were recorded."""
        from ..sched import context as sched_context
        me = threading.get_ident()
        by_thread = sched_context.by_thread()
        now = time.time()
        recorded = 0
        entries = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if _is_idle_leaf(frame):
                self.idle_dropped += 1
                continue
            ctx = by_thread.get(tid)
            qid = ctx.id if ctx is not None else ""
            entries.append((now, qid, _collapse(frame)))
            recorded += 1
        if entries:
            with self._mu:
                self._ring.extend(entries)
        self.samples_taken += 1
        from . import metrics as obs_metrics
        obs_metrics.PROFILE_SAMPLES.inc()
        return recorded

    # -- export --------------------------------------------------------------

    def flame(self, query: str = "", since_s: float = 0.0) -> str:
        """Collapsed-stack text (``stack count`` lines, weight-sorted)
        aggregated over the ring — speedscope/flamegraph.pl-loadable.
        ``query`` filters to one query id's samples; ``since_s`` keeps
        only samples newer than that many seconds."""
        cutoff = time.time() - since_s if since_s > 0 else 0.0
        counts: Counter[str] = Counter()
        matched = 0
        with self._mu:
            ring = list(self._ring)
        for ts, qid, stack in ring:
            if ts < cutoff:
                continue
            if query and qid != query:
                continue
            counts[stack] += 1
            matched += 1
        header = (f"# continuous profile: {matched} samples"
                  f" ({len(ring)} in ring, {self.hz:g} Hz,"
                  f" {self.idle_dropped} idle dropped)"
                  + (f" query={query}" if query else ""))
        lines = [header]
        for stack, c in counts.most_common():
            lines.append(f"{stack} {c}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        with self._mu:
            n = len(self._ring)
        return {"running": self.running, "hz": self.hz,
                "ringSamples": n, "ticks": self.samples_taken,
                "idleDropped": self.idle_dropped,
                "startedAt": self.started_at}


# Module default, for layers constructed without explicit wiring (bare
# test handlers) — NOT started; the server builds and starts its own
# from [profile] config.
_profiler = ContinuousProfiler()


def get_profiler() -> ContinuousProfiler:
    return _profiler

"""Profiling: sampling CPU profiles and thread dumps.

Reference: Go pprof mounted at ``/debug/pprof`` (handler.go:30,99) plus
the ``--profile.cpu`` / ``--profile.cpu-time`` server flags
(cmd/server.go:47-62,99-100). Go's pprof is a statistical sampler of all
goroutine stacks; the Python-host equivalent here samples
``sys._current_frames()`` across all threads on a fixed interval and
aggregates collapsed stacks (flamegraph-compatible ``a;b;c count``
lines). Copy of the JAX package's ``utils/profiling.py``: it profiles
the host path (parsing, routing, roaring maintenance) around the CUDA
kernels, and, as there, no device trace is taken.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter


# A thread whose innermost Python frame is one of these is blocked in an
# idle primitive (lock/event wait, selector poll), not burning CPU. Go's
# pprof samples on-CPU time via SIGPROF; Python has no per-thread
# equivalent, so this wall-clock sampler drops known-idle leaves instead
# and reports how many it dropped.
_IDLE_LEAVES = {
    ("threading.py", "wait"),
    ("threading.py", "_wait_for_tstate_lock"),
    ("threading.py", "join"),
    ("selectors.py", "select"),
    ("socketserver.py", "serve_forever"),
    ("connection.py", "poll"),
}


def _is_idle_leaf(frame) -> bool:
    code = frame.f_code
    return (code.co_filename.rsplit("/", 1)[-1],
            code.co_name) in _IDLE_LEAVES


# Heap profiling via tracemalloc (the reference gets /debug/pprof/heap
# free from net/http/pprof, handler.go:30,99). tracemalloc costs ~2× on
# allocations while tracing, so arming is explicit and removable
# without a restart — and, since this round, arm/disarm are separate
# MUTATING operations (POST on the endpoint) while the report is a
# pure read (GET): a monitoring system GETing the heap endpoint must
# never toggle interpreter-wide allocation tracing as a side effect.


def heap_start() -> str:
    """Arm tracemalloc (idempotent). One frame per allocation is
    recorded: the report groups by source line and never reads deeper
    frames."""
    import tracemalloc
    if tracemalloc.is_tracing():
        return "tracemalloc already tracing.\n"
    tracemalloc.start(1)
    return ("tracemalloc started. Allocations are now traced; GET the "
            "endpoint for the report, POST ?op=stop to disarm (tracing "
            "costs ~2x on allocation-heavy paths).\n")


def heap_stop() -> str:
    """Disarm tracemalloc (idempotent)."""
    import tracemalloc
    if tracemalloc.is_tracing():
        tracemalloc.stop()
        return "tracemalloc stopped; allocation tracing disarmed.\n"
    return "tracemalloc was not tracing.\n"


def heap_report(top_n: int = 30) -> str:
    """Allocation-site report — a pure read; arming state is
    untouched."""
    import tracemalloc
    if not tracemalloc.is_tracing():
        return ("tracemalloc is not tracing. POST "
                "/debug/pprof/heap?op=start to arm it, then GET for "
                "the report.\n")
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")
    total = sum(s.size for s in stats)
    lines = [f"traced memory: {total / (1 << 20):.1f} MiB in "
             f"{sum(s.count for s in stats)} blocks "
             f"(top {min(top_n, len(stats))} sites)\n"]
    for s in stats[:top_n]:
        fr = s.traceback[0]
        lines.append(f"{s.size / 1024:10.1f} KiB {s.count:8d} blocks  "
                     f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno}\n")
    return "".join(lines)


def collect_sample(skip_threads: tuple[int, ...] = (),
                   include_idle: bool = True) -> list[str]:
    """One collapsed stack per live thread, innermost frame last."""
    out = []
    for tid, frame in sys._current_frames().items():
        if tid in skip_threads:
            continue
        if not include_idle and _is_idle_leaf(frame):
            continue
        stack = []
        f = frame
        while f is not None:
            code = f.f_code
            stack.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
            f = f.f_back
        out.append(";".join(reversed(stack)))
    return out


def _sample_loop(seconds: float, interval: float,
                 stop: threading.Event | None = None
                 ) -> tuple[Counter, int, int]:
    """Shared sampler: returns (stack counts, #samples, #idle dropped)."""
    counts: Counter[str] = Counter()
    me = threading.get_ident()
    deadline = time.monotonic() + seconds
    n = idle = 0
    while time.monotonic() < deadline and (stop is None
                                           or not stop.is_set()):
        frames = sys._current_frames()
        for tid, frame in frames.items():
            if tid == me:
                continue
            if _is_idle_leaf(frame):
                idle += 1
                continue
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            counts[";".join(reversed(stack))] += 1
        n += 1
        time.sleep(interval)
    return counts, n, idle


def _format_report(counts: Counter, samples: int, idle: int,
                   interval: float) -> str:
    lines = [f"# cpu profile (wall-clock sampler, idle leaves dropped): "
             f"{samples} samples, {idle} idle stacks dropped "
             f"@ {interval * 1000:g}ms"]
    for stack, c in counts.most_common():
        lines.append(f"{stack} {c}")
    return "\n".join(lines) + "\n"


def sample_profile(seconds: float, interval: float = 0.005) -> str:
    """Sample all thread stacks for ``seconds``; return collapsed-stack
    counts sorted by weight (the pprof-profile equivalent)."""
    counts, n, idle = _sample_loop(seconds, interval)
    return _format_report(counts, n, idle, interval)


def thread_dump() -> str:
    """Stack trace of every live thread (the pprof-goroutine
    equivalent)."""
    frames = sys._current_frames()
    lines = []
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        daemon = " daemon" if t.daemon else ""
        lines.append(f"thread {t.name} (id {t.ident}{daemon}):")
        if frame is not None:
            lines.extend(line.rstrip() for line in
                         traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


class CPUProfiler:
    """Background sampler for the ``--profile.cpu`` server flag: starts
    on open, writes the collapsed-stack report at stop (or after
    ``duration`` seconds, whichever comes first)."""

    def __init__(self, path: str, duration: float = 30.0,
                 interval: float = 0.005):
        self.path = path
        self.duration = duration
        self.interval = interval
        self._counts: Counter[str] = Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="cpu-profiler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        self._counts, self._samples, idle = _sample_loop(
            self.duration, self.interval, stop=self._stop)
        with open(self.path, "w") as f:
            f.write(_format_report(self._counts, self._samples, idle,
                                   self.interval))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

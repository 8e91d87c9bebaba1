"""What the server's process does with its time around the window, for
the notes on standard error: its CPU seconds and page faults and the
machine's stolen CPU each second, the Python
garbage collector's pauses by generation, and the CPU of each of its
threads between two marks. Reads ``/proc`` and ``gc`` only; none of it
enters a metric.
"""

from __future__ import annotations

import gc
import os
import resource
import threading
import time

TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def cpu_s() -> float:
    """This process's user and system CPU seconds."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def steal_s() -> float:
    """CPU seconds the machine's hypervisor gave to others, summed over
    its CPUs (``/proc/stat``; 0 where it is not counted)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / TICK
    except (OSError, IndexError, ValueError):
        return 0.0


class GcClock:
    """Seconds the collector paused the process, by generation, since
    ``start``."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.counts = [0, 0, 0]
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = int(info.get("generation", 0))
            self.seconds[g] += time.perf_counter() - self._t
            self.counts[g] += 1
            self._t = None

    def start(self) -> None:
        gc.callbacks.append(self._cb)

    def stop(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def snapshot(self) -> tuple:
        return tuple(self.seconds), tuple(self.counts)


def threads_cpu() -> dict:
    """{thread name: CPU seconds} of every thread of this process; a
    Python thread by its name, any other by its ``comm``."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    out: dict = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/self/task/{tid}/comm") as f:
                comm = f.read().strip()
        except OSError:
            continue
        name = names.get(int(tid), comm)
        # utime and stime are fields 14 and 15 of stat; after the
        # command's ")" they are the 12th and 13th.
        s = (int(fields[11]) + int(fields[12])) / TICK
        out[name] = out.get(name, 0.0) + s
    return out


def thread_delta(a: dict, b: dict, top: int = 6) -> list:
    """The ``top`` threads by CPU seconds between two readings."""
    d = {k: v - a.get(k, 0.0) for k, v in b.items()}
    return [[k, round(v, 2)] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:top] if v > 0]


class EachSecond:
    """A daemon thread that reads this process's resource use once a
    second between ``start`` and ``stop``."""

    NAMES = ("user_s", "sys_s", "minflt", "steal_s")

    def __init__(self):
        self.samples: list = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="perfbench-cpu",
                                   daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            ru = resource.getrusage(resource.RUSAGE_SELF)
            self.samples.append((time.monotonic(), ru.ru_utime, ru.ru_stime,
                                 ru.ru_minflt, steal_s()))
            self._stop.wait(1.0)

    def start(self) -> None:
        self._t.start()

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=5)

    def by_bucket(self, t0: float, t1: float, width: float) -> dict:
        """User and system CPU seconds, minor page faults and the
        machine's stolen CPU seconds in each ``width`` bucket of
        [t0, t1), from the samples nearest its ends."""
        out = {n: [] for n in self.NAMES}
        k = t0
        while k < t1 - 1e-9 and self.samples:
            a = min(self.samples, key=lambda u: abs(u[0] - k))
            b = min(self.samples, key=lambda u: abs(u[0] - min(k + width, t1)))
            for i, n in enumerate(self.NAMES):
                v = b[i + 1] - a[i + 1]
                out[n].append(round(v, 2) if isinstance(v, float) else v)
            k += width
        return out

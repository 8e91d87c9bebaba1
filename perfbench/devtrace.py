"""The device trace of a stretch of the traced window: ``torch.profiler``
over CPU and CUDA, its Chrome trace read back.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. From them: the busy seconds (the union of their
intervals), each operation's summed seconds by name, and the idle gaps
between them, each named by the host operation that overlaps it most
(``python`` where no recorded operation does) and by the device
operation it follows.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 96


def _profiler():
    import torch
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def prime() -> None:
    """Start and stop a profiler once, in set-up, so that the tracer's
    own start-up is not paid inside the window."""
    with _profiler():
        pass


class Stretch:
    """Start with ``start()``, end with ``stop(path)``; ``stop`` returns
    the summary."""

    def __init__(self):
        self._prof = _profiler()
        self.t_start = self.t_stop = None

    def start(self) -> None:
        self._prof.__enter__()
        self.t_start = time.monotonic()

    def stop(self, path: str) -> dict:
        self.t_stop = time.monotonic()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        out = summarize(events, self.t_stop - self.t_start)
        out["t_start"], out["t_stop"] = self.t_start, self.t_stop
        return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(events: list, window_s: float) -> dict:
    """busy_s, window_s, per-name device seconds and the breakdown of
    a Chrome trace's events (times in microseconds)."""
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?"))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda x: x[0])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "?"))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cpu_op"),
                  key=lambda x: x[0])
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    last_name = None
    for s, e, name in dev:
        if cur_e is None:
            cur_s, cur_e, last_name = s, e, name
            continue
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s, last_name))
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
        if e >= cur_e:
            last_name = name
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for gs, ge, after in gaps[:TOP]:
        what = _host_during(host, gs, ge)
        idle.append([_short(f"host {what} after {after}"), (ge - gs) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "device_s": by_name,
            "breakdown": {"device_ops": [[_short(k), v] for k, v in ops[:TOP]],
                          "idle_gaps": idle}}


def _host_during(host: list, s: float, e: float) -> str:
    """The host operation that overlaps [s, e] most."""
    best, best_o = "python", 0.0
    for hs, he, name in host:
        if hs >= e:
            break
        o = min(he, e) - max(hs, s)
        if o > best_o:
            best, best_o = name, o
    return best

"""Stats clients (reference stats.go): a minimal metrics abstraction with
tag-scoped children, a no-op default, an expvar-style in-process collector
(surfaced at /debug/vars by the HTTP layer), and a fan-out multiplexer.

A copy of the JAX package's ``utils/stats.py``."""

from __future__ import annotations

import threading
from typing import Iterable, Optional


class StatsClient:
    """Interface (reference stats.go:33-54)."""

    def with_tags(self, *tags: str) -> "StatsClient":
        return self

    def count(self, name: str, value: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def histogram(self, name: str, value: float) -> None:
        pass

    def set(self, name: str, value: str) -> None:
        pass

    def timing(self, name: str, value_ns: float) -> None:
        pass


class NopStatsClient(StatsClient):
    pass


NOP = NopStatsClient()


class ExpvarStatsClient(StatsClient):
    """In-process counters keyed by tag-qualified names; JSON-able for
    /debug/vars (reference stats.go:70-130)."""

    def __init__(self, _root: Optional[dict] = None,
                 _prefix: str = "", _lock=None):
        self._root = _root if _root is not None else {}
        self._prefix = _prefix
        self._lock = _lock or threading.Lock()

    def with_tags(self, *tags: str) -> "ExpvarStatsClient":
        prefix = ",".join(filter(None, [self._prefix, *sorted(tags)]))
        return ExpvarStatsClient(self._root, prefix, self._lock)

    def _key(self, name: str) -> str:
        return f"{self._prefix}.{name}" if self._prefix else name

    def count(self, name: str, value: int = 1) -> None:
        with self._lock:
            k = self._key(name)
            self._root[k] = self._root.get(k, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._root[self._key(name)] = value

    def histogram(self, name: str, value: float) -> None:
        # Aggregate count/sum/min/max/last per key: the old
        # last-write-wins gauge meant /debug/vars showed whichever
        # sample landed last, not a distribution — a 10 s outlier in a
        # thousand 1 ms timings was invisible (or was ALL you saw).
        with self._lock:
            k = self._key(name)
            cur = self._root.get(k)
            if not isinstance(cur, dict) or "count" not in cur:
                cur = self._root[k] = {"count": 0, "sum": 0.0,
                                       "min": value, "max": value,
                                       "last": value}
            cur["count"] += 1
            cur["sum"] += value
            if value < cur["min"]:
                cur["min"] = value
            if value > cur["max"]:
                cur["max"] = value
            cur["last"] = value

    def set(self, name: str, value: str) -> None:
        with self._lock:
            self._root[self._key(name)] = value

    def timing(self, name: str, value_ns: float) -> None:
        self.histogram(name, value_ns)

    def snapshot(self) -> dict:
        with self._lock:
            # Histogram entries are mutable dicts: copy them so a
            # caller's snapshot can't tear against live updates.
            return {k: dict(v) if isinstance(v, dict) else v
                    for k, v in self._root.items()}


class MultiStatsClient(StatsClient):
    """Fan-out to several clients (reference stats.go:133-185)."""

    def __init__(self, clients: Iterable[StatsClient]):
        self._clients = list(clients)

    def with_tags(self, *tags: str) -> "MultiStatsClient":
        return MultiStatsClient(c.with_tags(*tags) for c in self._clients)

    def count(self, name: str, value: int = 1) -> None:
        for c in self._clients:
            c.count(name, value)

    def gauge(self, name: str, value: float) -> None:
        for c in self._clients:
            c.gauge(name, value)

    def histogram(self, name: str, value: float) -> None:
        for c in self._clients:
            c.histogram(name, value)

    def set(self, name: str, value: str) -> None:
        for c in self._clients:
            c.set(name, value)

    def timing(self, name: str, value_ns: float) -> None:
        for c in self._clients:
            c.timing(name, value_ns)

    def snapshot(self) -> dict:
        """Merged snapshot of every child that has one (the expvar
        child, behind /debug/vars) — composing the registry bridge in
        must not silently blank the expvar page."""
        out: dict = {}
        for c in self._clients:
            snap = getattr(c, "snapshot", None)
            if callable(snap):
                out.update(snap())
        return out

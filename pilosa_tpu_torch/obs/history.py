"""On-disk metric history: bounded multi-resolution rings over the
whole registry — the Monarch leaf store in miniature.

Every observability surface before this PR was point-in-time:
``/metrics`` is a snapshot and the only retained signals are kept
traces and blackbox snapshots, so "what did p99 look like in the ten
minutes before the watchdog tripped" was unanswerable. This module
keeps recent high-resolution history AT THE LEAF (the Monarch /
Dapper-lineage split: aggregate at query time, don't ship everything
to a central store):

- On the runtime-collector cadence, ``sample()`` walks every family in
  the metrics registry and appends one point per series into bounded
  rings at three resolutions (default 10 s × 1 h, 1 m × 12 h,
  15 m × 7 d). **Counters are stored as per-second rates** (the delta
  between ticks), gauges as values, and histograms as derived quantile
  series — ``<name>:p50`` / ``<name>:p99`` (interpolation-free bucket
  upper bounds over the tick's bucket deltas) plus ``<name>:rate``
  (observations/s).
- Coarser rings aggregate the base ring on the fly (bucket means), so
  a 7-day question costs 672 points, not 60 480.
- Every tick persists crash-safe to ``<data>/history/res<N>/`` through
  the PR-10 ``obs.diskring`` segment/crc discipline: a SIGKILL mid-
  append tears at most the unflushed tail of one segment, reopen
  skips exactly the torn record and serves everything else (the
  ``ring.write`` failpoint tears the history write site too — the
  chaos tests drive it).
- ``GET /debug/metrics/history?family=&label=&window=&step=`` serves
  the rings as JSON series; ``?scope=cluster`` federates the same
  question across the fleet (obs.federate).

Bounded by construction: per-series ring capacity is fixed, the series
count is capped (new series past the cap are dropped and counted), and
disk is the segment rings' budget — whatever the write rate.

Copy of the JAX package's ``obs/history.py``.
"""

from __future__ import annotations

import json
import threading
import time
from array import array
from typing import Optional

from . import metrics as obs_metrics
from .diskring import SegmentRing

# (step_seconds, ring_capacity): 10s x 1h, 1m x 12h, 15m x 7d.
DEFAULT_RESOLUTIONS = ((10.0, 360), (60.0, 720), (900.0, 672))
DEFAULT_MAX_SERIES = 4096
# Disk budget per resolution ring (segment_bytes, max_segments).
DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_MAX_SEGMENTS = 8

_EPS = 1e-12


def series_key(name: str, labels: dict) -> str:
    """Stable series identity: name + compact-JSON sorted label pairs
    (JSON so hostile label values can never collide or split a key)."""
    if not labels:
        return name
    return name + "|" + json.dumps(sorted(labels.items()),
                                   separators=(",", ":"))


def split_key(key: str) -> tuple[str, dict]:
    name, sep, raw = key.partition("|")
    if not sep:
        return name, {}
    try:
        return name, dict(json.loads(raw))
    except ValueError:
        return name, {}


class _Ring:
    """Fixed-capacity circular buffer of (ts, value) as two packed
    float arrays — ~16 bytes per point instead of a tuple's ~100."""

    __slots__ = ("cap", "ts", "v", "head", "count")

    def __init__(self, cap: int):
        self.cap = max(2, int(cap))
        self.ts = array("d", bytes(8 * self.cap))
        self.v = array("d", bytes(8 * self.cap))
        self.head = 0   # next write slot
        self.count = 0

    def append(self, ts: float, v: float) -> None:
        self.ts[self.head] = ts
        self.v[self.head] = v
        self.head = (self.head + 1) % self.cap
        if self.count < self.cap:
            self.count += 1

    def points(self, since: float = 0.0) -> list[tuple[float, float]]:
        """Chronological (ts, value) pairs with ts >= since."""
        out = []
        start = (self.head - self.count) % self.cap
        for i in range(self.count):
            j = (start + i) % self.cap
            t = self.ts[j]
            if t >= since:
                out.append((t, self.v[j]))
        return out

    def last_ts(self) -> float:
        if not self.count:
            return 0.0
        return self.ts[(self.head - 1) % self.cap]


class _Series:
    """One series' rings across every resolution plus the coarse
    aggregation accumulators (bucket mean)."""

    __slots__ = ("rings", "acc")

    def __init__(self, resolutions):
        self.rings = [_Ring(cap) for _step, cap in resolutions]
        # Per coarse resolution: [bucket_start, sum, count].
        self.acc = [[0.0, 0.0, 0] for _ in resolutions[1:]]


class MetricHistory:
    """The embedded RRD-style store (module docstring). Thread-safe;
    every disk error degrades to in-memory-only (diskring contract)."""

    def __init__(self, dir: Optional[str] = None,
                 resolutions=DEFAULT_RESOLUTIONS,
                 max_series: int = DEFAULT_MAX_SERIES,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segments: int = DEFAULT_MAX_SEGMENTS,
                 registry=None):
        self.resolutions = tuple((float(s), int(c))
                                 for s, c in resolutions)
        self.max_series = max(16, int(max_series))
        self.registry = registry or obs_metrics.default_registry()
        self._mu = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._prev: dict[str, tuple] = {}   # counter/histogram deltas
        self._last_sample = 0.0
        self.samples = 0
        self.dropped_series = 0
        self.disk: list[Optional[SegmentRing]] = [None] * len(
            self.resolutions)
        if dir:
            import os
            for i in range(len(self.resolutions)):
                self.disk[i] = SegmentRing(
                    os.path.join(dir, f"res{i}"),
                    segment_bytes=segment_bytes,
                    max_segments=max_segments)
            self._replay()

    # -- persistence ----------------------------------------------------------

    def _replay(self) -> None:
        """Rebuild the rings from the disk records (oldest first).
        A torn tail costs at most the unflushed records of one
        segment — everything else serves (diskring's scan contract)."""
        with self._mu:
            for i, ring in enumerate(self.disk):
                if ring is None:
                    continue
                for rec in ring.scan(newest_first=False):
                    try:
                        ts = float(rec["t"])
                        samples = rec["s"]
                    except (KeyError, TypeError, ValueError):
                        continue
                    if not isinstance(samples, dict):
                        continue
                    for key, v in samples.items():
                        s = self._series_for_locked(key)
                        if s is None:
                            continue
                        try:
                            if isinstance(v, (list, tuple)):
                                # Coarse form: [bucket_start, value]
                                # — the ring timestamp is the BUCKET,
                                # not the flush tick, so replayed
                                # points line up with live flushes.
                                s.rings[i].append(float(v[0]),
                                                  float(v[1]))
                            else:
                                s.rings[i].append(ts, float(v))
                        except (TypeError, ValueError, IndexError):
                            continue

    def _persist(self, res_idx: int, ts: float,
                 samples: dict) -> None:
        ring = self.disk[res_idx]
        if ring is None or not samples:
            return
        ok = ring.append({"t": round(ts, 3), "s": samples})
        obs_metrics.HISTORY_DISK_RECORDS.labels(
            "written" if ok else "dropped").inc()

    def close(self) -> None:
        for ring in self.disk:
            if ring is not None:
                ring.close()

    # -- sampling -------------------------------------------------------------

    def _series_for_locked(self, key: str) -> Optional[_Series]:
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                obs_metrics.HISTORY_SERIES_DROPPED.inc()
                return None
            s = self._series[key] = _Series(self.resolutions)
        return s

    def sample(self, now: Optional[float] = None) -> int:
        """One sampling pass over the whole registry; returns the
        number of points recorded. Re-entrant calls inside half a base
        step are ignored (the collector's on-demand /status path must
        not double-sample a tick)."""
        now = time.time() if now is None else float(now)
        base_step = self.resolutions[0][0]
        with self._mu:
            if now - self._last_sample < 0.45 * base_step:
                return 0
            self._last_sample = now
            points = self._collect_locked(now)
            base: dict[str, float] = {}
            # Coarse flushes persist as [bucket_start, mean] pairs:
            # each series' flushed bucket can differ (series that
            # skip ticks lag), so the record-level tick time cannot
            # stamp them — the bucket start must ride per key.
            coarse: list[dict[str, list]] = [
                {} for _ in self.resolutions[1:]]
            for key, v in points.items():
                s = self._series_for_locked(key)
                if s is None:
                    continue
                s.rings[0].append(now, v)
                base[key] = round(v, 6)
                # Roll into the coarser buckets; flush on boundary.
                for ci, (step, _cap) in enumerate(
                        self.resolutions[1:]):
                    acc = s.acc[ci]
                    bucket = now - (now % step)
                    if acc[2] and acc[0] != bucket:
                        mean = acc[1] / acc[2]
                        s.rings[ci + 1].append(acc[0], mean)
                        coarse[ci][key] = [round(acc[0], 3),
                                           round(mean, 6)]
                        acc[0], acc[1], acc[2] = bucket, 0.0, 0
                    elif not acc[2]:
                        acc[0] = bucket
                    acc[1] += v
                    acc[2] += 1
            self.samples += 1
        obs_metrics.HISTORY_SAMPLES.inc()
        obs_metrics.HISTORY_SERIES_LIVE.set(len(self._series))
        self._persist(0, now, base)
        for ci, flushed in enumerate(coarse):
            self._persist(ci + 1, now, flushed)
        return len(points)

    def _collect_locked(self, now: float) -> dict[str, float]:
        """The registry → {series key: value} for this tick (counters
        as rates, histograms as quantile/rate summaries)."""
        out: dict[str, float] = {}
        for name, fam in self.registry.families().items():
            try:
                if fam.type == "counter":
                    for labels, child in fam._label_dicts():
                        key = series_key(name, labels)
                        v = float(child.value)
                        pts = self._prev.get(key)
                        self._prev[key] = (now, v)
                        if pts is None:
                            continue
                        pt, pv = pts
                        dt = now - pt
                        if dt <= 0 or v < pv:  # reset → skip the tick
                            continue
                        out[key] = (v - pv) / dt
                elif fam.type == "gauge":
                    for labels, child in fam._label_dicts():
                        out[series_key(name, labels)] = float(
                            child.value)
                elif fam.type == "histogram":
                    for labels, child in fam._label_dicts():
                        key = series_key(name, labels)
                        counts, total, n = child.snapshot()
                        prev = self._prev.get(key)
                        self._prev[key] = (now, counts, total, n)
                        if prev is None:
                            continue
                        pt, pc, ptotal, pn = prev
                        dt = now - pt
                        dn = n - pn
                        if dt <= 0 or dn < 0:
                            continue
                        out[series_key(f"{name}:rate", labels)] = \
                            dn / dt
                        if dn == 0:
                            continue
                        deltas = [c - p for c, p in zip(counts, pc)]
                        bounds = fam.buckets
                        for q, suffix in ((0.5, ":p50"),
                                          (0.99, ":p99")):
                            want = dn * q
                            cum = 0
                            est = bounds[-1]
                            for i, d in enumerate(deltas[:-1]):
                                cum += d
                                if cum >= want:
                                    est = bounds[i]
                                    break
                            out[series_key(name + suffix,
                                           labels)] = est
            except Exception:  # noqa: BLE001 - sampling must not raise
                continue
        return out

    # -- querying -------------------------------------------------------------

    def _pick_resolution(self, window_s: float, step_s: float) -> int:
        """Finest resolution whose step honors the caller's step hint
        and whose ring span covers the window."""
        idx = 0
        for i, (step, _cap) in enumerate(self.resolutions):
            if step_s >= step:
                idx = i
        while idx < len(self.resolutions) - 1:
            step, cap = self.resolutions[idx]
            if window_s <= step * cap:
                break
            idx += 1
        return idx

    def series(self, family: str = "", label_filter: Optional[dict]
               = None, window_s: float = 3600.0,
               step_s: float = 0.0,
               now: Optional[float] = None) -> dict:
        """The query face of the store: every series whose name is
        ``family`` or a derived ``family:<q>`` form, label-filtered,
        over the trailing window at the chosen resolution."""
        now = time.time() if now is None else float(now)
        window_s = max(float(window_s), self.resolutions[0][0])
        idx = self._pick_resolution(window_s, float(step_s))
        since = now - window_s
        out = []
        with self._mu:
            for key, s in self._series.items():
                name, labels = split_key(key)
                if family and not (name == family or name.startswith(
                        family + ":")):
                    continue
                if label_filter and any(
                        labels.get(k) != v
                        for k, v in label_filter.items()):
                    continue
                pts = s.rings[idx].points(since)
                if not pts:
                    continue
                out.append({"name": name, "labels": labels,
                            "points": [[round(t, 3), round(v, 6)]
                                       for t, v in pts]})
        out.sort(key=lambda e: (e["name"], sorted(e["labels"].items())))
        return {"family": family, "windowS": window_s,
                "stepS": self.resolutions[idx][0],
                "resolution": idx, "series": out}

    def latest(self, name: str, labels: Optional[dict] = None
               ) -> Optional[float]:
        """Newest point of one exact series (the sentinel's cheap
        probe); None when the series doesn't exist or is empty."""
        key = series_key(name, labels or {})
        with self._mu:
            s = self._series.get(key)
            if s is None or not s.rings[0].count:
                return None
            return s.rings[0].v[(s.rings[0].head - 1) % s.rings[0].cap]

    def window_values(self, key: str, start: float, end: float
                      ) -> list[float]:
        """Base-ring values of one series key in [start, end) — the
        sentinel's window extraction."""
        with self._mu:
            s = self._series.get(key)
            if s is None:
                return []
            return [v for t, v in s.rings[0].points(start) if t < end]

    def keys(self, family: str = "") -> list[str]:
        with self._mu:
            return [k for k in self._series
                    if not family or split_key(k)[0] == family
                    or split_key(k)[0].startswith(family + ":")]

    def stats(self) -> dict:
        with self._mu:
            n = len(self._series)
        return {"series": n, "samples": self.samples,
                "droppedSeries": self.dropped_series,
                "resolutions": [{"stepS": s, "points": c}
                                for s, c in self.resolutions],
                "disk": [r.stats() for r in self.disk
                         if r is not None]}

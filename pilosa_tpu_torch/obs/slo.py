"""SLO health: rolling latency-objective burn rates + readiness.

Three pieces, all computed from observability state the metrics
registry already collects:

- **SLOTracker** — rolling burn rates over the existing query-latency
  histogram (obs.metrics.QUERY_SECONDS). The objective is "fraction
  ``target`` of queries complete within ``objective_s``"; the burn
  rate is the classic multi-window ratio: (observed bad fraction) /
  (allowed bad fraction). 1.0 means the error budget burns exactly at
  the sustainable rate; 10x means it is gone in a tenth of the window.
  Sampled by the runtime collector's cadence; published as
  ``pilosa_slo_burn_rate_ratio{window=...}`` and in ``/status``.
- **Exemplars** — the latency histograms carry OpenMetrics exemplars
  (the trace/query id of a recent observation per bucket), rendered at
  /metrics when the scraper negotiates the OpenMetrics content type —
  the pivot from "p99 got worse" to "here is a trace id to open".
  (The mechanics live in obs.metrics; the handler records them.)
- **HealthChecker** — a real READINESS probe for ``GET /health``,
  distinct from liveness (/version answers as long as the process
  serves): holder open, gossip converged, admission not saturated,
  data directory writable. Load balancers should route on this.

Copy of the JAX package's ``obs/slo.py``.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Optional

from . import metrics as obs_metrics

# Rolling windows (seconds) the burn rate is computed over — the
# standard fast/slow pair: the short window catches an active incident,
# the long one catches slow budget bleed.
DEFAULT_WINDOWS = ((300, "5m"), (3600, "1h"))

DEFAULT_OBJECTIVE_S = 0.25
DEFAULT_TARGET = 0.99


class SLOTracker:
    """Rolling latency-objective accounting over a latency histogram.

    Keeps a bounded ring of (ts, good, total) cumulative snapshots of
    the histogram family; a burn rate over a window is computed from
    the delta between now and the oldest snapshot inside the window —
    no per-request work at all (the histogram observe the handler
    already does is the only hot-path cost).
    """

    def __init__(self, histogram: Optional[obs_metrics.Histogram] = None,
                 objective_s: float = DEFAULT_OBJECTIVE_S,
                 target: float = DEFAULT_TARGET,
                 windows=DEFAULT_WINDOWS):
        self.histogram = histogram or obs_metrics.QUERY_SECONDS
        self.objective_s = float(objective_s)
        self.target = min(max(float(target), 0.0), 0.999999)
        self.windows = tuple(windows)
        # The histogram's buckets are fixed at family creation; the
        # objective maps to the smallest bucket bound >= objective (an
        # upper bound on "good" — documented, deterministic).
        bounds = self.histogram.buckets
        i = bisect_left(bounds, self.objective_s)
        self._good_le = bounds[i] if i < len(bounds) else None
        self._mu = threading.Lock()
        # ring spans the longest window at the collector cadence; 1024
        # entries at 10 s/sample covers ~2.8 h. Seeded with the counts
        # at construction so the first window has a baseline (a server
        # constructs its tracker before serving traffic).
        self._ring: deque[tuple[float, int, int]] = deque(maxlen=1024)
        good0, total0 = self._counts()
        self._ring.append((time.time(), good0, total0))
        obs_metrics.SLO_OBJECTIVE.set(self.objective_s)

    # -- sampling ------------------------------------------------------------

    def _counts(self) -> tuple[int, int]:
        """(good, total) cumulative over every label child of the
        histogram family."""
        good = total = 0
        for _labels, child in self.histogram._label_dicts():
            counts, _sum, n = child.snapshot()
            total += n
            if self._good_le is None:
                good += n
                continue
            cum = 0
            for bound, c in zip(self.histogram.buckets, counts):
                cum += c
                if bound == self._good_le:
                    break
            good += cum
        return good, total

    def record(self) -> dict:
        """One sampling pass (runtime-collector cadence): append a
        snapshot, update the burn-rate gauges, return the /status
        block."""
        good, total = self._counts()
        now = time.time()
        with self._mu:
            ring = list(self._ring)
            self._ring.append((now, good, total))
        out = {
            "objectiveS": self.objective_s,
            "target": self.target,
            "goodTotal": good,
            "requestsTotal": total,
            "burnRates": {},
        }
        budget = 1.0 - self.target
        for window_s, label in self.windows:
            # Baseline: the newest prior snapshot at or beyond the
            # window's far edge; when none is that old yet, the oldest
            # one we have (the window is effectively shorter until it
            # fills — correct at startup).
            base = ring[0] if ring else (now, good, total)
            for ts, g, t in ring:
                if ts <= now - window_s:
                    base = (ts, g, t)
                else:
                    break
            d_total = total - base[2]
            d_bad = (total - good) - (base[2] - base[1])
            if d_total <= 0:
                burn = 0.0
            else:
                burn = (d_bad / d_total) / budget
            out["burnRates"][label] = round(burn, 4)
            obs_metrics.SLO_BURN_RATE.labels(label).set(round(burn, 4))
        return out


class TenantSLOTracker:
    """Per-tenant burn rates over the tenant-labeled latency histogram
    (``pilosa_tenant_query_duration_seconds``) — the SLOTracker
    machinery applied per label child, so "the quiet tenant's burn
    stays below threshold while an aggressor sheds" is a measurable,
    alertable statement (published as
    ``pilosa_tenant_slo_burn_rate_ratio{tenant,window}``, /status,
    /debug/tenants). Same zero-hot-path-cost contract: the handler's
    one histogram observe is the only per-request work; burn math
    runs at the runtime collector's cadence."""

    def __init__(self, histogram: Optional[obs_metrics.Histogram] = None,
                 objective_s: float = DEFAULT_OBJECTIVE_S,
                 target: float = DEFAULT_TARGET,
                 windows=DEFAULT_WINDOWS):
        self.histogram = histogram or obs_metrics.TENANT_QUERY_SECONDS
        self.objective_s = float(objective_s)
        self.target = min(max(float(target), 0.0), 0.999999)
        self.windows = tuple(windows)
        bounds = self.histogram.buckets
        i = bisect_left(bounds, self.objective_s)
        self._good_le = bounds[i] if i < len(bounds) else None
        self._mu = threading.Lock()
        # tenant -> ring of (ts, good, total); rings appear lazily as
        # tenants first serve traffic, seeded at the TRACKER's start
        # with zero counts — the tracker is built before serving, so
        # a newly-appearing tenant's whole count history genuinely
        # accumulated after this stamp and lands inside the window.
        self._t0 = time.time()
        self._rings: dict[str, deque] = {}
        self._last: dict[str, dict] = {}

    def _counts(self) -> dict[str, tuple[int, int]]:
        out: dict[str, tuple[int, int]] = {}
        for labels, child in self.histogram._label_dicts():
            tenant = labels.get("tenant", "")
            counts, _sum, n = child.snapshot()
            if self._good_le is None:
                good = n
            else:
                good = 0
                for bound, c in zip(self.histogram.buckets, counts):
                    good += c
                    if bound == self._good_le:
                        break
            prev = out.get(tenant, (0, 0))
            out[tenant] = (prev[0] + good, prev[1] + n)
        return out

    def record(self) -> dict:
        """One sampling pass: per-tenant burn rates per window, gauges
        updated, /status + /debug/tenants block returned."""
        now = time.time()
        budget = 1.0 - self.target
        out: dict[str, dict] = {}
        for tenant, (good, total) in self._counts().items():
            with self._mu:
                ring = self._rings.get(tenant)
                if ring is None:
                    ring = self._rings[tenant] = deque(maxlen=1024)
                    ring.append((self._t0, 0, 0))
                snaps = list(ring)
                ring.append((now, good, total))
            burns = {}
            for window_s, label in self.windows:
                base = snaps[0] if snaps else (now, good, total)
                for ts, g, t in snaps:
                    if ts <= now - window_s:
                        base = (ts, g, t)
                    else:
                        break
                d_total = total - base[2]
                d_bad = (total - good) - (base[2] - base[1])
                burn = 0.0 if d_total <= 0 else \
                    (d_bad / d_total) / budget
                burns[label] = round(burn, 4)
                obs_metrics.TENANT_SLO_BURN.labels(tenant, label).set(
                    round(burn, 4))
            out[tenant] = {"requestsTotal": total,
                           "goodTotal": good,
                           "burnRates": burns}
        with self._mu:
            self._last = out
        return out

    def last(self) -> dict:
        """The most recent record() pass (for /debug/tenants — no
        recompute on the request path)."""
        with self._mu:
            return dict(self._last)


class HealthChecker:
    """Readiness checks behind ``GET /health`` — every check is cheap
    (the disk probe is throttled) so a load balancer can poll at 1 Hz
    without showing up in the profiles."""

    DISK_PROBE_INTERVAL_S = 5.0

    def __init__(self, holder=None, cluster=None, admission=None,
                 host: str = ""):
        self.holder = holder
        self.cluster = cluster
        self.admission = admission
        self.host = host
        self._disk_mu = threading.Lock()
        self._disk_last = 0.0
        self._disk_ok = True
        self._disk_err = ""

    def check(self) -> tuple[bool, dict]:
        """(ready, checks) — ready only when every check passes."""
        checks: dict[str, dict] = {}

        holder = self.holder
        if holder is None:
            checks["holder"] = {"ok": False, "detail": "no holder"}
        else:
            # Holder.open() creates the data dir and sets .path; a
            # closed/never-opened holder has no usable directory.
            path = getattr(holder, "path", "") or ""
            ok = bool(path) and os.path.isdir(path)
            checks["holder"] = {"ok": ok,
                                "detail": path or "not open"}

        if (self.cluster is not None and len(self.cluster.nodes) > 1
                and getattr(self.cluster, "node_set", None)
                is not None):
            try:
                states = self.cluster.node_states()
            except Exception as e:  # noqa: BLE001 - membership mid-close
                states = {}
                checks["gossip"] = {"ok": False, "detail": str(e)[:120]}
            if "gossip" not in checks:
                down = sorted(h for h, s in states.items() if s != "UP")
                checks["gossip"] = {
                    "ok": not down,
                    "detail": (f"down: {','.join(down)}" if down
                               else f"{len(states)} nodes UP")}
        elif self.cluster is not None and len(self.cluster.nodes) > 1:
            # Static/HTTP membership has no failure detector —
            # node_states() would report every peer DOWN and a load
            # balancer routing on /health would drain a healthy
            # cluster. Convergence simply isn't observable here.
            checks["gossip"] = {
                "ok": True,
                "detail": "static membership (no failure detector)"}
        else:
            checks["gossip"] = {"ok": True, "detail": "single node"}

        if self.admission is not None:
            snap = self.admission.snapshot()
            queued = sum((snap.get("queued") or {}).values())
            depth = snap.get("queueDepth", 0) or 1
            # Saturated = the queue is full (the next arrival would be
            # rejected); a busy-but-absorbing queue stays ready.
            ok = queued < depth
            checks["admission"] = {
                "ok": ok,
                "detail": f"queued={queued}/{depth}"
                          f" inFlight={snap.get('inFlight', 0)}"}
        else:
            checks["admission"] = {"ok": True, "detail": "unlimited"}

        checks["disk"] = self._check_disk()

        # Storage integrity (storage.integrity): quarantined fragments
        # are a degraded-but-serving condition when replicas exist
        # (reads fail over while the repairer re-streams); with no
        # peers to fail over to, the touched slices genuinely cannot
        # answer, so readiness reflects it.
        q = (getattr(self.holder, "quarantine", None)
             if self.holder is not None else None)
        if q is not None:
            n = len(q)
            # Failover needs a REPLICA of the quarantined data, not
            # just another node: replica_n=1 means no copy exists
            # anywhere else regardless of cluster size.
            replicated = (self.cluster is not None
                          and len(self.cluster.nodes) > 1
                          and getattr(self.cluster, "replica_n", 1)
                          > 1)
            checks["storage"] = {
                "ok": n == 0 or replicated,
                "detail": ("clean" if n == 0 else
                           f"{n} fragments quarantined"
                           + ("" if replicated
                              else " (no replica to fail over to)"))}

        # Disk-full degradation (fault.diskfull): while ENOSPC holds
        # the node write-unready, /health SAYS so — but the node is
        # not "down": reads keep serving, so the block carries its
        # own key instead of failing the disk probe (which may well
        # still succeed for tiny probe files on a nearly-full disk).
        from ..fault import diskfull as _diskfull
        wr = _diskfull.write_ready()
        checks["writeReady"] = {
            "ok": wr,
            "detail": ("writes accepted" if wr else
                       "write-unready after ENOSPC (writes answer"
                       " 507, reads serving)")}

        ready = all(c["ok"] for c in checks.values())
        return ready, checks

    def _check_disk(self) -> dict:
        path = getattr(self.holder, "path", "") or "" \
            if self.holder is not None else ""
        if not path:
            return {"ok": False, "detail": "no data dir"}
        now = time.monotonic()
        with self._disk_mu:
            if now - self._disk_last < self.DISK_PROBE_INTERVAL_S:
                return {"ok": self._disk_ok,
                        "detail": self._disk_err or path}
            self._disk_last = now
        probe = os.path.join(path, ".health-probe")
        try:
            with open(probe, "w") as f:
                f.write(str(time.time()))
            os.remove(probe)
            ok, err = True, ""
        except OSError as e:
            ok, err = False, str(e)[:120]
        with self._disk_mu:
            self._disk_ok, self._disk_err = ok, err
        return {"ok": ok, "detail": err or path}

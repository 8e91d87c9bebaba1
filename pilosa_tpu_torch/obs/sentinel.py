"""Regression sentinel: the trajectory watcher that tells you the
perf cliff happened while it is still happening.

Copy of the JAX package's ``obs/sentinel.py``. The sentinel closes that loop on a
slow cadence against the live metric history (obs.history):

- **Robust-z rules**: for every watched series (by default the query
  latency ``:p50``/``:p99`` and ``:rate`` derivations per lane/call),
  compare the recent window's median against the trailing baseline
  window's median/MAD. ``z = (recent - median) / (1.4826 * MAD)``
  past the threshold AND a minimum effect ratio → a finding. MAD, not
  stddev — one old outlier must not widen the band until a real cliff
  hides inside it.
- **Manifest envelope rules**: a manifest of committed benchmark
  numbers, read only from ``[sentinel] manifest`` (this package ships
  none), defines what this build measured on this class of hardware;
  live medians sustained past ``manifest_tolerance`` × the committed
  number breach the envelope, whatever the local
  baseline drifted to (a slow regression that re-baselines itself
  every hour still trips this one).

A firing rule:

- increments ``pilosa_sentinel_findings_total{metric,direction}`` and
  raises ``pilosa_sentinel_findings_active{metric,direction}`` until
  the condition clears;
- force-keeps every in-flight trace with the new keep reason
  ``anomaly`` (the queries running THROUGH the cliff are the
  evidence);
- lands a blackbox snapshot whose record names the regressed metric —
  so a silent perf cliff self-documents: history shows the bend, the
  kept traces show the queries inside it, the blackbox shows the
  system state around it.

Per-metric re-fires are rate-limited (``retrip_s``); recovery clears
the active gauge on the next pass.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from . import metrics as obs_metrics
from .history import split_key

DEFAULT_INTERVAL_S = 30.0
DEFAULT_WINDOW_S = 120.0
DEFAULT_BASELINE_S = 3600.0
DEFAULT_ZSCORE = 6.0
DEFAULT_MIN_POINTS = 5
DEFAULT_MIN_RATIO = 1.5
DEFAULT_RETRIP_S = 300.0
DEFAULT_MANIFEST_TOLERANCE = 5.0

# Which history series the robust-z rules watch, and in which
# direction a finding fires: latency quantiles regress UP, rates
# cliff DOWN (a traffic collapse is as much an incident as a latency
# spike). The rule catalogue is documented in docs/OBSERVABILITY.md.
DEFAULT_WATCHES = (
    ("pilosa_query_duration_seconds:p99", "up"),
    ("pilosa_query_duration_seconds:p50", "up"),
    ("pilosa_query_duration_seconds:rate", "down"),
    ("pilosa_cluster_rpc_seconds:p99", "up"),
    ("pilosa_wal_group_commit_flush_seconds:p99", "up"),
    ("pilosa_import_stage_seconds:p99", "up"),
    # Per-tenant latency regression: one tenant's p99 bending while
    # the aggregate stays flat is exactly the noisy-neighbor signature
    # the multi-tenant isolation work exists to catch.
    ("pilosa_tenant_query_duration_seconds:p99", "up"),
)

# Per-tenant SLO-burn rule (absolute, not robust-z): a tenant whose
# recent-median burn rate sits past this is eating its error budget
# 10x faster than sustainable — the classic fast-burn page threshold.
# Series: pilosa_tenant_slo_burn_rate_ratio{tenant,window}.
DEFAULT_TENANT_BURN_FAMILY = "pilosa_tenant_slo_burn_rate_ratio"
DEFAULT_TENANT_BURN_THRESHOLD = 10.0

# Planner misestimation rule (absolute): the planner's per-node
# (actual+1)/(est+1) ratio distribution. A p99 sustained past this
# means the cardinality estimator is off by ~an order of magnitude on
# the tail — plans reorder/place on numbers that are wrong, so the
# finding points at the estimator (stale rank caches, skew past the
# sampler) before users notice the slow plans it picks.
DEFAULT_PLANNER_MISEST_FAMILY = \
    "pilosa_planner_misestimation_ratio:p99"
DEFAULT_PLANNER_MISEST_THRESHOLD = 8.0

# Manifest envelope rules: (manifest metrics key, live series name,
# unit scale manifest→seconds). Only the committed keys that map
# cleanly onto a live series ride the default catalogue; a missing
# key skips its rule (older manifests must not crash newer servers).
DEFAULT_MANIFEST_RULES = (
    ("latency_below_cap_p99", "pilosa_query_duration_seconds:p99",
     1e-3),
    ("latency_below_cap_p50", "pilosa_query_duration_seconds:p50",
     1e-3),
)


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_z(recent: list[float], baseline: list[float]
             ) -> tuple[float, float, float]:
    """(z, recent_median, baseline_median) via median/MAD. A flat
    baseline (MAD 0) falls back to a fraction of the median as the
    scale so a constant-then-jump series still yields a finite z."""
    rm = _median(recent)
    bm = _median(baseline)
    mad = _median([abs(v - bm) for v in baseline])
    scale = 1.4826 * mad
    if scale <= 0:
        scale = max(abs(bm) * 0.05, 1e-9)
    return (rm - bm) / scale, rm, bm


class Sentinel:
    """The slow-cadence evaluator (module docstring). ``history`` is
    the obs.history.MetricHistory to read; tracer/sampler/registry/
    blackbox are the evidence-capture hooks (same wiring shape as the
    watchdog)."""

    def __init__(self, history, registry=None, tracer=None,
                 sampler=None, blackbox=None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 window_s: float = DEFAULT_WINDOW_S,
                 baseline_s: float = DEFAULT_BASELINE_S,
                 zscore: float = DEFAULT_ZSCORE,
                 min_points: int = DEFAULT_MIN_POINTS,
                 min_ratio: float = DEFAULT_MIN_RATIO,
                 retrip_s: float = DEFAULT_RETRIP_S,
                 manifest_path: str = "",
                 manifest_tolerance: float = DEFAULT_MANIFEST_TOLERANCE,
                 watches=DEFAULT_WATCHES,
                 tenant_burn_threshold: float
                 = DEFAULT_TENANT_BURN_THRESHOLD,
                 planner_misest_threshold: float
                 = DEFAULT_PLANNER_MISEST_THRESHOLD, logger=None):
        from ..utils import logger as logger_mod
        self.history = history
        self.registry = registry    # sched.QueryRegistry
        self.tracer = tracer        # obs.trace.Tracer
        self.sampler = sampler      # obs.sampler.TailSampler
        self.blackbox = blackbox    # obs.blackbox.Blackbox
        self.interval_s = max(0.02, float(interval_s))
        self.window_s = float(window_s)
        self.baseline_s = float(baseline_s)
        self.zscore = float(zscore)
        self.min_points = max(2, int(min_points))
        self.min_ratio = max(1.0, float(min_ratio))
        self.retrip_s = float(retrip_s)
        self.manifest_path = manifest_path
        self.manifest_tolerance = float(manifest_tolerance)
        self.watches = tuple(watches)
        self.tenant_burn_threshold = float(tenant_burn_threshold)
        self.planner_misest_threshold = float(planner_misest_threshold)
        self.logger = logger or logger_mod.NOP
        self.findings: list[dict] = []   # newest last, bounded
        self.checks = 0
        self._mu = threading.Lock()
        self._last_fire: dict[str, float] = {}
        self._active: set[tuple[str, str]] = set()
        self._manifest: Optional[dict] = None
        self._manifest_mtime = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-sentinel",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop AND join: the server closes the blackbox/trace disk
        rings right after, and a sentinel thread still mid-check with
        a firing rule would reopen a stray segment past the close
        (the RuntimeCollector.stop discipline)."""
        self._stop.set()
        thread = self._thread
        if thread is not None \
                and thread is not threading.current_thread():
            thread.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the sentinel must not die
                pass

    # -- the manifest envelope -------------------------------------------------

    def _manifest_metrics(self) -> dict:
        """The committed metrics table, re-read when the file changes
        (bench passes rewrite it); {} when absent/broken."""
        path = self.manifest_path
        if not path:
            return {}
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return {}
        if self._manifest is None or mtime != self._manifest_mtime:
            try:
                with open(path) as f:
                    doc = json.load(f)
                self._manifest = doc.get("metrics", {}) or {}
                self._manifest_mtime = mtime
            except (OSError, ValueError):
                return self._manifest or {}
        return self._manifest or {}

    # -- evaluation ------------------------------------------------------------

    def check(self, now: Optional[float] = None) -> list[dict]:
        """One pass over every rule; fires (and returns) the findings
        raised this pass. Recovered conditions clear their active
        gauge."""
        now = time.time() if now is None else float(now)
        fired = []
        seen_active: set[tuple[str, str]] = set()
        for finding in self._evaluate(now):
            key = (finding["metric"], finding["direction"])
            seen_active.add(key)
            if self._fire(finding, now):
                fired.append(finding)
        with self._mu:
            recovered = self._active - seen_active
            self._active = seen_active
            self.checks += 1
        for metric, direction in recovered:
            obs_metrics.SENTINEL_ACTIVE.labels(metric, direction).set(0)
        for metric, direction in seen_active:
            obs_metrics.SENTINEL_ACTIVE.labels(metric, direction).set(1)
        obs_metrics.SENTINEL_CHECKS.inc()
        return fired

    def _evaluate(self, now: float) -> list[dict]:
        out = []
        hist = self.history
        if hist is None:
            return out
        # Robust-z rules over every labeled series of each watch.
        for family, direction in self.watches:
            for key in hist.keys():
                name, labels = split_key(key)
                if name != family:
                    continue
                recent = hist.window_values(
                    key, now - self.window_s, now + 1.0)
                baseline = hist.window_values(
                    key, now - self.baseline_s, now - self.window_s)
                if (len(recent) < self.min_points
                        or len(baseline) < self.min_points):
                    continue
                z, rm, bm = robust_z(recent, baseline)
                if direction == "up":
                    ratio_ok = rm >= bm * self.min_ratio
                    z_ok = z >= self.zscore
                else:
                    ratio_ok = bm > 0 and rm <= bm / self.min_ratio
                    z_ok = z <= -self.zscore
                if z_ok and ratio_ok:
                    out.append({
                        "rule": "robust_z", "metric": family,
                        "series": key, "labels": labels,
                        "direction": direction,
                        "z": round(z, 2),
                        "recentMedian": round(rm, 6),
                        "baselineMedian": round(bm, 6),
                        "windowS": self.window_s,
                        "baselineS": self.baseline_s})
        # Per-tenant SLO-burn rule: absolute threshold over the
        # tenant burn-rate gauge series (sched.tenants isolation
        # contract — a quiet tenant's burn past the fast-burn
        # threshold is a finding whoever caused it).
        if self.tenant_burn_threshold > 0:
            for key in hist.keys():
                name, labels = split_key(key)
                if name != DEFAULT_TENANT_BURN_FAMILY:
                    continue
                recent = hist.window_values(
                    key, now - self.window_s, now + 1.0)
                if len(recent) < self.min_points:
                    continue
                rm = _median(recent)
                if rm > self.tenant_burn_threshold:
                    out.append({
                        "rule": "tenant_burn",
                        "metric": DEFAULT_TENANT_BURN_FAMILY,
                        "series": key, "labels": labels,
                        "direction": "up",
                        "recentMedian": round(rm, 4),
                        "threshold": self.tenant_burn_threshold,
                        "windowS": self.window_s})
        # Planner misestimation rule: absolute threshold over the
        # misestimation-ratio p99 series (plan.planner observes
        # (actual+1)/(est+1) per node as actuals land).
        if self.planner_misest_threshold > 0:
            for key in hist.keys():
                name, labels = split_key(key)
                if name != DEFAULT_PLANNER_MISEST_FAMILY:
                    continue
                recent = hist.window_values(
                    key, now - self.window_s, now + 1.0)
                if len(recent) < self.min_points:
                    continue
                rm = _median(recent)
                if rm > self.planner_misest_threshold:
                    out.append({
                        "rule": "planner_misestimate",
                        "metric": DEFAULT_PLANNER_MISEST_FAMILY,
                        "series": key, "labels": labels,
                        "direction": "up",
                        "recentMedian": round(rm, 4),
                        "threshold": self.planner_misest_threshold,
                        "windowS": self.window_s})
        # Manifest envelope rules.
        metrics = self._manifest_metrics()
        for man_key, family, to_seconds in DEFAULT_MANIFEST_RULES:
            entry = metrics.get(man_key)
            if not isinstance(entry, dict) or "value" not in entry:
                continue
            try:
                committed = float(entry["value"]) * to_seconds
            except (TypeError, ValueError):
                continue
            if committed <= 0:
                continue
            bound = committed * self.manifest_tolerance
            for key in hist.keys():
                name, labels = split_key(key)
                if name != family:
                    continue
                recent = hist.window_values(
                    key, now - self.window_s, now + 1.0)
                if len(recent) < self.min_points:
                    continue
                rm = _median(recent)
                if rm > bound:
                    out.append({
                        "rule": "manifest", "metric": family,
                        "series": key, "labels": labels,
                        "direction": "up",
                        "recentMedian": round(rm, 6),
                        "committed": round(committed, 6),
                        "tolerance": self.manifest_tolerance,
                        "manifestKey": man_key})
        return out

    # -- firing ----------------------------------------------------------------

    def _fire(self, finding: dict, now: float) -> bool:
        key = finding["series"]
        with self._mu:
            last = self._last_fire.get(key, 0.0)
            if last and now - last < self.retrip_s:
                return False
            self._last_fire[key] = now
            finding = dict(finding, firedAt=now)
            self.findings.append(finding)
            del self.findings[:-64]
        obs_metrics.SENTINEL_FINDINGS.labels(
            finding["metric"], finding["direction"]).inc()
        self.logger.printf(
            "sentinel finding: %s %s (%s: recent=%s baseline/bound"
            "=%s)", finding["metric"], finding["direction"],
            finding["rule"], finding.get("recentMedian"),
            finding.get("baselineMedian", finding.get("committed")))
        self._force_keep_traces()
        if self.blackbox is not None:
            try:
                self.blackbox.snapshot("sentinel",
                                       extra={"sentinel": finding})
            except TypeError:  # pre-extra test doubles
                self.blackbox.snapshot("sentinel")
            except Exception:  # noqa: BLE001 - evidence best-effort
                pass
        return True

    def _force_keep_traces(self) -> None:
        """Every in-flight query's trace-so-far, kept under reason
        ``anomaly`` — the queries living through the cliff are the
        evidence (same claim discipline as the watchdog's force-keep:
        exactly one keeper enters the ring/disk)."""
        if self.registry is None or self.tracer is None:
            return
        for ctx in self.registry.active_contexts():
            trace = getattr(ctx, "trace", None)
            if trace is None or getattr(trace, "keep_reason", ""):
                continue
            try:
                if self.tracer.keep(trace, reason="anomaly") \
                        and self.sampler is not None:
                    self.sampler.persist(trace, "anomaly", ctx=ctx)
            except Exception:  # noqa: BLE001
                continue

    def snapshot(self) -> dict:
        with self._mu:
            return {"checks": self.checks,
                    "findings": list(self.findings[-16:]),
                    "active": sorted(f"{m}:{d}"
                                     for m, d in self._active),
                    "intervalS": self.interval_s,
                    "windowS": self.window_s,
                    "baselineS": self.baseline_s,
                    "zscore": self.zscore,
                    "manifest": self.manifest_path or None}

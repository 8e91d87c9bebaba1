"""Prometheus-style metrics: registry, typed families, text exposition.

A copy of the JAX package's ``obs/metrics.py``: the registry, the typed
families (monotonic counters, point-in-time gauges, log-bucketed
histograms with bounded label sets), the Prometheus 0.0.4 and
OpenMetrics text exposition behind ``GET /metrics`` and the
``RegistryStatsClient`` bridge from the legacy ``StatsClient`` call
sites (utils/stats.py) into the ``pilosa_stats_*`` namespace.

Every family the port emits is declared here at import, with the JAX
package's name, type, labels and help text. The JAX families that no
event of the port raises (tiering, backup, the XLA compile-cache
counters and the build-info gauge, whose labels name jax) are left out;
``tests/test_torch_obs.py`` lists each by name with its reason.
Naming convention (enforced at registration):
``pilosa_<subsystem>_<noun>_<unit>`` — lowercase snake case, at least
three segments after ``pilosa``; counters end in ``_total``.
"""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left
from typing import Iterable, Optional

from ..utils.stats import StatsClient

# pilosa_<subsystem>_<noun>_<unit>: at least three snake segments after
# the pilosa prefix (subsystem, noun, unit); plain lowercase/digits.
# The one sanctioned exception is the OpenMetrics *info* idiom —
# ``pilosa_build_info``-style constant-1 gauges whose labels carry the
# values — which keeps the ecosystem-conventional name.
NAME_RE = re.compile(r"^pilosa(_[a-z][a-z0-9]*){3,}$"
                     r"|^pilosa(_[a-z][a-z0-9]*)+_info$")


def validate_name(name: str, type_: str) -> None:
    if not NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} outside the"
            f" pilosa_<subsystem>_<noun>_<unit> convention")
    if type_ == "counter" and not name.endswith("_total"):
        raise ValueError(f"counter {name!r} must end in _total")


def log_buckets(lo: float = 0.001, hi: float = 64.0
                ) -> tuple[float, ...]:
    """Power-of-two log-spaced bucket bounds [lo, hi] — 1 ms to 64 s
    by default, which covers warm queries (a few ms), cold slab uploads
    and the multi-second streaming TopN."""
    out = []
    b = lo
    while b < hi * 1.0001:
        out.append(round(b, 9))
        b *= 2.0
    return tuple(out)


# Per-family bound on distinct label sets: per-peer families
# (pilosa_cluster_rpc_seconds{peer}, pilosa_cluster_peer_health{peer})
# otherwise grow without bound as the cluster scales, and an unbounded
# registry is both a memory leak and a scrape-size incident. Past the
# cap, NEW label sets collapse into one ``_overflow_`` bucket and
# pilosa_metrics_label_overflow_total{family} counts the collapses.
DEFAULT_MAX_LABEL_SETS = 256
_OVERFLOW_LABEL = "_overflow_"
_OVERFLOW_COUNTER_NAME = "pilosa_metrics_label_overflow_total"


class _Family:
    """Shared base: a named family with optional label names and a
    dict of label-tuple → child state."""

    type = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        validate_name(name, self.type)
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self.max_label_sets = max(1, int(max_label_sets))
        self._mu = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _child(self, labelvalues: tuple):
        overflowed = False
        with self._mu:
            child = self._children.get(labelvalues)
            if child is None:
                if (self.labelnames
                        and len(self._children) >= self.max_label_sets
                        and self.name != _OVERFLOW_COUNTER_NAME):
                    # Cardinality guard: the cap is on NEW label sets;
                    # existing children (and the overflow bucket
                    # itself) keep resolving normally.
                    overflowed = True
                    labelvalues = ((_OVERFLOW_LABEL,)
                                   * len(self.labelnames))
                    child = self._children.get(labelvalues)
                if child is None:
                    child = self._children[labelvalues] = \
                        self._new_child()
        if overflowed:
            LABEL_OVERFLOW.labels(self.name).inc()
        return child

    def labels(self, *values, **kv):
        if kv:
            values = tuple(str(kv.get(ln, "")) for ln in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(values)} label values for"
                f" {self.labelnames}")
        return self._child(values)

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name}: labels required")
        return self._child(())

    def samples(self) -> list[tuple[str, dict, float]]:
        """(suffix, labels, value) triples for rendering."""
        raise NotImplementedError

    def samples_ex(self):
        """(suffix, labels, value, exemplar) — the OpenMetrics form;
        only histograms attach exemplars (they override this)."""
        return [(s, l, v, None) for s, l, v in self.samples()]

    def _label_dicts(self) -> list[tuple[dict, object]]:
        with self._mu:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, lv)), ch) for lv, ch in items]


class _CounterChild:
    __slots__ = ("_v", "_mu")

    def __init__(self):
        self._v = 0.0
        self._mu = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._mu:
            self._v += n

    def set_total(self, total: float) -> None:
        """Sync from an external monotonic source (e.g. the roaring
        container-op counters of storage.roaring, mirrored here at
        scrape time)."""
        with self._mu:
            if total > self._v:
                self._v = total

    @property
    def value(self) -> float:
        return self._v


class Counter(_Family):
    type = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set_total(self, total: float) -> None:
        self._default().set_total(total)

    @property
    def value(self) -> float:
        return self._default().value

    def samples(self):
        return [("", labels, ch.value)
                for labels, ch in self._label_dicts()]


class _GaugeChild:
    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = v

    def inc(self, n: float = 1.0) -> None:
        self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge(_Family):
    type = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    @property
    def value(self) -> float:
        return self._default().value

    def samples(self):
        return [("", labels, ch.value)
                for labels, ch in self._label_dicts()]


class _HistogramChild:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_mu",
                 "_exemplars")

    def __init__(self, bounds: tuple[float, ...]):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()
        # Per-bucket last exemplar: (labels, value, unix_ts) — the
        # OpenMetrics hook carrying a trace/query id next to the
        # latency observation that landed in that bucket.
        self._exemplars: dict[int, tuple[dict, float, float]] = {}

    def observe(self, v: float,
                exemplar: Optional[dict] = None) -> None:
        i = bisect_left(self._bounds, v)
        with self._mu:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar:
                self._exemplars[i] = (exemplar, v, time.time())

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._mu:
            return list(self._counts), self._sum, self._count

    def exemplars(self) -> dict[int, tuple[dict, float, float]]:
        with self._mu:
            return dict(self._exemplars)


class Histogram(_Family):
    type = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 buckets: Optional[tuple[float, ...]] = None,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self.buckets = tuple(buckets) if buckets else log_buckets()
        super().__init__(name, help, labels,
                         max_label_sets=max_label_sets)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        self._default().observe(v, exemplar=exemplar)

    def samples(self):
        return [s[:3] for s in self.samples_ex()]

    def samples_ex(self):
        """(suffix, labels, value, exemplar-or-None) — exemplars ride
        bucket samples only (the OpenMetrics rule)."""
        out = []
        for labels, ch in self._label_dicts():
            counts, total, n = ch.snapshot()
            exemplars = ch.exemplars()
            cum = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                out.append(("_bucket", {**labels, "le": _fmt(bound)},
                            cum, exemplars.get(i)))
            out.append(("_bucket", {**labels, "le": "+Inf"}, n,
                        exemplars.get(len(self.buckets))))
            out.append(("_sum", labels, total, None))
            out.append(("_count", labels, n, None))
        return out


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v):
        return str(int(v))
    return repr(v)


def _escape(v: str) -> str:
    """Label-VALUE escaping per the exposition spec: backslash, double
    quote, and line feed (in that order — escaping the backslash last
    would corrupt the other two escapes)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                               "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: ONLY backslash and line feed. ``\\"`` is
    not a valid escape sequence in help text — emitting it (the old
    shared escaper did) renders a spec-invalid line that strict
    OpenMetrics parsers reject."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


# Public faces for the federation renderer (obs.federate) and tests:
# one escaping implementation, every exposition writer.
escape_label_value = _escape
escape_help = _escape_help


class Registry:
    """Named metric families + the text-exposition renderer."""

    def __init__(self):
        self._mu = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, fam: _Family) -> _Family:
        with self._mu:
            existing = self._families.get(fam.name)
            if existing is not None:
                if (type(existing) is not type(fam)
                        or existing.labelnames != fam.labelnames):
                    raise ValueError(
                        f"metric {fam.name} re-registered with a"
                        f" different shape")
                return existing
            self._families[fam.name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = (),
                max_label_sets: int = DEFAULT_MAX_LABEL_SETS
                ) -> Counter:
        return self._register(Counter(
            name, help, labels, max_label_sets=max_label_sets))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = (),
              max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Gauge:
        return self._register(Gauge(
            name, help, labels, max_label_sets=max_label_sets))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Optional[tuple[float, ...]] = None,
                  max_label_sets: int = DEFAULT_MAX_LABEL_SETS
                  ) -> Histogram:
        return self._register(Histogram(
            name, help, labels, buckets,
            max_label_sets=max_label_sets))

    def families(self) -> dict[str, _Family]:
        with self._mu:
            return dict(self._families)

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format 0.0.4, or (with
        ``openmetrics=True``) OpenMetrics 1.0: counter families are
        declared under their ``_total``-stripped name, histogram bucket
        samples carry their exemplar (``# {trace_id="..."} v ts``), and
        the body terminates with ``# EOF``."""
        lines = []
        for name in sorted(self.families()):
            fam = self._families[name]
            om_name = name
            if (openmetrics and fam.type == "counter"
                    and name.endswith("_total")):
                om_name = name[: -len("_total")]
            if fam.help:
                lines.append(
                    f"# HELP {om_name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {om_name} {fam.type}")
            for suffix, labels, value, exemplar in fam.samples_ex():
                if labels:
                    lab = ",".join(
                        f'{k}="{_escape(str(v))}"'
                        for k, v in labels.items())
                    line = f"{name}{suffix}{{{lab}}} {_fnum(value)}"
                else:
                    line = f"{name}{suffix} {_fnum(value)}"
                if openmetrics and exemplar is not None:
                    ex_labels, ex_v, ex_ts = exemplar
                    exl = ",".join(
                        f'{k}="{_escape(str(v))}"'
                        for k, v in ex_labels.items())
                    line += (f" # {{{exl}}} {_fnum_om(ex_v)}"
                             f" {_fnum_om(ex_ts)}")
                lines.append(line)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _fnum(v: float) -> str:
    if isinstance(v, int) or v == int(v):
        return str(int(v))
    return repr(v)


format_value = _fnum  # the federation renderer's sample formatting


def _fnum_om(v: float) -> str:
    """Exemplar value/timestamp: keep floats readable (OpenMetrics
    allows either form; repr of a perf_counter float is noise)."""
    if v == int(v):
        return str(int(v))
    return f"{v:.6f}".rstrip("0").rstrip(".")


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT




# -- the emitted metric set ---------------------------------------------------
# Declared here, at import, against the default registry.

_TENANT_LABEL_SETS = 64
QUERY_SECONDS = _DEFAULT.histogram(
    "pilosa_query_duration_seconds",
    "End-to-end /query latency on this node",
    labels=("call", "lane", "status"))
QUERIES_TOTAL = _DEFAULT.counter(
    "pilosa_query_requests_total",
    "Queries served, by outcome",
    labels=("call", "lane", "status"))
IMPORT_BITS = _DEFAULT.counter(
    "pilosa_import_bits_total",
    "Bits (or field values) accepted by /import endpoints",
    labels=("kind",))
ADMISSION_REJECTED = _DEFAULT.counter(
    "pilosa_admission_rejections_total",
    "Requests answered 429 by the admission controller",
    labels=("lane",))
ADMISSION_QUEUE_DEPTH = _DEFAULT.gauge(
    "pilosa_admission_queue_depth",
    "Queries waiting in the admission queue",
    labels=("lane",))
ADMISSION_IN_FLIGHT = _DEFAULT.gauge(
    "pilosa_admission_inflight_queries",
    "Queries currently holding an execution slot")
ROARING_OPS = _DEFAULT.counter(
    "pilosa_roaring_container_ops_total",
    "Roaring container set-algebra operations, by op and operand"
    " container kinds",
    labels=("op", "kind"))
ROARING_CONTAINERS = _DEFAULT.gauge(
    "pilosa_roaring_containers_live",
    "Live roaring containers across open fragments, by kind"
    " (array/bitmap/run) — the container-mix shift to runs as a gauge",
    labels=("kind",))
ROARING_CONTAINER_BYTES = _DEFAULT.gauge(
    "pilosa_roaring_container_bytes",
    "Resident bytes held by live roaring containers, by kind — run"
    " containers shrinking this is the HBM-headroom payoff ramp",
    labels=("kind",))
# Declared for the JAX family set; the JAX package increments it nowhere
# either (the slow-query log counts in the stats pipeline).
SLOW_QUERIES = _DEFAULT.counter(
    "pilosa_query_slow_total",
    "Queries slower than the configured slow-query threshold")
RUNTIME_THREADS = _DEFAULT.gauge(
    "pilosa_runtime_threads_live",
    "Live interpreter threads", labels=("state",))
HOLDER_FRAGMENTS = _DEFAULT.gauge(
    "pilosa_holder_fragments_open",
    "Open fragments across all indexes")
HOLDER_CACHE_ENTRIES = _DEFAULT.gauge(
    "pilosa_holder_cache_entries",
    "Row-cache entries across all open fragments")
RESIDENCY_BYTES = _DEFAULT.gauge(
    "pilosa_residency_hbm_bytes",
    "Device residency cache HBM", labels=("kind",))
TRACES_KEPT = _DEFAULT.counter(
    "pilosa_trace_kept_total",
    "Traces retained by the tail sampler, by keep reason (slow/error/"
    "deadline/cancelled/partial/corruption/shed/breaker/failpoint/"
    "head/requested/watchdog/anomaly — docs/OBSERVABILITY.md"
    " keep-reason catalogue)",
    labels=("reason",))
TRACE_DISK_RECORDS = _DEFAULT.counter(
    "pilosa_trace_disk_records_total",
    "Kept traces persisted to the on-disk segment ring, by outcome"
    " (written / dropped)",
    labels=("outcome",))
LABEL_OVERFLOW = _DEFAULT.counter(
    "pilosa_metrics_label_overflow_total",
    "New label sets collapsed into a family's _overflow_ bucket by the"
    " per-family cardinality cap, by family",
    labels=("family",))
TENANT_QUERY_SECONDS = _DEFAULT.histogram(
    "pilosa_tenant_query_duration_seconds",
    "End-to-end /query latency on this node, by tenant — the"
    " per-tenant SLO burn rates are computed over this family",
    labels=("tenant",), max_label_sets=_TENANT_LABEL_SETS)
TENANT_QUERIES = _DEFAULT.counter(
    "pilosa_tenant_query_requests_total",
    "Queries served, by tenant and status — 429s and cost-policy"
    " 402s included, so shed/kill rates are derivable per tenant",
    labels=("tenant", "status"), max_label_sets=4 * _TENANT_LABEL_SETS)
TENANT_COST_UNITS = _DEFAULT.counter(
    "pilosa_tenant_cost_units_total",
    "Chargeback roll-up of the per-query cost ledgers, by tenant and"
    " resource (container_ops / words_scanned / bits_written /"
    " device_bytes / rpc_bytes / queue_wait_ms / wall_us)",
    labels=("tenant", "resource"),
    max_label_sets=8 * _TENANT_LABEL_SETS)
TENANT_SHED = _DEFAULT.counter(
    "pilosa_tenant_admission_rejections_total",
    "Per-tenant 429s: arrivals past the tenant's own queue quota"
    " (lane-scoped) — only the offending tenant sheds",
    labels=("tenant", "lane"), max_label_sets=4 * _TENANT_LABEL_SETS)
TENANT_KILLS = _DEFAULT.counter(
    "pilosa_tenant_cost_kills_total",
    "Queries killed cluster-wide by the per-tenant cost policy"
    " (ceiling breach at a stage boundary), by tenant",
    labels=("tenant",), max_label_sets=_TENANT_LABEL_SETS)
TENANT_INFLIGHT = _DEFAULT.gauge(
    "pilosa_tenant_inflight_queries",
    "Execution slots currently held, by tenant (scrape-time refresh"
    " from the admission controller)",
    labels=("tenant",), max_label_sets=_TENANT_LABEL_SETS)
TENANT_PENALTY = _DEFAULT.gauge(
    "pilosa_tenant_penalty_score",
    "Decaying penalty-box score, by tenant: each cost-policy kill"
    " adds 1, halving every penalty half-life; the effective stride"
    " weight is demoted by 2^-score until the score decays away",
    labels=("tenant",), max_label_sets=_TENANT_LABEL_SETS)
RESULT_CACHE_HITS = _DEFAULT.counter(
    "pilosa_executor_result_cache_hits_total",
    "Materialized-bitmap result-residency cache hits (a repeated"
    " Union/Intersect/Difference chain served without a re-fold)")
RESULT_CACHE_MISSES = _DEFAULT.counter(
    "pilosa_executor_result_cache_misses_total",
    "Result-residency lookups that had to fold (cacheable key, no"
    " live entry)")
RESULT_CACHE_EVICTIONS = _DEFAULT.counter(
    "pilosa_executor_result_cache_evictions_total",
    "Result-residency entries evicted by the entry/bit bounds")
PLANNER_DECISIONS = _DEFAULT.counter(
    "pilosa_planner_decisions_total",
    "Planner decisions taken, by outcome (planned / reordered /"
    " short_circuit / cse / placement) — every read query lands at"
    " least one 'planned'",
    labels=("outcome",))
PLANNER_MISESTIMATE = _DEFAULT.histogram(
    "pilosa_planner_misestimation_ratio",
    "Actual/estimated cardinality ratio per measured plan node"
    " ((actual+1)/(est+1)): 1.0 = perfect, the sentinel's"
    " planner_misestimate rule fires on a sustained p99 drift",
    buckets=(0.015625, 0.03125, 0.0625, 0.125, 0.25, 0.5, 1.0, 2.0,
             4.0, 8.0, 16.0, 32.0, 64.0))
PLANNER_SUBRESULT_EVENTS = _DEFAULT.counter(
    "pilosa_planner_subresult_cache_events_total",
    "Generation-token-keyed interior-node subresult cache events"
    " (hit / miss / store / evict) — the cross-query CSE plane",
    labels=("event",))
PLANNER_PLAN_SECONDS = _DEFAULT.histogram(
    "pilosa_planner_plan_seconds",
    "Wall seconds spent planning one read query (estimation +"
    " rewrite) — the overhead-guard numerator, before execution",
    buckets=(0.00001, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
             0.5, 1.0))

# -- cluster and fault families (the JAX package's names) -------------------
RPC_SECONDS = _DEFAULT.histogram(
    "pilosa_cluster_rpc_seconds",
    "Cluster fan-out RPC latency, by peer host",
    labels=("peer", "kind"))
PEER_HEALTH = _DEFAULT.gauge(
    "pilosa_cluster_peer_health",
    "Blended per-peer health score in [0, 1]: EWMA of RPC outcomes"
    " scaled by gossip liveness (fault subsystem)",
    labels=("peer",))
BREAKER_STATE = _DEFAULT.gauge(
    "pilosa_fault_breaker_state",
    "Per-peer circuit-breaker state: 0=closed, 1=half-open, 2=open",
    labels=("peer",))
BREAKER_TRANSITIONS = _DEFAULT.counter(
    "pilosa_fault_breaker_transitions_total",
    "Circuit-breaker state transitions, by peer and target state",
    labels=("peer", "state"))
FAILPOINT_TRIGGERS = _DEFAULT.counter(
    "pilosa_fault_failpoint_triggers_total",
    "Armed failpoint injections fired, by site",
    labels=("site",))
FAILOVER_SLICES = _DEFAULT.counter(
    "pilosa_cluster_failover_slices_total",
    "Slices re-mapped onto surviving replicas after a node leg"
    " failed mid-query, by failed peer",
    labels=("peer",))
GENERATION_UPDATES = _DEFAULT.counter(
    "pilosa_cluster_generation_updates_total",
    "Per-slice generation-token entries applied to the coordinator"
    " generation map, by source peer (X-Pilosa-Generations headers"
    " and /generations probes)",
    labels=("peer",))
CLUSTER_CACHE_REQUESTS = _DEFAULT.counter(
    "pilosa_executor_cluster_cache_requests_total",
    "Coordinator hot-query result-cache lookups, by outcome: hit"
    " (every generation token validated), miss (no entry or"
    " unvalidatable), invalidated (a token mismatched — a replica"
    " took a write since the entry was cached)",
    labels=("outcome",))
TOPN_PUSHDOWN = _DEFAULT.counter(
    "pilosa_executor_topn_pushdown_total",
    "Distributed TopN pushdown outcomes: merged (per-node partials"
    " merged per the two-phase semantics) or fallback (pushdown"
    " failed; the fan-out path answered)",
    labels=("outcome",))
RESIZE_STATE = _DEFAULT.gauge(
    "pilosa_cluster_resize_state",
    "Elastic-resize state on this node: 1 on the current phase label"
    " (idle / preparing / streaming / migrating / flipping / draining /"
    " finalizing / done / aborted), 0 elsewhere — the cluster_ prefix"
    " carries the naming convention's subsystem segment"
    " (docs/CLUSTER_RESIZE.md)",
    labels=("phase",))
RESIZE_SLICES_MOVED = _DEFAULT.counter(
    "pilosa_resize_slices_moved_total",
    "Moving (index, slice) groups whose fragments finished streaming"
    " to their new owner during an elastic resize")
RESIZE_STREAM_BYTES = _DEFAULT.counter(
    "pilosa_resize_stream_bytes_total",
    "Position bytes pushed source→target by the resize fragment"
    " streamer (the migration wire cost — run-shaped fragments ride"
    " their compact container form)")
RESIZE_DOUBLE_READS = _DEFAULT.counter(
    "pilosa_cluster_resize_double_reads_total",
    "Moving-slice double-read legs during a resize, by winner: source"
    " (old owner answered — the authoritative pre-flip copy) or"
    " target (old side failed; the new owner's post-flip answer won"
    " with the newest generation tokens)",
    labels=("winner",))

HEDGED_REQUESTS = _DEFAULT.counter(
    "pilosa_cluster_hedged_requests_total",
    "Hedged-read outcomes: fired (second leg launched), primary_won,"
    " hedge_won",
    labels=("outcome",))
PARTIAL_RESULTS = _DEFAULT.counter(
    "pilosa_query_partial_results_total",
    "Queries answered degraded (?partial=1) with at least one"
    " unreachable slice skipped")
FEDERATION_SCRAPES = _DEFAULT.counter(
    "pilosa_federation_scrapes_total",
    "Cluster-federation fan-out legs (/metrics/cluster,"
    " /debug/cluster, history scope=cluster), by peer and outcome —"
    " error legs are the partial-result denominator",
    labels=("peer", "outcome"))

# Storage integrity (storage.integrity / storage.scrub / server.repair)
# and disk-full degradation (fault.diskfull).
STORAGE_SCRUB_BLOCKS = _DEFAULT.counter(
    "pilosa_storage_scrub_blocks_total",
    "Container blocks whose crc32 was re-verified against the snapshot"
    " footer, by source (scrub = the background pass, read = the lazy"
    " first-read check after an open)",
    labels=("source",))
STORAGE_CORRUPTION = _DEFAULT.counter(
    "pilosa_storage_corruption_detected_total",
    "On-disk corruption detections (checksum mismatch or unparseable"
    " snapshot), by detection site (open / read / scrub)",
    labels=("site",))
STORAGE_QUARANTINED = _DEFAULT.counter(
    "pilosa_storage_quarantined_fragments_total",
    "Fragments newly quarantined after a corruption detection (reads"
    " fail over to a replica; writes keep WAL-buffering)")
STORAGE_QUARANTINED_LIVE = _DEFAULT.gauge(
    "pilosa_storage_quarantined_fragments_live",
    "Fragments currently quarantined on this node (awaiting replica"
    " repair, or unrepairable with no healthy replica)")
STORAGE_REPAIRS = _DEFAULT.counter(
    "pilosa_storage_repairs_total",
    "Automatic replica re-stream repairs of quarantined fragments, by"
    " outcome (repaired / failed / no_replica)",
    labels=("outcome",))
STORAGE_ENOSPC = _DEFAULT.counter(
    "pilosa_storage_enospc_events_total",
    "ENOSPC hits at durable-write sites (wal.append /"
    " snapshot.write), by site — each flips the node write-unready"
    " until a probe write succeeds",
    labels=("site",))
STORAGE_WRITE_READY = _DEFAULT.gauge(
    "pilosa_storage_write_ready",
    "1 while durable writes are accepted; 0 while the node is"
    " write-unready after ENOSPC (writes answer 507, reads keep"
    " serving, auto-recovers on a successful probe write)")

# -- tiered storage (the tier working-set manager) ----------------------------
TIER_FRAGMENTS = _DEFAULT.gauge(
    "pilosa_tier_fragments_resident",
    "Fragments per residency tier on this node (hot = fully mmap-"
    "resident with caches, cold = metadata-only with unfaulted"
    " container blocks, blob = bytes live only in the blob store)",
    labels=("tier",))
TIER_BYTES = _DEFAULT.gauge(
    "pilosa_tier_bytes_resident",
    "Data bytes per residency tier on this node — resident counts"
    " hot fragments plus the faulted blocks of cold ones; the"
    " watermark eviction loop works against this gauge's resident"
    " label",
    labels=("tier",))
TIER_FAULTS = _DEFAULT.counter(
    "pilosa_tier_block_faults_total",
    "Container blocks faulted into residency on first read of a cold"
    " fragment, by outcome (ok / corrupt — a corrupt fault"
    " quarantines exactly like a failed lazy read verify)",
    labels=("outcome",))
TIER_DEMOTIONS = _DEFAULT.counter(
    "pilosa_tier_demotions_total",
    "Fragment demotions out of the resident set, by reason"
    " (watermark = eviction pressure, idle = idle-age sweep,"
    " blob = pushed to the blob tier)",
    labels=("reason",))
TIER_PROMOTIONS = _DEFAULT.counter(
    "pilosa_tier_promotions_total",
    "Fragment promotions back toward residency, by trigger (read ="
    " a query faulted it, prefetch = the history-driven prefetcher,"
    " write = a mutation landed on a cold fragment)",
    labels=("trigger",))
TIER_PREFETCH = _DEFAULT.counter(
    "pilosa_tier_prefetch_total",
    "History-driven prefetch decisions, by outcome (promoted /"
    " skipped_busy / skipped_budget / error)",
    labels=("outcome",))
TIER_FETCHES = _DEFAULT.counter(
    "pilosa_tier_blob_transfers_total",
    "Blob-tier transfers, by direction (push / fetch) and outcome"
    " (ok / error / corrupt — corrupt means the fetched bytes failed"
    " footer verification at admission and were discarded)",
    labels=("direction", "outcome"))
TIER_FAULT_SECONDS = _DEFAULT.histogram(
    "pilosa_tier_fault_wait_seconds",
    "Latency of faulting the blocks one read touched on a cold"
    " fragment (crc verification included; blob fetch included when"
    " the fragment had left local disk)")
TIER_TOUCH = _DEFAULT.counter(
    "pilosa_tier_fragment_touches_total",
    "Read-path touches per (tenant, index, slice) — sampled into the"
    " on-disk metric history, where yesterday's rates drive the"
    " prefetcher's prediction of tomorrow's hot set",
    labels=("tenant", "index", "slice"), max_label_sets=512)

# -- the operator surface: obs.watchdog, obs.blackbox, obs.slo, obs.profile
WATCHDOG_TRIPS = _DEFAULT.counter(
    "pilosa_watchdog_trips_total",
    "Stall-watchdog trips, by cause (wal_flusher / stuck_query /"
    " gossip_silence / admission_stall)",
    labels=("cause",))
BLACKBOX_SNAPSHOTS = _DEFAULT.counter(
    "pilosa_blackbox_snapshots_total",
    "Flight-recorder whole-system snapshots taken, by trigger",
    labels=("trigger",))
BLACKBOX_DUMPS = _DEFAULT.counter(
    "pilosa_blackbox_dumps_total",
    "Flight-recorder full dumps written, by cause (sigterm / fatal /"
    " watchdog / api)",
    labels=("cause",))
SLO_BURN_RATE = _DEFAULT.gauge(
    "pilosa_slo_burn_rate_ratio",
    "Latency-objective error-budget burn rate over a rolling window"
    " (1.0 = budget burns exactly at the sustainable rate)",
    labels=("window",))
SLO_OBJECTIVE = _DEFAULT.gauge(
    "pilosa_slo_latency_objective_seconds",
    "The configured latency objective the burn rate is computed"
    " against")
PROFILE_SAMPLES = _DEFAULT.counter(
    "pilosa_profile_samples_total",
    "Continuous-profiler sampling ticks taken")
TENANT_CACHE_BYTES = _DEFAULT.gauge(
    "pilosa_tenant_cache_bytes",
    "Result-cache residency held per tenant (result-residency bits/8"
    " + coordinator cluster-cache entries) under the per-tenant"
    " cache quota",
    labels=("tenant",), max_label_sets=_TENANT_LABEL_SETS)
TENANT_SLO_BURN = _DEFAULT.gauge(
    "pilosa_tenant_slo_burn_rate_ratio",
    "Per-tenant latency-objective error-budget burn rate over a"
    " rolling window (1.0 = sustainable) — the quiet tenant's"
    " isolation guarantee is stated against this",
    labels=("tenant", "window"),
    max_label_sets=4 * _TENANT_LABEL_SETS)

# -- the write path: WAL group commit and the import stages
WAL_GROUP_BATCH_SIZE = _DEFAULT.histogram(
    "pilosa_wal_group_commit_batch_size",
    "Op records covered by one WAL group-commit leader flush — the"
    " syscall/fsync amortization factor of the write path",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096,
             16384, 65536))
WAL_GROUP_FLUSH_SECONDS = _DEFAULT.histogram(
    "pilosa_wal_group_commit_flush_seconds",
    "Wall seconds one WAL group-commit leader flush took (write +"
    " fsync per policy)")
WAL_FSYNCS = _DEFAULT.counter(
    "pilosa_wal_fsync_calls_total",
    "fsync() calls issued by WAL group-commit leader flushes — the"
    " denominator the group-commit amortization is measured against")
IMPORT_STAGE_SECONDS = _DEFAULT.histogram(
    "pilosa_import_stage_seconds",
    "Wire-import handler stage timings: decode (wire to arrays),"
    " apply (fragment mutation), snapshot (storage rewrite) — the"
    " decode-vs-apply serialization recorded as a metric",
    labels=("stage",))
IMPORT_PIPELINE_DEPTH = _DEFAULT.gauge(
    "pilosa_import_pipeline_depth",
    "Wire-import blocks currently in their apply stage across all"
    " fragments — >1 means decode of later blocks is overlapping"
    " earlier applies (the pipelined import path)")

# -- metric history and the regression sentinel (obs.history, obs.sentinel)
HISTORY_SAMPLES = _DEFAULT.counter(
    "pilosa_history_samples_total",
    "Metric-history sampling passes over the registry (obs.history —"
    " one pass per runtime-collector tick)")
HISTORY_SERIES_LIVE = _DEFAULT.gauge(
    "pilosa_history_series_live",
    "Series held in the on-disk metric history's in-memory rings"
    " (bounded by the per-process series cap)")
HISTORY_SERIES_DROPPED = _DEFAULT.counter(
    "pilosa_history_series_dropped_total",
    "New series the metric history refused past its series cap — a"
    " nonzero value means some families' label growth outran the"
    " retention budget")
HISTORY_DISK_RECORDS = _DEFAULT.counter(
    "pilosa_history_disk_records_total",
    "Metric-history tick records persisted to the per-resolution"
    " segment rings, by outcome (written / dropped)",
    labels=("outcome",))
SENTINEL_FINDINGS = _DEFAULT.counter(
    "pilosa_sentinel_findings_total",
    "Regression-sentinel findings raised, by watched metric and"
    " direction (up = regressed slower/hotter, down = cliff): a"
    " robust-z anomaly against the trailing baseline or a breach of"
    " the committed MANIFEST envelope (obs.sentinel;"
    " docs/OBSERVABILITY.md rule catalogue)",
    labels=("metric", "direction"))
SENTINEL_ACTIVE = _DEFAULT.gauge(
    "pilosa_sentinel_findings_active",
    "1 while a sentinel finding's condition still holds on the most"
    " recent evaluation, 0 once it recovers, by watched metric and"
    " direction",
    labels=("metric", "direction"))
SENTINEL_CHECKS = _DEFAULT.counter(
    "pilosa_sentinel_checks_total",
    "Regression-sentinel evaluation passes (every rule, every pass)")

# -- workload capture (obs.capture)
CAPTURE_RECORDS = _DEFAULT.counter(
    "pilosa_capture_records_total",
    "Workload-capture records appended to the on-disk capture ring,"
    " by kind (query / import)",
    labels=("kind",))
CAPTURE_DROPPED = _DEFAULT.counter(
    "pilosa_capture_dropped_total",
    "Capture records lost, by reason (io = the ring append failed)",
    labels=("reason",))
CAPTURE_BYTES = _DEFAULT.counter(
    "pilosa_capture_bytes_total",
    "Framed record bytes appended to the capture ring, by kind",
    labels=("kind",))


# -- legacy StatsClient bridge ------------------------------------------------

_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")
_SAN_RE = re.compile(r"[^a-z0-9_]")


def _snake(name: str) -> str:
    s = _SAN_RE.sub("_", _CAMEL_RE.sub("_", name).lower()).strip("_")
    return re.sub(r"__+", "_", s) or "unnamed"


class RegistryStatsClient(StatsClient):
    """StatsClient adapter onto a metrics Registry: legacy call sites
    (``stats.count("setN")``, holder gauges, slow-query counters) land
    in the ``pilosa_stats_*`` namespace so /metrics sees them without a
    second instrumentation pass. Tag-scoped children carry the joined
    tag string as one ``tags`` label (bounded: tags are per-index /
    per-frame scopes, not per-query values)."""

    def __init__(self, registry: Optional[Registry] = None,
                 _tags: str = ""):
        self.registry = registry or default_registry()
        self._tags = _tags
        self._cache: dict[tuple[str, str], object] = {}

    def with_tags(self, *tags: str) -> "RegistryStatsClient":
        joined = ",".join(filter(None, [self._tags, *sorted(tags)]))
        child = RegistryStatsClient(self.registry, joined)
        return child

    def _metric(self, kind: str, name: str):
        key = (kind, name)
        m = self._cache.get(key)
        if m is not None:
            return m
        snake = _snake(name)
        if kind == "count":
            fam = self.registry.counter(
                f"pilosa_stats_{snake}_total", labels=("tags",))
        elif kind == "gauge":
            fam = self.registry.gauge(
                f"pilosa_stats_{snake}_value", labels=("tags",))
        else:  # histogram / timing: seconds
            if snake.endswith("_ns"):
                snake = snake[:-3]
            if not snake.endswith("_seconds"):
                snake += "_seconds"
            fam = self.registry.histogram(
                f"pilosa_stats_{snake}", labels=("tags",))
        m = fam.labels(self._tags)
        self._cache[key] = m
        return m

    def count(self, name: str, value: int = 1) -> None:
        self._metric("count", name).inc(value)

    def gauge(self, name: str, value: float) -> None:
        self._metric("gauge", name).set(value)

    def histogram(self, name: str, value: float) -> None:
        self._metric("histogram", name).observe(value)

    def timing(self, name: str, value_ns: float) -> None:
        self._metric("timing", name).observe(value_ns / 1e9)

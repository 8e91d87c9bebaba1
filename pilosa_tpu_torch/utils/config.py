"""Configuration: TOML file + PILOSA_* environment + flags.

Copy of the JAX package's ``utils/config.py`` (reference config.go,
schema at config.go:34-57, defaults :59-71, and cmd/root.go:99-153, the
viper merge priority flags > env > file): ``load()`` starts from the
defaults, overlays the TOML file, then the ``PILOSA_*`` environment, and
the CLI overlays explicit flags last; ``Config.to_toml()`` writes the
file the ``config`` verb prints. A JAX config file loads here to the
same values with the same errors, and ``to_toml()`` writes the same
bytes.

Every section is parsed, validated and kept, also that of the
subsystem this package does not run yet (backup): the ``server`` verb
refuses an explicit switch-on of it (``unported_switch_ons``).
"""

from __future__ import annotations

import os
import re
import tomllib
from dataclasses import dataclass, field

DEFAULT_HOST = "localhost"
DEFAULT_PORT = "10101"
DEFAULT_CLUSTER_TYPE = "static"
DEFAULT_REPLICA_N = 1
DEFAULT_POLLING_INTERVAL = 60.0
DEFAULT_ANTI_ENTROPY_INTERVAL = 600.0
DEFAULT_INTERNAL_PORT = "14000"   # gossip port (config.go:25-31)
CLUSTER_TYPES = ("static", "http", "gossip")


def parse_duration(v) -> float:
    """Go-style duration string ("10m", "1h30m", "45s") → seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    units = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
             "h": 3600.0}
    total = 0.0
    matched = False
    for num, unit in re.findall(r"([0-9.]+)(ns|us|ms|s|m|h)", str(v)):
        total += float(num) * units[unit]
        matched = True
    if not matched:
        raise ValueError(f"invalid duration: {v!r}")
    return total


@dataclass
class ClusterConfig:
    replica_n: int = DEFAULT_REPLICA_N
    type: str = DEFAULT_CLUSTER_TYPE          # static | http | gossip
    hosts: list[str] = field(default_factory=list)
    internal_hosts: list[str] = field(default_factory=list)
    polling_interval: float = DEFAULT_POLLING_INTERVAL
    internal_port: str = DEFAULT_INTERNAL_PORT  # gossip bind port
    gossip_seed: str = ""                       # seed "host:port" to join
    gossip_secret: str = ""                     # HMAC key for gossip frames
    # Staleness bound (seconds) on the coordinator generation map
    # (cluster.generations): remote-slice cache keys stop trusting a
    # peer's tokens this long after the last exchange with it. Writes
    # routed through this coordinator invalidate on their own response
    # — the bound only governs out-of-band writes (docs/DISTRIBUTED.md).
    gen_staleness: float = 2.0
    # Elastic resize (cluster.resize; docs/CLUSTER_RESIZE.md):
    # ``resize_pace`` (seconds) breathes between streamed blocks so a
    # migration never saturates a serving node; ``resize_grace``
    # (seconds) keeps the previous epoch's owners write-accepting
    # after finalize so straggler coordinators' union-writes don't
    # bounce.
    resize_pace: float = 0.0
    resize_grace: float = 30.0


# Query lifecycle defaults (sched subsystem; docs/SCHEDULING.md).
DEFAULT_QUERY_CONCURRENCY = 16
DEFAULT_QUERY_QUEUE_DEPTH = 64


# Executor cache defaults (docs/DISTRIBUTED.md): the materialized
# bitmap-result residency bounds and the coordinator hot-query cache.
DEFAULT_RESULT_CACHE_ENTRIES = 8
DEFAULT_RESULT_CACHE_BITS = 32 << 20
DEFAULT_CLUSTER_CACHE_ENTRIES = 64


@dataclass
class QueryConfig:
    """[query] section: the sched subsystem's knobs. concurrency/
    queue_depth bound the admission controller (overflow answers 429);
    default_timeout (seconds, 0 = none) applies when a request carries
    neither ?timeout= nor X-Pilosa-Deadline; slow_threshold (seconds,
    0 = disabled) arms the slow-query log. result_cache_entries/_bits
    bound the executor's materialized-result residency cache;
    cluster_cache_entries bounds the coordinator hot-query result
    cache (0 disables either)."""
    concurrency: int = DEFAULT_QUERY_CONCURRENCY
    queue_depth: int = DEFAULT_QUERY_QUEUE_DEPTH
    default_timeout: float = 0.0
    slow_threshold: float = 0.0
    result_cache_entries: int = DEFAULT_RESULT_CACHE_ENTRIES
    result_cache_bits: int = DEFAULT_RESULT_CACHE_BITS
    cluster_cache_entries: int = DEFAULT_CLUSTER_CACHE_ENTRIES


# -- [tenants]: per-tenant QoS (sched.tenants; docs/SCHEDULING.md) -----------
# One sub-table per tenant (tenant = index). The ``default`` entry is
# MANDATORY whenever the table is present: it is what unknown tenants
# (new indexes, forwarded legs with no header) schedule under, so a
# table without it would silently drop them on the floor.

_TENANT_KEYS = ("weight", "concurrency", "queue-depth",
                "max-container-ops", "max-device-bytes", "max-wall",
                "cache-share")

DEFAULT_TENANT = "default"


def validate_tenant_entry(name: str, entry) -> dict:
    """One ``[tenants.<name>]`` table → normalized snake_case dict.
    Fails LOUDLY (ValueError) on unknown keys, non-positive weights,
    or out-of-range shares — a half-parsed QoS table that silently
    drops a ceiling is an isolation hole, not a default."""
    if not isinstance(entry, dict):
        raise ValueError(f"[tenants.{name}]: expected a table,"
                         f" got {type(entry).__name__}")
    unknown = sorted(set(entry) - set(_TENANT_KEYS))
    if unknown:
        raise ValueError(
            f"[tenants.{name}]: unknown key(s) {', '.join(unknown)}"
            f" (valid: {', '.join(_TENANT_KEYS)})")
    out: dict = {}
    if "weight" in entry:
        w = float(entry["weight"])
        if w <= 0:
            raise ValueError(
                f"[tenants.{name}]: weight must be positive, got {w}")
        out["weight"] = w
    for key, attr in (("concurrency", "concurrency"),
                      ("queue-depth", "queue_depth"),
                      ("max-container-ops", "max_container_ops"),
                      ("max-device-bytes", "max_device_bytes")):
        if key in entry:
            v = int(entry[key])
            if v < 0:
                raise ValueError(f"[tenants.{name}]: {key} must be"
                                 f" >= 0 (0 = unlimited), got {v}")
            out[attr] = v
    if "max-wall" in entry:
        v = parse_duration(entry["max-wall"])
        if v < 0:
            raise ValueError(f"[tenants.{name}]: max-wall must be"
                             f" >= 0 (0 = unlimited), got {v}")
        out["max_wall_s"] = v
    if "cache-share" in entry:
        v = float(entry["cache-share"])
        if not 0.0 < v <= 1.0:
            raise ValueError(
                f"[tenants.{name}]: cache-share must be in (0, 1],"
                f" got {v}")
        out["cache_share"] = v
    return out


def parse_tenant_table(table) -> dict[str, dict]:
    """The whole ``[tenants]`` TOML table → {name: normalized dict}.
    A present-but-defaultless table fails loudly."""
    if not isinstance(table, dict):
        raise ValueError("[tenants]: expected a table of tables")
    out = {str(name): validate_tenant_entry(str(name), entry)
           for name, entry in table.items()}
    if out and DEFAULT_TENANT not in out:
        raise ValueError(
            "[tenants]: a 'default' entry is required — it is what"
            " unknown tenants schedule and account under")
    return out


def parse_tenants(raw: str) -> dict[str, dict]:
    """Compact env/flag form of the tenant table (PILOSA_TENANTS /
    --tenants), same key vocabulary as the TOML::

        default:weight=4,concurrency=8;bulk:weight=1,max-wall=2s

    ``;`` separates tenants, ``name:`` starts one, ``,``-separated
    ``key=value`` pairs follow. Same loud validation as the table."""
    table: dict = {}
    for part in str(raw).split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, body = part.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"invalid tenant spec {part!r}: expected"
                f" name:key=value[,key=value...]")
        entry: dict = {}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, eq, v = kv.partition("=")
            if not eq:
                raise ValueError(
                    f"invalid tenant spec {part!r}: {kv!r} is not"
                    f" key=value")
            entry[k.strip()] = v.strip()
        table[name] = entry
    return parse_tenant_table(table)


@dataclass
class TenantsConfig:
    """[tenants] section (sched.tenants; docs/SCHEDULING.md): the
    per-tenant QoS table — weight (second-level stride share within
    each lane), concurrency / queue-depth (per-tenant slot cap and
    queue quota; overflow 429s only that tenant), max-container-ops /
    max-device-bytes / max-wall (slow-query kill ceilings over the
    live cost ledger; 0 = unlimited), cache-share (fraction of the
    result-cache budgets one tenant may occupy). ``table`` maps
    tenant name → normalized entry; empty = every tenant rides the
    built-in default policy."""
    table: dict = field(default_factory=dict)


@dataclass
class MetricsConfig:
    """[metrics] section (obs subsystem): ``enabled`` gates the
    /metrics endpoint, the StatsClient→registry bridge, and the
    runtime collector; ``runtime_interval`` (seconds) paces the
    collector's background sampling; ``accounting`` gates the
    per-query cost ledger (obs.accounting — on by default, plain-int
    increments). ``federate_timeout``/``federate_fanout`` bound the
    cluster-federation fan-out (obs.federate): per-peer scrape
    deadline and max parallel legs."""
    enabled: bool = True
    runtime_interval: float = 10.0
    accounting: bool = True
    federate_timeout: float = 2.0
    federate_fanout: int = 8


def parse_resolutions(raw: str) -> tuple[tuple[float, int], ...]:
    """``"10s:360,1m:720,15m:672"`` → ((10.0, 360), ...) — the metric
    history's (step, ring-capacity) ladder. The store hard-depends on
    finest-first ordering (resolutions[0] drives the sampling guard
    and every window walk assumes steps grow with index), so this IS
    the validation gate: steps must be strictly ascending and every
    capacity positive — a misconfigured ladder fails loudly at load
    instead of serving garbage history to a blinded sentinel."""
    out = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        step_s, _, cap = part.partition(":")
        step, points = parse_duration(step_s), int(cap)
        if step <= 0 or points <= 0:
            raise ValueError(
                f"invalid history resolution {part!r}: step and"
                f" capacity must be positive")
        if out and step <= out[-1][0]:
            raise ValueError(
                f"history resolutions must be strictly ascending"
                f" (finest first): {raw!r}")
        out.append((step, points))
    if not out:
        raise ValueError(f"invalid history resolutions: {raw!r}")
    return tuple(out)


@dataclass
class HistoryConfig:
    """[history] section (obs.history): the embedded on-disk metric
    history. ``resolutions`` is the step:capacity ladder (finest
    first); ``segment_bytes`` × ``segments`` bound each resolution's
    disk ring; ``max_series`` caps the in-memory series count."""
    enabled: bool = True
    resolutions: str = "10s:360,1m:720,15m:672"
    segment_bytes: int = 1 << 20
    segments: int = 8
    max_series: int = 4096


@dataclass
class SentinelConfig:
    """[sentinel] section (obs.sentinel): the regression sentinel.
    ``interval`` paces evaluation; a robust-z rule fires when the
    recent ``window`` median sits ``zscore`` MAD-scaled deviations
    past the trailing ``baseline`` median AND at least ``min_ratio``
    times it; ``manifest`` points at a committed benchmarks/
    MANIFEST.json whose envelope (× ``manifest_tolerance``) live
    medians must stay inside; ``retrip`` rate-limits re-fires per
    series."""
    enabled: bool = True
    interval: float = 30.0
    window: float = 120.0
    baseline: float = 3600.0
    zscore: float = 6.0
    min_points: int = 5
    min_ratio: float = 1.5
    retrip: float = 300.0
    manifest: str = ""
    manifest_tolerance: float = 5.0


@dataclass
class ProfileConfig:
    """[profile] section (obs subsystem): the ALWAYS-ON low-Hz
    continuous wall profiler behind ``GET /debug/pprof/flame``
    (obs.profile). ``continuous`` turns it off entirely; ``hz`` is the
    sampling rate (default 10 — microseconds of work per tick);
    ``ring`` bounds the retained sample count."""
    continuous: bool = True
    hz: float = 10.0
    ring: int = 8192


@dataclass
class SLOConfig:
    """[slo] section (obs subsystem): the latency objective the
    rolling burn rates (obs.slo.SLOTracker) are computed against —
    fraction ``target`` of queries must finish within ``objective``
    seconds."""
    objective: float = 0.25
    target: float = 0.99


@dataclass
class FaultConfig:
    """[fault] section (fault subsystem; docs/FAULT_TOLERANCE.md):
    ``enabled`` gates peer health tracking + circuit breakers;
    ``breaker_threshold`` consecutive transport failures trip a peer's
    breaker open; the open window backs off exponentially from
    ``breaker_backoff`` up to ``breaker_backoff_cap`` with full
    jitter; ``hedge`` (seconds, 0 = off) arms hedged reads — a second
    replica leg fires when the first exceeds max(hedge, the peer's
    p95-ish latency estimate). ``failpoints`` maps injection sites to
    spec strings ([fault.failpoints] in TOML, PILOSA_FAULT_<SITE> in
    the environment); ``seed`` (PILOSA_FAULT_SEED) makes probabilistic
    failpoint schedules replay deterministically."""
    enabled: bool = True
    breaker_threshold: int = 3
    breaker_backoff: float = 0.5
    breaker_backoff_cap: float = 30.0
    hedge: float = 0.0
    failpoints: dict = field(default_factory=dict)
    seed: int = 0


@dataclass
class TraceConfig:
    """[trace] section (obs subsystem): ``enabled`` keeps EVERY
    query's trace (off by default; ``?trace=1`` opts in per request
    either way); ``max_traces``/``max_spans`` bound the per-node ring.

    Tail sampling (on by default — docs/OBSERVABILITY.md): ``tail``
    gives every query the span buffer and keeps the interesting ones
    at query end (slow / errored / deadline / cancelled / partial /
    shed / breaker / failpoint / 1-in-``head_n`` head sample);
    ``slow_floor`` floors the histogram-derived slow threshold. Kept
    traces persist to a disk segment ring under the data dir bounded
    by ``disk_segment_bytes`` × ``disk_segments`` (the retention
    knobs), browsable via /debug/traces?source=disk."""
    enabled: bool = False
    max_traces: int = 64
    max_spans: int = 512
    tail: bool = True
    head_n: int = 1000
    slow_floor: float = 0.1
    disk_segment_bytes: int = 1 << 20
    disk_segments: int = 8


@dataclass
class BlackboxConfig:
    """[blackbox] section (obs.blackbox): the flight recorder.
    ``interval`` paces the periodic whole-system snapshot;
    ``segment_bytes`` × ``segments`` bound the on-disk ring;
    ``dumps`` bounds the retained full-dump files."""
    enabled: bool = True
    interval: float = 10.0
    segment_bytes: int = 256 << 10
    segments: int = 4
    dumps: int = 4


@dataclass
class WatchdogConfig:
    """[watchdog] section (obs.watchdog): the stall watchdog.
    ``interval`` paces the detectors; ``wal_stall`` is the WAL
    dirty-age threshold, ``deadline_grace`` the past-deadline grace
    for running legs, ``gossip_silence`` the membership-silence bound,
    ``queue_stall`` the no-grant-while-queued bound; ``resize_stall``
    the no-progress bound on an elastic resize this node coordinates;
    ``scrub_stall`` the no-progress bound on an in-flight storage
    scrub pass (storage.scrub); ``tier_stall`` the no-progress bound
    while the tier working-set manager has pending work
    (tier.manager); ``backup_stall`` the no-progress bound on an
    in-flight cluster backup this node coordinates (backup
    coordinator); ``retrip`` rate-limits repeat trips per cause
    (0 on any threshold disables that detector)."""
    enabled: bool = True
    interval: float = 1.0
    wal_stall: float = 5.0
    deadline_grace: float = 5.0
    gossip_silence: float = 60.0
    queue_stall: float = 10.0
    resize_stall: float = 60.0
    scrub_stall: float = 300.0
    tier_stall: float = 120.0
    backup_stall: float = 120.0
    retrip: float = 60.0


@dataclass
class ScrubConfig:
    """[scrub] section (storage.scrub): the background storage-
    integrity scrubber. ``interval`` is the pause between passes;
    ``pace`` the sleep between fragments WITHIN a pass (serving
    traffic owns the disk — the scrub breathes); ``repair`` gates the
    automatic replica re-stream of quarantined fragments
    (server.repair); ``repair_rescan`` its rescan/retry cadence."""
    enabled: bool = True
    interval: float = 600.0
    pace: float = 0.01
    repair: bool = True
    repair_rescan: float = 15.0


@dataclass
class TierConfig:
    """[tier] section (tier.manager): the tiered-storage working-set
    manager. ``resident_budget`` is the byte budget for the resident
    (hot + faulted-cold) set — 0 disables watermark eviction;
    ``high_watermark``/``low_watermark`` are the fractions of that
    budget where eviction starts and stops; ``idle`` the no-touch age
    before an open fragment becomes a demotion candidate;
    ``blob_idle`` the additional cold age before a demoted fragment
    is pushed off local disk into the blob store; ``cold_dir`` roots
    the blob staging area and the local-dir blob backend (defaults to
    ``<data-dir>/_tier``); ``blob`` selects the blob backend
    (``""`` = no blob tier, ``dir`` = the local-dir backend standing
    in for object storage); ``interval`` paces the manager loop;
    ``prefetch_interval`` the history-driven prefetcher cadence
    (0 = off); ``pace`` the sleep between per-fragment transitions
    within one pass (serving traffic owns the disk)."""
    enabled: bool = False
    resident_budget: int = 0
    high_watermark: float = 0.9
    low_watermark: float = 0.7
    idle: float = 300.0
    blob_idle: float = 3600.0
    cold_dir: str = ""
    blob: str = ""
    interval: float = 10.0
    prefetch_interval: float = 0.0
    pace: float = 0.01


@dataclass
class CaptureConfig:
    """[capture] section (obs.capture): the workload-capture plane —
    every served query/import appends a replayable record to an
    on-disk segment ring under ``<data>/capture/``. ``mode`` is
    ``off`` | ``sampled`` | ``full``: off is a nop-cost path, sampled
    (the default) records every write/import plus 1-in-``sample-n``
    reads, full records everything. ``segment-bytes`` × ``segments``
    bound the ring (the byte budget). ``redact`` is a comma-separated
    tenant list ("*" = all) whose PQL string/numeric literals are
    replaced with ``?`` before recording."""
    mode: str = "sampled"
    sample_n: int = 16
    segment_bytes: int = 1 << 20
    segments: int = 8
    redact: str = ""


@dataclass
class BackupConfig:
    """[backup] section (backup package): the disaster-recovery
    archive. ``archive`` selects the archive blob backend (same spec
    grammar as ``tier.blob``: ``""`` = no archive, ``dir:<path>`` =
    the local-dir backend standing in for object storage; bare
    ``dir`` roots it at ``<data-dir>/_archive``); ``wal_interval``
    paces the continuous WAL-segment archiver flush (the
    point-in-time-recovery granularity is bounded by it);
    ``keep_fulls`` is the retention floor — GC keeps the newest N
    full backups plus every incremental and WAL segment any of them
    depend on."""
    archive: str = ""
    wal_interval: float = 2.0
    keep_fulls: int = 2


def parse_bool(v) -> bool:
    """The boolean reading of the file, the environment and the flags:
    "0", "false", "no", "off" and "" are false, anything else true."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() not in ("0", "false", "no", "off", "")


@dataclass
class Config:
    data_dir: str = "~/.pilosa"
    host: str = f"{DEFAULT_HOST}:{DEFAULT_PORT}"
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    query: QueryConfig = field(default_factory=QueryConfig)
    tenants: TenantsConfig = field(default_factory=TenantsConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    history: HistoryConfig = field(default_factory=HistoryConfig)
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    blackbox: BlackboxConfig = field(default_factory=BlackboxConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    scrub: ScrubConfig = field(default_factory=ScrubConfig)
    tier: TierConfig = field(default_factory=TierConfig)
    capture: CaptureConfig = field(default_factory=CaptureConfig)
    backup: BackupConfig = field(default_factory=BackupConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)
    anti_entropy_interval: float = DEFAULT_ANTI_ENTROPY_INTERVAL
    log_path: str = ""
    # Accepted and persisted but inert, exactly like the reference at
    # this vintage: config.go:48-50 declares [plugins] path and
    # cmd/server.go:96 flags it, but nothing ever loads a plugin.
    plugins_path: str = ""

    def to_toml(self) -> str:
        hosts = ", ".join(f'"{h}"' for h in self.cluster.hosts)
        internal = ", ".join(f'"{h}"' for h in self.cluster.internal_hosts)
        failpoints = "".join(
            f'"{site}" = "{spec}"\n'
            for site, spec in sorted(self.fault.failpoints.items()))
        if failpoints:
            failpoints = "\n[fault.failpoints]\n" + failpoints
        toml_keys = {"weight": "weight", "concurrency": "concurrency",
                     "queue_depth": "queue-depth",
                     "max_container_ops": "max-container-ops",
                     "max_device_bytes": "max-device-bytes",
                     "max_wall_s": "max-wall",
                     "cache_share": "cache-share"}
        tenants = ""
        for name, entry in sorted(self.tenants.table.items()):
            tenants += f"\n[tenants.{name}]\n"
            for attr, key in toml_keys.items():
                if attr in entry:
                    v = entry[attr]
                    tenants += (f'{key} = "{v}s"\n'
                                if key == "max-wall" else
                                f"{key} = {v}\n")

        def dur(v: float) -> str:
            # Sub-second values must survive the round trip ("0.5s"
            # parses back to 0.5; int-truncation would write "0s",
            # silently disabling the knob).
            return f"{int(v)}s" if v == int(v) else f"{v}s"
        return f"""data-dir = "{self.data_dir}"
host = "{self.host}"
log-path = "{self.log_path}"

[cluster]
replicas = {self.cluster.replica_n}
type = "{self.cluster.type}"
hosts = [{hosts}]
internal-hosts = [{internal}]
polling-interval = "{int(self.cluster.polling_interval)}s"
internal-port = "{self.cluster.internal_port}"
gossip-seed = "{self.cluster.gossip_seed}"
gossip-secret = "{self.cluster.gossip_secret}"
gen-staleness = "{dur(self.cluster.gen_staleness)}"
resize-pace = "{dur(self.cluster.resize_pace)}"
resize-grace = "{dur(self.cluster.resize_grace)}"

[query]
concurrency = {self.query.concurrency}
queue-depth = {self.query.queue_depth}
default-timeout = "{dur(self.query.default_timeout)}"
slow-threshold = "{dur(self.query.slow_threshold)}"
result-cache-entries = {self.query.result_cache_entries}
result-cache-bits = {self.query.result_cache_bits}
cluster-cache-entries = {self.query.cluster_cache_entries}
{tenants}
[metrics]
enabled = {str(self.metrics.enabled).lower()}
runtime-interval = "{dur(self.metrics.runtime_interval)}"
accounting = {str(self.metrics.accounting).lower()}
federate-timeout = "{dur(self.metrics.federate_timeout)}"
federate-fanout = {self.metrics.federate_fanout}

[history]
enabled = {str(self.history.enabled).lower()}
resolutions = "{self.history.resolutions}"
segment-bytes = {self.history.segment_bytes}
segments = {self.history.segments}
max-series = {self.history.max_series}

[sentinel]
enabled = {str(self.sentinel.enabled).lower()}
interval = "{dur(self.sentinel.interval)}"
window = "{dur(self.sentinel.window)}"
baseline = "{dur(self.sentinel.baseline)}"
zscore = {self.sentinel.zscore}
min-points = {self.sentinel.min_points}
min-ratio = {self.sentinel.min_ratio}
retrip = "{dur(self.sentinel.retrip)}"
manifest = "{self.sentinel.manifest}"
manifest-tolerance = {self.sentinel.manifest_tolerance}

[trace]
enabled = {str(self.trace.enabled).lower()}
max-traces = {self.trace.max_traces}
max-spans = {self.trace.max_spans}
tail = {str(self.trace.tail).lower()}
head-n = {self.trace.head_n}
slow-floor = "{dur(self.trace.slow_floor)}"
disk-segment-bytes = {self.trace.disk_segment_bytes}
disk-segments = {self.trace.disk_segments}

[blackbox]
enabled = {str(self.blackbox.enabled).lower()}
interval = "{dur(self.blackbox.interval)}"
segment-bytes = {self.blackbox.segment_bytes}
segments = {self.blackbox.segments}
dumps = {self.blackbox.dumps}

[watchdog]
enabled = {str(self.watchdog.enabled).lower()}
interval = "{dur(self.watchdog.interval)}"
wal-stall = "{dur(self.watchdog.wal_stall)}"
deadline-grace = "{dur(self.watchdog.deadline_grace)}"
gossip-silence = "{dur(self.watchdog.gossip_silence)}"
queue-stall = "{dur(self.watchdog.queue_stall)}"
resize-stall = "{dur(self.watchdog.resize_stall)}"
scrub-stall = "{dur(self.watchdog.scrub_stall)}"
tier-stall = "{dur(self.watchdog.tier_stall)}"
backup-stall = "{dur(self.watchdog.backup_stall)}"
retrip = "{dur(self.watchdog.retrip)}"

[scrub]
enabled = {str(self.scrub.enabled).lower()}
interval = "{dur(self.scrub.interval)}"
pace = "{dur(self.scrub.pace)}"
repair = {str(self.scrub.repair).lower()}
repair-rescan = "{dur(self.scrub.repair_rescan)}"

[tier]
enabled = {str(self.tier.enabled).lower()}
resident-budget = {self.tier.resident_budget}
high-watermark = {self.tier.high_watermark}
low-watermark = {self.tier.low_watermark}
idle = "{dur(self.tier.idle)}"
blob-idle = "{dur(self.tier.blob_idle)}"
cold-dir = "{self.tier.cold_dir}"
blob = "{self.tier.blob}"
interval = "{dur(self.tier.interval)}"
prefetch-interval = "{dur(self.tier.prefetch_interval)}"
pace = "{dur(self.tier.pace)}"

[capture]
mode = "{self.capture.mode}"
sample-n = {self.capture.sample_n}
segment-bytes = {self.capture.segment_bytes}
segments = {self.capture.segments}
redact = "{self.capture.redact}"

[backup]
archive = "{self.backup.archive}"
wal-interval = "{dur(self.backup.wal_interval)}"
keep-fulls = {self.backup.keep_fulls}

[profile]
continuous = {str(self.profile.continuous).lower()}
hz = {self.profile.hz}
ring = {self.profile.ring}

[slo]
objective = "{dur(self.slo.objective)}"
target = {self.slo.target}

[fault]
enabled = {str(self.fault.enabled).lower()}
breaker-threshold = {self.fault.breaker_threshold}
breaker-backoff = "{dur(self.fault.breaker_backoff)}"
breaker-backoff-cap = "{dur(self.fault.breaker_backoff_cap)}"
hedge = "{dur(self.fault.hedge)}"
seed = {self.fault.seed}
{failpoints}
[plugins]
path = "{self.plugins_path}"

[anti-entropy]
interval = "{int(self.anti_entropy_interval)}s"
"""


def load(path: str = "", env: dict | None = None) -> Config:
    """Defaults ← TOML file ← PILOSA_* env (cmd/root.go:99-153)."""
    cfg = Config()
    if path:
        with open(path, "rb") as f:
            data = tomllib.load(f)
        cfg.data_dir = data.get("data-dir", cfg.data_dir)
        cfg.host = data.get("host", cfg.host)
        cfg.log_path = data.get("log-path", cfg.log_path)
        cl = data.get("cluster", {})
        cfg.cluster.replica_n = int(cl.get("replicas",
                                           cfg.cluster.replica_n))
        cfg.cluster.type = cl.get("type", cfg.cluster.type)
        cfg.cluster.hosts = list(cl.get("hosts", cfg.cluster.hosts))
        cfg.cluster.internal_hosts = list(
            cl.get("internal-hosts", cfg.cluster.internal_hosts))
        if "polling-interval" in cl:
            cfg.cluster.polling_interval = parse_duration(
                cl["polling-interval"])
        cfg.cluster.internal_port = str(cl.get("internal-port",
                                               cfg.cluster.internal_port))
        cfg.cluster.gossip_seed = cl.get("gossip-seed",
                                         cfg.cluster.gossip_seed)
        cfg.cluster.gossip_secret = cl.get("gossip-secret",
                                           cfg.cluster.gossip_secret)
        if "gen-staleness" in cl:
            cfg.cluster.gen_staleness = parse_duration(
                cl["gen-staleness"])
        if "resize-pace" in cl:
            cfg.cluster.resize_pace = parse_duration(cl["resize-pace"])
        if "resize-grace" in cl:
            cfg.cluster.resize_grace = parse_duration(
                cl["resize-grace"])
        ae = data.get("anti-entropy", {})
        if "interval" in ae:
            cfg.anti_entropy_interval = parse_duration(ae["interval"])
        q = data.get("query", {})
        cfg.query.concurrency = int(q.get("concurrency",
                                          cfg.query.concurrency))
        cfg.query.queue_depth = int(q.get("queue-depth",
                                          cfg.query.queue_depth))
        if "default-timeout" in q:
            cfg.query.default_timeout = parse_duration(
                q["default-timeout"])
        if "slow-threshold" in q:
            cfg.query.slow_threshold = parse_duration(
                q["slow-threshold"])
        cfg.query.result_cache_entries = int(q.get(
            "result-cache-entries", cfg.query.result_cache_entries))
        cfg.query.result_cache_bits = int(q.get(
            "result-cache-bits", cfg.query.result_cache_bits))
        cfg.query.cluster_cache_entries = int(q.get(
            "cluster-cache-entries", cfg.query.cluster_cache_entries))
        if "tenants" in data:
            cfg.tenants.table = parse_tenant_table(data["tenants"])
        m = data.get("metrics", {})
        if "enabled" in m:
            cfg.metrics.enabled = parse_bool(m["enabled"])
        if "runtime-interval" in m:
            cfg.metrics.runtime_interval = parse_duration(
                m["runtime-interval"])
        if "accounting" in m:
            cfg.metrics.accounting = parse_bool(m["accounting"])
        if "federate-timeout" in m:
            cfg.metrics.federate_timeout = parse_duration(
                m["federate-timeout"])
        if "federate-fanout" in m:
            cfg.metrics.federate_fanout = int(m["federate-fanout"])
        hs = data.get("history", {})
        if "enabled" in hs:
            cfg.history.enabled = parse_bool(hs["enabled"])
        if "resolutions" in hs:
            parse_resolutions(hs["resolutions"])  # validate at load
            cfg.history.resolutions = str(hs["resolutions"])
        if "segment-bytes" in hs:
            cfg.history.segment_bytes = int(hs["segment-bytes"])
        if "segments" in hs:
            cfg.history.segments = int(hs["segments"])
        if "max-series" in hs:
            cfg.history.max_series = int(hs["max-series"])
        sn = data.get("sentinel", {})
        if "enabled" in sn:
            cfg.sentinel.enabled = parse_bool(sn["enabled"])
        for key, attr in (("interval", "interval"),
                          ("window", "window"),
                          ("baseline", "baseline"),
                          ("retrip", "retrip")):
            if key in sn:
                setattr(cfg.sentinel, attr, parse_duration(sn[key]))
        if "zscore" in sn:
            cfg.sentinel.zscore = float(sn["zscore"])
        if "min-points" in sn:
            cfg.sentinel.min_points = int(sn["min-points"])
        if "min-ratio" in sn:
            cfg.sentinel.min_ratio = float(sn["min-ratio"])
        if "manifest" in sn:
            cfg.sentinel.manifest = str(sn["manifest"])
        if "manifest-tolerance" in sn:
            cfg.sentinel.manifest_tolerance = float(
                sn["manifest-tolerance"])
        t = data.get("trace", {})
        if "enabled" in t:
            cfg.trace.enabled = parse_bool(t["enabled"])
        if "max-traces" in t:
            cfg.trace.max_traces = int(t["max-traces"])
        if "max-spans" in t:
            cfg.trace.max_spans = int(t["max-spans"])
        if "tail" in t:
            cfg.trace.tail = parse_bool(t["tail"])
        if "head-n" in t:
            cfg.trace.head_n = int(t["head-n"])
        if "slow-floor" in t:
            cfg.trace.slow_floor = parse_duration(t["slow-floor"])
        if "disk-segment-bytes" in t:
            cfg.trace.disk_segment_bytes = int(t["disk-segment-bytes"])
        if "disk-segments" in t:
            cfg.trace.disk_segments = int(t["disk-segments"])
        bb = data.get("blackbox", {})
        if "enabled" in bb:
            cfg.blackbox.enabled = parse_bool(bb["enabled"])
        if "interval" in bb:
            cfg.blackbox.interval = parse_duration(bb["interval"])
        if "segment-bytes" in bb:
            cfg.blackbox.segment_bytes = int(bb["segment-bytes"])
        if "segments" in bb:
            cfg.blackbox.segments = int(bb["segments"])
        if "dumps" in bb:
            cfg.blackbox.dumps = int(bb["dumps"])
        wd = data.get("watchdog", {})
        if "enabled" in wd:
            cfg.watchdog.enabled = parse_bool(wd["enabled"])
        for key, attr in (("interval", "interval"),
                          ("wal-stall", "wal_stall"),
                          ("deadline-grace", "deadline_grace"),
                          ("gossip-silence", "gossip_silence"),
                          ("queue-stall", "queue_stall"),
                          ("resize-stall", "resize_stall"),
                          ("scrub-stall", "scrub_stall"),
                          ("tier-stall", "tier_stall"),
                          ("backup-stall", "backup_stall"),
                          ("retrip", "retrip")):
            if key in wd:
                setattr(cfg.watchdog, attr, parse_duration(wd[key]))
        sc = data.get("scrub", {})
        if "enabled" in sc:
            cfg.scrub.enabled = parse_bool(sc["enabled"])
        if "interval" in sc:
            cfg.scrub.interval = parse_duration(sc["interval"])
        if "pace" in sc:
            cfg.scrub.pace = parse_duration(sc["pace"])
        if "repair" in sc:
            cfg.scrub.repair = parse_bool(sc["repair"])
        if "repair-rescan" in sc:
            cfg.scrub.repair_rescan = parse_duration(sc["repair-rescan"])
        ti = data.get("tier", {})
        if "enabled" in ti:
            cfg.tier.enabled = parse_bool(ti["enabled"])
        if "resident-budget" in ti:
            cfg.tier.resident_budget = int(ti["resident-budget"])
        if "high-watermark" in ti:
            cfg.tier.high_watermark = float(ti["high-watermark"])
        if "low-watermark" in ti:
            cfg.tier.low_watermark = float(ti["low-watermark"])
        for key, attr in (("idle", "idle"),
                          ("blob-idle", "blob_idle"),
                          ("interval", "interval"),
                          ("prefetch-interval", "prefetch_interval"),
                          ("pace", "pace")):
            if key in ti:
                setattr(cfg.tier, attr, parse_duration(ti[key]))
        if "cold-dir" in ti:
            cfg.tier.cold_dir = str(ti["cold-dir"])
        if "blob" in ti:
            cfg.tier.blob = str(ti["blob"])
        cp = data.get("capture", {})
        if "mode" in cp:
            cfg.capture.mode = str(cp["mode"])
        if "sample-n" in cp:
            cfg.capture.sample_n = int(cp["sample-n"])
        if "segment-bytes" in cp:
            cfg.capture.segment_bytes = int(cp["segment-bytes"])
        if "segments" in cp:
            cfg.capture.segments = int(cp["segments"])
        if "redact" in cp:
            cfg.capture.redact = str(cp["redact"])
        bu = data.get("backup", {})
        if "archive" in bu:
            cfg.backup.archive = str(bu["archive"])
        if "wal-interval" in bu:
            cfg.backup.wal_interval = parse_duration(bu["wal-interval"])
        if "keep-fulls" in bu:
            cfg.backup.keep_fulls = int(bu["keep-fulls"])
        p = data.get("profile", {})
        if "continuous" in p:
            cfg.profile.continuous = parse_bool(p["continuous"])
        if "hz" in p:
            cfg.profile.hz = float(p["hz"])
        if "ring" in p:
            cfg.profile.ring = int(p["ring"])
        s = data.get("slo", {})
        if "objective" in s:
            cfg.slo.objective = parse_duration(s["objective"])
        if "target" in s:
            cfg.slo.target = float(s["target"])
        fl = data.get("fault", {})
        if "enabled" in fl:
            cfg.fault.enabled = parse_bool(fl["enabled"])
        if "breaker-threshold" in fl:
            cfg.fault.breaker_threshold = int(fl["breaker-threshold"])
        if "breaker-backoff" in fl:
            cfg.fault.breaker_backoff = parse_duration(
                fl["breaker-backoff"])
        if "breaker-backoff-cap" in fl:
            cfg.fault.breaker_backoff_cap = parse_duration(
                fl["breaker-backoff-cap"])
        if "hedge" in fl:
            cfg.fault.hedge = parse_duration(fl["hedge"])
        if "seed" in fl:
            cfg.fault.seed = int(fl["seed"])
        for site, spec in (fl.get("failpoints") or {}).items():
            cfg.fault.failpoints[str(site)] = str(spec)
        cfg.plugins_path = data.get("plugins", {}).get(
            "path", cfg.plugins_path)
    env = os.environ if env is None else env
    if env.get("PILOSA_DATA_DIR"):
        cfg.data_dir = env["PILOSA_DATA_DIR"]
    if env.get("PILOSA_HOST"):
        cfg.host = env["PILOSA_HOST"]
    if env.get("PILOSA_CLUSTER_TYPE"):
        cfg.cluster.type = env["PILOSA_CLUSTER_TYPE"]
    if env.get("PILOSA_CLUSTER_HOSTS"):
        cfg.cluster.hosts = [h.strip() for h in
                             env["PILOSA_CLUSTER_HOSTS"].split(",")
                             if h.strip()]
    if env.get("PILOSA_CLUSTER_REPLICAS"):
        cfg.cluster.replica_n = int(env["PILOSA_CLUSTER_REPLICAS"])
    if env.get("PILOSA_CLUSTER_INTERNAL_PORT"):
        cfg.cluster.internal_port = env["PILOSA_CLUSTER_INTERNAL_PORT"]
    if env.get("PILOSA_CLUSTER_GOSSIP_SEED"):
        cfg.cluster.gossip_seed = env["PILOSA_CLUSTER_GOSSIP_SEED"]
    if env.get("PILOSA_CLUSTER_GOSSIP_SECRET"):
        cfg.cluster.gossip_secret = env["PILOSA_CLUSTER_GOSSIP_SECRET"]
    if env.get("PILOSA_CLUSTER_INTERNAL_HOSTS"):
        cfg.cluster.internal_hosts = [
            h.strip() for h in
            env["PILOSA_CLUSTER_INTERNAL_HOSTS"].split(",") if h.strip()]
    if env.get("PILOSA_CLUSTER_POLL_INTERVAL"):
        cfg.cluster.polling_interval = parse_duration(
            env["PILOSA_CLUSTER_POLL_INTERVAL"])
    if env.get("PILOSA_LOG_PATH"):
        cfg.log_path = env["PILOSA_LOG_PATH"]
    if env.get("PILOSA_ANTI_ENTROPY_INTERVAL"):
        cfg.anti_entropy_interval = parse_duration(
            env["PILOSA_ANTI_ENTROPY_INTERVAL"])
    if env.get("PILOSA_QUERY_CONCURRENCY"):
        cfg.query.concurrency = int(env["PILOSA_QUERY_CONCURRENCY"])
    if env.get("PILOSA_QUERY_QUEUE_DEPTH"):
        cfg.query.queue_depth = int(env["PILOSA_QUERY_QUEUE_DEPTH"])
    if env.get("PILOSA_QUERY_DEFAULT_TIMEOUT"):
        cfg.query.default_timeout = parse_duration(
            env["PILOSA_QUERY_DEFAULT_TIMEOUT"])
    if env.get("PILOSA_QUERY_SLOW_THRESHOLD"):
        cfg.query.slow_threshold = parse_duration(
            env["PILOSA_QUERY_SLOW_THRESHOLD"])
    if env.get("PILOSA_QUERY_RESULT_CACHE_ENTRIES"):
        cfg.query.result_cache_entries = int(
            env["PILOSA_QUERY_RESULT_CACHE_ENTRIES"])
    if env.get("PILOSA_QUERY_RESULT_CACHE_BITS"):
        cfg.query.result_cache_bits = int(
            env["PILOSA_QUERY_RESULT_CACHE_BITS"])
    if env.get("PILOSA_QUERY_CLUSTER_CACHE_ENTRIES"):
        cfg.query.cluster_cache_entries = int(
            env["PILOSA_QUERY_CLUSTER_CACHE_ENTRIES"])
    if env.get("PILOSA_TENANTS"):
        cfg.tenants.table = parse_tenants(env["PILOSA_TENANTS"])
    if env.get("PILOSA_CLUSTER_GEN_STALENESS"):
        # Bare numbers accepted too (the executor's direct env read
        # takes them; the two entry points must not diverge).
        raw = env["PILOSA_CLUSTER_GEN_STALENESS"]
        try:
            cfg.cluster.gen_staleness = float(raw)
        except ValueError:
            cfg.cluster.gen_staleness = parse_duration(raw)
    if env.get("PILOSA_CLUSTER_RESIZE_PACE"):
        cfg.cluster.resize_pace = parse_duration(
            env["PILOSA_CLUSTER_RESIZE_PACE"])
    if env.get("PILOSA_CLUSTER_RESIZE_GRACE"):
        cfg.cluster.resize_grace = parse_duration(
            env["PILOSA_CLUSTER_RESIZE_GRACE"])
    if env.get("PILOSA_METRICS_ENABLED"):
        cfg.metrics.enabled = parse_bool(env["PILOSA_METRICS_ENABLED"])
    if env.get("PILOSA_METRICS_RUNTIME_INTERVAL"):
        cfg.metrics.runtime_interval = parse_duration(
            env["PILOSA_METRICS_RUNTIME_INTERVAL"])
    if env.get("PILOSA_METRICS_ACCOUNTING"):
        cfg.metrics.accounting = parse_bool(
            env["PILOSA_METRICS_ACCOUNTING"])
    if env.get("PILOSA_METRICS_FEDERATE_TIMEOUT"):
        cfg.metrics.federate_timeout = parse_duration(
            env["PILOSA_METRICS_FEDERATE_TIMEOUT"])
    if env.get("PILOSA_METRICS_FEDERATE_FANOUT"):
        cfg.metrics.federate_fanout = int(
            env["PILOSA_METRICS_FEDERATE_FANOUT"])
    if env.get("PILOSA_HISTORY_ENABLED"):
        cfg.history.enabled = parse_bool(env["PILOSA_HISTORY_ENABLED"])
    if env.get("PILOSA_HISTORY_RESOLUTIONS"):
        parse_resolutions(env["PILOSA_HISTORY_RESOLUTIONS"])
        cfg.history.resolutions = env["PILOSA_HISTORY_RESOLUTIONS"]
    if env.get("PILOSA_HISTORY_SEGMENT_BYTES"):
        cfg.history.segment_bytes = int(
            env["PILOSA_HISTORY_SEGMENT_BYTES"])
    if env.get("PILOSA_HISTORY_SEGMENTS"):
        cfg.history.segments = int(env["PILOSA_HISTORY_SEGMENTS"])
    if env.get("PILOSA_HISTORY_MAX_SERIES"):
        cfg.history.max_series = int(env["PILOSA_HISTORY_MAX_SERIES"])
    if env.get("PILOSA_SENTINEL_ENABLED"):
        cfg.sentinel.enabled = parse_bool(
            env["PILOSA_SENTINEL_ENABLED"])
    for env_key_, attr_ in (("PILOSA_SENTINEL_INTERVAL", "interval"),
                            ("PILOSA_SENTINEL_WINDOW", "window"),
                            ("PILOSA_SENTINEL_BASELINE", "baseline"),
                            ("PILOSA_SENTINEL_RETRIP", "retrip")):
        if env.get(env_key_):
            setattr(cfg.sentinel, attr_, parse_duration(env[env_key_]))
    if env.get("PILOSA_SENTINEL_ZSCORE"):
        cfg.sentinel.zscore = float(env["PILOSA_SENTINEL_ZSCORE"])
    if env.get("PILOSA_SENTINEL_MIN_POINTS"):
        cfg.sentinel.min_points = int(env["PILOSA_SENTINEL_MIN_POINTS"])
    if env.get("PILOSA_SENTINEL_MIN_RATIO"):
        cfg.sentinel.min_ratio = float(env["PILOSA_SENTINEL_MIN_RATIO"])
    if env.get("PILOSA_SENTINEL_MANIFEST"):
        cfg.sentinel.manifest = env["PILOSA_SENTINEL_MANIFEST"]
    if env.get("PILOSA_SENTINEL_MANIFEST_TOLERANCE"):
        cfg.sentinel.manifest_tolerance = float(
            env["PILOSA_SENTINEL_MANIFEST_TOLERANCE"])
    if env.get("PILOSA_PROFILE_CONTINUOUS"):
        cfg.profile.continuous = parse_bool(
            env["PILOSA_PROFILE_CONTINUOUS"])
    if env.get("PILOSA_PROFILE_HZ"):
        cfg.profile.hz = float(env["PILOSA_PROFILE_HZ"])
    if env.get("PILOSA_PROFILE_RING"):
        cfg.profile.ring = int(env["PILOSA_PROFILE_RING"])
    if env.get("PILOSA_SLO_OBJECTIVE"):
        cfg.slo.objective = parse_duration(env["PILOSA_SLO_OBJECTIVE"])
    if env.get("PILOSA_SLO_TARGET"):
        cfg.slo.target = float(env["PILOSA_SLO_TARGET"])
    if env.get("PILOSA_TRACE_ENABLED"):
        cfg.trace.enabled = parse_bool(env["PILOSA_TRACE_ENABLED"])
    if env.get("PILOSA_TRACE_MAX_TRACES"):
        cfg.trace.max_traces = int(env["PILOSA_TRACE_MAX_TRACES"])
    if env.get("PILOSA_TRACE_MAX_SPANS"):
        cfg.trace.max_spans = int(env["PILOSA_TRACE_MAX_SPANS"])
    if env.get("PILOSA_TRACE_TAIL"):
        cfg.trace.tail = parse_bool(env["PILOSA_TRACE_TAIL"])
    if env.get("PILOSA_TRACE_HEAD_N"):
        cfg.trace.head_n = int(env["PILOSA_TRACE_HEAD_N"])
    if env.get("PILOSA_TRACE_SLOW_FLOOR"):
        cfg.trace.slow_floor = parse_duration(
            env["PILOSA_TRACE_SLOW_FLOOR"])
    if env.get("PILOSA_TRACE_DISK_SEGMENT_BYTES"):
        cfg.trace.disk_segment_bytes = int(
            env["PILOSA_TRACE_DISK_SEGMENT_BYTES"])
    if env.get("PILOSA_TRACE_DISK_SEGMENTS"):
        cfg.trace.disk_segments = int(env["PILOSA_TRACE_DISK_SEGMENTS"])
    if env.get("PILOSA_BLACKBOX_ENABLED"):
        cfg.blackbox.enabled = parse_bool(env["PILOSA_BLACKBOX_ENABLED"])
    if env.get("PILOSA_BLACKBOX_INTERVAL"):
        cfg.blackbox.interval = parse_duration(
            env["PILOSA_BLACKBOX_INTERVAL"])
    if env.get("PILOSA_BLACKBOX_SEGMENT_BYTES"):
        cfg.blackbox.segment_bytes = int(
            env["PILOSA_BLACKBOX_SEGMENT_BYTES"])
    if env.get("PILOSA_BLACKBOX_SEGMENTS"):
        cfg.blackbox.segments = int(env["PILOSA_BLACKBOX_SEGMENTS"])
    if env.get("PILOSA_BLACKBOX_DUMPS"):
        cfg.blackbox.dumps = int(env["PILOSA_BLACKBOX_DUMPS"])
    if env.get("PILOSA_WATCHDOG_ENABLED"):
        cfg.watchdog.enabled = parse_bool(env["PILOSA_WATCHDOG_ENABLED"])
    for env_key_, attr_ in (("PILOSA_WATCHDOG_INTERVAL", "interval"),
                            ("PILOSA_WATCHDOG_WAL_STALL", "wal_stall"),
                            ("PILOSA_WATCHDOG_DEADLINE_GRACE",
                             "deadline_grace"),
                            ("PILOSA_WATCHDOG_GOSSIP_SILENCE",
                             "gossip_silence"),
                            ("PILOSA_WATCHDOG_QUEUE_STALL",
                             "queue_stall"),
                            ("PILOSA_WATCHDOG_RESIZE_STALL",
                             "resize_stall"),
                            ("PILOSA_WATCHDOG_SCRUB_STALL",
                             "scrub_stall"),
                            ("PILOSA_WATCHDOG_TIER_STALL",
                             "tier_stall"),
                            ("PILOSA_WATCHDOG_BACKUP_STALL",
                             "backup_stall"),
                            ("PILOSA_WATCHDOG_RETRIP", "retrip")):
        if env.get(env_key_):
            setattr(cfg.watchdog, attr_, parse_duration(env[env_key_]))
    if env.get("PILOSA_SCRUB_ENABLED"):
        cfg.scrub.enabled = parse_bool(env["PILOSA_SCRUB_ENABLED"])
    if env.get("PILOSA_SCRUB_INTERVAL"):
        cfg.scrub.interval = parse_duration(env["PILOSA_SCRUB_INTERVAL"])
    if env.get("PILOSA_SCRUB_PACE"):
        cfg.scrub.pace = parse_duration(env["PILOSA_SCRUB_PACE"])
    if env.get("PILOSA_SCRUB_REPAIR"):
        cfg.scrub.repair = parse_bool(env["PILOSA_SCRUB_REPAIR"])
    if env.get("PILOSA_SCRUB_REPAIR_RESCAN"):
        cfg.scrub.repair_rescan = parse_duration(
            env["PILOSA_SCRUB_REPAIR_RESCAN"])
    if env.get("PILOSA_TIER_ENABLED"):
        cfg.tier.enabled = parse_bool(env["PILOSA_TIER_ENABLED"])
    if env.get("PILOSA_TIER_RESIDENT_BUDGET"):
        cfg.tier.resident_budget = int(env["PILOSA_TIER_RESIDENT_BUDGET"])
    if env.get("PILOSA_TIER_HIGH_WATERMARK"):
        cfg.tier.high_watermark = float(env["PILOSA_TIER_HIGH_WATERMARK"])
    if env.get("PILOSA_TIER_LOW_WATERMARK"):
        cfg.tier.low_watermark = float(env["PILOSA_TIER_LOW_WATERMARK"])
    for env_key_, attr_ in (("PILOSA_TIER_IDLE", "idle"),
                            ("PILOSA_TIER_BLOB_IDLE", "blob_idle"),
                            ("PILOSA_TIER_INTERVAL", "interval"),
                            ("PILOSA_TIER_PREFETCH_INTERVAL",
                             "prefetch_interval"),
                            ("PILOSA_TIER_PACE", "pace")):
        if env.get(env_key_):
            setattr(cfg.tier, attr_, parse_duration(env[env_key_]))
    if env.get("PILOSA_TIER_COLD_DIR"):
        cfg.tier.cold_dir = env["PILOSA_TIER_COLD_DIR"]
    if env.get("PILOSA_TIER_BLOB"):
        cfg.tier.blob = env["PILOSA_TIER_BLOB"]
    if env.get("PILOSA_CAPTURE_MODE"):
        cfg.capture.mode = env["PILOSA_CAPTURE_MODE"]
    if env.get("PILOSA_CAPTURE_SAMPLE_N"):
        cfg.capture.sample_n = int(env["PILOSA_CAPTURE_SAMPLE_N"])
    if env.get("PILOSA_CAPTURE_SEGMENT_BYTES"):
        cfg.capture.segment_bytes = int(
            env["PILOSA_CAPTURE_SEGMENT_BYTES"])
    if env.get("PILOSA_CAPTURE_SEGMENTS"):
        cfg.capture.segments = int(env["PILOSA_CAPTURE_SEGMENTS"])
    if env.get("PILOSA_CAPTURE_REDACT"):
        cfg.capture.redact = env["PILOSA_CAPTURE_REDACT"]
    if env.get("PILOSA_BACKUP_ARCHIVE"):
        cfg.backup.archive = env["PILOSA_BACKUP_ARCHIVE"]
    if env.get("PILOSA_BACKUP_WAL_INTERVAL"):
        cfg.backup.wal_interval = parse_duration(
            env["PILOSA_BACKUP_WAL_INTERVAL"])
    if env.get("PILOSA_BACKUP_KEEP_FULLS"):
        cfg.backup.keep_fulls = int(env["PILOSA_BACKUP_KEEP_FULLS"])
    if env.get("PILOSA_PLUGINS_PATH"):
        cfg.plugins_path = env["PILOSA_PLUGINS_PATH"]
    if env.get("PILOSA_FAULT_ENABLED"):
        cfg.fault.enabled = parse_bool(env["PILOSA_FAULT_ENABLED"])
    if env.get("PILOSA_FAULT_BREAKER_THRESHOLD"):
        cfg.fault.breaker_threshold = int(
            env["PILOSA_FAULT_BREAKER_THRESHOLD"])
    if env.get("PILOSA_FAULT_BREAKER_BACKOFF"):
        cfg.fault.breaker_backoff = parse_duration(
            env["PILOSA_FAULT_BREAKER_BACKOFF"])
    if env.get("PILOSA_FAULT_BREAKER_BACKOFF_CAP"):
        cfg.fault.breaker_backoff_cap = parse_duration(
            env["PILOSA_FAULT_BREAKER_BACKOFF_CAP"])
    if env.get("PILOSA_FAULT_HEDGE"):
        cfg.fault.hedge = parse_duration(env["PILOSA_FAULT_HEDGE"])
    if env.get("PILOSA_FAULT_SEED"):
        cfg.fault.seed = int(env["PILOSA_FAULT_SEED"])
    # Failpoint arming: PILOSA_FAULT_<SITE> via the canonical site
    # list + env-key mapping owned by fault.failpoints, so a newly
    # added site cannot silently drift out of env arming and the
    # reserved knobs above never collide (runtime import: failpoints
    # imports parse_duration from here).
    from ..fault.failpoints import SITES as _fp_sites
    from ..fault.failpoints import env_key as _fp_env_key
    for site in _fp_sites:
        if env.get(_fp_env_key(site)):
            cfg.fault.failpoints[site] = env[_fp_env_key(site)]
    return cfg


# The subsystems of the JAX package that this package does not run yet:
# (section, switched on, the slice of ROADMAP.md's queue 1 that brings
# it). The JAX default leaves it off.
UNPORTED = (
    ("backup", lambda c: bool(c.backup.archive),
     "item 7, the backup slice"),
)


def unported_switch_ons(cfg: Config) -> list[str]:
    """One message for each unported subsystem ``cfg`` switches on (a
    ``[backup] archive``), naming its slice; the server verb refuses to
    start on any."""
    return [f"[{section}] is not available in this package yet"
            f" ({slice_name})"
            for section, on, slice_name in UNPORTED if on(cfg)]

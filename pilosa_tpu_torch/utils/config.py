"""The query lifecycle's configuration: durations, tenants, admission
and tracing.

The part of the JAX package's ``utils/config.py`` (reference config.go)
that a ``Server`` takes for the sched, obs, cluster and storage-integrity
subsystems: the Go-style duration parser behind ``?timeout=``, the
mandatory ``default`` tenant and the ``[tenants]`` table's validation,
the ``[query]``, ``[tenants]``, ``[trace]``, ``[scrub]`` and
``[cluster]`` sections as dataclasses with the JAX package's defaults,
and the ``PILOSA_TRACE_*`` / ``PILOSA_SCRUB_*`` environment keys that
the JAX ``load()`` reads for the ``[trace]`` and ``[scrub]`` sections
(``apply_env``). The TOML loader and the other sections' overlays wait
for the operator slice.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


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


# Query lifecycle defaults (sched subsystem).
DEFAULT_QUERY_CONCURRENCY = 16
DEFAULT_QUERY_QUEUE_DEPTH = 64


@dataclass
class QueryConfig:
    """[query] section: concurrency/queue_depth bound the admission
    controller (overflow answers 429); default_timeout (seconds, 0 =
    none) applies when a request carries neither ?timeout= nor
    X-Pilosa-Deadline; slow_threshold (seconds, 0 = disabled) arms the
    slow-query log."""
    concurrency: int = DEFAULT_QUERY_CONCURRENCY
    queue_depth: int = DEFAULT_QUERY_QUEUE_DEPTH
    default_timeout: float = 0.0
    slow_threshold: float = 0.0


# -- [tenants]: per-tenant QoS (sched.tenants) -------------------------------
# One sub-table per tenant (tenant = index). The ``default`` entry is
# MANDATORY whenever the table is present: it is what unknown tenants
# (new indexes, requests with no header) schedule under.

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
    """The whole ``[tenants]`` table → {name: normalized dict}. A
    present-but-defaultless table fails loudly."""
    if not isinstance(table, dict):
        raise ValueError("[tenants]: expected a table of tables")
    out = {str(name): validate_tenant_entry(str(name), entry)
           for name, entry in table.items()}
    if out and DEFAULT_TENANT not in out:
        raise ValueError(
            "[tenants]: a 'default' entry is required — it is what"
            " unknown tenants schedule and account under")
    return out


@dataclass
class TenantsConfig:
    """[tenants] section (sched.tenants): ``table`` maps tenant name →
    normalized entry (parse_tenant_table); empty = every tenant rides
    the built-in default policy."""
    table: dict = field(default_factory=dict)


@dataclass
class TraceConfig:
    """[trace] section (obs subsystem): ``enabled`` keeps EVERY
    query's trace (off by default; ``?trace=1`` opts in per request
    either way); ``max_traces``/``max_spans`` bound the per-node ring.

    Tail sampling (on by default): ``tail`` gives every query the span
    buffer and keeps the interesting ones at query end (slow / errored /
    deadline / cancelled / partial / shed / breaker / failpoint /
    1-in-``head_n`` head sample); ``slow_floor`` floors the
    histogram-derived slow threshold. Kept traces persist to a disk
    segment ring under the data dir bounded by ``disk_segment_bytes`` ×
    ``disk_segments``, browsable via /debug/traces?source=disk."""
    enabled: bool = False
    max_traces: int = 64
    max_spans: int = 512
    tail: bool = True
    head_n: int = 1000
    slow_floor: float = 0.1
    disk_segment_bytes: int = 1 << 20
    disk_segments: int = 8


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


def parse_bool(v) -> bool:
    """The JAX config's boolean reading: "0", "false", "no", "off" and
    "" are false, anything else true."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() not in ("0", "false", "no", "off", "")


def apply_env(trace: TraceConfig, scrub: ScrubConfig,
              env: dict) -> None:
    """Overlay the ``PILOSA_TRACE_*`` and ``PILOSA_SCRUB_*`` keys of
    ``env`` onto the two sections, as the JAX package's ``load()`` does
    (a key that is absent or empty leaves the default)."""
    if env.get("PILOSA_TRACE_ENABLED"):
        trace.enabled = parse_bool(env["PILOSA_TRACE_ENABLED"])
    if env.get("PILOSA_TRACE_MAX_TRACES"):
        trace.max_traces = int(env["PILOSA_TRACE_MAX_TRACES"])
    if env.get("PILOSA_TRACE_MAX_SPANS"):
        trace.max_spans = int(env["PILOSA_TRACE_MAX_SPANS"])
    if env.get("PILOSA_TRACE_TAIL"):
        trace.tail = parse_bool(env["PILOSA_TRACE_TAIL"])
    if env.get("PILOSA_TRACE_HEAD_N"):
        trace.head_n = int(env["PILOSA_TRACE_HEAD_N"])
    if env.get("PILOSA_TRACE_SLOW_FLOOR"):
        trace.slow_floor = parse_duration(env["PILOSA_TRACE_SLOW_FLOOR"])
    if env.get("PILOSA_TRACE_DISK_SEGMENT_BYTES"):
        trace.disk_segment_bytes = int(
            env["PILOSA_TRACE_DISK_SEGMENT_BYTES"])
    if env.get("PILOSA_TRACE_DISK_SEGMENTS"):
        trace.disk_segments = int(env["PILOSA_TRACE_DISK_SEGMENTS"])
    if env.get("PILOSA_SCRUB_ENABLED"):
        scrub.enabled = parse_bool(env["PILOSA_SCRUB_ENABLED"])
    if env.get("PILOSA_SCRUB_INTERVAL"):
        scrub.interval = parse_duration(env["PILOSA_SCRUB_INTERVAL"])
    if env.get("PILOSA_SCRUB_PACE"):
        scrub.pace = parse_duration(env["PILOSA_SCRUB_PACE"])
    if env.get("PILOSA_SCRUB_REPAIR"):
        scrub.repair = parse_bool(env["PILOSA_SCRUB_REPAIR"])
    if env.get("PILOSA_SCRUB_REPAIR_RESCAN"):
        scrub.repair_rescan = parse_duration(
            env["PILOSA_SCRUB_REPAIR_RESCAN"])


# Cluster defaults (reference server.go:33-37 and the JAX package's
# utils/config.py).
DEFAULT_REPLICA_N = 1
DEFAULT_CLUSTER_TYPE = "static"
DEFAULT_POLLING_INTERVAL = 60.0
DEFAULT_ANTI_ENTROPY_INTERVAL = 600.0
CLUSTER_TYPES = ("static", "http", "gossip")


@dataclass
class ClusterConfig:
    """[cluster] section, and the anti-entropy interval: ``hosts`` is
    the static membership (this node among them), ``type`` the
    broadcast backend (``static`` sends no schema messages, ``http``
    POSTs them to every peer's ``/messages``; ``gossip`` waits for the
    gossip slice), ``polling_interval`` the max-slice poll of the
    peers."""
    replica_n: int = DEFAULT_REPLICA_N
    type: str = DEFAULT_CLUSTER_TYPE
    hosts: list = field(default_factory=list)
    internal_hosts: list = field(default_factory=list)
    polling_interval: float = DEFAULT_POLLING_INTERVAL
    anti_entropy_interval: float = DEFAULT_ANTI_ENTROPY_INTERVAL

"""Workload capture: the recorded-traffic plane (docs/OBSERVABILITY.md).

Every handler-served query (and import ack) can append one compact
record — arrival timestamps, PQL, index/tenant/lane, effective request
options, query id, plan fingerprint, status, latency, and a canonical
64-bit digest of the normalized result JSON — into a crc-framed on-disk
segment ring under ``<data>/capture/`` (the obs.diskring discipline:
bounded bytes, torn tails skipped on reopen, diagnostics never raise).
A captured stream is replayable: ``pilosa-tpu replay`` re-issues it
against any cluster preserving inter-arrival gaps, and the shadow-diff
mode compares digests between a baseline and a candidate endpoint.

Record wire format (compact keys; one JSON object per ring line)::

    seq    per-node capture id (monotonic int; the ?since= cursor)
    t      arrival wall-clock (time.time, float seconds)
    mono   arrival monotonic stamp (gap reconstruction within a node)
    kind   "query" | "import"
    pql    the query text (possibly redacted), "" for imports
    index  index name         tenant  scheduling principal
    lane   read|write|admin   qid     the X-Pilosa-Query-Id
    plan   plan fingerprint ("" when unplanned)
    status HTTP status        latS    service latency (seconds)
    digest canonical result digest ("" on errors / non-200)
    opts   effective request options ({"timeout": s, "partial": true})
    node   host that served it (merged multi-node exports disambiguate)
    bits/slice  (imports only) accepted bit count and target slice

Digest canonicalization contract: the digest is a 64-bit BLAKE2b over
the *normalized* result JSON (server.codec.query_response_json shapes)
serialized with sorted keys and no whitespace. Normalization sorts
TopN pair lists by (count desc, id asc) — ties in count are broken by
ascending id — so two servers that order equal-count pairs differently
still agree. Floats are round-tripped through repr via json; bools,
ints, and bitmap JSON pass through structurally.

Sampling modes (``[capture] mode``): ``off`` is a nop-cost path (one
attribute read per request); ``sampled`` (the default) records
EVERY write and import — replay must reproduce state — plus 1-in-N
reads; ``full`` records everything. Redaction (``redact``): for the
listed tenants ("*" = all), PQL string/numeric literals are replaced
with ``?`` before the record is written, so a captured ring can leave
the trust boundary without leaking row ids or attribute strings (the
plan-fingerprint normalization rule, applied to the raw text).

Copy of the JAX package's ``obs/capture.py``.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
from typing import Optional

from . import metrics as obs_metrics
from .diskring import SegmentRing

MODES = ("off", "sampled", "full")

DIGEST_HEADER = "X-Pilosa-Result-Digest"

DEFAULT_SAMPLE_N = 16
DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_SEGMENTS = 8


# -- canonical result digest --------------------------------------------------


def _is_pair_list(v) -> bool:
    return (isinstance(v, list) and bool(v)
            and all(isinstance(e, dict) and "id" in e and "count" in e
                    for e in v))


def normalize_result(v):
    """The canonical form the digest hashes: TopN pair lists sorted by
    (count desc, id asc), containers recursed, scalars unchanged."""
    if _is_pair_list(v):
        return [{"id": e["id"], "count": e["count"]}
                for e in sorted(v, key=lambda e: (-e["count"], e["id"]))]
    if isinstance(v, dict):
        return {k: normalize_result(x) for k, x in v.items()}
    if isinstance(v, list):
        return [normalize_result(x) for x in v]
    return v


def result_digest(results_json) -> str:
    """Stable 64-bit digest (16 hex chars) over normalized result
    JSON — the value of ``X-Pilosa-Result-Digest`` and the shadow-diff
    comparison key. Input is the ``results`` list of
    codec.query_response_json (already plain JSON values)."""
    body = json.dumps(normalize_result(results_json), sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.blake2b(body.encode(), digest_size=8).hexdigest()


# -- PQL redaction ------------------------------------------------------------

# String literals first (so digits inside them vanish with the
# string), then bare numeric literals. Frame/view/field *names* are
# argument values too ("frame=f" / frame="f") — the capture contract
# redacts quoted strings wholesale: a redacted record stays
# fingerprintable (the plan fingerprint rides alongside) but carries
# no tenant data.
_STR_RE = re.compile(r'"(?:[^"\\]|\\.)*"')
_NUM_RE = re.compile(r"(?<![\w?])\d+(?:\.\d+)?\b")


def redact_pql(pql: str) -> str:
    return _NUM_RE.sub("?", _STR_RE.sub('"?"', pql))


# -- the store ----------------------------------------------------------------


class CaptureStore:
    """Per-node capture ring + sampling/redaction policy. Thread-safe;
    append failures count (metrics + ring.dropped), never raise."""

    def __init__(self, dir: str, mode: str = "sampled",
                 sample_n: int = DEFAULT_SAMPLE_N,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segments: int = DEFAULT_SEGMENTS,
                 redact_tenants: Optional[set] = None,
                 node: str = ""):
        if mode not in MODES:
            raise ValueError(f"capture mode {mode!r} not in {MODES}")
        self.mode = mode
        self.sample_n = max(1, int(sample_n))
        self.redact_tenants = frozenset(redact_tenants or ())
        self.node = node
        self.ring = SegmentRing(dir, segment_bytes=segment_bytes,
                                max_segments=max_segments)
        self._mu = threading.Lock()
        self._reads_seen = 0
        # Resume the per-node cursor past what survives on disk, so
        # ?since= cursors from before a restart stay monotonic.
        seq = 0
        for rec in self.ring.scan(newest_first=True):
            seq = int(rec.get("seq", 0))
            break
        self._seq = seq

    # The one check the handler pays per request when capture is off:
    # a bool attribute read (the nop-cost disabled path the overhead
    # guard proves).
    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def should_capture(self, lane: str) -> bool:
        """Sampling decision: writes/imports always (replay must
        reproduce state), reads 1-in-``sample_n`` when sampled."""
        if self.mode == "off":
            return False
        if self.mode == "full" or lane != "read":
            return True
        with self._mu:
            self._reads_seen += 1
            return self._reads_seen % self.sample_n == 1 \
                or self.sample_n == 1

    def redacts(self, tenant: str) -> bool:
        return ("*" in self.redact_tenants
                or tenant in self.redact_tenants)

    def add(self, kind: str, pql: str, index: str, tenant: str,
            lane: str, qid: str, status: int, latency_s: float,
            digest: str = "", plan: str = "",
            opts: Optional[dict] = None, wall: Optional[float] = None,
            mono: Optional[float] = None, **extra) -> int:
        """Append one record; returns its capture id (seq), or 0 when
        the append was dropped."""
        if self.redacts(tenant) and pql:
            pql = redact_pql(pql)
        with self._mu:
            self._seq += 1
            seq = self._seq
        rec = {"seq": seq,
               "t": time.time() if wall is None else wall,
               "mono": time.monotonic() if mono is None else mono,
               "kind": kind, "pql": pql, "index": index,
               "tenant": tenant, "lane": lane, "qid": qid,
               "plan": plan, "status": int(status),
               "latS": round(latency_s, 6), "digest": digest,
               "node": self.node}
        if opts:
            rec["opts"] = opts
        rec.update(extra)
        if self.ring.append(rec):
            obs_metrics.CAPTURE_RECORDS.labels(kind).inc()
            obs_metrics.CAPTURE_BYTES.labels(kind).inc(
                len(json.dumps(rec, separators=(",", ":"),
                               default=str)))
            return seq
        obs_metrics.CAPTURE_DROPPED.labels("io").inc()
        return 0

    # -- export ---------------------------------------------------------------

    def export(self, since: int = 0, limit: int = 500) -> list[dict]:
        """Records with seq > ``since``, oldest first, at most
        ``limit`` — the /debug/capture/records page. The cursor for
        the next page is the last record's seq."""
        limit = max(1, min(int(limit), 10000))
        out = []
        for rec in self.ring.scan(newest_first=False):
            if int(rec.get("seq", 0)) > since:
                out.append(rec)
                if len(out) >= limit:
                    break
        return out

    def status(self) -> dict:
        s = self.ring.stats()
        return {"mode": self.mode, "sampleN": self.sample_n,
                "redactTenants": sorted(self.redact_tenants),
                "seq": self._seq, "node": self.node,
                "budgetBytes": s["segmentBytes"] * s["maxSegments"],
                "ring": s}

    def close(self) -> None:
        self.ring.close()


# -- replay-side helpers (obs.replay, tests) ----------------------------------


def merge_streams(streams: list[list[dict]]) -> list[dict]:
    """Merge per-node exports into one replayable stream ordered by
    arrival wall-clock (cross-node ``mono`` stamps are not comparable;
    ``t`` is the only shared axis). Stable on ties: (t, node, seq)."""
    merged = [r for s in streams for r in s]
    merged.sort(key=lambda r: (r.get("t", 0.0), r.get("node", ""),
                               r.get("seq", 0)))
    return merged


def arrival_offsets(records: list[dict]) -> list[float]:
    """Seconds offset of each record from the first, preserving the
    recorded inter-arrival gaps. Single-node streams use the monotonic
    stamps (immune to wall-clock steps); merged streams fall back to
    wall time."""
    if not records:
        return []
    nodes = {r.get("node", "") for r in records}
    key = "mono" if len(nodes) == 1 and all(
        "mono" in r for r in records) else "t"
    base = records[0].get(key, 0.0)
    return [max(0.0, r.get(key, base) - base) for r in records]

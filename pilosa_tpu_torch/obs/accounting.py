"""Per-query resource accounting: the QueryCost ledger + cost tree.

A copy of the JAX package's ``obs/accounting.py``. The ledger
attributes a query's work at container granularity and on the card:

- **container ops** by ``(op, operand-kind pair)`` — the same keying as
  the global ``pilosa_roaring_container_ops_total`` counters, but
  per-query (storage/roaring.py increments both at one site);
- **word-equivalents scanned** (1024 words per bitmap container
  operand, ``ceil(len/64)`` per array operand);
- **bits written** (the fragment's mutate and import paths);
- **device programs dispatched + device bytes** — one a kernel launch
  of parallel.mesh, with the bytes of the slabs it reads — and
  **compile seconds**: the kernel extensions' first load (and nvcc
  build) in ops/build.py, charged to the query that paid for it;
- **queue wait** rides the context's ``admission`` stage.

A ledger is attached to ``sched.QueryContext.cost`` by the serving
layer; ``None`` is the no-allocation fast path — every ``note_*``
helper is two attribute reads and out. The ledger is summarized in the
``X-Pilosa-Stats`` response header, returned inline with results under
``?profile=1`` (the cost tree), and visible in ``/debug/queries`` and
the slow log. The JAX package's remote-leg stitching (``X-Pilosa-Cost``)
rides along unused until the cluster slice.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

# Wire header: a remote leg's serialized ledger rides the internal
# query response; the coordinator's cluster client stitches it in as a
# child of its own ledger.
COST_HEADER = "X-Pilosa-Cost"
# Compact per-response summary (every /query response carries it).
STATS_HEADER = "X-Pilosa-Stats"

# Hard cap on stitched children so a pathological fan-out cannot
# balloon the tree (mirrors trace.MAX_SPANS's role).
MAX_CHILDREN = 64

# Module switch: accounting is ON by default (the ledger is plain int
# increments). This is the process-wide kill switch the overhead-guard
# test flips; operators use the per-server gate instead
# ([metrics] accounting / --metrics.accounting /
# PILOSA_METRICS_ACCOUNTING, threaded into the handler).
_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


class QueryCost:
    """One query's resource ledger on one node.

    Increments are GIL-coarse plain-int bumps (a rare lost count is
    acceptable for accounting, same contract as roaring._OP_COUNTS);
    the lock guards only the merge/serialize paths.
    """

    __slots__ = ("node", "container_ops", "words_scanned",
                 "bits_written", "device_programs", "device_bytes",
                 "compile_s", "wal_wait_s", "result_cache_hits", "rpc",
                 "children", "_mu")

    def __init__(self, node: str = ""):
        self.node = node
        self.container_ops: dict[str, int] = {}
        self.words_scanned = 0
        self.bits_written = 0
        self.device_programs = 0
        self.device_bytes = 0
        self.compile_s = 0.0
        # Seconds this query's threads spent blocked in WAL group
        # commit (waiting for a leader's flush to cover their records)
        # — the write-side queue wait, alongside the admission stage's
        # read-side one.
        self.wal_wait_s = 0.0
        # Results this query served from a generation-validated cache
        # (result residency or the coordinator cluster cache) instead
        # of re-folding — the ledger's "why was this query cheap".
        self.result_cache_hits = 0
        # peer host -> {"bytesOut": n, "bytesIn": n, "calls": n}
        self.rpc: dict[str, dict] = {}
        self.children: list[dict] = []
        self._mu = threading.Lock()

    # -- increment sites -----------------------------------------------------

    def note_container_op(self, op: str, kind: str, words: int = 0) -> None:
        key = f"{op}:{kind}"
        self.container_ops[key] = self.container_ops.get(key, 0) + 1
        if words:
            self.words_scanned += words

    def note_bits_written(self, n: int) -> None:
        self.bits_written += n

    def note_device_dispatch(self, nbytes: int = 0) -> None:
        self.device_programs += 1
        self.device_bytes += nbytes

    def note_compile(self, seconds: float) -> None:
        self.compile_s += seconds

    def note_wal_wait(self, seconds: float) -> None:
        self.wal_wait_s += seconds

    def note_result_cache_hit(self, n: int = 1) -> None:
        self.result_cache_hits += n

    def note_rpc(self, peer: str, bytes_out: int, bytes_in: int) -> None:
        with self._mu:
            entry = self.rpc.setdefault(
                peer, {"bytesOut": 0, "bytesIn": 0, "calls": 0})
            entry["bytesOut"] += bytes_out
            entry["bytesIn"] += bytes_in
            entry["calls"] += 1

    # -- stitching -----------------------------------------------------------

    def add_remote_json(self, payload: str) -> None:
        """Stitch a peer's piggybacked ledger (COST_HEADER value) as a
        child of this tree."""
        try:
            tree = json.loads(payload)
        except ValueError:
            return
        if not isinstance(tree, dict):
            return
        with self._mu:
            if len(self.children) < MAX_CHILDREN:
                self.children.append(tree)

    # -- export --------------------------------------------------------------

    def to_tree(self, stages: Optional[dict] = None) -> dict:
        """The per-node cost tree: this ledger plus stitched children.
        ``stages`` (the QueryContext's per-stage seconds) makes it
        per-stage as well as per-node."""
        with self._mu:
            rpc = {p: dict(v) for p, v in self.rpc.items()}
            children = list(self.children)
        out: dict = {
            "node": self.node,
            "containerOps": dict(self.container_ops),
            "wordsScanned": self.words_scanned,
            "bitsWritten": self.bits_written,
            "devicePrograms": self.device_programs,
            "deviceBytes": self.device_bytes,
            "compileMs": round(self.compile_s * 1e3, 3),
        }
        if self.wal_wait_s:
            out["walWaitMs"] = round(self.wal_wait_s * 1e3, 3)
        if self.result_cache_hits:
            out["resultCacheHit"] = self.result_cache_hits
        if stages:
            out["stages"] = {k: round(v, 6) for k, v in stages.items()}
            if "admission" in stages:
                out["queueWaitMs"] = round(stages["admission"] * 1e3, 3)
        if rpc:
            out["rpc"] = rpc
        if children:
            out["children"] = children
        return out

    def summary(self) -> dict:
        """Compact roll-up for headers, span tags, and slow-log rows —
        totals only, bounded size whatever the query did."""
        with self._mu:
            rpc_out = sum(v["bytesOut"] for v in self.rpc.values())
            rpc_in = sum(v["bytesIn"] for v in self.rpc.values())
            n_children = len(self.children)
        out = {
            "containerOps": sum(self.container_ops.values()),
            "wordsScanned": self.words_scanned,
            "bitsWritten": self.bits_written,
            "devicePrograms": self.device_programs,
            "deviceBytes": self.device_bytes,
            "compileMs": round(self.compile_s * 1e3, 3),
        }
        if self.wal_wait_s:
            out["walWaitMs"] = round(self.wal_wait_s * 1e3, 3)
        if self.result_cache_hits:
            out["resultCacheHit"] = self.result_cache_hits
        if rpc_out or rpc_in:
            out["rpcBytesOut"] = rpc_out
            out["rpcBytesIn"] = rpc_in
        if n_children:
            out["remoteLegs"] = n_children
        return out

    # Same wire budget rationale as trace.Trace._WIRE_BYTES:
    # http.client rejects header LINES over 64 KiB.
    _WIRE_BYTES = 48 << 10

    def wire_json(self, stages: Optional[dict] = None,
                  max_bytes: int = _WIRE_BYTES) -> str:
        """Compact JSON of the tree for the piggyback header; over
        budget the containerOps detail collapses to its total (the
        mix is the first thing to go — totals must survive)."""
        tree = self.to_tree(stages)
        out = json.dumps(tree, separators=(",", ":"))
        if len(out) > max_bytes:
            tree["containerOps"] = {
                "total": sum(self.container_ops.values())}
            tree.pop("children", None)
            out = json.dumps(tree, separators=(",", ":"))
        return out


# -- current-query helpers ----------------------------------------------------
# The sched package import is deferred to first use: storage.roaring
# imports this module, and an import-time ``from ..sched import ...``
# could re-enter a partially initialized package when the import chain
# starts from sched.warmup -> executor -> storage.

_sched_current = None
_sched_tls = None


def current_cost() -> Optional[QueryCost]:
    """The ledger of this thread's current query, or None (the fast
    path: thread-local read + two attribute reads, no allocation)."""
    global _sched_current
    if _sched_current is None:
        from ..sched.context import current as _c
        _sched_current = _c
    ctx = _sched_current()
    if ctx is None:
        return None
    return getattr(ctx, "cost", None)


def attach(ctx, node: str = "") -> Optional[QueryCost]:
    """Attach a fresh ledger to a QueryContext (respecting the module
    switch); returns it. The serving layers call this where they
    construct the context — mirroring how the tracer binds ctx.trace."""
    if not _enabled:
        return None
    cost = QueryCost(node=node or getattr(ctx, "node", ""))
    ctx.cost = cost
    return cost


def note_bits_written(n: int) -> None:
    # The per-op write hot path: one thread-local read inline instead
    # of the current_cost() call chain (measured at per-op rates).
    global _sched_tls
    tls = _sched_tls
    if tls is None:
        from ..sched import context as _sched_ctx
        tls = _sched_tls = _sched_ctx._tls
    ctx = getattr(tls, "ctx", None)
    if ctx is None:
        return
    cost = getattr(ctx, "cost", None)
    if cost is not None:
        cost.note_bits_written(n)


def note_result_cache_hit(ctx=None) -> None:
    """Stamp a generation-validated cache hit on the query's ledger
    (explicit ctx where the caller holds one; thread-bound otherwise)."""
    cost = (getattr(ctx, "cost", None) if ctx is not None
            else current_cost())
    if cost is not None:
        cost.note_result_cache_hit()


def note_device_dispatch(nbytes: int = 0) -> None:
    cost = current_cost()
    if cost is not None:
        cost.note_device_dispatch(nbytes)


def note_compile(seconds: float) -> None:
    cost = current_cost()
    if cost is not None:
        cost.note_compile(seconds)

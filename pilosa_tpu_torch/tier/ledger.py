"""Residency ledger: who lives where, how big, and whose working set.

Copy of the JAX package's ``tier/ledger.py``.

One entry per tracked fragment, keyed (index, frame, view, slice):
the tier (hot / cold / blob), the on-disk byte footprint, how many of
a cold fragment's bytes have been faulted back in, the monotonic
last-touch stamp, and the tenant whose reads last touched it. The
manager's watermark loop asks the ledger two questions:

- ``resident_bytes()`` — the number the budget is stated against:
  hot fragments count whole, cold fragments count their faulted
  blocks only, blob fragments count nothing.
- ``victims(...)`` — which fragments to demote to get back under the
  low watermark, honoring the per-tenant cache-share discipline
  (sched.tenants ``cache_share``): tenants OVER their share of the
  resident budget are drained first (LRU within each), and tenants
  under their share are only touched when every over-share tenant is
  exhausted — so a cold-scanning tenant's own fragments absorb its
  own pressure before anyone else's working set pays.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..obs import metrics as obs_metrics

HOT = "hot"
COLD = "cold"
BLOB = "blob"

# Ledger attribution for reads outside any tenant context (library
# calls, background loops). Matches the tenants-subsystem default.
DEFAULT_TENANT = "default"


class Entry:
    __slots__ = ("key", "tier", "nbytes", "faulted_bytes",
                 "last_touch", "tenant", "pinned")

    def __init__(self, key: tuple, tier: str, nbytes: int,
                 tenant: str = DEFAULT_TENANT):
        self.key = key
        self.tier = tier
        self.nbytes = int(nbytes)
        self.faulted_bytes = 0
        self.last_touch = time.monotonic()
        self.tenant = tenant
        # True while the manager is mid-transition on this fragment
        # (demoting, pushing, fetching) — victim selection skips it.
        self.pinned = False

    def resident(self) -> int:
        if self.tier == HOT:
            return self.nbytes
        if self.tier == COLD:
            return min(self.faulted_bytes, self.nbytes)
        return 0

    def to_json(self) -> dict:
        return {"index": self.key[0], "frame": self.key[1],
                "view": self.key[2], "slice": self.key[3],
                "tier": self.tier, "bytes": self.nbytes,
                "faultedBytes": self.faulted_bytes,
                "tenant": self.tenant,
                "idleS": round(time.monotonic() - self.last_touch, 1)}


class ResidencyLedger:
    """Thread-safe; the internal lock is a LEAF — never held while
    acquiring fragment or manager locks (the read-path touch runs
    under the fragment lock, the demotion loop takes fragment locks
    first), so the two directions cannot deadlock."""

    def __init__(self):
        self._mu = threading.Lock()
        self._entries: dict[tuple, Entry] = {}

    @staticmethod
    def key_of(frag) -> tuple:
        return (frag.index, frag.frame, frag.view, frag.slice)

    # -- tracking -------------------------------------------------------------

    def track(self, frag, tier: str, nbytes: int) -> Entry:
        key = self.key_of(frag)
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                e = Entry(key, tier, nbytes)
                self._entries[key] = e
            else:
                e.tier = tier
                e.nbytes = int(nbytes)
            if tier != COLD:
                e.faulted_bytes = 0
            return e

    def forget(self, frag) -> None:
        with self._mu:
            self._entries.pop(self.key_of(frag), None)

    def get(self, frag) -> Optional[Entry]:
        return self._entries.get(self.key_of(frag))

    def touch(self, frag, tenant: str = "") -> None:
        e = self._entries.get(self.key_of(frag))
        if e is not None:
            e.last_touch = time.monotonic()
            if tenant:
                e.tenant = tenant

    def note_fault(self, frag, nbytes: int) -> None:
        e = self._entries.get(self.key_of(frag))
        if e is not None:
            e.faulted_bytes += int(nbytes)

    def set_tier(self, frag, tier: str, nbytes: Optional[int] = None
                 ) -> None:
        with self._mu:
            e = self._entries.get(self.key_of(frag))
            if e is None:
                return
            e.tier = tier
            if nbytes is not None:
                e.nbytes = int(nbytes)
            if tier != COLD:
                e.faulted_bytes = 0

    def pin(self, frag, pinned: bool) -> None:
        e = self._entries.get(self.key_of(frag))
        if e is not None:
            e.pinned = pinned

    # -- accounting -----------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._mu:
            return sum(e.resident() for e in self._entries.values())

    def tenant_resident(self) -> dict[str, int]:
        with self._mu:
            out: dict[str, int] = {}
            for e in self._entries.values():
                r = e.resident()
                if r:
                    out[e.tenant] = out.get(e.tenant, 0) + r
            return out

    def counts(self) -> dict[str, tuple[int, int]]:
        """{tier: (fragments, bytes)} — bytes are the tier's total
        data bytes (resident share for cold is faulted only)."""
        with self._mu:
            out = {HOT: [0, 0], COLD: [0, 0], BLOB: [0, 0]}
            for e in self._entries.values():
                row = out[e.tier]
                row[0] += 1
                row[1] += e.nbytes
            return {k: (v[0], v[1]) for k, v in out.items()}

    def update_gauges(self) -> None:
        counts = self.counts()
        resident = self.resident_bytes()
        for tier, (n, nbytes) in counts.items():
            obs_metrics.TIER_FRAGMENTS.labels(tier).set(n)
            obs_metrics.TIER_BYTES.labels(tier).set(nbytes)
        obs_metrics.TIER_BYTES.labels("resident").set(resident)

    # -- victim selection -----------------------------------------------------

    def idle_hot(self, idle_s: float) -> list[tuple]:
        """Hot entries untouched for ``idle_s`` — the idle-sweep
        demotion candidates, oldest first."""
        now = time.monotonic()
        with self._mu:
            out = [e for e in self._entries.values()
                   if e.tier == HOT and not e.pinned
                   and now - e.last_touch >= idle_s]
        out.sort(key=lambda e: e.last_touch)
        return [e.key for e in out]

    def idle_cold(self, idle_s: float) -> list[tuple]:
        """Cold entries untouched for ``idle_s`` — blob-push
        candidates, oldest first."""
        now = time.monotonic()
        with self._mu:
            out = [e for e in self._entries.values()
                   if e.tier == COLD and not e.pinned
                   and now - e.last_touch >= idle_s]
        out.sort(key=lambda e: e.last_touch)
        return [e.key for e in out]

    def victims(self, need_bytes: int, budget: int,
                shares: Optional[dict[str, float]] = None
                ) -> list[tuple]:
        """Fragments to demote (hot) or re-chill (cold with faulted
        blocks — a cold scan's residency is reclaimed by resetting
        its fault set, not by touching anyone else) to reclaim
        ``need_bytes``, in eviction order. The per-tenant discipline:
        tenants whose resident usage exceeds ``share × budget`` give
        up residency first (most-over-share tenant's LRU entry
        first); tenants under their share are only drained once no
        over-share tenant has anything left to give. With no shares
        (or no budget) this degrades to plain global LRU."""
        with self._mu:
            cands = [e for e in self._entries.values()
                     if not e.pinned and e.resident() > 0]
            usage: dict[str, int] = {}
            for e in self._entries.values():
                r = e.resident()
                if r:
                    usage[e.tenant] = usage.get(e.tenant, 0) + r
        if not cands:
            return []
        cands.sort(key=lambda e: e.last_touch)
        if not shares or budget <= 0:
            out, got = [], 0
            for e in cands:
                if got >= need_bytes:
                    break
                out.append(e.key)
                got += e.resident()
            return out

        def over_by(tenant: str) -> int:
            share = shares.get(tenant, shares.get("", 1.0))
            return usage.get(tenant, 0) - int(share * budget)

        # Two passes: over-share tenants' LRU entries first (the
        # most-over tenant pays first and its usage is debited as we
        # pick, so pressure drains proportionally), then — only if
        # still short — everyone else's global LRU.
        out: list[tuple] = []
        got = 0
        remaining = list(cands)
        while got < need_bytes:
            over = [e for e in remaining if over_by(e.tenant) > 0]
            if not over:
                break
            # Most-over tenant's least-recently-touched entry.
            over.sort(key=lambda e: (-over_by(e.tenant), e.last_touch))
            e = over[0]
            remaining.remove(e)
            out.append(e.key)
            got += e.resident()
            usage[e.tenant] = usage.get(e.tenant, 0) - e.resident()
        for e in remaining:
            if got >= need_bytes:
                break
            out.append(e.key)
            got += e.resident()
        return out

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self, tier: str = "") -> list[dict]:
        with self._mu:
            return [e.to_json() for e in self._entries.values()
                    if not tier or e.tier == tier]

    def keys(self, tier: str = "") -> list[tuple]:
        with self._mu:
            return [k for k, e in self._entries.items()
                    if not tier or e.tier == tier]

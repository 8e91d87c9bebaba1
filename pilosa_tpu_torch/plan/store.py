"""Bounded per-fingerprint plan store behind ``GET /debug/plans``.

A copy of the JAX package's ``plan/store.py``. One row per plan
fingerprint (the normalized-shape hash, so literal row ids and operand
order collapse together): hit count, latency p50/p99 over a bounded
reservoir, estimated-vs-actual drift, the last observed plan tree, and
an example PQL. LRU-bounded — the store is a debugging surface, not a
history.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

MAX_FINGERPRINTS = 256
_DURATIONS = 64
_DRIFTS = 64


class PlanStore:
    def __init__(self, max_fingerprints: int = MAX_FINGERPRINTS):
        self.max_fingerprints = max_fingerprints
        self._mu = threading.Lock()
        self._rows: OrderedDict[str, dict] = OrderedDict()

    def record(self, fingerprint: str, plan,
               duration_s: float, pql: str = "",
               est_rows=None, actual_rows=None) -> None:
        """``plan`` is the serialized tree, or a zero-arg callable
        producing it — the hot path passes a callable so a repeated
        fingerprint skips per-query serialization (the stored tree
        refreshes at most once a second)."""
        with self._mu:
            row = self._rows.get(fingerprint)
            if row is None:
                row = {"count": 0,
                       "durations": deque(maxlen=_DURATIONS),
                       "drifts": deque(maxlen=_DRIFTS),
                       "lastPlan": None, "examplePql": "",
                       "lastSeen": 0.0, "_planAt": 0.0}
                self._rows[fingerprint] = row
                while len(self._rows) > self.max_fingerprints:
                    self._rows.popitem(last=False)
            self._rows.move_to_end(fingerprint)
            row["count"] += 1
            row["durations"].append(duration_s)
            now = time.time()
            if callable(plan):
                if row["lastPlan"] is None or now - row["_planAt"] >= 1.0:
                    row["lastPlan"] = plan()
                    row["_planAt"] = now
            else:
                row["lastPlan"] = plan
                row["_planAt"] = now
            row["lastSeen"] = now
            if pql and not row["examplePql"]:
                row["examplePql"] = pql[:200]
            if est_rows is not None and actual_rows is not None:
                row["drifts"].append(
                    (actual_rows + 1) / (est_rows + 1))

    def snapshot(self, limit: int = 64) -> dict:
        with self._mu:
            items = list(self._rows.items())
        items.sort(key=lambda kv: kv[1]["count"], reverse=True)
        plans = []
        for fp, row in items[:limit]:
            durs = sorted(row["durations"])
            drifts = sorted(row["drifts"])
            entry = {
                "fingerprint": fp,
                "count": row["count"],
                "p50Ms": round(_quantile(durs, 0.5) * 1e3, 3),
                "p99Ms": round(_quantile(durs, 0.99) * 1e3, 3),
                "lastSeen": row["lastSeen"],
                "examplePql": row["examplePql"],
                "lastPlan": row["lastPlan"],
            }
            if drifts:
                entry["estActualDrift"] = {
                    "median": round(_quantile(drifts, 0.5), 3),
                    "p99": round(_quantile(drifts, 0.99), 3),
                    "n": len(drifts),
                }
            plans.append(entry)
        return {"fingerprints": len(items), "plans": plans}


def _quantile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(q * (len(sorted_vals) - 1) + 0.5)))
    return sorted_vals[i]

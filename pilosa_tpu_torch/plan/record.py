"""Per-query plan artifacts: the plan tree, its record, and the stable
fingerprint.

Trimmed copy of the JAX package's ``plan/record.py``. The planner
(plan.planner) rewrites a read query before execution; every planned
query carries a ``PlanRecord`` holding the chosen plan tree with
per-node estimated cardinality (and, as it runs, actual cardinality
and wall time) and the decisions taken: ``?plan=1`` returns it without
executing (EXPLAIN), ``?profile=1`` with the results (EXPLAIN
ANALYZE), and the record rides the query's context (``ctx.plan``). The
JAX module's process-wide enable switch is the executor's
``planner_enabled`` attribute here (on by default, as there).
Remote-leg stitching (``X-Pilosa-Plan``) waits for the cluster slice.

Fingerprint stability contract: the fingerprint hashes the NORMALIZED
canonical tree — numeric literals (row/column ids, TopN n, condition
values) become ``?`` while frame/view/field names are kept, and
commutative operands (Intersect/Union children) are sorted by their
normalized form. Two queries with the same shape over the same frames
share a fingerprint regardless of literal ids or operand order.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional

from ..pql.ast import Call, Condition

# -- fingerprint --------------------------------------------------------------


def _norm_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return "?"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_norm_value(x) for x in v) + "]"
    return repr(v)


def normalize_call(call: Call) -> str:
    """The normalized canonical form one call hashes to — numeric
    literals ``?``'d out, commutative children sorted."""
    parts = [normalize_call(c) for c in call.children]
    if call.name in ("Intersect", "Union"):
        parts.sort()
    for k in sorted(call.args):
        v = call.args[k]
        if isinstance(v, Condition):
            parts.append(f"{k} {v.op} ?")
        else:
            parts.append(f"{k}={_norm_value(v)}")
    return f"{call.name}({','.join(parts)})"


def fingerprint_calls(calls) -> str:
    text = "\n".join(normalize_call(c) for c in calls)
    return hashlib.sha1(text.encode()).hexdigest()[:12]


# -- the plan tree ------------------------------------------------------------


class PlanNode:
    """One operator of the chosen plan. ``est_rows``/``est_cost_s``
    are the planner's predictions; ``actual_rows``/``actual_s`` are
    filled by the executor as the node runs (ANALYZE). ``decisions``
    records what the planner DID here (reordered / short_circuit / cse
    / placement:*) so a plan reads as a decision log, not just a
    shape."""

    __slots__ = ("op", "detail", "est_rows", "exact", "est_cost_s",
                 "placement", "decisions", "children", "actual_rows",
                 "actual_s", "frames", "key", "cache_lookup",
                 "cache_store", "short_circuit")

    def __init__(self, op: str, detail: str = ""):
        self.op = op
        self.detail = detail
        self.est_rows: Optional[int] = None
        self.exact = False
        self.est_cost_s: Optional[float] = None
        self.placement = "auto"
        self.decisions: list[str] = []
        self.children: list[PlanNode] = []
        self.actual_rows: Optional[int] = None
        self.actual_s: Optional[float] = None
        # Planner wiring (not serialized): frame/view keys under this
        # subtree, the canonical subtree string (the subresult-cache
        # key stem), and the cache/short-circuit marks.
        self.frames: frozenset = frozenset()
        self.key = ""
        self.cache_lookup = False
        self.cache_store = False
        self.short_circuit = False

    def to_json(self) -> dict:
        out: dict = {"op": self.op}
        if self.detail:
            out["detail"] = self.detail
        if self.est_rows is not None:
            out["estRows"] = int(self.est_rows)
            out["exact"] = self.exact
        if self.est_cost_s is not None:
            out["estCostS"] = round(self.est_cost_s, 6)
        if self.actual_rows is not None:
            out["actualRows"] = int(self.actual_rows)
        if self.actual_s is not None:
            out["actualS"] = round(self.actual_s, 6)
        if self.placement != "auto":
            out["placement"] = self.placement
        if self.decisions:
            out["decisions"] = list(self.decisions)
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out


class PlanRecord:
    """The per-query plan ledger riding ``ctx.plan`` (the ctx.cost
    pattern): root plan nodes (one per planned call), the query
    fingerprint and a decision roll-up."""

    __slots__ = ("fingerprint", "node", "roots", "decisions", "analyze",
                 "sample", "_mu")

    def __init__(self, fingerprint: str, node: str = ""):
        self.fingerprint = fingerprint
        self.node = node
        self.roots: list[PlanNode] = []
        self.decisions: dict[str, int] = {}
        self.analyze = False
        # Observability sampling gate: freshly-planned queries and a
        # 1-in-16 slice of plan-memo hits carry per-node actuals and
        # feed the plan store / misestimation stream; the rest skip
        # that bookkeeping. ?profile=1 (analyze) always records.
        self.sample = True
        self._mu = threading.Lock()

    def note(self, outcome: str, n: int = 1) -> None:
        with self._mu:
            self.decisions[outcome] = self.decisions.get(outcome, 0) + n

    def decision_summary(self) -> dict:
        with self._mu:
            return dict(self.decisions)

    def to_tree(self) -> dict:
        out: dict = {
            "fingerprint": self.fingerprint,
            "node": self.node,
            "calls": [r.to_json() for r in self.roots],
        }
        summary = self.decision_summary()
        if summary:
            out["decisions"] = summary
        return out

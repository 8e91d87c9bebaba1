"""Cost-based planning for read queries.

Trimmed copy of the JAX package's ``plan/planner.py``. The executor
consults the planner once per read query, before any device or host
work. Planning operates on a CLONE of the parsed call tree and produces
(rewritten calls, a ``PlanRecord``); the executor then runs the
rewritten tree. Four decision kinds, each recorded in the plan tree:

- **reorder** — ``Intersect``/``Union`` operands sorted smallest-first
  by estimated cardinality (the galloping-intersection ordering,
  arXiv:1402.6407 §4). ``Difference`` is never reordered (left operand
  is semantic). A reordered tree compiles to the same device program
  shape, and its count is the same.
- **short_circuit** — branches PROVEN empty are not executed: an
  exactly-empty operand empties an ``Intersect``, is dropped from a
  ``Union``/``Difference`` subtrahend list, and empties a whole call
  (``Count`` answers 0 with no launch). Proofs are exact only — every
  slice enumerated against the fragments (absent fragment = 0 bits);
  sampled estimates (past ``EXACT_SLICES`` slices) never
  short-circuit.
- **cse** — duplicate pure bitmap subtrees go through a
  generation-token-keyed per-slice subresult cache (SubresultCache):
  the second occurrence WITHIN a batch and repeats ACROSS queries fold
  once per slice and then hit. Keys carry the slice's (uid, generation)
  tokens (cluster.generations), so any write to any involved fragment
  invalidates by key mismatch.
- **placement** — per-subtree host/device pricing from measured cost
  constants (``calibration``, parallel.costmodel): installed by the
  executor's cost model on the card, inert (None) on the CPU unless a
  model is injected.

Estimates come from ``Fragment`` count caches (``cache.get(rid)``) with
a ``row_count`` fallback, summed across slices — exact up to
``EXACT_SLICES`` slices, sampled+extrapolated past that.

Finished plans are memoized (``plan_query_cached``): a repeated query
reuses its plan after an epoch-validation sweep over the exact facts
the plan's proofs rest on.

The planner metrics (``pilosa_planner_*``) and the misestimate stream
(``observe_misestimate``) are the JAX package's. Estimation never
faults a cold or blob fragment in: its estimate stays inexact, as in the
JAX package. Left out of the copy: the blackbox snapshot.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from ..cluster import generations
from ..obs import metrics as obs_metrics
from ..ops.packed import WORDS_PER_SLICE
from ..pql.ast import Call, Condition
from .record import PlanNode, PlanRecord, fingerprint_calls

# Slice-count ceiling for exact (every slice enumerated) estimation;
# past it the planner samples ESTIMATE_SAMPLES slices and extrapolates.
EXACT_SLICES = 64
ESTIMATE_SAMPLES = 8

# The ops the planner rewrites / caches. Placement + estimation also
# understand Count/TopN wrappers (their bitmap child is planned).
_BITMAP_OPS = ("Intersect", "Union", "Difference")

# Per-operand estimation entries kept (keyed by fragment mutation
# epoch, so a write invalidates in place).
_ESTIMATE_CACHE_ENTRIES = 4096
# Canonical subtrees remembered for cross-query CSE detection.
_SEEN_ENTRIES = 1024
# Finished plans memoized per (index, canonical calls, slices) — the
# repeated-query fast path the ≤2% overhead budget requires. Validity
# is fact-checked per hit (plan_query_cached), never assumed.
_PLAN_MEMO_ENTRIES = 256


class SubresultCache:
    """Bounded per-slice interior-node result cache.

    Key: (index, canonical subtree, slice, generation tokens of every
    frame/view the subtree reads at that slice). A mutation bumps the
    fragment generation, the token tuple changes, and the stale entry
    simply stops matching (it ages out by LRU) — no explicit
    invalidation channel.
    """

    def __init__(self, max_entries: int = 512,
                 max_bits: int = 32 << 20):
        self.max_entries = max_entries
        self.max_bits = max_bits
        self._mu = threading.Lock()
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bits = 0
        # Lookup outcomes and stores (also counted in
        # pilosa_planner_subresult_cache_events_total).
        self.hits = self.misses = self.stores = 0

    def get(self, key: tuple):
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                obs_metrics.PLANNER_SUBRESULT_EVENTS.labels(
                    "miss").inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        obs_metrics.PLANNER_SUBRESULT_EVENTS.labels("hit").inc()
        return ent[0]

    def put(self, key: tuple, bm, bits: int) -> None:
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bits -= old[1]
            self._entries[key] = (bm, bits)
            self._bits += bits
            self.stores += 1
            while (len(self._entries) > self.max_entries
                   or self._bits > self.max_bits):
                if len(self._entries) <= 1 and \
                        self._bits <= self.max_bits:
                    break
                _, (_, b) = self._entries.popitem(last=False)
                self._bits -= b
                obs_metrics.PLANNER_SUBRESULT_EVENTS.labels(
                    "evict").inc()
        obs_metrics.PLANNER_SUBRESULT_EVENTS.labels("store").inc()

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._bits = 0

    def stats(self) -> dict:
        with self._mu:
            return {"entries": len(self._entries), "bits": self._bits,
                    "hits": self.hits, "misses": self.misses,
                    "stores": self.stores}


class Planner:
    """One per executor. Thread-safe: planning itself runs on the
    query thread; the seen/estimate LRUs take the planner lock."""

    def __init__(self, holder, margin: float = 0.5,
                 subresult_entries: int = 512,
                 subresult_bits: int = 32 << 20):
        self.holder = holder
        self.margin = margin
        self.subresults = SubresultCache(subresult_entries,
                                         subresult_bits)
        # Measured cost constants (parallel.costmodel.Calibration),
        # installed by the executor with its cost model (on the card at
        # first device use, or an injected model) and primed by the
        # server's warmup. None (the CPU without a model): placement
        # decides nothing.
        self.calibration = None
        self._mu = threading.Lock()
        self._seen: OrderedDict[str, int] = OrderedDict()
        self._estimates: OrderedDict[tuple, tuple] = OrderedDict()
        # Finished-plan memo: key -> {planned, roots, fingerprint,
        # decisions, deps, cse_nodes} (plan_query_cached).
        self._plans: OrderedDict[tuple, dict] = OrderedDict()
        # Decision roll-up over the planner's life.
        self.decision_totals: dict[str, int] = {}

    # -- public entry points -------------------------------------------------

    def plan_query(self, index: str, calls: list[Call], slices,
                   all_local: bool = True,
                   record: Optional[PlanRecord] = None,
                   deps: Optional[list] = None
                   ) -> tuple[list[Call], PlanRecord]:
        """Plan a batch of read calls. Returns (rewritten clones, the
        populated record). Caller is responsible for gating (write
        queries and disabled planning never reach here). ``deps``, when
        given, collects the (frame, view, fragment-epoch) facts the
        plan's estimates rest on — the memo validity set."""
        t0 = time.perf_counter()
        if record is None:
            record = PlanRecord(fingerprint_calls(calls))
        idx = self.holder.index(index)
        slices = tuple(int(s) for s in slices)
        planned: list[Call] = []
        for call in calls:
            c = call.clone()
            node = self._plan_call(idx, index, c, slices, all_local,
                                   record, covered=True, deps=deps)
            record.roots.append(node)
            planned.append(c)
        record.note("planned")
        self._bump("planned")
        obs_metrics.PLANNER_PLAN_SECONDS.observe(
            time.perf_counter() - t0)
        return planned, record

    def plan_query_cached(self, index: str, calls: list[Call], slices,
                          all_local: bool = True, node: str = ""
                          ) -> tuple[list[Call], PlanRecord]:
        """``plan_query`` behind a bounded memo: a repeated query (the
        hot shape) reuses its finished plan
        instead of re-walking estimation and fingerprinting, so
        planning amortizes to a key build plus a validity sweep.

        Safety: every entry carries the exact facts its proofs rest on
        — frame/view identity and per-fragment mutation epochs,
        including PROVABLY ABSENT fragments/views (a fragment appearing
        breaks an emptiness proof as surely as a write). Any mismatch
        discards the entry and replans, so a memoized short-circuit can
        never outlive the emptiness it proved. Plan NODES are shared
        across hits; the per-query PlanRecord (actuals, stitched legs)
        is always fresh."""
        slices = tuple(int(s) for s in slices)
        try:
            key = (index, tuple(_memo_call_key(c) for c in calls),
                   slices, bool(all_local))
            with self._mu:
                ent = self._plans.get(key)
                if ent is not None:
                    self._plans.move_to_end(key)
        except TypeError:
            # Unhashable literal somewhere in the tree — plan uncached.
            key = ent = None
        if ent is not None and self._deps_valid(index, ent["deps"]):
            ent["hits"] = hits = ent["hits"] + 1
            rec = PlanRecord(ent["fingerprint"], node=node)
            # Roots/calls are aliased, not copied: plan shape is
            # immutable after planning (only per-node actuals race,
            # and those are observability-only).
            rec.roots = ent["roots"]
            rec.decisions.update(ent["decisions"])
            rec.sample = hits % 16 == 0
            # A hit is another sighting of every cacheable subtree —
            # keep the cross-query CSE ladder climbing to store state.
            for n in ent["cse_nodes"]:
                if not n.cache_store:
                    self._mark_cse(n)
            return ent["planned"], rec
        rec = PlanRecord(fingerprint_calls(calls), node=node)
        deps: list[tuple] = []
        planned, rec = self.plan_query(index, calls, slices,
                                       all_local=all_local,
                                       record=rec, deps=deps)
        cse_nodes = [n for root in rec.roots
                     for n in _walk_nodes(root) if n.cache_lookup]
        if key is not None:
            ent = {"planned": planned, "roots": list(rec.roots),
                   "fingerprint": rec.fingerprint,
                   "decisions": rec.decision_summary(),
                   "deps": deps, "cse_nodes": cse_nodes, "hits": 0}
            with self._mu:
                self._plans[key] = ent
                while len(self._plans) > _PLAN_MEMO_ENTRIES:
                    self._plans.popitem(last=False)
        return planned, rec

    def _deps_valid(self, index: str, deps) -> bool:
        """True when every fact a memoized plan depends on still
        holds. Identity checks (``is``) catch drop-and-recreate, not
        just mutation."""
        idx = self.holder.index(index)
        if idx is None:
            return False
        try:
            for d in deps:
                kind = d[0]
                if kind == "frag":
                    _, view, s, epoch = d
                    frag = view.fragments.get(s)
                    cur = (None if frag is None
                           else getattr(frag, "_epoch", 0))
                    if cur != epoch:
                        return False
                elif kind == "view":
                    _, frame, view = d
                    if frame.views.get("standard") is not view:
                        return False
                else:  # "frame"
                    _, name, frame = d
                    if idx.frames.get(name) is not frame:
                        return False
        except Exception:  # noqa: BLE001 - any doubt means replan
            return False
        return True

    def explain(self, index: str, calls: list[Call], slices,
                all_local: bool = True) -> dict:
        """EXPLAIN-only (?plan=1): plan without executing."""
        _, record = self.plan_query(index, calls, slices,
                                    all_local=all_local)
        return record.to_tree()

    # -- decision bookkeeping ------------------------------------------------

    def snapshot(self) -> dict:
        """Planner state for /debug/plans."""
        with self._mu:
            totals = dict(self.decision_totals)
            seen = len(self._seen)
        out = {"decisions": totals, "seenSubtrees": seen,
               "subresultCache": self.subresults.stats()}
        if self.calibration is not None:
            out["calibration"] = self.calibration.to_dict()
        return out

    def _bump(self, outcome: str) -> None:
        obs_metrics.PLANNER_DECISIONS.labels(outcome).inc()
        with self._mu:
            self.decision_totals[outcome] = \
                self.decision_totals.get(outcome, 0) + 1

    def _decide(self, record: PlanRecord, node: PlanNode,
                outcome: str) -> None:
        node.decisions.append(outcome)
        record.note(outcome)
        self._bump(outcome)

    # -- recursive planning --------------------------------------------------

    def _plan_call(self, idx, index: str, call: Call, slices,
                   all_local: bool, record: PlanRecord,
                   covered: bool = False,
                   deps: Optional[list] = None) -> PlanNode:
        """Plan one call subtree in place (mutates the clone).
        ``covered`` marks subtrees the executor's whole-result caches
        already key (the root of a Union/Intersect/Difference call) —
        those skip subresult-cache marking to avoid double storage."""
        name = call.name
        if name == "Bitmap":
            return self._plan_leaf(idx, call, slices, all_local, deps)
        if name in _BITMAP_OPS:
            return self._plan_bitmap_op(idx, index, call, slices,
                                        all_local, record, covered,
                                        deps)
        # Wrappers (Count/TopN/...) — plan bitmap children; the call
        # itself is a pass-through node.
        node = PlanNode(name)
        for child in call.children:
            node.children.append(self._plan_call(
                idx, index, child, slices, all_local, record,
                deps=deps))
        if node.children:
            first = node.children[0]
            node.est_rows = first.est_rows
            node.exact = first.exact
            if name == "Count" and first.short_circuit:
                # Count of a proven-empty subtree answers 0 without
                # fan-out.
                node.short_circuit = True
                self._decide(record, node, "short_circuit")
        return node

    def _plan_bitmap_op(self, idx, index: str, call: Call, slices,
                        all_local: bool, record: PlanRecord,
                        covered: bool,
                        deps: Optional[list] = None) -> PlanNode:
        node = PlanNode(call.name)
        child_nodes = [self._plan_call(idx, index, c, slices,
                                       all_local, record, deps=deps)
                       for c in call.children]

        # Short-circuit rewrites (exact proofs only).
        if call.name == "Intersect":
            if any(c.exact and c.est_rows == 0 for c in child_nodes):
                node.short_circuit = True
                node.est_rows, node.exact = 0, True
                node.children = child_nodes
                self._decide(record, node, "short_circuit")
                return node
        elif call.name == "Union":
            keep = [i for i, c in enumerate(child_nodes)
                    if not (c.exact and c.est_rows == 0)]
            if not keep:
                node.short_circuit = True
                node.est_rows, node.exact = 0, True
                node.children = child_nodes
                self._decide(record, node, "short_circuit")
                return node
            if len(keep) < len(child_nodes):
                call.children = [call.children[i] for i in keep]
                child_nodes = [child_nodes[i] for i in keep]
                self._decide(record, node, "short_circuit")
        elif call.name == "Difference":
            if (child_nodes and child_nodes[0].exact
                    and child_nodes[0].est_rows == 0):
                node.short_circuit = True
                node.est_rows, node.exact = 0, True
                node.children = child_nodes
                self._decide(record, node, "short_circuit")
                return node
            keep = [0] + [i for i in range(1, len(child_nodes))
                          if not (child_nodes[i].exact
                                  and child_nodes[i].est_rows == 0)]
            if child_nodes and len(keep) < len(child_nodes):
                call.children = [call.children[i] for i in keep]
                child_nodes = [child_nodes[i] for i in keep]
                self._decide(record, node, "short_circuit")

        # Reorder commutative operands smallest-first.
        if call.name in ("Intersect", "Union") and len(child_nodes) > 1:
            order = sorted(
                range(len(child_nodes)),
                key=lambda i: (child_nodes[i].est_rows
                               if child_nodes[i].est_rows is not None
                               else float("inf")))
            if order != list(range(len(child_nodes))):
                call.children = [call.children[i] for i in order]
                child_nodes = [child_nodes[i] for i in order]
                self._decide(record, node, "reordered")

        node.children = child_nodes

        # Combined estimate.
        ests = [c.est_rows for c in child_nodes]
        known = [e for e in ests if e is not None]
        all_exact = bool(child_nodes) and all(c.exact
                                              for c in child_nodes)
        if call.name == "Intersect" and known:
            node.est_rows = min(known)
            node.exact = all_exact and node.est_rows == 0
        elif call.name == "Union" and len(known) == len(ests):
            node.est_rows = sum(known)
            node.exact = all_exact and node.est_rows == 0
        elif call.name == "Difference" and ests and ests[0] is not None:
            node.est_rows = ests[0]
            node.exact = child_nodes[0].exact and node.est_rows == 0

        # Purity: every descendant contributed a known frame/view set.
        frames: set = set()
        pure = bool(child_nodes)
        for c in child_nodes:
            if not c.frames:
                pure = False
                break
            frames.update(c.frames)
        if pure:
            node.frames = frozenset(frames)
            node.key = str(call)
            if not covered:
                self._mark_cse(node)
            self._placement(node, slices)
        return node

    def _plan_leaf(self, idx, call: Call, slices,
                   all_local: bool,
                   deps: Optional[list] = None) -> PlanNode:
        node = PlanNode("Bitmap")
        frame_name = call.args.get("frame")
        if not isinstance(frame_name, str) or not frame_name:
            frame_name = "general"  # executor.DEFAULT_FRAME
        if idx is None or call.args.get("filter") is not None:
            return node
        frame = idx.frames.get(frame_name)
        if frame is None:
            # No frame: estimation stays open (the executor raises its
            # own FrameNotFound; planning must not pre-empt errors).
            return node
        try:
            row_id, row_ok = call.uint_arg(frame.row_label)
        except ValueError:
            row_ok = False
            row_id = 0
        if not row_ok:
            # Inverse leaves (columnID) read the inverse view over a
            # different slice domain; leave them unestimated.
            return node
        node.detail = f"{frame_name}/{row_id}"
        view = frame.views.get("standard")
        node.frames = frozenset((f"{frame_name}/standard",))
        node.key = str(call)
        if deps is not None:
            deps.append(("frame", frame_name, frame))
            # A view APPEARING breaks a proof ("no view" = exact 0).
            deps.append(("view", frame, view))
        est, exact = self._estimate_row(view, row_id, slices,
                                        all_local, deps)
        node.est_rows, node.exact = est, exact
        return node

    def _estimate_row(self, view, row_id: int, slices,
                      all_local: bool,
                      deps: Optional[list] = None) -> tuple[int, bool]:
        """Estimated bits for one (frame, standard view, row) over
        ``slices``. Exact only when every slice was enumerated against
        a local fragment (or a provably absent one)."""
        if view is None:
            return (0, all_local)
        if len(slices) > EXACT_SLICES:
            step = max(1, len(slices) // ESTIMATE_SAMPLES)
            sample = slices[::step][:ESTIMATE_SAMPLES]
            total, _ = self._sum_slices(view, row_id, sample, False,
                                        deps)
            scaled = int(total * len(slices) / max(len(sample), 1))
            return (scaled, False)
        return self._sum_slices(view, row_id, slices, all_local, deps)

    def _sum_slices(self, view, row_id: int, slices,
                    all_local: bool,
                    deps: Optional[list] = None) -> tuple[int, bool]:
        total = 0
        exact = all_local
        for s in slices:
            frag = view.fragments.get(s)
            if frag is None:
                # Locally absent fragment = 0 bits — exact only when
                # this node owns every slice of the query. The absence
                # itself is a memo dependency: a fragment appearing
                # voids the proof.
                if deps is not None:
                    deps.append(("frag", view, s, None))
                continue
            key = (id(view), row_id, s)
            epoch = getattr(frag, "_epoch", 0)
            if deps is not None:
                deps.append(("frag", view, s, epoch))
            with self._mu:
                hit = self._estimates.get(key)
                if hit is not None and hit[0] == epoch:
                    self._estimates.move_to_end(key)
                    total += hit[1]
                    continue
            n = 0
            try:
                if frag.cache is not None:
                    n = int(frag.cache.get(row_id))
                if n <= 0:
                    if frag.tier_state != "hot":
                        # Never fault a cold fragment in to plan a
                        # query: the estimate stays open.
                        exact = False
                        continue
                    n = int(frag.row_count(row_id))
            except Exception:
                exact = False
                continue
            total += n
            with self._mu:
                self._estimates[key] = (epoch, n)
                while len(self._estimates) > _ESTIMATE_CACHE_ENTRIES:
                    self._estimates.popitem(last=False)
        return (total, exact)

    # -- CSE + placement -----------------------------------------------------

    def _mark_cse(self, node: PlanNode) -> None:
        """Interior pure subtrees consult the subresult cache; a
        subtree STORES once its canonical form has been seen twice
        (within one batch or across queries) — first sightings only
        register, so one-off shapes never occupy cache budget."""
        with self._mu:
            count = self._seen.get(node.key, 0) + 1
            self._seen[node.key] = count
            self._seen.move_to_end(node.key)
            while len(self._seen) > _SEEN_ENTRIES:
                self._seen.popitem(last=False)
        node.cache_lookup = True
        node.cache_store = count >= 2
        if count >= 2 and "cse" not in node.decisions:
            node.decisions.append("cse")

    def _placement(self, node: PlanNode, slices) -> None:
        """Price host vs device for this subtree from the measured
        constants. Only a clear host win becomes a hint (the costmodel
        margin rule); everything else stays ``auto`` and the usual
        device gates decide."""
        cal = self.calibration
        if cal is None or not slices:
            return
        leaves = _count_leaves(node)
        n_slices = len(slices)
        slab = n_slices * WORDS_PER_SLICE * 4
        device_bytes = leaves * slab
        host_bytes = 0
        for leaf_est in _leaf_estimates(node):
            if leaf_est is None:
                host_bytes += slab
            else:
                # Roaring walk cost: ~2 bytes/bit in array containers,
                # capped at the dense slab.
                host_bytes += min(leaf_est * 2, slab)
        host = cal.host_cost(host_bytes)
        device = cal.device_cost(device_bytes)
        node.est_cost_s = min(host, device)
        if host < self.margin * device:
            node.placement = "host"
            node.decisions.append("placement:host")
            self._bump("placement")
        else:
            node.placement = "device"

    # -- subresult cache wiring ----------------------------------------------

    def subresult_key(self, index: str, node: PlanNode,
                      slice: int) -> Optional[tuple]:
        """The generation-token cache key for one planned subtree at
        one slice, or None when any involved fragment is untracked."""
        toks = generations.slice_tokens(self.holder, index, slice)
        out = []
        for fv in sorted(node.frames):
            out.append((fv, toks.get(fv, (0, 0))))
        return (index, node.key, int(slice), tuple(out))


def observe_misestimate(node: PlanNode, rows: int) -> None:
    """Stamp a node's actual cardinality and observe its
    actual/estimated ratio (pilosa_planner_misestimation_ratio)."""
    node.actual_rows = rows
    if node.est_rows is None:
        return
    obs_metrics.PLANNER_MISESTIMATE.observe(
        (rows + 1) / (node.est_rows + 1))


def _memo_call_key(call: Call) -> tuple:
    """Structural memo key for one call — a nested tuple, much cheaper
    to build than the canonical string. Raises TypeError on an
    unhashable literal (caller plans uncached)."""
    items = []
    for k in sorted(call.args):
        v = call.args[k]
        if isinstance(v, Condition):
            v = (v.op, v.value if not isinstance(v.value, list)
                 else tuple(v.value))
        elif isinstance(v, list):
            v = tuple(v)
        items.append((k, v))
    return (call.name, tuple(items),
            tuple(_memo_call_key(c) for c in call.children))


def _walk_nodes(node: PlanNode):
    yield node
    for c in node.children:
        yield from _walk_nodes(c)


def _count_leaves(node: PlanNode) -> int:
    if not node.children:
        return 1
    return sum(_count_leaves(c) for c in node.children)


def _leaf_estimates(node: PlanNode):
    if not node.children:
        yield node.est_rows
        return
    for c in node.children:
        yield from _leaf_estimates(c)

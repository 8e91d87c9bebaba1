"""Executor: per-call PQL dispatch over the slices of one holder.

Trimmed copy of the JAX package's ``executor.py`` (reference
executor.go): ``execute(index, pql)`` parses the query and runs its
calls in order. What the port serves:

- **Count** of any bitmap tree of ``Bitmap`` leaves (a row of the
  standard view, or with ``columnID`` a row of the inverse view),
  ``Range`` leaves and ``Intersect``/``Union``/``Difference`` folds runs
  on the device, over every slice at once (``_execute_count``): the tree
  compiles to an expression over leaf slabs kept resident in the
  budgeted device cache (parallel.residency) and the expression-count
  kernel counts it (parallel.mesh.count_expr_sharded). A time ``Range``
  is an or-fold of one leaf per view of its minimal time-view cover; a
  BSI ``Range(field OP value)`` is the comparison as a fold over the
  field's bit planes (storage.bsi.compare_fold_expr).
- **Sum** of a BSI field is depth+1 plane counts, each plane ∧ the
  optional filter, on the device (``_sum_device``), folded as
  ``min·count + Σ 2^i·count_i`` in Python ints; **Min** and **Max** run
  the plane walk on the host, as in the JAX package.
- **TopN**, every form the JAX package answers on one node
  (``_execute_top_n``): sourceless or with one source, with or without
  ``ids``, ``n``, ``threshold``, ``tanimotoThreshold`` and
  ``field``/``filters``, over LRU and ranked count caches. Plain
  sourceless TopN over complete LRU caches is one pass over the rank
  arrays on the host; otherwise the reference's two phases run — the
  per-slice candidate phase over the rank caches (``fragment.top``),
  then the exact refetch of the candidate union. With a source the
  refetch counts every candidate on the device (the TopN block count;
  threshold > 1 and Tanimoto prune per slice on the device); without
  one it is a device top-k while the block fits TOPN_BLOCK_BYTES. The
  ids-without-source form reads the rank caches on the host, as the
  JAX package does, and blocks over _TOPN_HOST_BLOCK_BYTES take the
  per-slice path.
- ``Bitmap``/``Range``/``Intersect``/``Union``/``Difference`` as
  top-level calls are materialized by host roaring algebra over the
  fragments (a BSI ``Range`` by the JAX package's circuit,
  storage.bsi.range_bitmap); a top-level ``Bitmap`` carries its row's
  (or column's) attributes, and one of a column runs over the inverse
  view's slices.
- ``SetBit``/``ClearBit`` on the standard and inverse views (with a
  timestamp, also on the time views), ``SetFieldValue``,
  ``SetRowAttrs`` and ``SetColumnAttrs`` (a query of ``SetRowAttrs``
  calls alone is one bulk write per frame).

Before a read query runs, the cost-based planner (plan.planner, as in
the JAX package's ``_maybe_plan``) rewrites a clone of it: operands
proven empty from the data are dropped or empty their parent (a Count
of a proven-empty tree answers 0 and launches nothing; a TopN over a
proven-empty source answers no pair), commutative operands are
reordered smallest-first (the device program changes order, not
shape), and repeated interior subtrees of the host folds go through
the per-slice subresult cache. ``planner_enabled = False`` runs the
parsed tree as it is.

A device error surfaces to the caller: there is no host fallback.
Single node, one device: the cluster fan-out, TopN pushdown, pod,
result caches, cost model (and with it the planner's placement) and
fault handling wait for later slices.
"""

from __future__ import annotations

import datetime as dt
from typing import Optional

import numpy as np

from .device import resolve_device
from .errors import (TIME_FORMAT, FrameNotFoundError, IndexNotFoundError,
                     PilosaError, QueryRequiredError)
from .models.view import VIEW_INVERSE, VIEW_STANDARD
from .ops.packed import WORDS_PER_SLICE
from .parallel import mesh as mesh_mod
from .parallel import residency
from .plan import planner as plan_planner
from .pql.ast import Call, Query
from .pql.parser import parse as parse_pql
from .storage import bsi
from .storage.bitmap import Bitmap, BitmapSegment
from .storage.cache import LRUCache, Pair, pairs_sort
from .storage.fragment import TopOptions
from .utils import timequantum as tq

# Frame used when a call does not specify one (executor.go:35).
DEFAULT_FRAME = "general"

MIN_THRESHOLD = 1

_WRITE_CALLS = ("SetBit", "ClearBit", "SetFieldValue", "SetRowAttrs",
                "SetColumnAttrs")


def _has_only_set_row_attrs(calls: list[Call]) -> bool:
    return bool(calls) and all(c.name == "SetRowAttrs" for c in calls)


def _needs_slices(calls: list[Call]) -> bool:
    # executor.go:1273-1289
    if not calls:
        return False
    return any(c.name not in _WRITE_CALLS for c in calls)


def _attach_plan_nodes(call: Call, node) -> None:
    """Pair the planner's PlanNode tree onto the cloned Call tree via a
    ``_plan_node`` attribute, so the per-slice hooks read the plan from
    the call itself. The planner clones calls 1:1 with the nodes it
    emits (drops happen to both sides together), so a zip is exact; a
    length mismatch would mean a planner bug and attaching stops rather
    than mis-pair hints."""
    call._plan_node = node
    if len(call.children) != len(node.children):
        return
    for ch_call, ch_node in zip(call.children, node.children):
        _attach_plan_nodes(ch_call, ch_node)


def _short_circuit(c: Call) -> bool:
    """True when the planner proved ``c`` empty."""
    node = getattr(c, "_plan_node", None)
    return node is not None and node.short_circuit


def _parse_timestamp(c: Call, key: str = "timestamp"
                     ) -> Optional[dt.datetime]:
    v = c.args.get(key)
    if v is None:
        return None
    if isinstance(v, dt.datetime):
        return v
    try:
        return dt.datetime.strptime(v, TIME_FORMAT)
    except (TypeError, ValueError):
        raise PilosaError(f"invalid date: {v}")


class Executor:
    """Executes PQL queries against a Holder on one device.

    ``device`` is the card (``cuda:0``) unless the caller passes
    ``"cpu"``, where every kernel wrapper computes its plain version.
    """

    _DEVICE_FOLD_OPS = {"Intersect": "and", "Union": "or",
                        "Difference": "andnot"}

    # Largest dense candidate block the TopN device leg may pack on the
    # host for the streaming form (slices × candidates × 128 KB).
    _TOPN_HOST_BLOCK_BYTES = 2 << 30

    def __init__(self, holder, device=None):
        self.holder = holder
        self.device = resolve_device(device)
        # Cost-based planner (plan.planner), consulted once per read
        # query; on by default as in the JAX package.
        self.planner = plan_planner.Planner(holder)
        self.planner_enabled = True

    def execute(self, index: str, query,
                slices: Optional[list[int]] = None) -> list:
        if not index:
            raise PilosaError("index required")
        if isinstance(query, str):
            query = parse_pql(query)
        if not isinstance(query, Query):
            raise QueryRequiredError("query required")
        needs = _needs_slices(query.calls)
        # A top-level Bitmap of a column reads the inverse view, whose
        # slices follow row ids: it takes the inverse slice list when
        # the caller gave no slices, as in the JAX package's _execute.
        # Every other call, a Count of inverse leaves too, takes the
        # column slices.
        computed_slices = not slices
        inverse_slices: list[int] = []
        column_label = "columnID"
        if not slices and needs:
            idx = self.holder.index(index)
            if idx is None:
                raise IndexNotFoundError(index)
            slices = list(range(idx.max_slice() + 1))
            inverse_slices = list(range(idx.max_inverse_slice() + 1))
            column_label = idx.column_label
        slices = slices or []
        if _has_only_set_row_attrs(query.calls):
            return self._execute_bulk_set_row_attrs(index, query.calls)
        if slices and needs:
            query = self._maybe_plan(index, query, slices)
        results = []
        i = 0
        while i < len(query.calls):
            # Consecutive SetBit/ClearBit calls batch into one batched
            # mutation + WAL append per touched fragment.
            wbatch = self._mutate_batch_run(index, query.calls, i)
            if wbatch is not None:
                bools, n = wbatch
                results.extend(bools)
                i += n
                continue
            call = query.calls[i]
            call_slices = slices
            if call.supports_inverse() and needs and computed_slices:
                frame_name = call.args.get("frame") or DEFAULT_FRAME
                frame = self.holder.frame(index, frame_name)
                if frame is None:
                    raise FrameNotFoundError(frame_name)
                if call.is_inverse(frame.row_label, column_label):
                    call_slices = inverse_slices
            results.append(self._execute_call(index, call, call_slices))
            i += 1
        return results

    # -- cost-based planning (plan.planner) ----------------------------------

    def _maybe_plan(self, index: str, query: Query,
                    slices: list[int]) -> Query:
        """The planned clone of a read query, or ``query`` itself when
        planning is off or the query writes. The plan tree rides each
        cloned Call as ``_plan_node``. Planning failure is never a
        query failure: the original tree executes."""
        if not self.planner_enabled or query.write_calls():
            return query
        try:
            planned, rec = self.planner.plan_query_cached(
                index, query.calls, slices)
        except (PilosaError, ValueError, TypeError):
            # Planning never fails a query: the tree runs as parsed, and
            # its own errors surface there.
            return query
        for call, node in zip(planned, rec.roots):
            # Memo hits return calls already carrying their plan node.
            if getattr(call, "_plan_node", None) is not node:
                _attach_plan_nodes(call, node)
        return Query(planned)

    def explain(self, index: str, query,
                slices: Optional[list[int]] = None) -> dict:
        """EXPLAIN-only (?plan=1): plan the query without executing
        and return the plan tree."""
        if isinstance(query, str):
            query = parse_pql(query)
        if not isinstance(query, Query):
            raise QueryRequiredError("query required")
        if query.write_calls():
            raise PilosaError("cannot EXPLAIN a write query")
        if not slices:
            idx = self.holder.index(index)
            if idx is None:
                raise IndexNotFoundError(index)
            slices = list(range(idx.max_slice() + 1))
        return self.planner.explain(index, query.calls, slices)

    def _execute_call(self, index: str, c: Call, slices: list[int]):
        # executor.go:146-170
        if c.name == "ClearBit":
            return self._execute_mutate_bit(index, c, set=False)
        if c.name == "Count":
            return self._execute_count(index, c, slices)
        if c.name == "SetBit":
            return self._execute_mutate_bit(index, c, set=True)
        if c.name == "SetRowAttrs":
            _, frame, row_id, attrs = self._row_attrs_of(index, c)
            frame.row_attr_store.set_attrs(row_id, attrs)
            return None
        if c.name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c)
            return None
        if c.name == "TopN":
            return self._execute_top_n(index, c, slices)
        if c.name in ("Sum", "Min", "Max"):
            return self._execute_field_aggregate(index, c, slices)
        if c.name == "SetFieldValue":
            return self._execute_set_field_value(index, c)
        return self._execute_bitmap_call(index, c, slices)

    # -- bitmap calls on the host --------------------------------------------

    def _execute_bitmap_call(self, index: str, c: Call,
                             slices: list[int]) -> Bitmap:
        if _short_circuit(c):
            return Bitmap()
        bm = Bitmap()
        for slice in slices:
            bm.merge(self._bitmap_call_slice(index, c, slice))
        if c.name == "Bitmap":
            self._attach_bitmap_attrs(index, c, bm)
        return bm

    def _attach_bitmap_attrs(self, index: str, c: Call, bm: Bitmap) -> None:
        # executor.go:215-249: column attrs if the column label was used,
        # row attrs otherwise.
        idx = self.holder.index(index)
        if idx is None:
            return
        column_id, col_ok = c.uint_arg(idx.column_label)
        if col_ok:
            bm.attrs = idx.column_attr_store.attrs(column_id)
            return
        frame = idx.frame(c.args.get("frame") or DEFAULT_FRAME)
        if frame is not None:
            row_id, ok = c.uint_arg(frame.row_label)
            if ok:
                bm.attrs = frame.row_attr_store.attrs(row_id)

    def _bitmap_call_slice(self, index: str, c: Call, slice: int) -> Bitmap:
        # Plan consult (when the call was planned): proven-empty
        # subtrees return without touching storage, and CSE-marked
        # interior nodes go through the generation-token-keyed
        # subresult cache — a write between queries changes the key,
        # so a stale entry is never served.
        node = getattr(c, "_plan_node", None)
        if node is not None:
            if node.short_circuit:
                return Bitmap()
            if node.cache_lookup:
                key = self.planner.subresult_key(index, node, slice)
                hit = self.planner.subresults.get(key)
                if hit is not None:
                    return _share_result(hit)
                r = self._bitmap_slice_dispatch(index, c, slice)
                if node.cache_store:
                    self.planner.subresults.put(key, _share_result(r),
                                                r.count())
                return r
        return self._bitmap_slice_dispatch(index, c, slice)

    def _bitmap_slice_dispatch(self, index: str, c: Call,
                               slice: int) -> Bitmap:
        # executor.go:253-268
        if c.name == "Bitmap":
            return self._bitmap_slice(index, c, slice)
        if c.name == "Difference":
            return self._fold_slice(index, c, slice, "difference",
                                    require_children=True)
        if c.name == "Intersect":
            return self._fold_slice(index, c, slice, "intersect",
                                    require_children=True)
        if c.name == "Range":
            return self._range_slice(index, c, slice)
        if c.name == "Union":
            return self._fold_slice(index, c, slice, "union",
                                    require_children=False)
        raise PilosaError(f"unknown call: {c.name}")

    def _fold_slice(self, index: str, c: Call, slice: int, op: str,
                    require_children: bool) -> Bitmap:
        if require_children and not c.children:
            raise PilosaError(f"empty {c.name} query is currently"
                              " not supported")
        out = Bitmap()
        for i, child in enumerate(c.children):
            bm = self._bitmap_call_slice(index, child, slice)
            out = bm if i == 0 else getattr(out, op)(bm)
        return out

    def _bitmap_slice(self, index: str, c: Call, slice: int) -> Bitmap:
        # executor.go:420-465: row id → standard view, column id → inverse.
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        frame_name = c.args.get("frame") or DEFAULT_FRAME
        frame = idx.frame(frame_name)
        if frame is None:
            raise FrameNotFoundError(frame_name)
        row_id, row_ok = c.uint_arg(frame.row_label)
        col_id, col_ok = c.uint_arg(idx.column_label)
        if row_ok and col_ok:
            raise PilosaError(
                f"Bitmap() cannot specify both {frame.row_label} and"
                f" {idx.column_label} values")
        if not row_ok and not col_ok:
            raise PilosaError(
                f"Bitmap() must specify either {frame.row_label} or"
                f" {idx.column_label} values")
        view, id = VIEW_STANDARD, row_id
        if col_ok:
            view, id = VIEW_INVERSE, col_id
            if not frame.inverse_enabled:
                raise PilosaError("Bitmap() cannot retrieve columns unless"
                                  " inverse storage enabled")
        frag = self.holder.fragment(index, frame_name, view, slice)
        if frag is None:
            return Bitmap()
        return frag.row(id)

    # -- Range: time views and BSI fields (executor.go:490-546) --------------

    def _range_views(self, index: str, c: Call, strict: bool):
        """``(frame_name, row_id, view_names)`` of a time Range: the
        minimal time-view cover. The one parse of both the host path
        and the device compiler; ``strict`` raises the host path's
        errors, otherwise a malformed call gives None. An empty view
        list (no time quantum) is an empty result, not an error."""
        frame_name = c.args.get("frame") or DEFAULT_FRAME
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            if not strict:
                return None
            raise FrameNotFoundError(frame_name)
        row_id, ok = c.uint_arg(frame.row_label)
        if not ok:
            if not strict:
                return None
            raise PilosaError(
                f"Range() row field '{frame.row_label}' required")
        start = c.args.get("start")
        if start is None:
            if not strict:
                return None
            raise PilosaError("Range() start time required")
        end = c.args.get("end")
        if end is None:
            if not strict:
                return None
            raise PilosaError("Range() end time required")
        try:
            start_t = dt.datetime.strptime(start, TIME_FORMAT)
            end_t = dt.datetime.strptime(end, TIME_FORMAT)
        except (TypeError, ValueError):
            if not strict:
                return None
            raise PilosaError("cannot parse Range() time")
        q = frame.time_quantum()
        if not q:
            return frame_name, row_id, []
        return (frame_name, row_id,
                tq.views_by_time_range(VIEW_STANDARD, start_t, end_t, q))

    def _field_range_parse(self, index: str, c: Call, strict: bool):
        """``(frame_name, Field, Condition)`` of a Range with a ``field
        OP value`` condition; None without one, or (not strict) when
        the frame or field is missing."""
        pair = c.condition_arg()
        if pair is None:
            return None
        field_name, cond = pair
        frame_name = c.args.get("frame") or DEFAULT_FRAME
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            if not strict:
                return None
            raise FrameNotFoundError(frame_name)
        field = frame.field(field_name)
        if field is None:
            if not strict:
                return None
            raise PilosaError(f"field not found: {field_name}")
        return frame_name, field, cond

    @staticmethod
    def _bsi_plane_row(plane: int) -> int:
        """Circuit plane (bsi.EXISTS_PLANE or value bit i) → the field
        view's row id."""
        if plane == bsi.EXISTS_PLANE:
            return bsi.EXISTS_ROW
        return bsi.PLANE_ROW_OFFSET + plane

    def _field_range_slice(self, index: str, c: Call,
                           slice: int) -> Bitmap:
        """Host leg of Range(field OP value): the JAX package's circuit
        over the fragment's rows in roaring algebra."""
        frame_name, field, cond = self._field_range_parse(index, c,
                                                          strict=True)
        frag = self.holder.fragment(index, frame_name, field.view_name,
                                    slice)
        if frag is None:
            return Bitmap()
        bm = bsi.range_bitmap(
            cond.op, cond.value, field.min, field.max,
            lambda plane: frag.row(self._bsi_plane_row(plane)))
        return bm if bm is not None else Bitmap()

    def _range_slice(self, index: str, c: Call, slice: int) -> Bitmap:
        # executor.go:490-546: union the minimal time-view cover.
        if c.condition_arg() is not None:
            return self._field_range_slice(index, c, slice)
        frame_name, row_id, views = self._range_views(index, c,
                                                      strict=True)
        bm = Bitmap()
        for view in views:
            frag = self.holder.fragment(index, frame_name, view, slice)
            if frag is not None:
                bm = bm.union(frag.row(row_id))
        return bm

    # -- Sum / Min / Max over a BSI field ------------------------------------

    def _execute_field_aggregate(self, index: str, c: Call,
                                 slices: list[int]) -> bsi.ValCount:
        """Sum / Min / Max of a BSI field, with an optional filter
        bitmap child. Sum runs on the device when its filter compiles;
        otherwise, and for Min and Max, one batched plane walk over
        every slice on the host (bsi.sum_count_many / min_max_many)."""
        name = c.name
        frame_name = c.args.get("frame") or DEFAULT_FRAME
        field_name = c.args.get("field")
        if not field_name or not isinstance(field_name, str):
            raise PilosaError(f"{name}() field required")
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise FrameNotFoundError(frame_name)
        field = frame.field(field_name)
        if field is None:
            raise PilosaError(f"field not found: {field_name}")
        if len(c.children) > 1:
            raise PilosaError(
                f"{name}() only accepts a single bitmap input")
        child = c.children[0] if c.children else None
        if name == "Sum" and slices:
            out = self._sum_device(index, frame_name, field, child, slices)
            if out is not None:
                return out
        legs = []
        for s in slices:
            frag = self.holder.fragment(index, frame_name,
                                        field.view_name, s)
            if frag is None:
                continue
            filt = (self._bitmap_call_slice(index, child, s)
                    if child is not None else None)
            legs.append((lambda plane, f=frag:
                         f.row(self._bsi_plane_row(plane)), filt))
        if name == "Sum":
            return bsi.sum_count_many(field.min, field.max, legs)
        return bsi.min_max_many(field.min, field.max, legs,
                                want_min=name == "Min")

    def _sum_exprs(self, index: str, frame_name: str, field,
                   child: Optional[Call]):
        """``(exprs, leaves)`` of a device Sum: K = depth+1 expressions,
        each a plane leaf ∧ the compiled filter (the existence row
        first), over the plane leaves and the filter's; None when the
        filter does not compile."""
        leaves: list[tuple] = []
        filter_expr = None
        if child is not None:
            filter_expr = self._compile_device_expr(index, child, leaves)
            if filter_expr is None:
                return None
        exprs = []
        for plane in range(bsi.EXISTS_PLANE, field.bit_depth):
            leaves.append((frame_name, field.view_name,
                           self._bsi_plane_row(plane)))
            leaf = ("leaf", len(leaves) - 1)
            exprs.append(leaf if filter_expr is None
                         else ("and", leaf, filter_expr))
        return tuple(exprs), leaves

    def _sum_device(self, index: str, frame_name: str, field,
                    child: Optional[Call],
                    slices: list[int]) -> Optional[bsi.ValCount]:
        """Device Sum: the K counts of ``_sum_exprs`` over resident
        plane slabs (mesh.count_exprs_sharded, one expression-count
        launch a plane); the weighted fold runs in Python ints, so no
        depth overflows. None when the filter does not compile (the
        host path owns its errors)."""
        built = self._sum_exprs(index, frame_name, field, child)
        if built is None:
            return None
        exprs, leaves = built
        arrs = [self._leaf_device_array(index, leaf, tuple(slices))
                for leaf in leaves]
        counts = mesh_mod.count_exprs_sharded(exprs, arrs)
        count = counts[0]
        total = field.min * count + sum(
            n << i for i, n in enumerate(counts[1:]))
        return bsi.ValCount(total, count)

    def _execute_set_field_value(self, index: str, c: Call) -> bool:
        """SetFieldValue(frame=f, <col>=N, <field>=V): the frame's
        per-plane write of one column (executor.go:664-691, one node)."""
        frame_name = c.args.get("frame")
        if not frame_name:
            raise PilosaError("SetFieldValue() frame required")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        frame = idx.frame(frame_name)
        if frame is None:
            raise FrameNotFoundError(frame_name)
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise PilosaError(f"SetFieldValue() column field"
                              f" '{idx.column_label}' required")
        pairs = [(k, v) for k, v in c.args.items()
                 if k not in ("frame", idx.column_label)]
        if len(pairs) != 1:
            raise PilosaError(
                "SetFieldValue() requires exactly one field=value")
        field_name, value = pairs[0]
        if isinstance(value, bool) or not isinstance(value, int):
            raise PilosaError(
                f"SetFieldValue() value must be an integer: {value!r}")
        return frame.set_field_value(field_name, col_id, value)

    # -- device expressions --------------------------------------------------

    def _compile_device_expr(self, index: str, c: Call, leaves: list):
        """Compile a pure bitmap call tree into a mesh expression tree.

        Supported: Bitmap leaves (standard or inverse) and Range (an
        or-fold over its minimal time-view cover, a leaf per view; or a
        BSI comparison) combined with Intersect/Union/Difference (n-ary
        calls fold left to right, like _fold_slice). Returns None for
        anything else (malformed args, missing frames or fields, empty
        folds, an empty time cover, a provably empty comparison) — the
        host path owns their errors and semantics. Recursion follows
        the PQL nesting depth, not the fold width.
        """
        if c.name == "Range":
            if c.condition_arg() is not None:
                return self._compile_field_range_expr(index, c, leaves)
            parsed = self._range_views(index, c, strict=False)
            if parsed is None or not parsed[2]:
                return None
            frame_name, row_id, views = parsed
            expr = None
            for vn in views:
                leaves.append((frame_name, vn, row_id))
                part = ("leaf", len(leaves) - 1)
                expr = part if expr is None else ("or", expr, part)
            return expr
        if c.name == "Bitmap":
            idx = self.holder.index(index)
            if idx is None:
                return None
            frame = idx.frame(c.args.get("frame") or DEFAULT_FRAME)
            if frame is None:
                return None
            row_id, row_ok = c.uint_arg(frame.row_label)
            col_id, col_ok = c.uint_arg(idx.column_label)
            if row_ok == col_ok:
                return None
            view, id = ((VIEW_STANDARD, row_id) if row_ok
                        else (VIEW_INVERSE, col_id))
            if view == VIEW_INVERSE and not frame.inverse_enabled:
                return None
            leaves.append((frame.name, view, id))
            return ("leaf", len(leaves) - 1)
        op = self._DEVICE_FOLD_OPS.get(c.name)
        if op is None or not c.children:
            return None
        parts = [self._compile_device_expr(index, ch, leaves)
                 for ch in c.children]
        if any(p is None for p in parts):
            return None
        expr = parts[0]
        for p in parts[1:]:
            expr = (op, expr, p)
        return expr

    def _compile_field_range_expr(self, index: str, c: Call,
                                  leaves: list):
        """Range(field OP value) as the comparison fold over the field's
        bit-plane leaves (storage.bsi.compare_fold_expr: depth+1
        instructions, ``><`` two chains and one spill slot). A clamp to
        "all" is the existence row; a clamp to "none" and a provably
        empty comparison give None (the host path answers them)."""
        parsed = self._field_range_parse(index, c, strict=False)
        if parsed is None:
            return None
        frame_name, field, cond = parsed
        clamped = bsi.clamp(cond.op, cond.value, field.min, field.max)
        if clamped == "none":
            return None
        leaf_ids: dict[tuple, int] = {}

        def leaf(plane: int):
            key = (frame_name, field.view_name, self._bsi_plane_row(plane))
            if key not in leaf_ids:
                leaves.append(key)
                leaf_ids[key] = len(leaves) - 1
            return ("leaf", leaf_ids[key])

        if clamped == "all":
            return leaf(bsi.EXISTS_PLANE)
        cop, upred = clamped
        return bsi.compare_fold_expr(cop, upred, field.bit_depth, leaf)

    def _fragment_gens(self, index: str, frame: str, view: str,
                       slices: tuple[int, ...]) -> tuple[list, tuple]:
        frags = [self.holder.fragment(index, frame, view, s)
                 for s in slices]
        gens = tuple((f.device.uid, f.device.generation) if f is not None
                     else (0, 0) for f in frags)
        return frags, gens

    def _leaf_device_array(self, index: str, leaf: tuple,
                           slices: tuple[int, ...]):
        """Device-resident ``[n_slices, words]`` slab of one PQL leaf row,
        held in the budgeted device cache. The key embeds every backing
        fragment's (uid, generation), so a write or reopen stops the
        entry being referenced and it ages out of the LRU."""
        frame, view, row_id = leaf
        frags, gens = self._fragment_gens(index, frame, view, slices)
        key = ("leaf", str(self.device), id(self.holder), index, frame,
               view, row_id, slices, gens)
        return residency.leaf_slab(self.device, key, frags, row_id)

    def _pack_leaf_block(self, index: str, leaves: list[tuple],
                         slices: list[int]) -> np.ndarray:
        """[n_leaves, n_slices, words] block of packed leaf rows; absent
        fragments stay zero."""
        block = np.zeros((len(leaves), len(slices), WORDS_PER_SLICE),
                         dtype=np.uint32)
        for li, (frame, view, row_id) in enumerate(leaves):
            for si, slice in enumerate(slices):
                frag = self.holder.fragment(index, frame, view, slice)
                if frag is not None:
                    frag.pack_row(row_id, out=block[li, si])
        return block

    # -- Count (executor.go:568-597) -----------------------------------------

    def _execute_count(self, index: str, c: Call, slices: list[int]) -> int:
        if len(c.children) == 0:
            raise PilosaError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise PilosaError("Count() only accepts a single bitmap input")
        if _short_circuit(c):
            return 0  # the planner proved the tree empty: no launch
        leaves: list[tuple] = []
        expr = self._compile_device_expr(index, c.children[0], leaves)
        if expr is None:
            # Not a device expression (an empty Union, a malformed leaf,
            # an empty time cover, a comparison clamped to none): the
            # host materialization gives the JAX package's answer or
            # raises its error.
            return self._execute_bitmap_call(index, c.children[0],
                                             slices).count()
        if not slices:
            return 0
        arrs = [self._leaf_device_array(index, leaf, tuple(slices))
                for leaf in leaves]
        return mesh_mod.count_expr_sharded(expr, arrs)

    # -- TopN (executor.go:271-396) ------------------------------------------

    def _topn_args(self, c: Call):
        frame_name = c.args.get("frame") or DEFAULT_FRAME
        n, _ = c.uint_arg("n")
        field = c.args.get("field", "")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        filters = c.args.get("filters") or []
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if min_threshold <= 0:
            min_threshold = MIN_THRESHOLD
        return (frame_name, n, field, row_ids, min_threshold, filters,
                tanimoto)

    def _execute_top_n(self, index: str, c: Call,
                       slices: list[int]) -> list[Pair]:
        if len(c.children) > 1:
            raise PilosaError("TopN() can only have one input bitmap")
        if c.children:
            src = c.children[0]
            if _short_circuit(src):
                # No candidate intersects a proven-empty source: every
                # form of TopN answers no pair (fragment.top pushes no
                # count 0) — after the Tanimoto bound, which the
                # per-slice path checks wherever a fragment exists.
                frame_name, *_, tanimoto = self._topn_args(c)
                if tanimoto > 100 and any(
                        self.holder.fragment(index, frame_name,
                                             VIEW_STANDARD, s) is not None
                        for s in slices):
                    raise PilosaError(
                        "Tanimoto Threshold is from 1 to 100 only")
                return []
            if self._compile_device_expr(index, src, []) is None:
                # Malformed, a Range the host answers (an empty time
                # cover, a comparison clamped to none), or (in a query
                # that also writes, which is not planned) a tree
                # holding an empty Union(): the host materialization
                # raises the JAX package's error for the first, and
                # the per-slice phases below answer the others.
                self._execute_bitmap_call(index, src, slices)
        # The JAX package's order (executor.py _execute_top_n): the
        # single pass over complete LRU caches, else the per-slice
        # candidate phase and, without ids, the exact refetch of the
        # candidate union — a device top-k when the sourceless block
        # fits TOPN_BLOCK_BYTES, else the per-slice path, trimmed to n.
        row_ids, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        fast = self._topn_host_single_pass(index, c, slices)
        if fast is not None:
            return fast
        pairs = self._top_n_slices(index, c, slices)
        if not pairs or row_ids:
            return pairs
        other = Call(c.name, dict(c.args, ids=sorted({p.id for p in pairs})),
                     c.children)
        dev = self._topn_device_topk(index, other, slices, n)
        if dev is not None:
            return dev
        trimmed = self._top_n_slices(index, other, slices)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _topn_host_single_pass(self, index: str, c: Call,
                               slices: list[int]) -> Optional[list[Pair]]:
        """The plain sourceless TopN form in ONE pass over the rank
        caches, or None for the general path.

        The reference runs two per-slice phases: local tops merged into
        a candidate union, then an exact-count refetch of every
        candidate on every slice (executor.go:273-310). With complete
        per-fragment LRU count caches both phases read the SAME arrays,
        so one walk yields both: the ≥floor prefix feeds a dense
        accumulator (the phase-2 exact sums, per-slice floor applied)
        and its n-trim marks candidates (the phase-1 union).

        Gates: LRU caches only (RankCache rankings are rate-limited and
        threshold-trimmed), and caches that have not evicted and cover
        every present row (an evicted row's exact count needs the
        phase-2 recount)."""
        (frame_name, n, field, row_ids, min_threshold, filters,
         tanimoto) = self._topn_args(c)
        if row_ids or c.children or (field and filters) or tanimoto > 0:
            return None
        floor = max(min_threshold, 1)
        acc_parts: list[tuple[np.ndarray, np.ndarray, int]] = []
        max_id = 0
        for slice in slices:
            frag = self.holder.fragment(index, frame_name,
                                        VIEW_STANDARD, slice)
            if frag is None:
                continue
            cache = frag.cache
            if (not isinstance(cache, LRUCache)
                    or len(cache) >= cache.max_entries
                    or not frag._cache_complete):
                return None
            with frag._mu:
                ids, counts = cache.top_arrays()
            if not len(ids):
                continue
            # counts are rank-sorted descending: the ≥floor set is a
            # prefix (same binary-search cut as fragment.top).
            cut = len(counts) - int(np.searchsorted(
                counts[::-1], floor, side="left"))
            if not cut:
                continue
            ids, counts = ids[:cut], counts[:cut]
            acc_parts.append((ids, counts, min(n, cut) if n else cut))
            max_id = max(max_id, int(ids.max()))
        if not acc_parts:
            return []
        if max_id < (1 << 24):
            # Dense accumulate: per-slice ids are unique, so fancy
            # assignment sums safely slice by slice; candidate marks
            # come from each slice's n-trimmed prefix.
            sums = np.zeros(max_id + 1, dtype=np.int64)
            cand_mark = np.zeros(max_id + 1, dtype=bool)
            for ids, counts, marks in acc_parts:
                idx = ids.astype(np.int64)
                sums[idx] += counts
                cand_mark[idx[:marks]] = True
            cand = np.flatnonzero(cand_mark)
            cand_sums = sums[cand]
        else:
            all_ids = np.concatenate([p[0] for p in acc_parts])
            all_counts = np.concatenate([p[1] for p in acc_parts])
            uids, inv = np.unique(all_ids, return_inverse=True)
            usums = np.bincount(inv,
                                weights=all_counts).astype(np.int64)
            cand = np.unique(np.concatenate(
                [p[0][:p[2]] for p in acc_parts]))
            cand_sums = usums[np.searchsorted(uids, cand)]
        order = np.lexsort((cand, -cand_sums))
        cand, cand_sums = cand[order], cand_sums[order]
        if n:
            cand, cand_sums = cand[:n], cand_sums[:n]
        return [Pair(i, cnt) for i, cnt in zip(cand.tolist(),
                                               cand_sums.tolist())]

    def _topn_device_topk(self, index: str, c: Call, slices: list[int],
                          n: int) -> Optional[list[Pair]]:
        """The sourceless TopN exact-count refetch as a device top-k
        (mesh.topn_topk_sharded): the candidate union from phase 1
        uploads as a resident block, the TopN block count with no
        expression counts every candidate on every slice, and the top k
        come back in ``pairs_sort`` order. Plain form only — thresholds
        > 1, Tanimoto and attribute filters keep the per-slice path,
        which owns those semantics. Counts are fresh popcounts. None =
        the form or the block size (over TOPN_BLOCK_BYTES) takes the
        per-slice path."""
        (frame_name, _n, field, row_ids, min_threshold, filters,
         tanimoto) = self._topn_args(c)
        if (c.children or (field and filters) or tanimoto > 0
                or min_threshold > 1 or not row_ids or not slices):
            return None
        ids = list(row_ids)
        block_bytes = len(slices) * len(ids) * WORDS_PER_SLICE * 4
        if block_bytes > mesh_mod.TOPN_BLOCK_BYTES:
            return None
        k = min(n, len(ids)) if n else len(ids)
        frags, rows_key = self._topn_rows_key(index, frame_name,
                                              tuple(ids), tuple(slices))
        rows_arr = residency.candidate_block(self.device, rows_key, frags,
                                             tuple(ids))
        counts, idxs = mesh_mod.topn_topk_sharded(None, rows_arr, [], k)
        return [Pair(ids[i], cnt)
                for i, cnt in zip(idxs, counts) if cnt > 0]

    def _top_n_slices(self, index: str, c: Call,
                      slices: list[int]) -> list[Pair]:
        """One TopN phase over every slice: the device leg for the
        with-source ids forms, else the vectorized host leg for the
        sourceless forms, else ``fragment.top`` slice by slice; per-slice
        pairs summed by id (int64), then ``pairs_sort``."""
        if not slices:
            return []
        out = NotImplemented
        device_fn = self._topn_local_device_fn(index, c)
        if device_fn is not None:
            out = device_fn(slices)
        if out is NotImplemented:
            host_fn = self._topn_local_host_fn(index, c)
            if host_fn is not None:
                out = host_fn(slices)
        merged: dict[int, int] = {}
        if isinstance(out, dict):
            merged = out
        elif out is not NotImplemented:
            for p in out:
                merged[p.id] = merged.get(p.id, 0) + p.count
        else:
            for slice in slices:
                for p in self._top_n_slice(index, c, slice):
                    merged[p.id] = merged.get(p.id, 0) + p.count
        return pairs_sort(Pair(i, cnt) for i, cnt in merged.items())

    def _topn_local_device_fn(self, index: str, c: Call):
        """The TopN exact-count phase on the device: ALL candidate rows
        × ALL slices at once, for the with-source ids forms (explicit
        candidate ids plus a device-compilable source bitmap). The plain
        form sums the TopN block counts; threshold > 1 and Tanimoto run
        the per-slice pruning on the device (mesh.topn_filtered_sharded,
        fragment.go:560-614 semantics); attribute filters drop candidates
        on the host first (row attrs are frame-global, so pre-filtering
        ids is exactly the per-slice filter). The ids-without-source form
        stays on the host on purpose: there the per-slice path answers
        from RankCache counts, and the device's fresh popcounts could
        disagree with a stale cache entry. None = the form takes another
        leg; the returned function gives NotImplemented when the frame
        is missing or the candidate block is over _TOPN_HOST_BLOCK_BYTES
        (the per-slice path, which never builds a dense block)."""
        (frame_name, _n, field, row_ids, min_threshold, filters,
         tanimoto) = self._topn_args(c)
        if not row_ids or tanimoto > 100 or len(c.children) != 1:
            return None
        leaves: list[tuple] = []
        expr = self._compile_device_expr(index, c.children[0], leaves)
        if expr is None:
            return None
        threshold = max(min_threshold, MIN_THRESHOLD)

        def local_fn(slices: list[int]):
            ids = self._attr_filtered_ids(index, frame_name, row_ids,
                                          field, filters)
            if ids is None:
                return NotImplemented
            if not ids:
                return []
            block_bytes = len(slices) * len(ids) * WORDS_PER_SLICE * 4
            if block_bytes > self._TOPN_HOST_BLOCK_BYTES:
                return NotImplemented
            if block_bytes <= mesh_mod.TOPN_BLOCK_BYTES:
                counts = self._topn_exact_resident(
                    index, frame_name, expr, leaves, tuple(ids),
                    tuple(slices), threshold, tanimoto)
            else:
                counts = mesh_mod.topn_exact(
                    self.device, expr,
                    self._pack_candidate_rows(index, frame_name, ids,
                                              slices),
                    self._pack_leaf_block(index, leaves, slices),
                    threshold=threshold, tanimoto=tanimoto)
            return [Pair(rid, cnt) for rid, cnt in zip(ids, counts)
                    if cnt > 0]

        return local_fn

    def _topn_local_host_fn(self, index: str, c: Call):
        """Vectorized host leg for the sourceless TopN forms: one
        rank-array pass per fragment, merged as a single id→count dict.
        It replays the per-slice semantics (floor, then the per-slice
        n-trim for the plain form; cache counts with recounts of misses
        for the ids form) in numpy. None when the form needs the
        per-slice path (source bitmap, attribute filters, Tanimoto)."""
        (frame_name, n, field, row_ids, min_threshold, filters,
         tanimoto) = self._topn_args(c)
        if c.children or (field and filters) or tanimoto > 0:
            return None

        def host_fn(batch: list[int]):
            floor = max(min_threshold, 1)
            merged_ids: list[np.ndarray] = []
            merged_counts: list[np.ndarray] = []
            row_arr = (np.asarray(sorted(row_ids), dtype=np.uint64)
                       if row_ids else None)
            for slice in batch:
                frag = self.holder.fragment(index, frame_name,
                                            VIEW_STANDARD, slice)
                if frag is None:
                    continue
                if row_arr is not None and not isinstance(frag.cache,
                                                          LRUCache):
                    # RankCache rankings are rate-limited (stale up to
                    # 10 s) and threshold-trimmed; the per-slice path's
                    # cache.get() reads fresh entries — only the LRU
                    # cache's arrays are equivalent to get().
                    return NotImplemented
                with frag._mu:
                    frag.cache.invalidate()
                    ids, counts = frag.cache.top_arrays()
                    if row_arr is None:
                        # plain form: the ≥-floor prefix, then the
                        # per-slice n trim (fragment.top's array path).
                        cut = len(counts) - int(np.searchsorted(
                            counts[::-1], floor, side="left"))
                        ids, counts = ids[:cut], counts[:cut]
                        if n:
                            ids, counts = ids[:n], counts[:n]
                    elif len(ids) == 0:
                        # empty cache: every candidate goes through the
                        # recount.
                        ids, counts = self._topn_recount(
                            frag, row_arr,
                            np.zeros(len(row_arr), np.int64),
                            np.arange(len(row_arr)), floor)
                    else:
                        # ids form: per-slice counts per candidate; cache
                        # misses with bits recount via row_count
                        # (fragment._top_pairs semantics) + the per-slice
                        # floor.
                        order = np.argsort(ids)
                        sids, scounts = ids[order], counts[order]
                        pos = np.minimum(np.searchsorted(sids, row_arr),
                                         len(sids) - 1)
                        hit = sids[pos] == row_arr
                        got = np.where(hit, scounts[pos],
                                       0).astype(np.int64)
                        missing = np.flatnonzero(~hit | (got <= 0))
                        ids, counts = self._topn_recount(
                            frag, row_arr, got, missing, floor)
                if len(ids):
                    merged_ids.append(ids.astype(np.uint64))
                    merged_counts.append(counts.astype(np.int64))
            if not merged_ids:
                return {}
            uids, inv = np.unique(np.concatenate(merged_ids),
                                  return_inverse=True)
            sums = np.bincount(inv, weights=np.concatenate(merged_counts)
                               ).astype(np.int64)
            return dict(zip(uids.tolist(), sums.tolist()))

        return host_fn

    @staticmethod
    def _topn_recount(frag, row_arr, got, missing, floor):
        """Recount the ``missing`` candidate positions of ``got`` via
        row_count — only for rows that have bits here
        (fragment.present_rows). Returns the ≥-floor (ids, counts).
        Caller holds frag._mu."""
        if len(missing):
            present = frag.present_rows()
            if present is not None:
                missing = missing[np.isin(row_arr[missing], present)]
            if len(missing):
                got = got.copy()
                for mi in missing.tolist():
                    got[mi] = frag.row_count(int(row_arr[mi]))
        keep = got >= floor
        return row_arr[keep], got[keep]

    def _top_n_slice(self, index: str, c: Call, slice: int) -> list[Pair]:
        # executor.go:325-396
        (frame_name, n, field, row_ids, min_threshold, filters,
         tanimoto) = self._topn_args(c)
        src = None
        if len(c.children) == 1:
            src = self._bitmap_call_slice(index, c.children[0], slice)
        elif len(c.children) > 1:
            raise PilosaError("TopN() can only have one input bitmap")
        frag = self.holder.fragment(index, frame_name, VIEW_STANDARD, slice)
        if frag is None:
            return []
        # Validation ordering matches the reference: tanimoto bounds
        # are checked by Fragment.Top AFTER the nil-fragment return
        # (fragment.go:490-625) — a bad threshold against a missing
        # fragment is an empty result, not an error.
        if tanimoto > 100:
            raise PilosaError("Tanimoto Threshold is from 1 to 100 only")
        return frag.top(TopOptions(
            n=n, src=src, row_ids=row_ids, filter_field=field,
            filter_values=filters, min_threshold=min_threshold,
            tanimoto_threshold=tanimoto))

    def _attr_filtered_ids(self, index: str, frame_name: str, row_ids,
                           field, filters) -> Optional[list[int]]:
        """Candidate ids whose row attribute ``field`` holds one of
        ``filters``. Row attributes are frame-global, so filtering the
        ids first equals the per-slice filter. None = no such frame
        (the per-slice path answers)."""
        if not (field and filters):
            return list(row_ids)
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            return None
        store = frame.row_attr_store
        fset = set(filters)
        return [rid for rid in row_ids
                if (val := store.attrs(rid).get(field)) is not None
                and val in fset]

    def _pack_candidate_rows(self, index: str, frame_name: str,
                             row_ids: list[int],
                             slices: list[int]) -> np.ndarray:
        """[n_slices, n_rows, words] dense candidate block, host-side."""
        rows = np.zeros((len(slices), len(row_ids), WORDS_PER_SLICE),
                        dtype=np.uint32)
        for si, slice in enumerate(slices):
            frag = self.holder.fragment(index, frame_name,
                                        VIEW_STANDARD, slice)
            if frag is None:
                continue
            # Bypass the packed-row LRU when this candidate set exceeds
            # the fragment's own budget (0% hit rate, pure churn).
            cached = len(row_ids) <= frag.device.max_rows
            for ri, rid in enumerate(row_ids):
                frag.pack_row(rid, out=rows[si, ri], cached=cached)
        return rows

    def _topn_rows_key(self, index: str, frame_name: str,
                       row_ids: tuple[int, ...],
                       slices: tuple[int, ...]) -> tuple[list, tuple]:
        """The fragments of a candidate block and its residency key."""
        frags, gens = self._fragment_gens(index, frame_name, VIEW_STANDARD,
                                          slices)
        return frags, ("topnrows", str(self.device), id(self.holder), index,
                       frame_name, row_ids, slices, gens)

    def _topn_exact_resident(self, index: str, frame_name: str, expr,
                             leaves: list[tuple],
                             row_ids: tuple[int, ...],
                             slices: tuple[int, ...],
                             threshold: int = 1,
                             tanimoto: int = 0) -> list[int]:
        """TopN exact counts with the candidate block and leaf slabs
        device-resident (budgeted cache) — repeat TopN queries skip the
        pack + upload. threshold > 1 or Tanimoto engage the per-slice
        pruning (mesh.topn_filtered_sharded)."""
        frags, key = self._topn_rows_key(index, frame_name, row_ids,
                                         slices)
        rows_arr = residency.candidate_block(self.device, key, frags,
                                             row_ids)
        leaf_arrays = [self._leaf_device_array(index, leaf, slices)
                       for leaf in leaves]
        if threshold > 1 or tanimoto > 0:
            return mesh_mod.topn_filtered_sharded(
                expr, rows_arr, leaf_arrays, threshold=threshold,
                tanimoto=tanimoto)
        return mesh_mod.topn_exact_sharded(expr, rows_arr, leaf_arrays)

    # -- writes (executor.go:600-797) ----------------------------------------

    def _execute_mutate_bit(self, index: str, c: Call, set: bool) -> bool:
        name = "SetBit" if set else "ClearBit"
        view = c.args.get("view", "")
        frame_name = c.args.get("frame")
        if not frame_name:
            raise PilosaError(f"{name}() frame required")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        frame = idx.frame(frame_name)
        if frame is None:
            raise FrameNotFoundError(frame_name)
        row_id, ok = c.uint_arg(frame.row_label)
        if not ok:
            raise PilosaError(
                f"{name}() row field '{frame.row_label}' required")
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise PilosaError(
                f"{name}() column field '{idx.column_label}' required")
        timestamp = _parse_timestamp(c) if set else None
        # The inverse view holds the transpose: its row is the column id.
        op = frame.set_bit if set else frame.clear_bit
        if view == VIEW_STANDARD:
            return op(VIEW_STANDARD, row_id, col_id, timestamp)
        if view == VIEW_INVERSE:
            return op(VIEW_INVERSE, col_id, row_id, timestamp)
        if view == "":
            ret = op(VIEW_STANDARD, row_id, col_id, timestamp)
            if frame.inverse_enabled:
                if op(VIEW_INVERSE, col_id, row_id, timestamp):
                    ret = True
            return ret
        raise PilosaError(f"invalid view: {view}")

    # Shortest run of SetBit/ClearBit calls that takes the batch lane.
    _BATCH_MIN_MUTATES = 8

    def _mutate_batch_run(self, index: str, calls: list[Call], start: int):
        """(results, n_calls) for a maximal run of consecutive
        timestamp-free SetBit (or ClearBit) calls on the standard or
        inverse view, applied through the fragments' batch lane
        (Frame.mutate_bits) — one batched mutation and WAL append per
        touched fragment and view, the count cache upkept in row order,
        as in the JAX package. None (the per-op path) for short runs and
        anything unusual — other views, timestamps, missing or malformed
        arguments — so error semantics stay exactly per-op: nothing is
        applied until every call of the run parses."""
        name = calls[start].name
        if name not in ("SetBit", "ClearBit"):
            return None
        n = len(calls)
        j = start
        while (j < n and calls[j].name == name
               and "timestamp" not in calls[j].args
               and calls[j].args.get("view", "") in
               ("", VIEW_STANDARD, VIEW_INVERSE)):
            j += 1
        count = j - start
        if count < self._BATCH_MIN_MUTATES:
            return None
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        frames: dict = {}
        # (call k, frame, view, view row, view column): the inverse view
        # takes the transpose, its slice chosen by the row id.
        vops: list[tuple] = []
        for k, c in enumerate(calls[start:j]):
            fname = c.args.get("frame")
            if not fname:
                return None
            frame = frames.get(fname)
            if frame is None:
                frame = idx.frame(fname)
                if frame is None:
                    return None
                frames[fname] = frame
            try:
                row_id, ok = c.uint_arg(frame.row_label)
                col_id, ok2 = c.uint_arg(idx.column_label)
            except (PilosaError, ValueError, TypeError):
                return None
            if not (ok and ok2):
                return None
            view = c.args.get("view", "")
            if view in ("", VIEW_STANDARD):
                vops.append((k, fname, VIEW_STANDARD, row_id, col_id))
            if view == VIEW_INVERSE or (view == "" and frame.inverse_enabled):
                vops.append((k, fname, VIEW_INVERSE, col_id, row_id))
        results = [False] * count
        groups: dict[tuple, list] = {}
        for vop in vops:
            groups.setdefault((vop[1], vop[2]), []).append(vop)
        for (fname, view), group in groups.items():
            rows = np.fromiter((g[3] for g in group), np.uint64, len(group))
            cols = np.fromiter((g[4] for g in group), np.uint64, len(group))
            changed = frames[fname].mutate_bits(view, rows, cols,
                                                name == "SetBit")
            for g, ch in zip(group, changed.tolist()):
                if ch:
                    results[g[0]] = True
        return results, count

    # -- attributes (executor.go:800-988) ------------------------------------

    def _row_attrs_of(self, index: str, c: Call):
        """Resolve a SetRowAttrs call → (frame_name, frame, row_id,
        attrs without the reserved keys)."""
        frame_name = c.args.get("frame")
        if not frame_name:
            raise PilosaError("SetRowAttrs() frame required")
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise FrameNotFoundError(frame_name)
        row_id, ok = c.uint_arg(frame.row_label)
        if not ok:
            raise PilosaError(
                f"SetRowAttrs() row field '{frame.row_label}' required")
        attrs = dict(c.args)
        attrs.pop("frame", None)
        attrs.pop(frame.row_label, None)
        return frame_name, frame, row_id, attrs

    def _execute_bulk_set_row_attrs(self, index: str,
                                    calls: list[Call]) -> list:
        # executor.go:857-941: group attrs by frame and row, one bulk
        # write per frame.
        by_frame: dict[str, tuple] = {}
        for c in calls:
            frame_name, frame, row_id, attrs = self._row_attrs_of(index, c)
            rows = by_frame.setdefault(frame_name, (frame, {}))[1]
            rows.setdefault(row_id, {}).update(attrs)
        for frame, rows in by_frame.values():
            frame.row_attr_store.set_bulk_attrs(rows)
        return [None] * len(calls)

    def _execute_set_column_attrs(self, index: str, c: Call) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        id, ok = c.uint_arg("id")
        col_name = "id"
        if not ok:
            id, ok = c.uint_arg(idx.column_label)
            if not ok:
                raise PilosaError("SetColumnAttrs() id required")
            col_name = idx.column_label
        attrs = dict(c.args)
        attrs.pop(col_name, None)
        idx.column_attr_store.set_attrs(id, attrs)


def _share_result(bm: Bitmap) -> Bitmap:
    """COW handout of a cached result (mutating callers copy, never the
    cached object)."""
    out = Bitmap()
    out.attrs = dict(bm.attrs)
    for seg in bm.segments:
        out.segments.append(BitmapSegment(seg.data.shared(), seg.slice,
                                          False))
    return out

"""Executor: per-call PQL dispatch over the slices of one holder.

Trimmed copy of the JAX package's ``executor.py`` (reference
executor.go): ``execute(index, pql)`` parses the query and runs its
calls in order. What this slice of the port serves:

- **Count** of any bitmap tree of standard-view ``Bitmap`` leaves and
  ``Intersect``/``Union``/``Difference`` folds runs on the device, over
  every slice at once (``_execute_count``): the tree compiles to an
  expression over leaf slabs kept resident in the budgeted device cache
  (parallel.residency) and the expression-count kernel counts it
  (parallel.mesh.count_expr_sharded).
- **TopN with one source child and ``ids``** (threshold at most 1, no
  Tanimoto, no attribute filter) counts every candidate row against
  the source on the device: the resident form when the candidate block
  fits TOPN_BLOCK_BYTES, the streaming form up to
  _TOPN_HOST_BLOCK_BYTES (``_execute_top_n``).
- ``Bitmap``/``Intersect``/``Union``/``Difference`` as top-level calls
  are materialized by host roaring algebra over the fragments.
- ``SetBit``/``ClearBit`` on the standard view.

Before a read query runs, empty operands (``Union()``) fold away from
its bitmap trees by set algebra (``_fold_empty``), as the JAX package's
planner proves them empty: a Count or TopN over a source that folds to
∅ answers 0 or no pair and launches nothing.

Every other call or form raises PilosaError and names the slice that
will port it. A device error surfaces to the caller: there is no host
fallback. Single node, one device: the cluster fan-out, pod, planner,
result caches, cost model and fault handling wait for later slices.
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
from .pql.ast import Call, Query
from .pql.parser import parse as parse_pql
from .storage.bitmap import Bitmap
from .storage.cache import Pair, pairs_sort

# Frame used when a call does not specify one (executor.go:35).
DEFAULT_FRAME = "general"

MIN_THRESHOLD = 1

_WRITE_CALLS = ("SetBit", "ClearBit", "SetFieldValue", "SetRowAttrs",
                "SetColumnAttrs")

# The slice of the port that will serve each call this one refuses.
_LATER = {
    "Range": "the Range/time-view/BSI slice",
    "Sum": "the Range/time-view/BSI slice",
    "Min": "the Range/time-view/BSI slice",
    "Max": "the Range/time-view/BSI slice",
    "SetFieldValue": "the Range/time-view/BSI slice",
    "SetRowAttrs": "the HTTP-front slice (attribute stores)",
    "SetColumnAttrs": "the HTTP-front slice (attribute stores)",
}


def _needs_slices(calls: list[Call]) -> bool:
    # executor.go:1273-1289
    if not calls:
        return False
    return any(c.name not in _WRITE_CALLS for c in calls)


def _is_empty(c: Call) -> bool:
    """``Union()`` with no operand is the empty set."""
    return c.name == "Union" and not c.children


def _fold_empty(c: Call) -> Call:
    """``c`` with its syntactically empty operands folded away by set
    algebra: x ∪ ∅ = x, x ∩ ∅ = ∅, x − ∅ = x, ∅ − x = ∅, and ∅ is
    ``Union()``. An operand that folds into ∅ is not evaluated, so its
    errors do not surface — the JAX package's planner proves these
    branches empty and skips them the same way (plan/planner.py
    short_circuit). ``Intersect()``/``Difference()`` with no operand
    stay as they are: the host path raises for them. Returns ``c``
    itself when nothing folds; never mutates the parsed tree."""
    if c.name not in ("Intersect", "Union", "Difference") or not c.children:
        return c
    kids = [_fold_empty(ch) for ch in c.children]
    empty = [_is_empty(k) for k in kids]
    if (c.name == "Intersect" and any(empty)) or \
            (c.name == "Difference" and empty[0]):
        return Call("Union")
    if c.name != "Intersect":
        kids = [k for i, k in enumerate(kids)
                if not empty[i] or (i == 0 and c.name == "Difference")]
    if kids == c.children:
        return c
    return Call(c.name, c.args, kids)


def _fold_query(calls: list[Call]) -> list[Call]:
    """Fold the bitmap trees of a read query (``_fold_empty``): the
    top-level bitmap calls and the source of each Count and TopN."""
    out = []
    for c in calls:
        if c.name in ("Count", "TopN"):
            kids = [_fold_empty(ch) for ch in c.children]
            c = c if kids == c.children else Call(c.name, c.args, kids)
        out.append(_fold_empty(c))
    return out


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


def _later(what: str, where: str) -> PilosaError:
    return PilosaError(f"{what} is not ported yet: it comes with {where}"
                       " of pilosa_tpu_torch")


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

    def execute(self, index: str, query,
                slices: Optional[list[int]] = None) -> list:
        if not index:
            raise PilosaError("index required")
        if isinstance(query, str):
            query = parse_pql(query)
        if not isinstance(query, Query):
            raise QueryRequiredError("query required")
        if not slices and _needs_slices(query.calls):
            idx = self.holder.index(index)
            if idx is None:
                raise IndexNotFoundError(index)
            slices = list(range(idx.max_slice() + 1))
        slices = slices or []
        calls = query.calls
        if slices and _needs_slices(calls) and not query.write_calls():
            # As the JAX package plans a read query (executor.py
            # _maybe_plan): empty operands fold away before execution.
            calls = _fold_query(calls)
        return [self._execute_call(index, c, slices) for c in calls]

    def _execute_call(self, index: str, c: Call, slices: list[int]):
        # executor.go:146-170
        if c.name == "ClearBit":
            return self._execute_mutate_bit(index, c, set=False)
        if c.name == "Count":
            return self._execute_count(index, c, slices)
        if c.name == "SetBit":
            return self._execute_mutate_bit(index, c, set=True)
        if c.name == "TopN":
            return self._execute_top_n(index, c, slices)
        if c.name in _LATER:
            raise _later(f"{c.name}()", _LATER[c.name])
        return self._execute_bitmap_call(index, c, slices)

    # -- bitmap calls on the host --------------------------------------------

    def _execute_bitmap_call(self, index: str, c: Call,
                             slices: list[int]) -> Bitmap:
        bm = Bitmap()
        for slice in slices:
            bm.merge(self._bitmap_call_slice(index, c, slice))
        return bm

    def _bitmap_call_slice(self, index: str, c: Call, slice: int) -> Bitmap:
        # executor.go:253-268
        if c.name == "Bitmap":
            return self._bitmap_slice(index, c, slice)
        if c.name == "Difference":
            return self._fold_slice(index, c, slice, "difference",
                                    require_children=True)
        if c.name == "Intersect":
            return self._fold_slice(index, c, slice, "intersect",
                                    require_children=True)
        if c.name == "Union":
            return self._fold_slice(index, c, slice, "union",
                                    require_children=False)
        if c.name in _LATER:
            raise _later(f"{c.name}()", _LATER[c.name])
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
        if col_ok:
            # Frames of this slice never enable inverse storage.
            raise PilosaError("Bitmap() cannot retrieve columns unless"
                              " inverse storage enabled")
        frag = self.holder.fragment(index, frame_name, VIEW_STANDARD, slice)
        if frag is None:
            return Bitmap()
        return frag.row(row_id)

    # -- device expressions --------------------------------------------------

    def _compile_device_expr(self, index: str, c: Call, leaves: list):
        """Compile a pure bitmap call tree into a mesh expression tree.

        Supported: standard-view Bitmap leaves combined with
        Intersect/Union/Difference (n-ary calls fold left to right, like
        _fold_slice). Returns None for anything else (malformed args,
        missing frames, empty folds, calls of later slices) — the host
        path owns their errors and semantics. Recursion follows the PQL
        nesting depth, not the fold width.
        """
        if c.name == "Bitmap":
            idx = self.holder.index(index)
            if idx is None:
                return None
            frame = idx.frame(c.args.get("frame") or DEFAULT_FRAME)
            if frame is None:
                return None
            row_id, row_ok = c.uint_arg(frame.row_label)
            _, col_ok = c.uint_arg(idx.column_label)
            if not row_ok or col_ok:
                return None
            leaves.append((frame.name, VIEW_STANDARD, row_id))
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

    def _fragment_gens(self, index: str, frame: str,
                       slices: tuple[int, ...]) -> tuple[list, tuple]:
        frags = [self.holder.fragment(index, frame, VIEW_STANDARD, s)
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
        frags, gens = self._fragment_gens(index, frame, slices)
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
        leaves: list[tuple] = []
        expr = self._compile_device_expr(index, c.children[0], leaves)
        if expr is None:
            # Not a device expression (an empty Union, a call of a later
            # slice, a malformed leaf): the host materialization gives
            # the JAX package's answer or raises its error.
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
        (frame_name, _n, field, row_ids, min_threshold, filters,
         tanimoto) = self._topn_args(c)
        if len(c.children) > 1:
            raise PilosaError("TopN() can only have one input bitmap")
        if not c.children:
            raise _later("TopN() without a source bitmap",
                         "the sourceless-TopN slice (rank-cache phase)")
        if tanimoto > 100:
            raise PilosaError("Tanimoto Threshold is from 1 to 100 only")
        src = c.children[0]
        leaves: list[tuple] = []
        expr = self._compile_device_expr(index, src, leaves)
        if expr is None and not _is_empty(src):
            # Malformed, a call of a later slice, or (in a query that
            # also writes, which execute does not fold) a tree holding
            # empty operands: the host path raises the JAX package's
            # error for the first two, and the third folds away.
            self._execute_bitmap_call(index, src, slices)
            src = _fold_empty(src)
            leaves = []
            expr = self._compile_device_expr(index, src, leaves)
        if _is_empty(src):
            # No candidate intersects ∅: every form of TopN answers no
            # pair (the JAX package's fragment.top pushes no count 0).
            return []
        if expr is None:
            raise _later(f"TopN() over {src}", "a later slice")
        if not row_ids:
            raise _later("TopN() without ids (the rank-cache candidate"
                         " phase)", "the sourceless-TopN slice")
        if min_threshold > 1 or tanimoto > 0:
            raise _later("TopN() threshold/tanimotoThreshold",
                         "the threshold/Tanimoto slice")
        if field and filters:
            raise _later("TopN() attribute filters",
                         "the HTTP-front slice (attribute stores)")
        if not slices:
            return []
        ids = list(row_ids)
        block_bytes = len(slices) * len(ids) * WORDS_PER_SLICE * 4
        if block_bytes > self._TOPN_HOST_BLOCK_BYTES:
            raise _later(f"TopN() over a {block_bytes}-byte candidate "
                         "block (the per-slice host path)",
                         "the sourceless-TopN slice")
        if block_bytes <= mesh_mod.TOPN_BLOCK_BYTES:
            counts = self._topn_exact_resident(
                index, frame_name, expr, leaves, tuple(ids), tuple(slices))
        else:
            counts = mesh_mod.topn_exact(
                self.device, expr,
                self._pack_candidate_rows(index, frame_name, ids, slices),
                self._pack_leaf_block(index, leaves, slices))
        # Same reduction as the JAX package's local leg: per-candidate
        # pairs merged by id (a repeated id sums), then count-descending
        # with ascending id on ties. ids given ⇒ no n-trim
        # (executor.go:273-310).
        merged: dict[int, int] = {}
        for rid, cnt in zip(ids, counts):
            if cnt > 0:
                merged[rid] = merged.get(rid, 0) + cnt
        return pairs_sort(Pair(rid, cnt) for rid, cnt in merged.items())

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

    def _topn_exact_resident(self, index: str, frame_name: str, expr,
                             leaves: list[tuple],
                             row_ids: tuple[int, ...],
                             slices: tuple[int, ...]) -> list[int]:
        """TopN exact counts with the candidate block and leaf slabs
        device-resident (budgeted cache) — repeat TopN queries skip the
        pack + upload."""
        frags, gens = self._fragment_gens(index, frame_name, slices)
        key = ("topnrows", str(self.device), id(self.holder), index,
               frame_name, row_ids, slices, gens)
        rows_arr = residency.candidate_block(self.device, key, frags,
                                             row_ids)
        leaf_arrays = [self._leaf_device_array(index, leaf, slices)
                       for leaf in leaves]
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
        if view in ("", VIEW_STANDARD):
            op = frame.set_bit if set else frame.clear_bit
            return op(VIEW_STANDARD, row_id, col_id, timestamp)
        if view == VIEW_INVERSE:
            raise PilosaError("inverse views not enabled for frame")
        raise PilosaError(f"invalid view: {view}")

"""Executor: per-call PQL dispatch over the slices of one holder.

Trimmed copy of the JAX package's ``executor.py`` (reference
executor.go): ``execute(index, pql)`` parses the query and runs its
calls in order. What the port serves:

- **Count** of any bitmap tree of standard-view ``Bitmap`` leaves and
  ``Intersect``/``Union``/``Difference`` folds runs on the device, over
  every slice at once (``_execute_count``): the tree compiles to an
  expression over leaf slabs kept resident in the budgeted device cache
  (parallel.residency) and the expression-count kernel counts it
  (parallel.mesh.count_expr_sharded).
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
- ``Bitmap``/``Intersect``/``Union``/``Difference`` as top-level calls
  are materialized by host roaring algebra over the fragments; a
  top-level ``Bitmap`` carries its row's attributes.
- ``SetBit``/``ClearBit`` on the standard view, ``SetRowAttrs`` and
  ``SetColumnAttrs`` (a query of ``SetRowAttrs`` calls alone is one
  bulk write per frame).

Before a read query runs, empty operands (``Union()``) fold away from
its bitmap trees by set algebra (``_fold_empty``), as the JAX package's
planner proves them empty: a Count or TopN over a source that folds to
∅ answers 0 or no pair and launches nothing.

Every other call or form raises PilosaError and names the slice that
will port it. A device error surfaces to the caller: there is no host
fallback. Single node, one device: the cluster fan-out, TopN pushdown,
pod, planner, result caches, cost model and fault handling wait for
later slices.
"""

from __future__ import annotations

import datetime as dt
from typing import Optional

import numpy as np

from .device import resolve_device
from .errors import (TIME_FORMAT, FrameNotFoundError, IndexNotFoundError,
                     PilosaError, QueryRequiredError, later)
from .models.frame import LATER_VIEWS
from .models.view import VIEW_INVERSE, VIEW_STANDARD
from .ops.packed import WORDS_PER_SLICE
from .parallel import mesh as mesh_mod
from .parallel import residency
from .pql.ast import Call, Query
from .pql.parser import parse as parse_pql
from .storage.bitmap import Bitmap
from .storage.cache import LRUCache, Pair, pairs_sort
from .storage.fragment import TopOptions

# Frame used when a call does not specify one (executor.go:35).
DEFAULT_FRAME = "general"

MIN_THRESHOLD = 1

_WRITE_CALLS = ("SetBit", "ClearBit", "SetFieldValue", "SetRowAttrs",
                "SetColumnAttrs")

# The calls this slice refuses; the Range/time-view/BSI slice serves them.
_LATER = frozenset(("Range", "Sum", "Min", "Max", "SetFieldValue"))


def _has_only_set_row_attrs(calls: list[Call]) -> bool:
    return bool(calls) and all(c.name == "SetRowAttrs" for c in calls)


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
        if _has_only_set_row_attrs(calls):
            return self._execute_bulk_set_row_attrs(index, calls)
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
        if c.name == "SetRowAttrs":
            _, frame, row_id, attrs = self._row_attrs_of(index, c)
            frame.row_attr_store.set_attrs(row_id, attrs)
            return None
        if c.name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c)
            return None
        if c.name == "TopN":
            return self._execute_top_n(index, c, slices)
        if c.name in _LATER:
            raise later(f"{c.name}()", LATER_VIEWS)
        return self._execute_bitmap_call(index, c, slices)

    # -- bitmap calls on the host --------------------------------------------

    def _execute_bitmap_call(self, index: str, c: Call,
                             slices: list[int]) -> Bitmap:
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
            raise later(f"{c.name}()", LATER_VIEWS)
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
            if frame.inverse_enabled:
                raise later("Bitmap() of a column (the inverse view)",
                            LATER_VIEWS)
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
        if len(c.children) > 1:
            raise PilosaError("TopN() can only have one input bitmap")
        if c.children:
            src = c.children[0]
            leaves: list[tuple] = []
            expr = self._compile_device_expr(index, src, leaves)
            if expr is None and not _is_empty(src):
                # Malformed, a call of a later slice, or (in a query
                # that also writes, which execute does not fold) a tree
                # holding empty operands: the host path raises the JAX
                # package's error for the first two, and the third
                # folds away.
                self._execute_bitmap_call(index, src, slices)
                src = _fold_empty(src)
                expr = self._compile_device_expr(index, src, [])
                c = Call(c.name, c.args, [src])
            if _is_empty(src):
                # No candidate intersects ∅: every form of TopN answers
                # no pair (the JAX package's fragment.top pushes no
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
            if expr is None:
                raise later(f"TopN() over {src}", "a later slice")
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
        frags, gens = self._fragment_gens(index, frame_name, slices)
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
        if view in ("", VIEW_STANDARD):
            op = frame.set_bit if set else frame.clear_bit
            return op(VIEW_STANDARD, row_id, col_id, timestamp)
        if view == VIEW_INVERSE:
            if frame.inverse_enabled:
                raise later(f"{name}() on the inverse view", LATER_VIEWS)
            raise PilosaError("inverse views not enabled for frame")
        raise PilosaError(f"invalid view: {view}")

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

"""Bit-sliced indexing (BSI): integer fields as bit-plane rows.

The port's copy of the JAX package's ``storage/bsi.py``. A frame
*field* (name, min, max) stores one integer per column in a dedicated
``field_<name>`` view: row 0 is the existence (not-null) row and rows
1..depth hold the binary planes of ``value - min`` (bit i of the offset
value lives in row ``1 + i``), with ``depth = ceil(log2(max - min +
1))``. Comparisons are the O(depth) bit-plane boolean circuit
(O'Neil/Quass bit-sliced range evaluation; pilosa 1.0 fragment.go
fieldRange*), and Sum/Min/Max aggregate by popcount-weighted plane
folds.

Two forms of each comparison:

- ``compare_expr``, the JAX package's circuit, evaluated on the host
  over roaring bitmaps (``range_bitmap``). Its ``lt``/``gt`` terms reuse
  the running ``eq`` subtree, so as an expression tree it is quadratic
  in the depth.
- ``compare_fold_expr``, the same function as an LSB-first left fold
  with one operand a leaf at every node, which the device's expression
  program (ops.cuda_kernels.compile_program) runs in depth+1
  instructions with no spill slot (``><``: two chains, one slot).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..errors import PilosaError

# Row layout within a field_<name> view (pilosa 1.0's bsiExistsBit /
# bsiOffsetBit layout): row 0 = existence, row 1+i = offset-value bit i.
EXISTS_ROW = 0
PLANE_ROW_OFFSET = 1

# Offset values are unsigned 63-bit at most (predicates travel as PQL
# int64; a wider range would not round-trip the wire form).
MAX_BIT_DEPTH = 63

# The existence row as a circuit plane index (compare_expr leaf space).
EXISTS_PLANE = -1


def bit_depth(min_v: int, max_v: int) -> int:
    """Value-plane count for the inclusive range [min, max]."""
    if max_v < min_v:
        raise PilosaError("field max must be >= min")
    return (max_v - min_v).bit_length()


@dataclass
class ValCount:
    """A Sum/Min/Max aggregate result: ``value`` plus how many columns
    contributed (for Min/Max: how many columns hold the extreme).
    ``count == 0`` means no column matched (value is meaningless)."""
    value: int = 0
    count: int = 0

    def to_json(self) -> dict:
        return {"value": self.value, "count": self.count}


def clamp(op: str, predicate, min_v: int, max_v: int):
    """Normalize a comparison against the field's [min, max] domain.

    Returns ``"none"`` (no column can match), ``"all"`` (every column
    with a value matches — the existence row), or ``(op, upred)`` with
    the predicate shifted into unsigned offset space. ``><`` returns
    ``("><", (ulo, uhi))`` with both bounds clamped into the domain.
    """
    if op == "><":
        lo, hi = predicate
        if lo > hi or hi < min_v or lo > max_v:
            return "none"
        if lo <= min_v and hi >= max_v:
            return "all"
        return op, (max(lo, min_v) - min_v, min(hi, max_v) - min_v)
    p = predicate
    if op == "<":
        if p <= min_v:
            return "none"
        if p > max_v:
            return "all"
    elif op == "<=":
        if p < min_v:
            return "none"
        if p >= max_v:
            return "all"
    elif op == ">":
        if p >= max_v:
            return "none"
        if p < min_v:
            return "all"
    elif op == ">=":
        if p > max_v:
            return "none"
        if p <= min_v:
            return "all"
    elif op == "==":
        if p < min_v or p > max_v:
            return "none"
    elif op == "!=":
        if p < min_v or p > max_v:
            return "all"
    else:
        raise PilosaError(f"invalid range operator: {op!r}")
    return op, p - min_v


def _eq_lt_exprs(upred: int, depth: int, leaf) -> tuple:
    """(eq, lt) circuit pair: eq = columns whose offset value equals
    ``upred``; lt = columns strictly below it. One MSB→LSB pass — the
    classic bit-sliced comparison (fragment.go fieldRangeLT shape)."""
    eq = leaf(EXISTS_PLANE)
    lt = None
    for i in reversed(range(depth)):
        plane = leaf(i)
        if (upred >> i) & 1:
            term = ("andnot", eq, plane)  # equal so far, bit 0 < 1
            lt = term if lt is None else ("or", lt, term)
            eq = ("and", eq, plane)
        else:
            eq = ("andnot", eq, plane)  # a 1 here exceeds the predicate
    return eq, lt


def _eq_gt_exprs(upred: int, depth: int, leaf) -> tuple:
    eq = leaf(EXISTS_PLANE)
    gt = None
    for i in reversed(range(depth)):
        plane = leaf(i)
        if (upred >> i) & 1:
            eq = ("and", eq, plane)
        else:
            term = ("and", eq, plane)  # equal so far, bit 1 > 0
            gt = term if gt is None else ("or", gt, term)
            eq = ("andnot", eq, plane)
    return eq, gt


def compare_expr(op: str, upred, depth: int,
                 leaf: Callable[[int], tuple]) -> Optional[tuple]:
    """The comparison circuit as an executor expression tree.

    ``op``/``upred`` must already be clamped into offset space (see
    ``clamp``; "none"/"all" never reach here). ``leaf(i)`` yields the
    leaf expression of value plane ``i`` (``EXISTS_PLANE`` for the
    existence row); it is called at most once per plane per side, so a
    plain list-appending closure stays linear. Returns None for a
    provably-empty circuit (e.g. ``< 0`` in offset space).
    """
    if op == "==":
        return _eq_lt_exprs(upred, depth, leaf)[0]
    if op == "!=":
        eq = _eq_lt_exprs(upred, depth, leaf)[0]
        return ("andnot", leaf(EXISTS_PLANE), eq)
    if op == "<":
        return _eq_lt_exprs(upred, depth, leaf)[1]
    if op == "<=":
        eq, lt = _eq_lt_exprs(upred, depth, leaf)
        return eq if lt is None else ("or", lt, eq)
    if op == ">":
        return _eq_gt_exprs(upred, depth, leaf)[1]
    if op == ">=":
        eq, gt = _eq_gt_exprs(upred, depth, leaf)
        return eq if gt is None else ("or", gt, eq)
    if op == "><":
        ulo, uhi = upred
        ge = compare_expr(">=", ulo, depth, leaf)
        le = compare_expr("<=", uhi, depth, leaf)
        if ge is None or le is None:
            return None
        return ("and", ge, le)
    raise PilosaError(f"invalid range operator: {op!r}")


def eval_bitmap_expr(expr: tuple, leaf_fn: Callable[[int], object]):
    """Evaluate a circuit over result Bitmaps (storage.bitmap.Bitmap —
    or anything with intersect/union/difference): the host per-slice
    backend. ``leaf_fn(i)`` materializes leaf ``i``."""
    op = expr[0]
    if op == "leaf":
        return leaf_fn(expr[1])
    a = eval_bitmap_expr(expr[1], leaf_fn)
    b = eval_bitmap_expr(expr[2], leaf_fn)
    if op == "and":
        return a.intersect(b)
    if op == "or":
        return a.union(b)
    return a.difference(b)


def range_bitmap(op: str, predicate, min_v: int, max_v: int,
                 row: Callable[[int], object]):
    """One slice's Range(field OP predicate) result Bitmap.

    ``row(i)`` returns the Bitmap of circuit plane ``i``
    (``EXISTS_PLANE`` = existence). Returns None for a provably-empty
    result (the caller supplies its empty-Bitmap type).
    """
    clamped = clamp(op, predicate, min_v, max_v)
    if clamped == "none":
        return None
    if clamped == "all":
        return row(EXISTS_PLANE)
    cop, upred = clamped
    expr = compare_expr(cop, upred, bit_depth(min_v, max_v),
                        lambda i: ("leaf", i))
    if expr is None:
        return None
    return eval_bitmap_expr(expr, row)


def sum_count(min_v: int, max_v: int, row: Callable[[int], object],
              filter=None) -> ValCount:
    """Popcount-weighted plane fold: Sum = min*count + Σ 2^i · |plane_i
    ∩ filter| (plane bits are subsets of the existence row, so no
    explicit existence intersect is needed per plane)."""
    exists = row(EXISTS_PLANE)
    if filter is None:
        count = exists.count()
    else:
        count = exists.intersection_count(filter)
    if count == 0:
        return ValCount(0, 0)
    total = min_v * count
    for i in range(bit_depth(min_v, max_v)):
        plane = row(i)
        n = plane.count() if filter is None \
            else plane.intersection_count(filter)
        total += n << i
    return ValCount(total, count)


def min_max(min_v: int, max_v: int, row: Callable[[int], object],
            filter=None, want_min: bool = True) -> ValCount:
    """Extreme value among columns with a value (∩ filter), plus how
    many columns hold it: MSB→LSB, keep the sub-population that can
    still be extreme at each plane."""
    b = row(EXISTS_PLANE)
    if filter is not None:
        b = b.intersect(filter)
    if b.count() == 0:
        return ValCount(0, 0)
    value = 0
    for i in reversed(range(bit_depth(min_v, max_v))):
        plane = row(i)
        if want_min:
            z = b.difference(plane)
            if z.count():
                b = z  # someone has bit 0: the minimum does too
            else:
                value |= 1 << i  # every candidate has this bit set
        else:
            z = b.intersect(plane)
            if z.count():
                b = z
                value |= 1 << i
    return ValCount(value + min_v, b.count())


def sum_count_many(min_v: int, max_v: int,
                   legs: list) -> ValCount:
    """One (sum, count) partial over a whole node leg's slices in one
    pass — the batched form of per-slice ``sum_count`` + ``combine_sum``.
    ``legs`` is ``[(row_fn, filter_or_None), ...]``, one entry per
    owned slice. Slices with an empty (filtered) existence row drop
    out before any value plane is read."""
    live = []
    count = 0
    for row, filt in legs:
        exists = row(EXISTS_PLANE)
        n = exists.count() if filt is None \
            else exists.intersection_count(filt)
        if n:
            count += n
            live.append((row, filt))
    if count == 0:
        return ValCount(0, 0)
    total = min_v * count
    for i in range(bit_depth(min_v, max_v)):
        for row, filt in live:
            plane = row(i)
            n = plane.count() if filt is None \
                else plane.intersection_count(filt)
            total += n << i
    return ValCount(total, count)


def min_max_many(min_v: int, max_v: int, legs: list,
                 want_min: bool = True) -> ValCount:
    """One min/max partial over a whole node leg's slices — the
    MSB→LSB candidate walk of ``min_max`` run JOINTLY across slices,
    which prunes harder than per-slice + combine: the moment ANY slice
    still holds a candidate with the favorable bit, every slice whose
    candidates all carry the unfavorable one is dropped outright and
    pays nothing for the remaining planes."""
    cands = []
    for row, filt in legs:
        b = row(EXISTS_PLANE)
        if filt is not None:
            b = b.intersect(filt)
        if b.count():
            cands.append((row, b))
    if not cands:
        return ValCount(0, 0)
    value = 0
    for i in reversed(range(bit_depth(min_v, max_v))):
        nxt = []
        for row, b in cands:
            z = (b.difference(row(i)) if want_min
                 else b.intersect(row(i)))
            if z.count():
                nxt.append((row, z))
        if nxt:
            # Some slice can still improve the extreme at this bit:
            # the global extreme has the favorable value here, and
            # only those slices stay in play.
            cands = nxt
            if not want_min:
                value |= 1 << i
        elif want_min:
            value |= 1 << i  # every candidate everywhere has the bit
    return ValCount(value + min_v,
                    sum(b.count() for _row, b in cands))


def combine_sum(a: ValCount, b: ValCount) -> ValCount:
    return ValCount(a.value + b.value, a.count + b.count)


def combine_min_max(a: ValCount, b: ValCount,
                    want_min: bool = True) -> ValCount:
    """Cluster mapReduce merge of per-slice Min/Max partials: empty
    sides (count == 0) are identity; equal extremes sum their counts."""
    if a.count == 0:
        return b
    if b.count == 0:
        return a
    if a.value == b.value:
        return ValCount(a.value, a.count + b.count)
    keep_a = a.value < b.value if want_min else a.value > b.value
    return a if keep_a else b


# -- the fold form (device expression programs) ------------------------------


def _lt_chain(upred: int, depth: int, leaf):
    """``(acc, is_l)`` of the LSB-first fold for ``value < upred``
    over every column, exists not yet applied: ``is_l`` means ``acc``
    is L (the columns whose low bits are below the predicate's), else
    it is G, its complement. A predicate bit of 1 maps L to ``plane
    andnot L`` (giving G) and G to ``G and plane``; a bit of 0 maps L
    to ``L andnot plane`` and G to ``G or plane``. The fold starts at
    the predicate's lowest 1 bit with G = that plane. ``(None, True)``
    when ``upred == 0`` (L is empty)."""
    if upred == 0:
        return None, True
    j = (upred & -upred).bit_length() - 1
    acc, is_l = leaf(j), False
    for i in range(j + 1, depth):
        plane = leaf(i)
        if (upred >> i) & 1:
            acc = ("andnot", plane, acc) if is_l else ("and", acc, plane)
            is_l = False
        else:
            acc = ("andnot", acc, plane) if is_l else ("or", acc, plane)
    return acc, is_l


def _below(upred: int, depth: int, leaf):
    """``value < upred`` within the existence row; None when empty.
    ``upred`` may be ``2**depth`` (every stored value is below it)."""
    if upred >= 1 << depth:
        return leaf(EXISTS_PLANE)
    acc, is_l = _lt_chain(upred, depth, leaf)
    if acc is None:
        return None
    if is_l:
        return ("and", acc, leaf(EXISTS_PLANE))
    return ("andnot", leaf(EXISTS_PLANE), acc)


def _at_least(upred: int, depth: int, leaf):
    """``value >= upred`` within the existence row; None when empty."""
    if upred >= 1 << depth:
        return None
    acc, is_l = _lt_chain(upred, depth, leaf)
    if acc is None:
        return leaf(EXISTS_PLANE)
    if is_l:
        return ("andnot", leaf(EXISTS_PLANE), acc)
    return ("and", acc, leaf(EXISTS_PLANE))


def compare_fold_expr(op: str, upred, depth: int,
                      leaf: Callable[[int], tuple]) -> Optional[tuple]:
    """``compare_expr``'s function as a fold: the same matched columns
    for any plane contents, None exactly where ``compare_expr`` is
    None. Every node has a leaf operand, so the device program is
    depth+1 instructions with no spill slot for ``<``, ``<=``, ``>``,
    ``>=`` and ``==``, depth+2 for ``!=`` and 2·(depth+1)+2 with one
    slot for ``><``."""
    if op == "==":
        return _eq_lt_exprs(upred, depth, leaf)[0]
    if op == "!=":
        eq = _eq_lt_exprs(upred, depth, leaf)[0]
        return ("andnot", leaf(EXISTS_PLANE), eq)
    if op == "<":
        return _below(upred, depth, leaf)
    if op == "<=":
        return _below(upred + 1, depth, leaf)
    if op == ">":
        return _at_least(upred + 1, depth, leaf)
    if op == ">=":
        return _at_least(upred, depth, leaf)
    if op == "><":
        ulo, uhi = upred
        ge = _at_least(ulo, depth, leaf)
        le = _below(uhi + 1, depth, leaf)
        if ge is None or le is None:
            return None
        return ("and", le, ge)
    raise PilosaError(f"invalid range operator: {op!r}")

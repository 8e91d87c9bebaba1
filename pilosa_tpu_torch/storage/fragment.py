"""Fragment: the storage unit at one (frame, view, slice) intersection.

Trimmed copy of the JAX package's ``storage/fragment.py``. A fragment
owns one roaring bitmap holding a rows × 2^20-column block; bit position
``pos = row * SLICE_WIDTH + (col % SLICE_WIDTH)`` (fragment.go:1511-1514).

Durability in this slice is a plain roaring snapshot: ``open`` reads the
data file (the same snapshot format as the JAX package, op-log records
included), ``close`` writes a fresh snapshot. The group-commit WAL, crc
footers, tiering, quarantine, scrub and block sync wait for later
slices.

The TopN count cache (``cache``: a RankCache or an LRUCache, from the
frame's ``cacheType``/``cacheSize``) is the JAX package's: every write
keeps it right, its ids persist in the same ``.cache`` protobuf sidecar
(fragment.go:1067-1093), and ``open`` re-ranks them with counts from
storage. ``top`` is the JAX package's ``Fragment.top``: the reference's
heap replay (fragment.go:490-625) over numpy rank arrays and one
vectorized source-count pass.

``device`` is the fragment's ``DeviceRowCache``: its ``(uid,
generation)`` pair is the staleness key of every device-resident block
built from this fragment (parallel.residency); every write bumps the
generation.
"""

from __future__ import annotations

import hashlib
import heapq
import math
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..parallel.residency import DeviceRowCache
from ..proto import internal as pb
from ..utils import arrays as arrays_mod
from . import cache as cache_mod
from . import roaring
from .bitmap import Bitmap
from .cache import Pair

# Largest position vector kept resident per fragment (8 B each ->
# 32 MB); larger ones are rebuilt per pass instead of pinned.
_POSITIONS_CACHE_BITS = 4 << 20

# Matched-position budget before folding src-count hits into a
# partial (ids, counts) map; module-level so tests can shrink it to
# exercise the multi-partial merge.
_SRC_FOLD_POSITIONS = 1 << 20

# Fragments at or under this many set bits take the all-positions
# vectorized src-count pass (8 B/bit peak -> <=128 MB); bigger ones
# keep the bounded chunked walk.
_SRC_VECTOR_BITS = 16 << 20

# Keys of roaring containers per slice row (SLICE_WIDTH / 2^16): a row's
# containers are the key span [row << _ROW_KEY_SHIFT, (row+1) << ...).
_ROW_KEY_SHIFT = np.uint64((SLICE_WIDTH // 65536).bit_length() - 1)


@dataclass
class TopOptions:
    """Options for Fragment.top (reference fragment.go TopOptions)."""
    n: int = 0
    src: Optional[Bitmap] = None
    row_ids: list[int] = field(default_factory=list)
    filter_field: str = ""
    filter_values: list = field(default_factory=list)
    min_threshold: int = 0
    tanimoto_threshold: int = 0


class Fragment:
    # Candidate sets larger than this take the one-pass src-count map.
    SRC_MAP_MIN = 64

    _EMPTY_COUNTS = (np.empty(0, dtype=np.int64),
                     np.empty(0, dtype=np.int64))

    def __init__(self, path: str, index: str, frame: str, view: str,
                 slice: int, cache_type: str = cache_mod.DEFAULT_CACHE_TYPE,
                 cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
                 row_attr_store=None):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        self.storage: Optional[roaring.Bitmap] = None
        self.cache = None                       # rank/lru count cache
        self._cache_flushed = None              # last flush_cache blob
        # True once the count cache provably covers every present row
        # (set by _repair_cache_completeness on open; writes keep it).
        self._cache_complete = False
        self.row_cache = cache_mod.SimpleCache()
        self.device = DeviceRowCache()
        # src-TopN count maps, keyed by src-content hash, valid for one
        # mutation epoch. Value: (epoch, (ids, counts)).
        self._src_counts: dict[
            bytes, tuple[int, tuple[np.ndarray, np.ndarray]]] = {}
        self._epoch = 0
        self._positions = None
        self._total_bits = None
        self._present_rows = None
        self._mu = threading.RLock()
        self._open = False

    # -- lifecycle -----------------------------------------------------------

    @property
    def cache_path(self) -> str:
        return self.path + ".cache"

    def open(self) -> None:
        with self._mu:
            if self._open:
                return
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            if os.path.exists(self.path):
                with open(self.path, "rb") as f:
                    self.storage = roaring.Bitmap.unmarshal(f.read())
            else:
                self.storage = roaring.Bitmap()
            self.cache = cache_mod.new_cache(self.cache_type,
                                             self.cache_size)
            self._open_cache()
            self._open = True

    def _open_cache(self) -> None:
        # Re-rank persisted ids with counts from storage
        # (reference fragment.go:236-274).
        ids = np.empty(0, dtype=np.uint64)
        try:
            with open(self.cache_path, "rb") as f:
                ids = np.asarray(pb.Cache.FromString(f.read()).IDs,
                                 dtype=np.uint64)
        except (OSError, pb.DecodeError):
            # The cache is advisory and reconstructible; a missing, torn
            # or corrupt sidecar must not brick the fragment.
            pass
        for rid, cnt in zip(ids.tolist(), self._row_counts_of(ids).tolist()):
            self.cache.bulk_add(rid, cnt)
        self._repair_cache_completeness()
        self.cache.recalculate()

    def _repair_cache_completeness(self) -> None:
        """Rows written after the sidecar's last flush (or every row,
        when the sidecar is lost) are missing from the count cache.
        Detect by cardinality (exact per-row counts must sum to the
        storage total) and repair from present_rows when the fragment is
        small enough to dump positions, else leave the cache flagged
        incomplete — the single-pass TopN then takes the recounting
        path."""
        total = self._cached_total_bits()
        if hasattr(self.cache, "_od"):
            cached = sum(self.cache._od.values())
        else:
            cached = sum(self.cache.entries.values())
        if cached == total:
            self._cache_complete = True
            return
        if total <= _POSITIONS_CACHE_BITS:
            present = self.present_rows()
            if present is not None:
                for rid, cnt in zip(present.tolist(),
                                    self._row_counts_of(present).tolist()):
                    self.cache.bulk_add(rid, cnt)
                self._cache_complete = True
                return
        self._cache_complete = False

    def close(self) -> None:
        with self._mu:
            if not self._open:
                return
            self.snapshot()
            self.row_cache.clear()
            self.device.invalidate_all()
            self.storage = None
            self._open = False

    def snapshot(self) -> None:
        """Write the whole bitmap as a plain snapshot (temp + rename),
        then the count cache's ids to the ``.cache`` sidecar."""
        with self._mu:
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as f:
                self.storage.write_to(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.flush_cache()

    def flush_cache(self) -> None:
        """Persist cache ids to the .cache protobuf sidecar
        (reference fragment.go:1067-1093); skipped when the bytes equal
        the last flush."""
        with self._mu:
            if self.cache is None:
                return
            blob = pb.Cache(IDs=np.asarray(self.cache.ids(),
                                           dtype=np.uint64)
                            ).SerializeToString()
            if blob == self._cache_flushed:
                return
            tmp = self.cache_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.cache_path)
            self._cache_flushed = blob

    def recalculate_cache(self) -> None:
        """Rebuild the rank cache regardless of the invalidate rate limit
        (reference fragment.go:1059-1063)."""
        with self._mu:
            self.cache.recalculate()

    # -- position / row helpers ---------------------------------------------

    def pos(self, row_id: int, column_id: int) -> int:
        min_col = self.slice * SLICE_WIDTH
        if not (min_col <= column_id < min_col + SLICE_WIDTH):
            raise ValueError("column out of bounds")
        return row_id * SLICE_WIDTH + (column_id % SLICE_WIDTH)

    def row(self, row_id: int) -> Bitmap:
        """Materialize a row as a one-segment result Bitmap of absolute
        column ids (reference fragment.go:338-367), through the row
        cache."""
        with self._mu:
            cached = self.row_cache.fetch(row_id)
            if cached is not None:
                return cached
            data = self.storage.offset_range(self.slice * SLICE_WIDTH,
                                             row_id * SLICE_WIDTH,
                                             (row_id + 1) * SLICE_WIDTH)
            bm = Bitmap()
            bm.add_segment(data, self.slice, writable=False)
            self.row_cache.add(row_id, bm)
            return bm

    def pack_row(self, row_id: int, out: np.ndarray,
                 cached: bool = True) -> np.ndarray:
        """Copy one row's packed slice-local words into ``out`` (a zeroed
        u32[WORDS_PER_SLICE] buffer). ``cached`` reads through the
        residency manager's host row cache; bulk packs larger than that
        cache pass False to avoid churning it."""
        from ..ops.packed import pack_storage_row
        with self._mu:
            if cached:
                out[:] = self.device.host_row_words(self.storage, row_id)
            else:
                pack_storage_row(self.storage, row_id, out)
        return out

    def row_count(self, row_id: int) -> int:
        return self.storage.count_range(row_id * SLICE_WIDTH,
                                        (row_id + 1) * SLICE_WIDTH)

    def _row_counts_of(self, row_ids: np.ndarray) -> np.ndarray:
        """Exact bit counts of many rows in one pass over the container
        table: slice rows align on container boundaries, so a row's
        count is the sum of the cardinalities in its key span (what
        ``row_count`` computes one row at a time)."""
        # Rows at or past 2^59 hold no container (positions are below
        # 2^64, so rows below 2^44); clamping keeps the shifts in range.
        row_ids = np.minimum(np.asarray(row_ids, dtype=np.uint64),
                             np.uint64(1 << 59))
        if not len(row_ids):
            return np.empty(0, dtype=np.int64)
        keys = self.storage._keys_np()
        conts = self.storage.containers
        csum = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum(np.fromiter((c.n for c in conts), np.int64, len(keys)),
                  out=csum[1:])
        lo = np.searchsorted(keys, row_ids << _ROW_KEY_SHIFT)
        hi = np.searchsorted(keys, (row_ids + np.uint64(1))
                             << _ROW_KEY_SHIFT)
        return csum[hi] - csum[lo]

    # -- mutation ------------------------------------------------------------

    def set_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            return self._mutate(row_id, column_id, set=True)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            return self._mutate(row_id, column_id, set=False)

    def _mutate(self, row_id: int, column_id: int, set: bool) -> bool:
        pos = self.pos(row_id, column_id)
        changed = self.storage.add(pos) if set else self.storage.remove(pos)
        if not changed:
            return False
        self._epoch += 1
        self.row_cache.invalidate(row_id)
        self.device.invalidate_row(row_id)
        self.cache.add(row_id, self.row_count(row_id))
        return True

    def import_bits(self, row_ids, column_ids) -> None:
        """Bulk import of (row, absolute column) pairs."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        if len(rows) != len(cols):
            raise ValueError("row/column id length mismatch")
        min_col = self.slice * SLICE_WIDTH
        if len(cols) and (int(cols.min()) < min_col
                          or int(cols.max()) >= min_col + SLICE_WIDTH):
            raise ValueError("column out of bounds")
        positions = rows * np.uint64(SLICE_WIDTH) + (
            cols % np.uint64(SLICE_WIDTH))
        self.import_positions(positions)

    def import_positions(self, positions: np.ndarray) -> None:
        """Bulk import of slice-local bit positions (row*SLICE_WIDTH +
        col%SLICE_WIDTH): one vectorized add, persisted by the next
        snapshot (close). The count cache follows the JAX package's two
        import lanes: a small import into a large fragment (16 × its
        positions below the container count, the JAX batch-write lane)
        adds the rows whose count changed and invalidates the rankings;
        any other import adds every touched row and re-ranks."""
        positions = np.asarray(positions, dtype=np.uint64)
        with self._mu:
            rows = arrays_mod.sort_dedupe(positions
                                          // np.uint64(SLICE_WIDTH))
            small = len(positions) * 16 < len(self.storage.keys)
            before = self._row_counts_of(rows) if small else None
            self.storage.add_many(positions)
            self._epoch += 1
            counts = self._row_counts_of(rows)
            if small:
                changed = counts != before
                rows, counts = rows[changed], counts[changed]
            for rid, cnt in zip(rows.tolist(), counts.tolist()):
                self.cache.bulk_add(rid, cnt)
            if small:
                self.cache.invalidate()
            else:
                self.cache.recalculate()
            self.row_cache.clear()
            self.device.invalidate_all()

    # -- device upload feeds -------------------------------------------------

    def sparse_row_pairs(self, row_id: int):
        """(word idx, word value) pairs for one row, under the fragment
        lock — the extraction feeding device uploads (ops.packed)."""
        from ..ops import packed
        with self._mu:
            return packed.sparse_row_words(self.storage, row_id)

    def positions(self) -> np.ndarray:
        """All set positions (sorted u64), cached per mutation epoch up
        to _POSITIONS_CACHE_BITS — the state ``carry`` exports and
        imports, what ``/export`` streams, and every whole-fragment
        TopN pass."""
        hit = self._positions
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        with self._mu:
            pos = self.storage.all_positions()
            self._positions = ((self._epoch, pos)
                               if len(pos) <= _POSITIONS_CACHE_BITS
                               else None)
        return pos

    def _cached_total_bits(self) -> int:
        """storage.count() per mutation epoch."""
        hit = self._total_bits
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        n = self.storage.count()
        self._total_bits = (self._epoch, n)
        return n

    def present_rows(self):
        """Sorted row ids holding >=1 bit, cached per mutation epoch —
        lets the TopN ids-refetch skip row_count for candidates with no
        bits here. None when the fragment is too big to dump positions
        cheaply; callers then recount per id."""
        hit = self._present_rows
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        if self._cached_total_bits() > _SRC_VECTOR_BITS:
            return None
        rows = np.unique(self.positions() >> np.uint64(
            SLICE_WIDTH.bit_length() - 1))
        self._present_rows = (self._epoch, rows)
        return rows

    # -- TopN ----------------------------------------------------------------

    def _top_pairs(self, row_ids: list[int]) -> list[Pair]:
        # reference fragment.go:627-677
        if not row_ids:
            self.cache.invalidate()
            return self.cache.top()
        pairs = []
        for rid in row_ids:
            n = self.cache.get(rid)
            if n <= 0:
                n = self.row_count(rid)
            if n > 0:
                pairs.append(Pair(rid, n))
        return pairs

    def _host_src_count_map(self, src: Bitmap
                            ) -> tuple[np.ndarray, np.ndarray]:
        """src ∩ row intersection counts for EVERY row of this fragment
        in one vectorized pass, as (sorted row ids, counts): O(fragment
        bits) once instead of one roaring walk per visited candidate
        (the reference counts per row, fragment.go:529-560)."""
        key = self._src_key(src)
        if key is None:
            return self._EMPTY_COUNTS
        hit = self._src_counts.get(key)
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        seg = src._segment(self.slice, False)
        src_cols = seg.data.values() % np.uint64(SLICE_WIDTH)
        return self._compute_src_count_map(src_cols,
                                           np.uint64(SLICE_WIDTH), key)

    def _src_key(self, src: Bitmap):
        """sha1 key of the slice-local src columns for the src-count
        cache (None = absent/empty segment), memoized on the segment's
        roaring data and guarded by its version against in-place
        mutation; only the 20-byte digest is retained."""
        seg = src._segment(self.slice, False)
        if seg is None:
            return None
        data = seg.data
        memo = getattr(data, "_src_key_memo", None)
        if memo is not None and memo[0] == data.version:
            return memo[1]
        src_cols = data.values() % np.uint64(SLICE_WIDTH)
        key = (hashlib.sha1(src_cols.tobytes()).digest()
               if len(src_cols) else None)
        data._src_key_memo = (data.version, key)
        return key

    def _host_src_count_map_cached(self, src: Bitmap):
        """The cached (ids, counts) map for this src if one is already
        current — no compute."""
        key = self._src_key(src)
        if key is None:
            return self._EMPTY_COUNTS
        hit = self._src_counts.get(key)
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        return None

    def _remember_src_counts(self, key, out):
        self._src_counts[key] = (self._epoch, out)
        while len(self._src_counts) > 4:
            self._src_counts.pop(next(iter(self._src_counts)))
        return out

    def _compute_src_count_map(self, src_cols, w, key
                               ) -> tuple[np.ndarray, np.ndarray]:
        if self._cached_total_bits() <= _SRC_VECTOR_BITS:
            positions = self.positions()
            hits = positions[np.isin(positions % w, src_cols)]
            if len(hits):
                out = np.unique((hits // w).astype(np.int64),
                                return_counts=True)
            else:
                out = self._EMPTY_COUNTS
            return self._remember_src_counts(key, out)
        # Partial (ids, counts) maps, folded every ~1 M matched
        # positions: peak memory is bounded by distinct row ids, not by
        # matched bits.
        partial_ids: list[np.ndarray] = []
        partial_counts: list[np.ndarray] = []
        hit_rows: list[np.ndarray] = []
        hit_len = 0
        batch: list[np.ndarray] = []
        batch_len = 0

        def fold_hits() -> None:
            nonlocal hit_rows, hit_len
            if not hit_rows:
                return
            rows = (hit_rows[0] if len(hit_rows) == 1
                    else np.concatenate(hit_rows))
            hit_rows, hit_len = [], 0
            ids, counts = np.unique(rows, return_counts=True)
            partial_ids.append(ids)
            partial_counts.append(counts)

        def flush() -> None:
            nonlocal batch, batch_len, hit_len
            if not batch:
                return
            vals = batch[0] if len(batch) == 1 else np.concatenate(batch)
            batch, batch_len = [], 0
            hits = vals[np.isin(vals % w, src_cols)]
            if len(hits):
                hit_rows.append((hits // w).astype(np.int64))
                hit_len += len(hits)
                if hit_len >= _SRC_FOLD_POSITIONS:
                    fold_hits()

        for vals in self.storage.value_chunks():
            batch.append(vals)
            batch_len += len(vals)
            if batch_len >= (1 << 20):
                flush()
        flush()
        fold_hits()
        if not partial_ids:
            out = self._EMPTY_COUNTS
        elif len(partial_ids) == 1:
            out = (partial_ids[0], partial_counts[0])
        else:
            ids, inv = np.unique(np.concatenate(partial_ids),
                                 return_inverse=True)
            out = (ids, np.bincount(
                inv, weights=np.concatenate(partial_counts))
                .astype(np.int64))
        return self._remember_src_counts(key, out)

    def top(self, opt: TopOptions = None) -> list[Pair]:
        """TopN with threshold pruning, attr filter, Tanimoto
        (reference fragment.go:490-625; same semantics, batched counts)."""
        opt = opt or TopOptions()
        with self._mu:
            # Array fast path for the plain TopN(frame, n) shape: the
            # first n rank-cache entries with count ≥ max(threshold, 1),
            # which the heap replay below computes identically.
            if (opt.src is None and not opt.row_ids
                    and not (opt.filter_field and opt.filter_values)
                    and opt.tanimoto_threshold <= 0):
                self.cache.invalidate()
                ids, counts = self.cache.top_arrays()
                # counts are rank-sorted descending: the ≥-floor set is
                # a prefix, found by binary search on the reversed view.
                floor = max(opt.min_threshold, 1)
                cut = len(counts) - int(np.searchsorted(
                    counts[::-1], floor, side="left"))
                ids, counts = ids[:cut], counts[:cut]
                if opt.n:
                    ids, counts = ids[:opt.n], counts[:opt.n]
                return [Pair(i, c) for i, c in zip(ids.tolist(),
                                                   counts.tolist())]
            # ids-form fast path: the replay with row_ids has n=0 (push
            # all positives ≥ threshold) and pops in (count desc, id
            # asc) order, which is exactly pairs_sort.
            if (opt.src is None and opt.row_ids
                    and not (opt.filter_field and opt.filter_values)
                    and opt.tanimoto_threshold <= 0):
                floor = max(opt.min_threshold, 1)
                return cache_mod.pairs_sort(
                    p for p in self._top_pairs(opt.row_ids)
                    if p.count >= floor)
            if not opt.row_ids:
                self.cache.invalidate()
                cand_ids, cand_counts = self.cache.top_arrays()
                cand_ids = cand_ids.astype(np.int64)
                cand_counts = np.asarray(cand_counts)
            else:
                pairs = self._top_pairs(opt.row_ids)
                cand_ids = np.fromiter((p.id for p in pairs),
                                       dtype=np.int64, count=len(pairs))
                cand_counts = np.fromiter((p.count for p in pairs),
                                          dtype=np.int64,
                                          count=len(pairs))
            n = 0 if opt.row_ids else opt.n

            filters = None
            if opt.filter_field and opt.filter_values:
                filters = set(opt.filter_values)

            tanimoto = 0
            min_tan = max_tan = 0.0
            src_count = 0
            if opt.tanimoto_threshold > 0 and opt.src is not None:
                tanimoto = opt.tanimoto_threshold
                src_count = opt.src.count()
                min_tan = src_count * tanimoto / 100
                max_tan = src_count * 100 / tanimoto

            # Candidate ∩ src counts: past SRC_MAP_MIN candidates one
            # vectorized pass over the fragment counts every row, then
            # zero-overlap candidates drop out before the replay (a
            # src-count-0 pair never pushes, and removing it cannot move
            # the break point). Small candidate sets keep the per-row
            # roaring intersection unless a map is already cached.
            count_ids = count_vals = None
            if opt.src is not None:
                if len(cand_ids) > self.SRC_MAP_MIN:
                    count_ids, count_vals = \
                        self._host_src_count_map(opt.src)
                else:
                    cached = self._host_src_count_map_cached(opt.src)
                    if cached is not None:
                        count_ids, count_vals = cached
            if count_ids is not None:
                scnt = None
                if len(cand_ids):
                    keep, at = arrays_mod.searchsorted_membership(
                        count_ids, cand_ids)
                    cand_ids = cand_ids[keep]
                    cand_counts = cand_counts[keep]
                    scnt = count_vals[at[keep]]
                if (filters is None and tanimoto == 0 and n > 0
                        and len(cand_ids)):
                    return self._top_src_vectorized(
                        cand_ids, cand_counts, scnt, n,
                        opt.min_threshold)

            def src_count_of(rid: int) -> int:
                if count_ids is None:
                    return opt.src.intersection_count(self.row(rid))
                i = np.searchsorted(count_ids, rid)
                if i < len(count_ids) and count_ids[i] == rid:
                    return int(count_vals[i])
                return 0

            # Replay the reference's heap algorithm over the counts.
            results: list[tuple[int, int]] = []  # min-heap of (count, -id)
            out: list[Pair] = []

            def push(rid, cnt):
                heapq.heappush(results, (cnt, -rid))

            for rid, cnt in zip(cand_ids.tolist(),
                                cand_counts.tolist()):
                if cnt <= 0:
                    continue
                if tanimoto > 0:
                    if cnt <= min_tan or cnt >= max_tan:
                        continue
                elif cnt < opt.min_threshold:
                    continue
                if filters is not None:
                    attrs = (self.row_attr_store.attrs(rid)
                             if self.row_attr_store else None)
                    if not attrs:
                        continue
                    val = attrs.get(opt.filter_field)
                    if val is None or val not in filters:
                        continue
                if n == 0 or len(results) < n:
                    count = cnt if opt.src is None else src_count_of(rid)
                    if count == 0:
                        continue
                    if tanimoto > 0:
                        t = math.ceil(count * 100 / (cnt + src_count - count))
                        if t <= tanimoto:
                            continue
                    elif count < opt.min_threshold:
                        continue
                    push(rid, count)
                    if n > 0 and len(results) == n and opt.src is None:
                        break
                    continue
                threshold = results[0][0]
                if threshold < opt.min_threshold or cnt < threshold:
                    break
                count = src_count_of(rid)
                if count < threshold:
                    continue
                push(rid, count)

            while results:
                cnt, neg_id = heapq.heappop(results)
                out.append(Pair(-neg_id, cnt))
            out.reverse()
            return out

    @staticmethod
    def _top_src_vectorized(cand_ids, cand_counts, scnt, n: int,
                            min_threshold: int) -> list[Pair]:
        """Vectorized replay of the heap walk for the plain-src shape
        (gathered src counts in hand, no tanimoto, no attr filter,
        n>0), with the loop's visit-order semantics: phase A pushes the
        first n valid candidates (cache count and src count both >=
        max(min_threshold, 1)); t = their min src count; the walk then
        breaks at the first later candidate whose CACHE count drops
        below t, and pushes every candidate before that whose src count
        >= t. Output sorted (count desc, id asc), like the heap drain."""
        floor = max(min_threshold, 1)
        scnt = np.asarray(scnt, dtype=np.int64)
        cache_ok = cand_counts >= floor
        valid = cache_ok & (scnt >= floor)
        valid_idx = np.flatnonzero(valid)
        if len(valid_idx) <= n:
            take = valid_idx
        else:
            first_n = valid_idx[:n]
            t = int(scnt[first_n].min())
            later = np.flatnonzero(cache_ok)
            later = later[later > first_n[-1]]
            brk = later[cand_counts[later] < t]
            stop = int(brk[0]) if len(brk) else len(cand_ids)
            phase_b = later[(later < stop) & (scnt[later] >= t)]
            take = np.concatenate((first_n, phase_b))
        ids = cand_ids[take]
        cnts = scnt[take]
        order = np.lexsort((ids, -cnts))
        return [Pair(int(i), int(c))
                for i, c in zip(ids[order].tolist(),
                                cnts[order].tolist())]

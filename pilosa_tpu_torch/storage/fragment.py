"""Fragment: the storage unit at one (frame, view, slice) intersection.

Trimmed copy of the JAX package's ``storage/fragment.py``. A fragment
owns one roaring bitmap holding a rows × 2^20-column block; bit position
``pos = row * SLICE_WIDTH + (col % SLICE_WIDTH)`` (fragment.go:1511-1514).

Durability in this slice is a plain roaring snapshot: ``open`` reads the
data file (the same snapshot format as the JAX package, op-log records
included), ``close`` writes a fresh snapshot. The group-commit WAL, crc
footers, tiering, quarantine, scrub, block sync and the TopN rank cache
wait for later slices.

``device`` is the fragment's ``DeviceRowCache``: its ``(uid,
generation)`` pair is the staleness key of every device-resident block
built from this fragment (parallel.residency); every write bumps the
generation.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..parallel.residency import DeviceRowCache
from . import cache as cache_mod
from . import roaring
from .bitmap import Bitmap

# Largest position vector kept resident per fragment (8 B each ->
# 32 MB); larger ones are rebuilt per pass instead of pinned.
_POSITIONS_CACHE_BITS = 4 << 20


class Fragment:
    def __init__(self, path: str, index: str, frame: str, view: str,
                 slice: int):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice
        self.storage: Optional[roaring.Bitmap] = None
        self.row_cache = cache_mod.SimpleCache()
        self.device = DeviceRowCache()
        self._epoch = 0
        self._positions = None
        self._mu = threading.RLock()
        self._open = False

    # -- lifecycle -----------------------------------------------------------

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
            self._open = True

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
        """Write the whole bitmap as a plain snapshot (temp + rename)."""
        with self._mu:
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as f:
                self.storage.write_to(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

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
        col%SLICE_WIDTH): one vectorized add; persisted by the next
        snapshot (close)."""
        positions = np.asarray(positions, dtype=np.uint64)
        with self._mu:
            self.storage.add_many(positions)
            self._epoch += 1
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
        imports, and what ``/export`` streams."""
        hit = self._positions
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        with self._mu:
            pos = self.storage.all_positions()
            self._positions = ((self._epoch, pos)
                               if len(pos) <= _POSITIONS_CACHE_BITS
                               else None)
        return pos

"""View: container of fragments by slice for one orientation.

Trimmed copy of the JAX package's ``models/view.py`` (reference
view.go). Names: ``standard``, ``inverse``, their time-suffixed
variants (``standard_2017``, ``inverse_201701``, ...) and one
``field_<name>`` view a BSI field. Directory layout
``<frame>/views/<name>/fragments/<slice>`` (view.go:186-189). One
node: creating a fragment announces no slice to peers.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..storage import cache as cache_mod
from ..storage import wal as wal_mod
from ..storage.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_INVERSE = "inverse"
# BSI integer-field views: one per field, column-sharded like standard.
VIEW_FIELD_PREFIX = "field_"


def is_inverse_view(name: str) -> bool:
    return name.startswith(VIEW_INVERSE)


def is_field_view(name: str) -> bool:
    return name.startswith(VIEW_FIELD_PREFIX)


def field_view_name(field: str) -> str:
    return VIEW_FIELD_PREFIX + field


def is_valid_view(name: str) -> bool:
    return (name.startswith(VIEW_STANDARD)
            or name.startswith(VIEW_INVERSE)
            or is_field_view(name))


class View:
    def __init__(self, path: str, index: str, frame: str, name: str,
                 cache_type: str = cache_mod.DEFAULT_CACHE_TYPE,
                 cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
                 row_attr_store=None, wal_fsync: str = wal_mod.FSYNC_NONE,
                 quarantine=None,
                 on_create_slice=None):
        self.path = path
        self.index = index
        self.frame = frame
        self.name = name
        # fn(slice), called when a new fragment raises the view's max
        # slice (view.go:232-246 broadcasts CreateSliceMessage).
        self.on_create_slice = on_create_slice
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        self.wal_fsync = wal_fsync
        self.quarantine = quarantine  # the holder's QuarantineRegistry
        self.fragments: dict[int, Fragment] = {}
        self._mu = threading.RLock()

    # -- lifecycle

    @property
    def fragments_path(self) -> str:
        return os.path.join(self.path, "fragments")

    def fragment_path(self, slice: int) -> str:
        return os.path.join(self.fragments_path, str(slice))

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.fragments_path, exist_ok=True)
            for entry in sorted(os.listdir(self.fragments_path)):
                if entry.endswith(".blob") and entry[:-5].isdigit():
                    # Blob-tier stub (tier): the data file left local
                    # disk, but the fragment stays discoverable —
                    # Fragment.open recognizes the stub and opens in the
                    # blob state.
                    entry = entry[:-5]
                elif not entry.isdigit():
                    continue
                if int(entry) in self.fragments:
                    continue
                frag = self._new_fragment(int(entry))
                frag.open()
                self.fragments[int(entry)] = frag

    def close(self) -> None:
        with self._mu:
            for frag in self.fragments.values():
                frag.close()
            self.fragments.clear()

    def _new_fragment(self, slice: int) -> Fragment:
        return Fragment(self.fragment_path(slice), self.index, self.frame,
                        self.name, slice, cache_type=self.cache_type,
                        cache_size=self.cache_size,
                        row_attr_store=self.row_attr_store,
                        wal_fsync=self.wal_fsync, quarantine=self.quarantine)

    # -- fragments

    def fragment(self, slice: int) -> Optional[Fragment]:
        return self.fragments.get(slice)

    def create_fragment_if_not_exists(self, slice: int) -> Fragment:
        with self._mu:
            frag = self.fragments.get(slice)
            if frag is None:
                grows = slice > max(self.fragments, default=0)
                frag = self._new_fragment(slice)
                frag.open()
                self.fragments[slice] = frag
                if grows and self.on_create_slice is not None:
                    self.on_create_slice(slice)
            return frag

    def max_slice(self) -> int:
        with self._mu:
            return max(self.fragments, default=0)

    # -- bit ops (route column → slice; view.go:265-283)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SLICE_WIDTH)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SLICE_WIDTH)
        return frag.clear_bit(row_id, column_id)

    def mutate_bits(self, row_ids: np.ndarray, column_ids: np.ndarray,
                    set: bool) -> np.ndarray:
        """Batched set/clear through the fragments' batch lane: one
        stable argsort groups the ops by slice, one batched mutation per
        touched fragment. Returns a per-op changed bool array (WAL'd
        durability identical to the per-op path — fragment.set_bits)."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        changed = np.zeros(len(rows), dtype=bool)
        if not len(rows):
            return changed
        slices = cols // np.uint64(SLICE_WIDTH)
        order = np.argsort(slices, kind="stable")
        srt = slices[order]
        bounds = np.flatnonzero(srt[1:] != srt[:-1]) + 1
        starts = np.concatenate(([0], bounds, [len(srt)]))
        w = np.uint64(SLICE_WIDTH)
        for s, e in zip(starts[:-1].tolist(), starts[1:].tolist()):
            idx = order[s:e]
            frag = self.create_fragment_if_not_exists(int(srt[s]))
            op = frag.set_bits if set else frag.clear_bits
            ch_pos = op(rows[idx], cols[idx])
            if len(ch_pos):
                pos = rows[idx] * w + cols[idx] % w
                # Only the FIRST occurrence of a duplicated op changed
                # (per-op semantics: the repeat is an idempotent no-op).
                uniq, first = np.unique(pos, return_index=True)
                hit = np.isin(uniq, ch_pos, assume_unique=True)
                changed[idx[first[hit]]] = True
        return changed

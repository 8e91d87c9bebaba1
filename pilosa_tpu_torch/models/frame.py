"""Frame: a named row-space within an index.

Trimmed copy of the JAX package's ``models/frame.py`` (reference
frame.go). Options (rowLabel, inverseEnabled, cacheType, cacheSize,
timeQuantum, BSI fields) persist as the same protobuf ``.meta`` file
(frame.go:280-336), so either package opens the other's frames with
their options; the row attribute store is ``<frame>/attrs``. Each
fragment keeps the TopN count cache of the frame's ``cacheType`` and
``cacheSize``. This slice writes the standard view: SetBit, ClearBit
and bulk import. The options
that later slices serve are kept and reported, and a write that needs
them (the inverse transpose, time views) raises PilosaError naming its
slice.
"""

from __future__ import annotations

import datetime as dt
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..errors import PilosaError, later, validate_label
from ..proto import internal as pb
from ..storage import cache as cache_mod
from ..storage import wal as wal_mod
from ..storage.attrs import AttrStore
from ..utils.arrays import group_by_key, sort_dedupe
from .view import (VIEW_STANDARD, View, is_field_view, is_inverse_view,
                   is_valid_view)

DEFAULT_ROW_LABEL = "rowID"

# Widest BSI field (value planes) the JAX package accepts.
MAX_BIT_DEPTH = 63

# The slice of the port that will serve what the options below enable.
LATER_VIEWS = "the Range/time-view/BSI slice"


@dataclass
class Field:
    """A BSI integer field of a frame: kept in ``.meta`` and reported in
    ``/schema``; its values are served by a later slice."""
    name: str
    min: int = 0
    max: int = 0

    def __post_init__(self):
        validate_label(self.name)
        if self.max < self.min:
            raise PilosaError(
                f"field max ({self.max}) must be >= min ({self.min})")
        if (self.max - self.min).bit_length() > MAX_BIT_DEPTH:
            raise PilosaError("field range too wide (max 63 bits)")

    def encode(self) -> pb.FieldMeta:
        return pb.FieldMeta(Name=self.name, Min=self.min, Max=self.max)

    @staticmethod
    def decode(meta: pb.FieldMeta) -> "Field":
        return Field(name=meta.Name, min=meta.Min, max=meta.Max)

    def to_json(self) -> dict:
        return {"name": self.name, "min": self.min, "max": self.max}


@dataclass
class FrameOptions:
    row_label: str = DEFAULT_ROW_LABEL
    inverse_enabled: bool = False
    cache_type: str = cache_mod.DEFAULT_CACHE_TYPE
    cache_size: int = cache_mod.DEFAULT_CACHE_SIZE
    time_quantum: str = ""
    fields: Optional[list[Field]] = None

    def encode(self) -> pb.FrameMeta:
        return pb.FrameMeta(RowLabel=self.row_label,
                            InverseEnabled=self.inverse_enabled,
                            CacheType=self.cache_type,
                            CacheSize=self.cache_size,
                            TimeQuantum=self.time_quantum,
                            Fields=[f.encode() for f in self.fields or []])

    @staticmethod
    def decode(meta: pb.FrameMeta) -> "FrameOptions":
        return FrameOptions(row_label=meta.RowLabel or DEFAULT_ROW_LABEL,
                            inverse_enabled=meta.InverseEnabled,
                            cache_type=meta.CacheType
                            or cache_mod.DEFAULT_CACHE_TYPE,
                            cache_size=meta.CacheSize
                            or cache_mod.DEFAULT_CACHE_SIZE,
                            time_quantum=meta.TimeQuantum,
                            fields=[Field.decode(f)
                                    for f in meta.Fields] or None)


class Frame:
    def __init__(self, path: str, index: str, name: str,
                 options: Optional[FrameOptions] = None,
                 wal_fsync: str = wal_mod.FSYNC_NONE):
        self.path = path
        self.index = index
        self.name = name
        self.options = options or FrameOptions()
        self.wal_fsync = wal_fsync
        self.views: dict[str, View] = {}
        self.row_attr_store = AttrStore(os.path.join(path, "attrs"))
        self._mu = threading.RLock()

    # -- lifecycle -----------------------------------------------------------

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def views_path(self) -> str:
        return os.path.join(self.path, "views")

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.views_path(), exist_ok=True)
            self._load_meta()
            self._save_meta()
            self.row_attr_store.open()
            for entry in sorted(os.listdir(self.views_path())):
                if not is_valid_view(entry):
                    continue
                view = self._new_view(entry)
                view.open()
                self.views[entry] = view

    def close(self) -> None:
        with self._mu:
            for v in self.views.values():
                v.close()
            self.views.clear()
            self.row_attr_store.close()

    def _load_meta(self) -> None:
        try:
            with open(self.meta_path, "rb") as f:
                self.options = FrameOptions.decode(
                    pb.FrameMeta.FromString(f.read()))
        except FileNotFoundError:
            pass

    def _save_meta(self) -> None:
        blob = self.options.encode().SerializeToString()
        tmp = self.meta_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.meta_path)

    # -- options accessors ---------------------------------------------------

    @property
    def row_label(self) -> str:
        return self.options.row_label

    @property
    def inverse_enabled(self) -> bool:
        return self.options.inverse_enabled

    def time_quantum(self) -> str:
        return self.options.time_quantum

    def fields(self) -> list[Field]:
        with self._mu:
            return list(self.options.fields or [])

    # -- views ---------------------------------------------------------------

    def _new_view(self, name: str) -> View:
        return View(os.path.join(self.views_path(), name), self.index,
                    self.name, name, cache_type=self.options.cache_type,
                    cache_size=self.options.cache_size,
                    row_attr_store=self.row_attr_store,
                    wal_fsync=self.wal_fsync)

    def view(self, name: str) -> Optional[View]:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._mu:
            if not self.inverse_enabled and is_inverse_view(name):
                raise PilosaError("inverse views not enabled for frame")
            v = self.views.get(name)
            if v is not None:
                return v
            if name != VIEW_STANDARD:
                raise later(f"writing view {name!r}", LATER_VIEWS)
            v = self._new_view(name)
            v.open()
            self.views[name] = v
            return v

    def max_slice(self) -> int:
        # Field views are column-sharded like standard, and a pure
        # integer frame may hold bits only there (time views fan out
        # beside standard, so standard bounds them).
        return max((v.max_slice() for name, v in list(self.views.items())
                    if name == VIEW_STANDARD or is_field_view(name)),
                   default=0)

    def max_inverse_slice(self) -> int:
        v = self.views.get("inverse")
        return v.max_slice() if v else 0

    # -- bit ops (frame.go:446-527) ------------------------------------------

    def _writable_standard_view(self, what: str) -> View:
        """The standard view, for a write that lands there alone: a frame
        with inverse storage also needs the transpose, which a later
        slice writes."""
        if self.inverse_enabled:
            raise later(f"{what} on a frame with inverseEnabled",
                        LATER_VIEWS)
        return self.create_view_if_not_exists(VIEW_STANDARD)

    def set_bit(self, view_name: str, row_id: int, col_id: int,
                t: Optional[dt.datetime] = None) -> bool:
        return self._mutate(view_name, row_id, col_id, t, set=True)

    def clear_bit(self, view_name: str, row_id: int, col_id: int,
                  t: Optional[dt.datetime] = None) -> bool:
        return self._mutate(view_name, row_id, col_id, t, set=False)

    def mutate_bits(self, row_ids, col_ids, set: bool) -> np.ndarray:
        """Batched timestamp-free set/clear on the standard view (the
        executor's SetBit-run lane). Returns per-op changed bools."""
        view = self._writable_standard_view(
            "SetBit()" if set else "ClearBit()")
        return view.mutate_bits(row_ids, col_ids, set)

    def _mutate(self, view_name: str, row_id: int, col_id: int,
                t: Optional[dt.datetime], set: bool) -> bool:
        what = "SetBit()" if set else "ClearBit()"
        if view_name != VIEW_STANDARD:
            raise later(f"{what} on view {view_name!r}", LATER_VIEWS)
        if t is not None and self.time_quantum():
            # frame.go:446-485: a timestamp also writes one time view
            # per quantum unit.
            raise later(f"{what} with a timestamp on a frame with a time"
                        " quantum", LATER_VIEWS)
        view = self._writable_standard_view(what)
        op = view.set_bit if set else view.clear_bit
        return op(row_id, col_id)

    # -- bulk import (frame.go:530-606) --------------------------------------

    def import_bits(self, row_ids, column_ids) -> None:
        """Group bits by slice and bulk-import each standard-view
        fragment."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        if len(rows) != len(cols):
            raise ValueError("row/column length mismatch")
        if not len(rows):
            return
        view = self._writable_standard_view("import")
        w = np.uint64(SLICE_WIDTH)
        for slice, rs, cs in group_by_key(cols // w, rows, cols):
            frag = view.create_fragment_if_not_exists(slice)
            frag.import_positions(sort_dedupe(rs * w + cs % w))

    def import_slice_positions(self, slice: int,
                               positions: np.ndarray) -> None:
        """Standard-view bulk import of one slice's sorted, deduplicated
        slice-local positions (the raw-import v2 wire form)."""
        if not len(positions):
            return
        view = self._writable_standard_view("import")
        view.create_fragment_if_not_exists(slice).import_positions(
            positions)

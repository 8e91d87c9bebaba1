"""Frame: a named row-space within an index.

Trimmed copy of the JAX package's ``models/frame.py`` (reference
frame.go). Options (rowLabel, inverseEnabled, cacheType, cacheSize,
timeQuantum, BSI fields) persist as the same protobuf ``.meta`` file
(frame.go:280-336), so either package opens the other's frames with
their options; the row attribute store is ``<frame>/attrs``. Each
fragment keeps the TopN count cache of the frame's ``cacheType`` and
``cacheSize``. A write with a timestamp also writes one view per
time-quantum unit (frame.go:446-485), a frame with ``inverseEnabled``
keeps the transpose in its ``inverse`` views, and each BSI field keeps
its bit planes in a ``field_<name>`` view (storage.bsi).
"""

from __future__ import annotations

import datetime as dt
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..errors import PilosaError, validate_label
from ..proto import internal as pb
from ..storage import bsi
from ..storage import cache as cache_mod
from ..storage import wal as wal_mod
from ..storage.attrs import AttrStore
from ..utils import timequantum as tq
from ..utils.arrays import group_by_key, sort_dedupe
from .view import (VIEW_INVERSE, VIEW_STANDARD, View, field_view_name,
                   is_field_view, is_inverse_view, is_valid_view)

DEFAULT_ROW_LABEL = "rowID"


@dataclass
class Field:
    """A BSI integer field of a frame: values in [min, max] stored as
    bit-plane rows in the ``field_<name>`` view (storage.bsi)."""
    name: str
    min: int = 0
    max: int = 0

    def __post_init__(self):
        validate_label(self.name)
        if self.max < self.min:
            raise PilosaError(
                f"field max ({self.max}) must be >= min ({self.min})")
        if bsi.bit_depth(self.min, self.max) > bsi.MAX_BIT_DEPTH:
            raise PilosaError("field range too wide (max 63 bits)")

    @property
    def bit_depth(self) -> int:
        return bsi.bit_depth(self.min, self.max)

    @property
    def view_name(self) -> str:
        return field_view_name(self.name)

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
                 wal_fsync: str = wal_mod.FSYNC_NONE, quarantine=None,
                 on_create_slice=None):
        self.path = path
        self.index = index
        self.name = name
        # fn(slice, inverse) for the views' new max slices.
        self.on_create_slice = on_create_slice
        self.options = options or FrameOptions()
        self.wal_fsync = wal_fsync
        self.quarantine = quarantine  # the holder's QuarantineRegistry
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

    def set_time_quantum(self, q: str) -> None:
        with self._mu:
            self.options.time_quantum = tq.parse_time_quantum(q)
            self._save_meta()

    # -- BSI integer fields (storage.bsi row layout) -------------------------

    def fields(self) -> list[Field]:
        with self._mu:
            return list(self.options.fields or [])

    def field(self, name: str) -> Optional[Field]:
        with self._mu:
            for f in self.options.fields or []:
                if f.name == name:
                    return f
            return None

    def create_field(self, field: Field) -> Field:
        """Register a field and persist it in the ``.meta`` protobuf.
        Idempotent when (name, min, max) match; another range for an
        existing name is an error (its planes would decode against the
        wrong base and depth)."""
        with self._mu:
            existing = self.field(field.name)
            if existing is not None:
                if (existing.min, existing.max) != (field.min, field.max):
                    raise PilosaError(
                        f"field already exists with different range:"
                        f" {field.name}")
                return existing
            if self.options.fields is None:
                self.options.fields = []
            self.options.fields.append(field)
            self._save_meta()
            return field

    def _field_of(self, field_name: str) -> Field:
        field = self.field(field_name)
        if field is None:
            raise PilosaError(f"field not found: {field_name}")
        return field

    def set_field_value(self, field_name: str, column_id: int,
                        value: int) -> bool:
        """Point write of one column's integer value: the existence bit
        and a set or clear of every plane (a re-set value clears stale
        1-planes). Returns whether any bit changed."""
        field = self._field_of(field_name)
        if not field.min <= value <= field.max:
            raise PilosaError(
                f"value {value} out of range for field {field_name}"
                f" [{field.min}, {field.max}]")
        view = self.create_view_if_not_exists(field.view_name)
        u = value - field.min
        changed = view.set_bit(bsi.EXISTS_ROW, column_id)
        for i in range(field.bit_depth):
            row = bsi.PLANE_ROW_OFFSET + i
            op = view.set_bit if (u >> i) & 1 else view.clear_bit
            if op(row, column_id):
                changed = True
        return changed

    def field_value(self, field_name: str, column_id: int
                    ) -> tuple[int, bool]:
        """(value, exists) of one column, read back from its planes."""
        field = self._field_of(field_name)
        view = self.view(field.view_name)
        frag = (view.fragment(column_id // SLICE_WIDTH)
                if view is not None else None)
        if frag is None:
            return 0, False
        col = np.uint64(column_id)
        if col not in frag.row(bsi.EXISTS_ROW).bits():
            return 0, False
        u = 0
        for i in range(field.bit_depth):
            if col in frag.row(bsi.PLANE_ROW_OFFSET + i).bits():
                u |= 1 << i
        return u + field.min, True

    def import_field_values(self, field_name: str, column_ids,
                            values) -> None:
        """Bulk value import, an assignment like SetFieldValue: a
        duplicate column's last value wins; per fragment the zero
        planes of the imported columns are cleared through the WAL'd
        batch lane, then the existence row and the one planes are
        bulk-added."""
        field = self._field_of(field_name)
        cols = np.asarray(column_ids, dtype=np.uint64)
        vals = np.asarray(values, dtype=np.int64)
        if len(cols) != len(vals):
            raise ValueError("column/value length mismatch")
        if not len(cols):
            return
        if int(vals.min()) < field.min or int(vals.max()) > field.max:
            raise PilosaError(
                f"value out of range for field {field_name}"
                f" [{field.min}, {field.max}]")
        if len(cols) > 1:
            # np.unique keeps the first occurrence: reverse for the last.
            _, first_of_rev = np.unique(cols[::-1], return_index=True)
            keep = np.sort(len(cols) - 1 - first_of_rev)
            cols, vals = cols[keep], vals[keep]
        u = (vals - field.min).astype(np.uint64)
        view = self.create_view_if_not_exists(field.view_name)
        w = np.uint64(SLICE_WIDTH)
        for slice, cs, us in group_by_key(cols // w, cols, u):
            frag = view.create_fragment_if_not_exists(slice)
            local = cs % w
            set_parts = [np.uint64(bsi.EXISTS_ROW) * w + local]
            clear_parts = []
            for i in range(field.bit_depth):
                row = np.uint64(bsi.PLANE_ROW_OFFSET + i)
                on = (us >> np.uint64(i)) & np.uint64(1) == 1
                set_parts.append(row * w + local[on])
                clear_parts.append(row * w + local[~on])
            clear = (np.concatenate(clear_parts) if clear_parts
                     else np.empty(0, np.uint64))
            if len(clear):
                # Before the add: a snapshot that ends the import then
                # holds the clears too.
                frag.clear_positions(clear)
            frag.import_positions(sort_dedupe(np.concatenate(set_parts)))

    # -- views ---------------------------------------------------------------

    def _new_view(self, name: str) -> View:
        return View(os.path.join(self.views_path(), name), self.index,
                    self.name, name, cache_type=self.options.cache_type,
                    cache_size=self.options.cache_size,
                    row_attr_store=self.row_attr_store,
                    wal_fsync=self.wal_fsync, quarantine=self.quarantine,
                    on_create_slice=self._announce_slice(name))

    def _announce_slice(self, view_name: str):
        if self.on_create_slice is None:
            return None
        inverse = is_inverse_view(view_name)
        return lambda slice: self.on_create_slice(slice, inverse)

    def view(self, name: str) -> Optional[View]:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._mu:
            if not self.inverse_enabled and is_inverse_view(name):
                raise PilosaError("inverse views not enabled for frame")
            v = self.views.get(name)
            if v is None:
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
        v = self.views.get(VIEW_INVERSE)
        return v.max_slice() if v else 0

    # -- bit ops (frame.go:446-527) ------------------------------------------

    def set_bit(self, view_name: str, row_id: int, col_id: int,
                t: Optional[dt.datetime] = None) -> bool:
        return self._mutate(view_name, row_id, col_id, t, set=True)

    def clear_bit(self, view_name: str, row_id: int, col_id: int,
                  t: Optional[dt.datetime] = None) -> bool:
        return self._mutate(view_name, row_id, col_id, t, set=False)

    def mutate_bits(self, view_name: str, row_ids, col_ids,
                    set: bool) -> np.ndarray:
        """Batched timestamp-free set/clear on one view (the executor's
        SetBit-run lane). Returns per-op changed bools."""
        if not is_valid_view(view_name):
            raise PilosaError(f"invalid view: {view_name!r}")
        view = self.create_view_if_not_exists(view_name)
        return view.mutate_bits(row_ids, col_ids, set)

    def _mutate(self, view_name: str, row_id: int, col_id: int,
                t: Optional[dt.datetime], set: bool) -> bool:
        if not is_valid_view(view_name):
            raise PilosaError(f"invalid view: {view_name!r}")
        view = self.create_view_if_not_exists(view_name)
        op = view.set_bit if set else view.clear_bit
        changed = op(row_id, col_id)
        if t is None:
            return changed
        for subname in tq.views_by_time(view_name, t, self.time_quantum()):
            sub = self.create_view_if_not_exists(subname)
            op = sub.set_bit if set else sub.clear_bit
            if op(row_id, col_id):
                changed = True
        return changed

    # -- bulk import (frame.go:530-606) --------------------------------------

    def import_bits(self, row_ids, column_ids, timestamps=None,
                    views: Optional[str] = None) -> None:
        """Group bits by (view, slice), the time views and the inverse
        transpose included, then bulk-import each fragment.

        ``views`` filters the fan-out: None = all, "standard" = the
        standard and time views only, "inverse" = the inverse views
        only. Pod-internal import legs use it because a bit's standard
        and inverse views live on different pod processes (column-slice
        against row-slice placement, parallel.pod)."""
        if views not in (None, VIEW_STANDARD, VIEW_INVERSE):
            raise ValueError(f"invalid views filter: {views!r}")
        do_standard = views in (None, VIEW_STANDARD)
        do_inverse = self.inverse_enabled and views in (None, VIEW_INVERSE)
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        if len(rows) != len(cols):
            raise ValueError("row/column length mismatch")
        if timestamps is not None:
            timestamps = list(timestamps)
            if len(timestamps) != len(rows):
                raise ValueError("timestamp length mismatch")
        q = self.time_quantum()
        # (view, slice) -> chunks of slice-local positions
        data: dict[tuple[str, int], list] = {}
        w = np.uint64(SLICE_WIDTH)

        def put(view_names, rids, cids):
            # One sort of (slice << 44 | position) keys orders every
            # fragment's positions at once while rows fit 24 bits and
            # slices 20; wider ids group by slice.
            if not len(rids):
                return
            slices = cids // w
            if int(rids.max()) < (1 << 24) and int(slices.max()) < (1 << 20):
                keys = sort_dedupe((slices << np.uint64(44))
                                   | (rids * w + cids % w))
                pos = keys & np.uint64((1 << 44) - 1)
                sl = keys >> np.uint64(44)
                b = np.flatnonzero(sl[1:] != sl[:-1]) + 1
                for s, e in zip(np.concatenate(([0], b)).tolist(),
                                np.concatenate((b, [len(sl)])).tolist()):
                    for vn in view_names:
                        data.setdefault((vn, int(sl[s])), []).append(
                            pos[s:e])
                return
            for slice, rs, cs in group_by_key(slices, rids, cids):
                for vn in view_names:
                    data.setdefault((vn, slice), []).append(rs * w + cs % w)

        plain = (np.ones(len(rows), dtype=bool) if timestamps is None
                 else np.array([t is None for t in timestamps], dtype=bool))
        if plain.any():
            if do_standard:
                put([VIEW_STANDARD], rows[plain], cols[plain])
            if do_inverse:
                put([VIEW_INVERSE], cols[plain], rows[plain])
        if not plain.all():
            # A time view's name depends only on the timestamp's local
            # fields: one fan-out per distinct timestamp.
            by_ts: dict = {}
            for i in np.flatnonzero(~plain).tolist():
                ts = timestamps[i]
                key = (ts.replace(tzinfo=None)
                       if isinstance(ts, dt.datetime) else ts)
                by_ts.setdefault(key, []).append(i)
            for ts, ii in by_ts.items():
                idx = np.asarray(ii)
                r_ts, c_ts = rows[idx], cols[idx]
                if do_standard:
                    put(tq.views_by_time(VIEW_STANDARD, ts, q)
                        + [VIEW_STANDARD], r_ts, c_ts)
                if do_inverse:
                    put(tq.views_by_time(VIEW_INVERSE, ts, q)
                        + [VIEW_INVERSE], c_ts, r_ts)
        for (view_name, slice), chunks in sorted(data.items()):
            frag = self.create_view_if_not_exists(view_name) \
                .create_fragment_if_not_exists(slice)
            frag.import_positions(
                chunks[0] if len(chunks) == 1 else np.concatenate(chunks))

    def import_slice_positions(self, slice: int,
                               positions: np.ndarray) -> None:
        """Standard-view bulk import of one slice's sorted, deduplicated
        slice-local positions (the raw-import v2 wire form). The caller
        sends a frame with inverse storage through ``import_bits``."""
        if not len(positions):
            return
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        view.create_fragment_if_not_exists(slice).import_positions(
            positions)

"""Index: a named database of frames with a column attribute store.

Trimmed copy of the JAX package's ``models/index.py`` (reference
index.go): options (columnLabel, the default timeQuantum) persist as the
same protobuf ``.meta`` file, the column attribute store is
``<index>/.data``, and CreateFrame applies the option defaults and checks
of index.go:378-432. The max slice takes the largest one learned from
peers (``set_remote_max_slice``, index.go:251-297).
"""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass
from typing import Optional

from ..errors import (FrameExistsError, PilosaError, validate_label,
                      validate_name)
from ..proto import internal as pb
from ..storage import wal as wal_mod
from ..storage.attrs import AttrStore
from ..utils import timequantum as tq
from .frame import Frame, FrameOptions

DEFAULT_COLUMN_LABEL = "columnID"


@dataclass
class IndexOptions:
    column_label: str = DEFAULT_COLUMN_LABEL
    time_quantum: str = ""

    def encode(self) -> pb.IndexMeta:
        return pb.IndexMeta(ColumnLabel=self.column_label,
                            TimeQuantum=self.time_quantum)

    @staticmethod
    def decode(meta: pb.IndexMeta) -> "IndexOptions":
        return IndexOptions(
            column_label=meta.ColumnLabel or DEFAULT_COLUMN_LABEL,
            time_quantum=meta.TimeQuantum)


class Index:
    def __init__(self, path: str, name: str,
                 options: Optional[IndexOptions] = None,
                 wal_fsync: str = wal_mod.FSYNC_NONE, quarantine=None,
                 on_create_slice=None):
        validate_name(name)
        self.path = path
        self.name = name
        # fn(index, slice, inverse) for the frames' new max slices.
        self.on_create_slice = on_create_slice
        # The largest slices peers hold (index.go:251-297): learned from
        # CreateSliceMessage broadcasts, the max-slice poll and remote
        # writes, so a coordinator's slice list spans every node.
        self.remote_max_slice = 0
        self.remote_max_inverse_slice = 0
        self.options = options or IndexOptions()
        self.wal_fsync = wal_fsync
        self.quarantine = quarantine  # the holder's QuarantineRegistry
        self.frames: dict[str, Frame] = {}
        self.column_attr_store = AttrStore(os.path.join(path, ".data"))
        self._mu = threading.RLock()

    # -- lifecycle

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            self._load_meta()
            self._save_meta()
            self.column_attr_store.open()
            for entry in sorted(os.listdir(self.path)):
                if os.path.isdir(os.path.join(self.path, entry)):
                    frame = Frame(self.frame_path(entry), self.name, entry,
                                  wal_fsync=self.wal_fsync,
                                  quarantine=self.quarantine,
                                  on_create_slice=self._announce())
                    frame.open()
                    self.frames[entry] = frame

    def close(self) -> None:
        with self._mu:
            for f in self.frames.values():
                f.close()
            self.frames.clear()
            self.column_attr_store.close()

    def _load_meta(self) -> None:
        try:
            with open(self.meta_path, "rb") as f:
                self.options = IndexOptions.decode(
                    pb.IndexMeta.FromString(f.read()))
        except FileNotFoundError:
            pass

    def _save_meta(self) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.options.encode().SerializeToString())
        os.replace(tmp, self.meta_path)

    # -- options

    @property
    def column_label(self) -> str:
        return self.options.column_label

    def time_quantum(self) -> str:
        return self.options.time_quantum

    def set_time_quantum(self, q: str) -> None:
        with self._mu:
            self.options.time_quantum = tq.parse_time_quantum(q)
            self._save_meta()

    # -- slices

    def max_slice(self) -> int:
        with self._mu:
            return max([f.max_slice() for f in self.frames.values()]
                       + [self.remote_max_slice])

    def max_inverse_slice(self) -> int:
        with self._mu:
            return max([f.max_inverse_slice() for f in self.frames.values()]
                       + [self.remote_max_inverse_slice])

    def set_remote_max_slice(self, n: int) -> None:
        with self._mu:
            self.remote_max_slice = max(self.remote_max_slice, n)

    def set_remote_max_inverse_slice(self, n: int) -> None:
        with self._mu:
            self.remote_max_inverse_slice = max(
                self.remote_max_inverse_slice, n)

    def _announce(self):
        if self.on_create_slice is None:
            return None
        return lambda slice, inverse: self.on_create_slice(
            self.name, slice, inverse)

    # -- frames

    def frame(self, name: str) -> Optional[Frame]:
        return self.frames.get(name)

    def frame_path(self, name: str) -> str:
        return os.path.join(self.path, name)

    def create_frame(self, name: str, options: Optional[FrameOptions] = None
                     ) -> Frame:
        with self._mu:
            if name in self.frames:
                raise FrameExistsError(name)
            return self._create_frame(name, options)

    def create_frame_if_not_exists(self, name: str,
                                   options: Optional[FrameOptions] = None
                                   ) -> Frame:
        with self._mu:
            f = self.frames.get(name)
            if f is not None:
                return f
            return self._create_frame(name, options)

    def _create_frame(self, name: str, options: Optional[FrameOptions]
                      ) -> Frame:
        validate_name(name)
        options = options or FrameOptions()
        validate_label(options.row_label)
        # Default the frame's time quantum from the index (index.go:419-427).
        if not options.time_quantum and self.time_quantum():
            options.time_quantum = self.time_quantum()
        tq.parse_time_quantum(options.time_quantum)
        if options.cache_type not in ("lru", "ranked"):
            raise PilosaError(f"invalid cache type: {options.cache_type!r}")
        frame = Frame(self.frame_path(name), self.name, name,
                      options=options, wal_fsync=self.wal_fsync,
                      quarantine=self.quarantine,
                      on_create_slice=self._announce())
        frame.open()
        self.frames[name] = frame
        return frame

    def delete_frame(self, name: str) -> None:
        with self._mu:
            f = self.frames.pop(name, None)
            if f is not None:
                f.close()
            shutil.rmtree(self.frame_path(name), ignore_errors=True)

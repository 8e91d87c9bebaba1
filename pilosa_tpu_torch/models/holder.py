"""Holder: root container for all indexes under one data directory.

Trimmed copy of the JAX package's ``models/holder.py`` (reference
holder.go): index CRUD, Index/Frame/View/Fragment navigation
(holder.go:177-322) and the schema summary (holder.go:154-171). It opens
a data directory the JAX package wrote and closed. The holder owns the
storage-integrity QuarantineRegistry (storage.integrity) and passes it
down to every fragment, as the JAX holder does, and ``flush_caches``
writes every fragment's ``.cache`` sidecar (the server calls it every
60 s, holder.go:31). Tiering waits for a later slice.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

from ..errors import IndexExistsError, PilosaError, validate_name
from ..storage import wal as wal_mod
from ..storage.integrity import QuarantineRegistry
from .index import Index, IndexOptions


class Holder:
    def __init__(self, path: str, wal_fsync: str = wal_mod.FSYNC_NONE):
        self.path = path
        # The fragments' WAL fsync policy (storage.wal): "none", "group"
        # or "always".
        self.wal_fsync = wal_mod.check_fsync_policy(wal_fsync)
        # Storage integrity: the node-wide registry of quarantined
        # fragments — the executor's read path consults it, the
        # repairer drains it.
        self.quarantine = QuarantineRegistry()
        self.indexes: dict[str, Index] = {}
        # fn(index, slice, inverse), set by a cluster server: a new
        # fragment past a view's max slice announces the slice to peers.
        self.on_create_slice = None
        self._mu = threading.RLock()

    # -- lifecycle

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            for entry in sorted(os.listdir(self.path)):
                full = os.path.join(self.path, entry)
                if not os.path.isdir(full):
                    continue
                try:
                    validate_name(entry)
                except PilosaError:  # not an index directory
                    continue
                idx = Index(full, entry, wal_fsync=self.wal_fsync,
                            quarantine=self.quarantine,
                            on_create_slice=self._announce_slice)
                idx.open()
                self.indexes[entry] = idx

    def close(self) -> None:
        with self._mu:
            for idx in self.indexes.values():
                idx.close()
            self.indexes.clear()

    def _announce_slice(self, index: str, slice: int,
                        inverse: bool) -> None:
        if self.on_create_slice is not None:
            self.on_create_slice(index, slice, inverse)

    # -- index CRUD

    def index_path(self, name: str) -> str:
        return os.path.join(self.path, name)

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str,
                     options: Optional[IndexOptions] = None) -> Index:
        with self._mu:
            if name in self.indexes:
                raise IndexExistsError(name)
            return self._create_index(name, options)

    def create_index_if_not_exists(self, name: str,
                                   options: Optional[IndexOptions] = None
                                   ) -> Index:
        with self._mu:
            idx = self.indexes.get(name)
            if idx is not None:
                return idx
            return self._create_index(name, options)

    def _create_index(self, name: str, options) -> Index:
        validate_name(name)
        idx = Index(self.index_path(name), name, options=options,
                    wal_fsync=self.wal_fsync, quarantine=self.quarantine,
                    on_create_slice=self._announce_slice)
        idx.open()
        self.indexes[name] = idx
        return idx

    # -- navigation (holder.go:177-322)

    def frame(self, index: str, name: str):
        idx = self.index(index)
        return idx.frame(name) if idx else None

    def view(self, index: str, frame: str, name: str):
        f = self.frame(index, frame)
        return f.view(name) if f else None

    def fragment(self, index: str, frame: str, view: str, slice: int):
        v = self.view(index, frame, view)
        return v.fragment(slice) if v else None

    def iter_fragments(self) -> list:
        """A point-in-time list of every open fragment."""
        with self._mu:
            return [frag
                    for idx in self.indexes.values()
                    for frame in idx.frames.values()
                    for view in frame.views.values()
                    for frag in view.fragments.values()]

    def delete_index(self, name: str) -> None:
        with self._mu:
            idx = self.indexes.pop(name, None)
            if idx is not None:
                idx.close()
            shutil.rmtree(self.index_path(name), ignore_errors=True)

    # -- schema (holder.go:154-171)

    def schema(self) -> list[dict]:
        with self._mu:
            out = []
            for name in sorted(self.indexes):
                idx = self.indexes[name]
                frames = []
                for fname in sorted(idx.frames):
                    frame = idx.frames[fname]
                    entry = {"name": fname,
                             "views": [{"name": vn}
                                       for vn in sorted(frame.views)]}
                    fields = frame.fields()
                    if fields:
                        entry["fields"] = [f.to_json() for f in fields]
                    frames.append(entry)
                out.append({"name": name, "frames": frames})
            return out

    def max_slices(self) -> dict[str, int]:
        return {name: idx.max_slice()
                for name, idx in self.indexes.items()}

    def flush_caches(self) -> None:
        """Flush all fragment TopN caches (holder.go:324-358)."""
        with self._mu:
            for idx in self.indexes.values():
                for frame in idx.frames.values():
                    for view in frame.views.values():
                        for frag in view.fragments.values():
                            frag.flush_cache()

    def max_inverse_slices(self) -> dict[str, int]:
        return {name: idx.max_inverse_slice()
                for name, idx in self.indexes.items()}

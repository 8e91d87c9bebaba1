"""View: container of fragments by slice for one orientation.

Trimmed copy of the JAX package's ``models/view.py`` (reference
view.go). Queries and writes of this slice reach the standard view
only; the inverse, time and BSI field views of a data directory the JAX
package wrote are opened and listed, and their fragments left as they
are. Directory layout ``<frame>/views/<name>/fragments/<slice>``
(view.go:186-189).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .. import SLICE_WIDTH
from ..storage import cache as cache_mod
from ..storage.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_INVERSE = "inverse"
# BSI integer-field views: one per field, column-sharded like standard.
VIEW_FIELD_PREFIX = "field_"


def is_inverse_view(name: str) -> bool:
    return name.startswith(VIEW_INVERSE)


def is_field_view(name: str) -> bool:
    return name.startswith(VIEW_FIELD_PREFIX)


def is_valid_view(name: str) -> bool:
    return (name.startswith(VIEW_STANDARD)
            or name.startswith(VIEW_INVERSE)
            or is_field_view(name))


class View:
    def __init__(self, path: str, index: str, frame: str, name: str,
                 cache_type: str = cache_mod.DEFAULT_CACHE_TYPE,
                 cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
                 row_attr_store=None):
        self.path = path
        self.index = index
        self.frame = frame
        self.name = name
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
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
                if not entry.isdigit() or int(entry) in self.fragments:
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
                        row_attr_store=self.row_attr_store)

    # -- fragments

    def fragment(self, slice: int) -> Optional[Fragment]:
        return self.fragments.get(slice)

    def create_fragment_if_not_exists(self, slice: int) -> Fragment:
        with self._mu:
            frag = self.fragments.get(slice)
            if frag is None:
                frag = self._new_fragment(slice)
                frag.open()
                self.fragments[slice] = frag
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

"""Generic (row, column) pair iterators.

Copy of the JAX package's ``storage/iterators.py`` (reference
iterator.go). The ``Iterator`` contract is two methods —
``seek(row, col)`` positions at the first pair >= (row, col), and
``next()`` returns ``(row, col, eof)`` — plus three adapters:
``BufIterator`` (single-slot unread/peek, iterator.go:30-80),
``LimitIterator`` (EOF past a max pair, iterator.go:82-119),
``SliceIterator`` (parallel id arrays, iterator.go:122-172), and
``RoaringIterator`` (adapts bitmap positions to pairs via
pos = row*SLICE_WIDTH + col, iterator.go:175-194).

These serve host-side streaming paths (export, consensus merge input);
bulk compute never iterates bit by bit — it goes through the packed
device kernels (pilosa_tpu_torch.ops).
"""

from __future__ import annotations

from .. import SLICE_WIDTH
from .roaring import Bitmap

EOF = (0, 0, True)


class BufIterator:
    """Buffered iterator supporting a one-deep unread (iterator.go:30-80)."""

    def __init__(self, itr):
        self._itr = itr
        self._buf = None          # last value read, if retained
        self._full = False

    def seek(self, row_id: int, column_id: int) -> None:
        self._full = False
        self._itr.seek(row_id, column_id)

    def next(self) -> tuple[int, int, bool]:
        if self._full:
            self._full = False
            return self._buf
        self._buf = self._itr.next()
        return self._buf

    def peek(self) -> tuple[int, int, bool]:
        out = self.next()
        self.unread()
        return out

    def unread(self) -> None:
        """Push the previous pair back; error if one is already buffered
        (iterator.go:73-80 panics) or nothing has been read yet."""
        if self._full:
            raise RuntimeError("BufIterator: buffer full")
        if self._buf is None:
            raise RuntimeError("BufIterator: nothing read yet")
        self._full = True


class LimitIterator:
    """EOF once the source passes (max_row, max_col) (iterator.go:82-119)."""

    def __init__(self, itr, max_row_id: int, max_column_id: int):
        self._itr = itr
        self.max_row_id = max_row_id
        self.max_column_id = max_column_id
        self._eof = False

    def seek(self, row_id: int, column_id: int) -> None:
        self._eof = False   # re-positioning revives a drained iterator
        self._itr.seek(row_id, column_id)

    def next(self) -> tuple[int, int, bool]:
        if self._eof:
            return EOF
        row, col, eof = self._itr.next()
        if eof or row > self.max_row_id or (
                row == self.max_row_id and col > self.max_column_id):
            self._eof = True
            return EOF
        return row, col, False


class SliceIterator:
    """Iterate parallel row/column id arrays (iterator.go:122-172)."""

    def __init__(self, row_ids, column_ids):
        if len(row_ids) != len(column_ids):
            raise ValueError(
                f"SliceIterator: pair length mismatch: "
                f"{len(row_ids)} != {len(column_ids)}")
        self._rows = row_ids
        self._cols = column_ids
        self._i = 0
        self._n = len(row_ids)

    def seek(self, row_id: int, column_id: int) -> None:
        for i in range(self._n):
            r, c = int(self._rows[i]), int(self._cols[i])
            if (row_id == r and column_id <= c) or row_id < r:
                self._i = i
                return
        self._i = self._n

    def next(self) -> tuple[int, int, bool]:
        if self._i >= self._n:
            return EOF
        out = (int(self._rows[self._i]), int(self._cols[self._i]), False)
        self._i += 1
        return out


class RoaringIterator:
    """Adapt a roaring bitmap's sorted positions into (row, col) pairs
    (iterator.go:175-194)."""

    def __init__(self, bitmap: Bitmap, slice_width: int = SLICE_WIDTH):
        self._bitmap = bitmap
        self._width = slice_width
        self._gen = iter(bitmap)

    def seek(self, row_id: int, column_id: int) -> None:
        self._gen = self._bitmap.iterator_from(
            row_id * self._width + column_id)

    def next(self) -> tuple[int, int, bool]:
        v = next(self._gen, None)
        if v is None:
            return EOF
        return v // self._width, v % self._width, False


def pairs(itr):
    """Drain an Iterator into a Python list of (row, col) tuples."""
    out = []
    while True:
        row, col, eof = itr.next()
        if eof:
            return out
        out.append((row, col))

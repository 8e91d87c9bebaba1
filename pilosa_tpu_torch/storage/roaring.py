"""Roaring bitmap engine — host-side storage layer, numpy-vectorized.

File-format compatible with the reference implementation
(the Go reference's roaring/roaring.go) so fragment data files interchange:

    snapshot  := cookie(u32 LE = 12346) keyN(u32 LE)
                 { key(u64 LE) n-1(u32 LE) } * keyN          # container headers
                 { offset(u32 LE) } * keyN                    # container offsets
                 container blocks                             # see below
    container := array  : n * u32 LE   (low-16-bit values widened to u32)
               | bitmap : 1024 * u64 LE
    op-log    := { typ(u8: 0=add 1=remove) value(u64 LE) fnv1a32(u32 LE) } *
                 appended after the snapshot body, replayed on load.

(Reference format sections: roaring.go:475-614 for snapshot,
roaring.go:1560-1626 for the op-log.)

Run containers (the reference vintage predates them) follow the later
papers — arXiv:1603.06549 and arXiv:1709.07821 — which add a third
container kind holding sorted ``[start, length]`` interval pairs plus a
cardinality-adaptive ``optimize()`` pass that picks the smallest of
array/bitmap/run per container. A snapshot containing at least one run
container uses the runs cookie (the upstream SERIAL_COOKIE idiom):

    snapshot  := cookie(u32 LE = 12347) keyN(u32 LE)
                 runFlags: ceil(keyN/8) bytes rounded up to a multiple
                           of 8 (bit i, little-endian bit order, set ⇒
                           container i is a run container)
                 { key(u64 LE) n-1(u32 LE) } * keyN   # n = cardinality
                 { offset(u32 LE) } * keyN
                 container blocks
    run block := numRuns(u16 LE) { start(u16 LE) length-1(u16 LE) } *

A snapshot with no run containers is byte-identical to the legacy
12346 form, so pre-run files (and the golden fixtures) interchange
unchanged. The op-log is kind-agnostic: replay mutates run containers
directly (interval surgery) or splits/extends them.

Design departure from the reference: containers are numpy arrays, not
pointer-chased structs — an array container is a sorted ``np.uint32`` vector
(values < 2^16), a bitmap container is an ``np.uint64[1024]`` word vector,
and a run container is a little-endian ``np.uint16`` vector that IS the
wire block (``[numRuns, start0, len0-1, ...]``), so serialization is a
write of the buffer and an mmap load is a zero-copy view.
All set algebra is vectorized (numpy or the optional C++ kernel lib in
``pilosa_tpu_torch.native``); the same dense-word orientation is what packs
straight onto the card (see pilosa_tpu_torch.ops.packed).

Copied from the JAX package's ``storage/roaring.py``, with its
``wal.append`` failpoint site on plain op writers (the group-commit
WAL carries its own at the leader flush).
Every container set-algebra op is counted by operand kinds and charged
to the current query's cost ledger (``_bump``, obs.accounting). Op records go to the group-commit WAL
(storage.wal) and point mutations take the one-crossing mutate
extension (storage.native_ext) when it is built.
"""

from __future__ import annotations

import bisect
import io
import struct
import zlib
from typing import Callable, Iterator as TIterator, Optional

import numpy as np

from ..fault import failpoints as _fp
from ..obs import accounting as _accounting
from . import integrity as _integrity
from . import native
from . import native_ext
from . import wal as _wal_mod
from ..utils.arrays import searchsorted_membership, sort_dedupe


def _wal_write(writer, blob: bytes) -> None:
    """Every op-log append funnels through here. A group-commit WAL
    (storage.wal.GroupCommitWal — the fragment's op writer) buffers the
    records; its LEADER flush is where bytes reach the file, so the
    ``wal.append`` failpoint fires there. Plain file-like writers
    (tests attaching BytesIO) keep the per-append injection + write."""
    if type(writer) is _wal_mod.GroupCommitWal:
        writer.append(blob)
        return
    if _fp.ACTIVE is not None:
        _fp.ACTIVE.hit("wal.append", writer=writer, data=blob)
    writer.write(blob)

# --- constants (match reference wire format) ---------------------------------

COOKIE = 12346               # roaring.go:30
COOKIE_RUNS = 12347          # runs format (upstream SERIAL_COOKIE idiom)
HEADER_SIZE = 8              # roaring.go:33
BITMAP_N = 1024              # u64 words per bitmap container (roaring.go:36)
ARRAY_MAX_SIZE = 4096        # roaring.go:833
# Past this many runs the run block (2 + 4R bytes) can never be the
# smallest representation (a bitmap is 8192 bytes), so mutation paths
# convert rather than let a degrading run container grow unboundedly.
RUN_MAX_SIZE = 2047
OP_SIZE = 13                 # 1 + 8 + 4 (roaring.go:1626)

OP_ADD = 0
OP_REMOVE = 1

_EMPTY_U32 = np.empty(0, dtype=np.uint32)
_EMPTY_U64 = np.empty(0, dtype=np.uint64)

# FNV-1a 32-bit (op-log checksums).
_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)

# Snapshot container-header record (key u64 LE + n-1 u32 LE, packed) —
# one definition shared by the reader (unmarshal) and the writer
# (_write_snapshot) so a format tweak cannot desynchronize them.
_HDR_DTYPE = np.dtype([("key", "<u8"), ("n", "<u4")])


def _container_sizes(ns: np.ndarray) -> np.ndarray:
    """On-disk payload bytes per container from its value count
    (n<=4096 ⇒ u32 array block, else 1024 u64 words)."""
    return np.where(ns <= ARRAY_MAX_SIZE, ns * 4, BITMAP_N * 8)


def fnv1a32(data: bytes) -> int:
    h = int(_FNV_OFFSET)
    for b in data:
        h = ((h ^ b) * int(_FNV_PRIME)) & 0xFFFFFFFF
    return h


def highbits(v: int) -> int:
    return v >> 16


def lowbits(v: int) -> int:
    return v & 0xFFFF


# --- container ---------------------------------------------------------------


class Container:
    """One 2^16-value container: sorted u32 array, 1024-word u64 bitmap,
    or a wire-form u16 run buffer ([R, start, len-1, ...]).

    ``mapped`` marks data backed by an external (mmap'd) buffer; any mutation
    first copies (copy-on-write), mirroring the reference's ``mapped`` flag
    (roaring.go:536-614) and BitmapSegment.writable (bitmap.go:384-392).
    """

    __slots__ = ("array", "bitmap", "runs", "n", "mapped", "cow")

    def __init__(self):
        self.array: Optional[np.ndarray] = _EMPTY_U32  # sorted u32, or None
        self.bitmap: Optional[np.ndarray] = None       # u64[1024], or None
        self.runs: Optional[np.ndarray] = None         # u16 run buffer, or None
        self.n: int = 0
        self.mapped: bool = False
        # Copy-on-write token for frozen-snapshot captures: when this
        # lags the owning Bitmap's _cow_epoch, an in-place bitmap-word
        # mutation must copy the buffer first (a background snapshot
        # serializes the captured buffer by pointer). Array and run
        # buffers are replaced, never mutated in place, so they need no
        # token check.
        self.cow: int = 0

    # -- representation management

    def is_array(self) -> bool:
        return self.bitmap is None and self.runs is None

    def is_run(self) -> bool:
        return self.runs is not None

    def kind(self) -> str:
        if self.runs is not None:
            return "run"
        return "array" if self.bitmap is None else "bitmap"

    def _unmap(self) -> None:
        if self.mapped:
            if self.array is not None:
                self.array = self.array.copy()
            if self.bitmap is not None:
                self.bitmap = self.bitmap.copy()
            if self.runs is not None:
                self.runs = self.runs.copy()
            self.mapped = False

    def _to_bitmap(self) -> None:
        """array/run → bitmap conversion (roaring.go:951-976)."""
        if self.bitmap is not None:
            return
        self.bitmap = self.as_words()
        self.array = None
        self.runs = None
        self.mapped = False

    def _to_array(self) -> None:
        """bitmap/run → array conversion (roaring.go:1023-1048)."""
        if self.runs is not None:
            self.array = runs_to_values(self.runs)
            self.runs = None
            self.mapped = False
            return
        if self.bitmap is None:
            return
        self.array = bitmap_words_to_values(self.bitmap)
        self.bitmap = None
        self.mapped = False

    def _run_to_legacy(self) -> None:
        """Run → the legacy kind the n<=4096 file rule dictates — the
        transparent upgrade the bulk write paths apply before mutating
        (runs re-appear at the next optimize())."""
        if self.n > ARRAY_MAX_SIZE:
            self._to_bitmap()
        else:
            self._to_array()

    def _maybe_convert(self) -> None:
        # Invariant (required by the file format, where n<=4096 ⇒ array
        # block): array containers hold at most ARRAY_MAX_SIZE values, bitmap
        # containers strictly more. Matches reference arrayAdd/bitmapRemove
        # boundaries (roaring.go:951-953,1023-1025). Run containers are
        # exempt (the runs flag bitset identifies them on disk); they
        # only convert when mutation degrades them past the point where
        # runs could ever be the smallest form.
        if self.runs is not None:
            if (len(self.runs) >> 1) > RUN_MAX_SIZE:
                self._run_to_legacy()
            return
        if self.bitmap is None:
            if self.n > ARRAY_MAX_SIZE:
                self._to_bitmap()
        else:
            if self.n <= ARRAY_MAX_SIZE:
                self._to_array()

    def optimize(self) -> str:
        """Cardinality-adaptive representation selection (the
        runOptimize pass of arXiv:1603.06549 §3 / arXiv:1709.07821 §2.1):
        count the runs the current contents compress into and keep the
        smallest wire form — run (2+4R bytes) vs the legacy kind the
        n<=4096 rule dictates (4n or 8192). Returns the chosen kind.
        A container already in its best form is left untouched (mmap'd
        buffers stay zero-copy)."""
        if self.n == 0:
            if self.runs is not None:
                self._to_array()
            return self.kind()
        if self.runs is not None:
            n_runs = (len(self.runs) - 1) >> 1
        elif self.bitmap is None:
            n_runs = run_count_array(self.array)
        else:
            n_runs = run_count_words(self.bitmap)
        run_size = 2 + 4 * n_runs
        legacy_size = (self.n * 4 if self.n <= ARRAY_MAX_SIZE
                       else BITMAP_N * 8)
        if run_size < legacy_size:
            if self.runs is None:
                vals = (self.array if self.bitmap is None
                        else bitmap_words_to_values(self.bitmap))
                self.runs = values_to_runs(vals)
                self.array = None
                self.bitmap = None
                self.mapped = False
            return "run"
        if self.runs is not None:
            self._run_to_legacy()
        else:
            self._maybe_convert()
        return self.kind()

    # -- point ops

    def add(self, v: int) -> bool:
        # The single-op write hot path: manual copy-insert instead of
        # np.insert (which is a Python-level helper costing ~15 us per
        # call), and plain Python ints on the bitmap branch (numpy
        # scalar ops pay ~2 us each). Building a fresh array also
        # detaches from a mapped buffer, so no _unmap() copy on the
        # array branch.
        if self.runs is not None:
            return self._run_add(v)
        if self.bitmap is None:
            # Manual numpy copy-insert: the ctypes pointer prep for the
            # native kernel costs ~4 us/call (arr.ctypes construction +
            # cast) — more than the whole insert at container sizes, so
            # the C path only pays for bulk ops, not point adds.
            a = self.array
            i = int(np.searchsorted(a, v))
            if i < len(a) and a[i] == v:
                return False
            grown = np.empty(len(a) + 1, dtype=np.uint32)
            grown[:i] = a[:i]
            grown[i] = v
            grown[i + 1:] = a[i:]
            self.array = grown
            self.mapped = False
            self.n += 1
            self._maybe_convert()
            return True
        w = v >> 6
        word = int(self.bitmap[w])
        bit = 1 << (v & 63)
        if word & bit:
            return False
        self._unmap()
        self.bitmap[w] = word | bit
        self.n += 1
        return True

    def _run_add(self, v: int) -> bool:
        """Interval surgery: extend/merge the neighbouring runs or
        insert a fresh single-value run. Rebuilds the (small) buffer —
        run buffers are never mutated in place, which keeps mmap'd and
        frozen captures safe without COW bookkeeping."""
        starts, ends = _runs_starts_ends(self.runs)
        n_runs = len(starts)
        i = int(np.searchsorted(starts, v, side="right")) - 1
        if i >= 0 and v < ends[i]:
            return False
        join_prev = i >= 0 and v == int(ends[i])
        join_next = i + 1 < n_runs and v == int(starts[i + 1]) - 1
        if join_prev and join_next:
            starts = np.delete(starts, i + 1)
            ends = np.delete(ends, i)
        elif join_prev:
            ends[i] += 1
        elif join_next:
            starts[i + 1] -= 1
        else:
            starts = np.insert(starts, i + 1, v)
            ends = np.insert(ends, i + 1, v + 1)
        self.runs = _build_runs(starts, ends)
        self.mapped = False
        self.n += 1
        self._maybe_convert()
        return True

    def _run_remove(self, v: int) -> bool:
        starts, ends = _runs_starts_ends(self.runs)
        i = int(np.searchsorted(starts, v, side="right")) - 1
        if i < 0 or v >= ends[i]:
            return False
        if ends[i] - starts[i] == 1:
            starts = np.delete(starts, i)
            ends = np.delete(ends, i)
        elif v == int(starts[i]):
            starts[i] += 1
        elif v == int(ends[i]) - 1:
            ends[i] -= 1
        else:  # split the run around v
            tail_end = int(ends[i])
            ends[i] = v
            starts = np.insert(starts, i + 1, v + 1)
            ends = np.insert(ends, i + 1, tail_end)
        self.runs = _build_runs(starts, ends)
        self.mapped = False
        self.n -= 1
        self._maybe_convert()
        return True

    def remove(self, v: int) -> bool:
        if self.runs is not None:
            return self._run_remove(v)
        if self.bitmap is None:
            a = self.array
            i = int(np.searchsorted(a, v))
            if i >= len(a) or a[i] != v:
                return False
            self._unmap()
            self.array = np.delete(self.array, i)
            self.n -= 1
            return True
        w, b = v >> 6, np.uint64(1) << np.uint64(v & 63)
        if not (self.bitmap[w] & b):
            return False
        self._unmap()
        self.bitmap[w] &= ~b
        self.n -= 1
        self._maybe_convert()
        return True

    def contains(self, v: int) -> bool:
        if self.runs is not None:
            starts = self.runs[1::2]
            i = int(np.searchsorted(starts, v, side="right")) - 1
            return (i >= 0 and
                    v <= int(starts[i]) + int(self.runs[2 + 2 * i]))
        if self.bitmap is None:
            a = self.array
            i = int(np.searchsorted(a, v))
            return i < len(a) and a[i] == v
        return bool((self.bitmap[v >> 6] >> np.uint64(v & 63)) & np.uint64(1))

    # -- bulk access

    def values(self) -> np.ndarray:
        """All set low-16-bit values, sorted, as u32."""
        if self.runs is not None:
            return runs_to_values(self.runs)
        if self.bitmap is None:
            return self.array
        return bitmap_words_to_values(self.bitmap)

    def as_words(self) -> np.ndarray:
        """Dense u64[1024] word view (built on demand for array and run
        containers)."""
        if self.runs is not None:
            return runs_to_words(self.runs)
        if self.bitmap is not None:
            return self.bitmap
        a = self.array
        if a is None or not len(a):
            return np.zeros(BITMAP_N, dtype=np.uint64)
        # One pass through a byte mask + packbits beats a u64 or.at
        # scatter ~4x: both are O(range), but packbits runs at memcpy
        # speed while or.at is a per-element C loop.
        bits = np.zeros(1 << 16, dtype=np.uint8)
        bits[a] = 1
        # "<u8": packbits emits value 64w+8i+j as byte 8w+i bit j, which
        # is a little-endian u64 word regardless of host endianness.
        return np.packbits(bits, bitorder="little").view("<u8")

    def count_range(self, start: int, end: int) -> int:
        """Number of set values in [start, end) within this container."""
        start, end = max(start, 0), min(end, 1 << 16)
        if start >= end:
            return 0
        if self.runs is not None:
            starts, ends = _runs_starts_ends(self.runs)
            return int((np.clip(ends, start, end)
                        - np.clip(starts, start, end)).sum())
        if self.bitmap is None:
            a = self.array
            return int(np.searchsorted(a, end) - np.searchsorted(a, start))
        # Whole-word popcount with masked edge words — O(words), no
        # cardinality-proportional allocation.
        w0, w1 = start >> 6, (end - 1) >> 6
        words = self.bitmap[w0:w1 + 1].copy()
        words[0] &= ~np.uint64(0) << np.uint64(start & 63)
        last_bits = ((end - 1) & 63) + 1
        if last_bits < 64:
            words[-1] &= ~(~np.uint64(0) << np.uint64(last_bits))
        return int(np.bitwise_count(words).sum())

    def rank(self, v: int) -> int:
        """Number of set values <= v within this container."""
        return self.count_range(0, v + 1)

    def size_bytes(self) -> int:
        """Serialized size (roaring.go container size(); run blocks are
        numRuns(u16) + 4 bytes per interval)."""
        if self.runs is not None:
            return int(self.runs.size) * 2
        return self.n * 4 if self.bitmap is None else BITMAP_N * 8

    def check(self) -> None:
        """Internal consistency (roaring.go:653-674 spirit). Run
        containers validate the full interval invariant set: buffer
        length matches the numRuns prefix, starts strictly sorted,
        intervals non-overlapping and non-adjacent, Σ lengths == n."""
        if self.runs is not None:
            r = self.runs
            if r.ndim != 1 or not len(r):
                raise ValueError("container: malformed run buffer")
            if len(r) != 1 + 2 * int(r[0]):
                raise ValueError(
                    f"container: run buffer length {len(r)} != "
                    f"1 + 2*{int(r[0])}")
            starts, ends = _runs_starts_ends(r)
            if len(starts) > 1 and not np.all(starts[1:] > ends[:-1]):
                raise ValueError(
                    "container: runs overlapping or adjacent")
            if int((ends - starts).sum()) != self.n:
                raise ValueError(
                    f"container: run lengths sum "
                    f"{int((ends - starts).sum())} != n {self.n}")
            if len(ends) and int(ends[-1]) > 1 << 16:
                raise ValueError("container: run past 2^16")
            return
        if self.bitmap is None:
            a = self.array
            if a is None:
                raise ValueError("container: nil array")
            if len(a) != self.n:
                raise ValueError(f"container: array len {len(a)} != n {self.n}")
            if len(a) > 1 and not np.all(a[1:] > a[:-1]):
                raise ValueError("container: array not strictly sorted")
            if len(a) and int(a[-1]) > 0xFFFF:
                raise ValueError("container: array value out of range")
            if len(a) > ARRAY_MAX_SIZE:
                # n<=4096 ⇒ array is a FILE-FORMAT rule: the snapshot
                # sizer maps n>4096 to an 8192-byte bitmap block, so an
                # oversized array serializes corrupt.
                raise ValueError(
                    f"container: array n {len(a)} > {ARRAY_MAX_SIZE}")
        else:
            got = int(np.bitwise_count(self.bitmap).sum())
            if got != self.n:
                raise ValueError(f"container: bitmap count {got} != n {self.n}")

    @staticmethod
    def from_array(a: np.ndarray, mapped: bool = False) -> "Container":
        c = Container()
        c.array = a
        c.n = len(a)
        c.mapped = mapped
        return c

    @staticmethod
    def from_bitmap(words: np.ndarray, n: Optional[int] = None,
                    mapped: bool = False) -> "Container":
        c = Container()
        c.array = None
        c.bitmap = words
        c.n = int(np.bitwise_count(words).sum()) if n is None else n
        c.mapped = mapped
        return c

    @staticmethod
    def from_runs(runs: np.ndarray, n: Optional[int] = None,
                  mapped: bool = False) -> "Container":
        c = Container()
        c.array = None
        c.runs = runs
        if n is None:
            n_runs = (len(runs) - 1) >> 1
            if n_runs <= _RUN_SMALL:  # scalar beats numpy overhead
                n = sum(runs.tolist()[2::2]) + n_runs
            else:
                n = int(runs[2::2].astype(np.int64).sum()) + n_runs
        c.n = n
        c.mapped = mapped
        return c


def bitmap_words_to_values(words: np.ndarray) -> np.ndarray:
    """Expand u64 words → sorted u32 value vector (vectorized)."""
    nz = np.flatnonzero(words)
    if not len(nz):
        return _EMPTY_U32
    # Expand each non-zero word into its set bit positions.
    w = words[nz]
    bits = ((w[:, None] >> np.arange(64, dtype=np.uint64)) &
            np.uint64(1)).astype(bool)
    word_idx, bit_idx = np.nonzero(bits)
    return (nz[word_idx].astype(np.uint32) * np.uint32(64)
            + bit_idx.astype(np.uint32))


# --- run-container helpers ---------------------------------------------------
# A run buffer is a little-endian u16 vector [R, s0, l0-1, s1, l1-1, ...]
# — exactly the wire block, so snapshots write it verbatim and mmap
# loads view it zero-copy. Invariants (Container.check): starts
# strictly increasing, intervals non-overlapping AND non-adjacent
# (adjacent runs must be merged), n == Σ lengths.


def _build_runs(starts, ends) -> np.ndarray:
    """Wire-form run buffer from int64 starts/exclusive-ends vectors."""
    n_runs = len(starts)
    buf = np.empty(1 + 2 * n_runs, dtype="<u2")
    buf[0] = n_runs
    buf[1::2] = starts
    buf[2::2] = np.asarray(ends) - np.asarray(starts) - 1
    return buf


def _runs_starts_ends(runs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, exclusive ends) of a run buffer as int64 vectors."""
    starts = runs[1::2].astype(np.int64)
    return starts, starts + runs[2::2].astype(np.int64) + 1


def run_count_array(a: np.ndarray) -> int:
    """Number of runs a sorted value vector would compress into."""
    if not len(a):
        return 0
    return 1 + int(np.count_nonzero(np.diff(a) != 1))


def run_count_words(words: np.ndarray) -> int:
    """Number of runs in a u64[1024] bitmap: set bits whose predecessor
    bit is clear, counted across word boundaries in one vector pass
    (the popcount((x << 1) &~ x) trick from arXiv:1709.07821 §3)."""
    carry = np.concatenate(([np.uint64(0)],
                            words[:-1] >> np.uint64(63)))
    shifted = (words << np.uint64(1)) | carry
    return int(np.bitwise_count(words & ~shifted).sum())


def values_to_runs(vals: np.ndarray) -> np.ndarray:
    """Sorted unique low-16-bit values → wire-form run buffer."""
    if not len(vals):
        return np.zeros(1, dtype="<u2")
    v = vals.astype(np.int64)
    brk = np.flatnonzero(np.diff(v) != 1)
    starts = v[np.concatenate(([0], brk + 1))]
    lasts = v[np.concatenate((brk, [len(v) - 1]))]
    return _build_runs(starts, lasts + 1)


def runs_to_values(runs: np.ndarray) -> np.ndarray:
    """Run buffer → sorted u32 value vector (vectorized decode)."""
    starts, ends = _runs_starts_ends(runs)
    lens = ends - starts
    total = int(lens.sum())
    if not total:
        return _EMPTY_U32
    offs = np.concatenate(([0], np.cumsum(lens[:-1])))
    return (np.repeat(starts - offs, lens)
            + np.arange(total)).astype(np.uint32)


def runs_to_words(runs: np.ndarray) -> np.ndarray:
    """Run buffer → dense u64[1024] words — the device decode step:
    residency uploads blit this straight into bit-plane slabs (see
    ops.packed). Boundary-mark + cumsum, O(2^16) regardless of
    cardinality; the non-adjacency invariant guarantees every mark
    index is distinct, so plain fancy assignment is safe."""
    starts, ends = _runs_starts_ends(runs)
    mark = np.zeros((1 << 16) + 1, dtype=np.int8)
    mark[starts] = 1
    mark[ends] = -1
    cov = np.cumsum(mark[:-1], dtype=np.int8).astype(np.uint8)
    return np.packbits(cov, bitorder="little").view("<u8")


def _runs_member(runs: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Boolean membership mask of sorted values against a run buffer —
    one searchsorted over the starts (the vectorized form of the
    galloping probe)."""
    starts = runs[1::2]
    if not len(starts):
        return np.zeros(len(vals), dtype=bool)
    i = np.searchsorted(starts, vals, side="right").astype(np.int64) - 1
    safe = np.maximum(i, 0)
    lasts = starts[safe].astype(np.int64) + runs[2::2][safe].astype(np.int64)
    return (i >= 0) & (vals.astype(np.int64) <= lasts)


def _runs_coverage_at(runs: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Σ |[s,e) ∩ [0,x)| per x — prefix coverage of a run set, one
    searchsorted + clip (no event sweep)."""
    starts, ends = _runs_starts_ends(runs)
    lens = ends - starts
    prefix = np.concatenate(([0], np.cumsum(lens)))
    k = np.searchsorted(starts, xs, side="right")
    km = np.maximum(k - 1, 0)
    overshoot = np.where(k > 0,
                         np.clip(ends[km] - xs, 0, lens[km]), 0)
    return prefix[k] - overshoot


# Interval-list size (Ra + Rb) below which the run algebra takes
# plain-int scalar paths: well-compressed containers hold 1-3 runs,
# where ~10 vectorized numpy calls of fixed ~1.5 us overhead each cost
# 10x the actual work.
_RUN_SMALL = 16


def _run_overlap_count(a_runs: np.ndarray, b_runs: np.ndarray) -> int:
    """|A ∩ B| for two run sets: each A-interval's overlap with B is a
    prefix-coverage difference — the intersection_count fast path for
    the Count(Intersect) serving shape (no merged interval list is
    ever built). Tiny lists take a scalar two-pointer merge."""
    n_a = (len(a_runs) - 1) >> 1
    n_b = (len(b_runs) - 1) >> 1
    if not n_a or not n_b:
        return 0
    if n_a + n_b <= _RUN_SMALL:
        al, bl = a_runs.tolist(), b_runs.tolist()
        total = 0
        i = j = 0
        while i < n_a and j < n_b:
            s1 = al[1 + 2 * i]
            e1 = s1 + al[2 + 2 * i] + 1
            s2 = bl[1 + 2 * j]
            e2 = s2 + bl[2 + 2 * j] + 1
            lo, hi = max(s1, s2), min(e1, e2)
            if hi > lo:
                total += hi - lo
            if e1 <= e2:
                i += 1
            else:
                j += 1
        return total
    sa, ea = _runs_starts_ends(a_runs)
    return int((_runs_coverage_at(b_runs, ea)
                - _runs_coverage_at(b_runs, sa)).sum())


def _interval_combine_small(a_runs: np.ndarray, b_runs: np.ndarray,
                            op: str) -> np.ndarray:
    """Scalar event sweep for tiny interval lists (see _RUN_SMALL)."""
    evs = []
    for runs, da, db in ((a_runs, 1, 0), (b_runs, 0, 1)):
        rl = runs.tolist()
        for i in range((len(rl) - 1) >> 1):
            s = rl[1 + 2 * i]
            e = s + rl[2 + 2 * i] + 1
            evs.append((s, da, db))
            evs.append((e, -da, -db))
    evs.sort()
    res_s: list[int] = []
    res_e: list[int] = []
    ca = cb = 0
    k, n = 0, len(evs)
    while k < n:
        pos = evs[k][0]
        while k < n and evs[k][0] == pos:
            ca += evs[k][1]
            cb += evs[k][2]
            k += 1
        if k >= n:
            break
        if op == "and":
            act = ca > 0 and cb > 0
        elif op == "or":
            act = ca > 0 or cb > 0
        elif op == "andnot":
            act = ca > 0 and cb <= 0
        else:  # xor
            act = (ca > 0) != (cb > 0)
        if act:
            if res_e and res_e[-1] == pos:
                res_e[-1] = evs[k][0]
            else:
                res_s.append(pos)
                res_e.append(evs[k][0])
    if not res_s:
        return np.zeros(1, dtype="<u2")
    flat = [len(res_s)]
    for s, e in zip(res_s, res_e):
        flat.append(s)
        flat.append(e - s - 1)
    return np.array(flat, dtype="<u2")


def _interval_combine(a_runs: np.ndarray, b_runs: np.ndarray,
                      op: str) -> np.ndarray:
    """The run×run algebra engine: boundary-event sweep over both
    interval sets, one argsort + two cumsums, emitting the merged runs
    where the per-operand coverage satisfies ``op`` (and/or/andnot/
    xor). O((Ra+Rb) log(Ra+Rb)) — never touches cardinality. Tiny
    lists (the well-compressed common case) take the scalar sweep."""
    if len(a_runs) + len(b_runs) <= 2 * _RUN_SMALL + 2:
        return _interval_combine_small(a_runs, b_runs, op)
    sa, ea = _runs_starts_ends(a_runs)
    sb, eb = _runs_starts_ends(b_runs)
    na, nb = len(sa), len(sb)
    pos = np.concatenate([sa, ea, sb, eb])
    da = np.zeros(2 * (na + nb), dtype=np.int64)
    da[:na] = 1
    da[na:2 * na] = -1
    db = np.zeros(2 * (na + nb), dtype=np.int64)
    db[2 * na:2 * na + nb] = 1
    db[2 * na + nb:] = -1
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    ca = np.cumsum(da[order])
    cb = np.cumsum(db[order])
    # Collapse duplicate boundary positions: the coverage between two
    # distinct positions is the cumsum at the LAST event of the lower.
    if len(pos) > 1:
        last = np.concatenate((pos[1:] != pos[:-1], [True]))
        pos, ca, cb = pos[last], ca[last], cb[last]
    ina, inb = ca > 0, cb > 0
    if op == "and":
        act = ina & inb
    elif op == "or":
        act = ina | inb
    elif op == "andnot":
        act = ina & ~inb
    else:  # xor
        act = ina ^ inb
    idx = np.flatnonzero(act[:-1]) if len(pos) > 1 else \
        np.empty(0, dtype=np.int64)
    if not len(idx):
        return np.zeros(1, dtype="<u2")
    # Segments tile the breakpoint span, so consecutive kept indices
    # are adjacent intervals — merge each consecutive group into one run.
    brk = np.flatnonzero(np.diff(idx) != 1) + 1
    gs = np.concatenate(([0], brk))
    ge = np.concatenate((brk, [len(idx)]))
    return _build_runs(pos[idx[gs]], pos[idx[ge - 1] + 1])


# --- container set algebra (vectorized; native C++ when available) -----------

# Per-(op, operand-kind) call counters — the per-container-type
# statistics the Roaring library paper (arXiv:1709.07821) credits for
# making its optimizations tractable. Pre-seeded plain ints bumped
# inline (GIL-coarse increments; a rare lost count is acceptable for
# metrics), published as pilosa_roaring_container_ops_total when
# /metrics is scraped.
OP_KINDS = ("array_array", "array_bitmap", "bitmap_bitmap",
            "run_run", "run_array", "run_bitmap")
_OPS = ("intersect", "intersection_count", "union", "difference", "xor")
_OP_COUNTS: dict[tuple[str, str], int] = {
    (op, kind): 0 for op in _OPS for kind in OP_KINDS}

# Canonical pair naming order for the operand-kind label.
_KIND_ORDER = {"run": 0, "array": 1, "bitmap": 2}


def _op_kind(a: Container, b: Container) -> str:
    ka, kb = a.kind(), b.kind()
    if _KIND_ORDER[kb] < _KIND_ORDER[ka]:
        ka, kb = kb, ka
    return f"{ka}_{kb}"


def op_counts() -> dict[tuple[str, str], int]:
    """Snapshot of the container set-algebra op counters."""
    return dict(_OP_COUNTS)


# Word-equivalents a bitmap container operand contributes: the unit the
# scan cost an operand adds to the per-query ledger.
_BITMAP_WORDS = 1024


def _scan_words(c: Container) -> int:
    """Word-equivalents one operand contributes: a bitmap container is
    a full 1024-word scan; an array container counts its elements at
    64 per word; a run container counts its interval list's bytes at 8
    per word."""
    if c.runs is not None:
        return max(1, (int(c.runs.size) * 2) >> 3)
    if c.is_array():
        return (len(c.array) + 63) >> 6
    return _BITMAP_WORDS


def _bump(op: str, a: Container, b: Container) -> None:
    """One site feeding both accountings: the process-global counters
    (pilosa_roaring_container_ops_total at scrape time) and the current
    query's cost ledger (obs.accounting) when one is bound to this
    thread."""
    kind = _op_kind(a, b)
    _OP_COUNTS[(op, kind)] += 1
    cost = _accounting.current_cost()
    if cost is not None:
        cost.note_container_op(op, kind,
                               _scan_words(a) + _scan_words(b))


# Size ratio past which a sorted-array intersection switches from the
# linear two-pointer merge to binary-search probes of the small side
# into the large (the galloping/skewed strategy of arXiv:1709.07821
# §4.2 — vectorized here as one searchsorted_membership pass).
_GALLOP_RATIO = 64


def _skewed(a: np.ndarray, b: np.ndarray) -> bool:
    na, nb = len(a), len(b)
    return min(na, nb) * _GALLOP_RATIO < max(na, nb)


def _settle(c: Container) -> Container:
    """Pick the smallest representation for an algebra result that came
    out as runs (the output half of the cardinality-adaptive kernel
    selection — a 3-run intersection result should not stay a run
    container if 2 array values are smaller)."""
    c.optimize()
    return c


def _as_runs(c: Container) -> np.ndarray:
    """Operand's interval form for the run×run engine (arrays convert
    in O(n); callers keep bitmaps on the word path instead)."""
    if c.runs is not None:
        return c.runs
    return values_to_runs(c.array)


def _intersect(a: Container, b: Container) -> Container:
    _bump("intersect", a, b)
    ra, rb = a.runs is not None, b.runs is not None
    if ra or rb:
        if (ra or a.bitmap is None) and (rb or b.bitmap is None):
            if ra != rb:
                # run ∩ array via membership probes of the array into
                # the run list — O(n_array log R), no interval sweep.
                run, arr = (a, b) if ra else (b, a)
                return Container.from_array(
                    arr.array[_runs_member(run.runs, arr.array)])
            return _settle(Container.from_runs(
                _interval_combine(a.runs, b.runs, "and")))
        run, bmp = (a, b) if ra else (b, a)
        words = runs_to_words(run.runs) & bmp.bitmap
        c = Container.from_bitmap(words)
        c._maybe_convert()
        return c
    if a.is_array() and b.is_array():
        if _skewed(a.array, b.array):
            small, big = ((a.array, b.array)
                          if len(a.array) <= len(b.array)
                          else (b.array, a.array))
            hit, _ = searchsorted_membership(big, small)
            return Container.from_array(small[hit])
        out = native.intersect_sorted_u32(a.array, b.array)
        return Container.from_array(out)
    if a.is_array() != b.is_array():
        arr, bmp = (a, b) if a.is_array() else (b, a)
        av = arr.array
        hit = (bmp.bitmap[av >> np.uint32(6)] >>
               (av.astype(np.uint64) & np.uint64(63))) & np.uint64(1)
        return Container.from_array(av[hit.astype(bool)])
    words = a.bitmap & b.bitmap
    c = Container.from_bitmap(words)
    c._maybe_convert()
    return c


def _intersection_count(a: Container, b: Container) -> int:
    _bump("intersection_count", a, b)
    ra, rb = a.runs is not None, b.runs is not None
    if ra or rb:
        if ra and rb:
            return _run_overlap_count(a.runs, b.runs)
        run, other = (a, b) if ra else (b, a)
        if other.bitmap is None:
            return int(_runs_member(run.runs, other.array).sum())
        return native.popcnt_and(runs_to_words(run.runs), other.bitmap)
    if a.is_array() and b.is_array():
        if _skewed(a.array, b.array):
            small, big = ((a.array, b.array)
                          if len(a.array) <= len(b.array)
                          else (b.array, a.array))
            hit, _ = searchsorted_membership(big, small)
            return int(hit.sum())
        return native.intersection_count_sorted_u32(a.array, b.array)
    if a.is_array() != b.is_array():
        arr, bmp = (a, b) if a.is_array() else (b, a)
        av = arr.array
        hit = (bmp.bitmap[av >> np.uint32(6)] >>
               (av.astype(np.uint64) & np.uint64(63))) & np.uint64(1)
        return int(hit.sum())
    return native.popcnt_and(a.bitmap, b.bitmap)


def _union(a: Container, b: Container) -> Container:
    _bump("union", a, b)
    ra, rb = a.runs is not None, b.runs is not None
    if ra or rb:
        if (ra or a.bitmap is None) and (rb or b.bitmap is None):
            return _settle(Container.from_runs(
                _interval_combine(_as_runs(a), _as_runs(b), "or")))
        run, bmp = (a, b) if ra else (b, a)
        c = Container.from_bitmap(runs_to_words(run.runs) | bmp.bitmap)
        c._maybe_convert()
        return c
    if a.is_array() and b.is_array():
        out = np.union1d(a.array, b.array).astype(np.uint32)
        c = Container.from_array(out)
        c._maybe_convert()
        return c
    words = a.as_words() | b.as_words()
    c = Container.from_bitmap(words)
    c._maybe_convert()
    return c


def _difference(a: Container, b: Container) -> Container:
    _bump("difference", a, b)
    ra, rb = a.runs is not None, b.runs is not None
    if ra or rb:
        if not ra and a.bitmap is None:  # array \ run: membership drop
            return Container.from_array(
                a.array[~_runs_member(b.runs, a.array)])
        if (ra or a.bitmap is None) and (rb or b.bitmap is None):
            return _settle(Container.from_runs(
                _interval_combine(_as_runs(a), _as_runs(b), "andnot")))
        words = a.as_words() & ~b.as_words()
        c = Container.from_bitmap(words)
        c._maybe_convert()
        return c
    if a.is_array():
        av = a.array
        if b.is_array():
            keep = ~np.isin(av, b.array, assume_unique=True)
        else:
            keep = ~((b.bitmap[av >> np.uint32(6)] >>
                      (av.astype(np.uint64) & np.uint64(63))) &
                     np.uint64(1)).astype(bool)
        return Container.from_array(av[keep])
    words = a.bitmap & ~b.as_words()
    c = Container.from_bitmap(words)
    c._maybe_convert()
    return c


def _xor(a: Container, b: Container) -> Container:
    _bump("xor", a, b)
    ra, rb = a.runs is not None, b.runs is not None
    if ra or rb:
        if (ra or a.bitmap is None) and (rb or b.bitmap is None):
            return _settle(Container.from_runs(
                _interval_combine(_as_runs(a), _as_runs(b), "xor")))
        words = a.as_words() ^ b.as_words()
        c = Container.from_bitmap(words)
        c._maybe_convert()
        return c
    if a.is_array() and b.is_array():
        out = np.setxor1d(a.array, b.array, assume_unique=True).astype(np.uint32)
        c = Container.from_array(out)
        c._maybe_convert()
        return c
    words = a.as_words() ^ b.as_words()
    c = Container.from_bitmap(words)
    c._maybe_convert()
    return c


# --- op-log ------------------------------------------------------------------


_OP_BODY = struct.Struct("<BQ")  # op type + u64 value (13-byte record w/ checksum)


def fnv_fold_records(recs: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a over the 9 body bytes of each 13-byte op
    record row ([n, OP_SIZE] u8) — the ONE checksum fold shared by
    the record builder (_wal_blob), replay validation (_replay_ops),
    and the scrubber's WAL-tail cross-check (storage.scrub)."""
    h = np.full(len(recs), int(_FNV_OFFSET), dtype=np.uint32)
    for i in range(9):
        h = (h ^ recs[:, i].astype(np.uint32)) * _FNV_PRIME
    return h


def _wal_blob(values: np.ndarray, typ: int) -> bytes:
    """13-byte op records for a value vector, checksummed, vectorized —
    the group-commit form of Op.marshal (verified byte-identical in
    tests; 0.1 us/record vs ~2 us through the scalar path). With the
    extension loaded the whole build is one GIL-released C crossing, so
    concurrent import threads' record builds overlap each other's
    applies."""
    ext = native_ext.EXT
    if ext is not None:
        fn = getattr(ext, "wal_records", None)
        if fn is not None:
            return fn(np.ascontiguousarray(values, dtype=np.uint64),
                      typ)
    n = len(values)
    rec = np.zeros((n, OP_SIZE), dtype=np.uint8)
    rec[:, 0] = typ
    rec[:, 1:9] = values.astype("<u8").view(np.uint8).reshape(n, 8)
    h = fnv_fold_records(rec)
    rec[:, 9:13] = h.astype("<u4").view(np.uint8).reshape(n, 4)
    return rec.tobytes()


class Op:
    """One op-log record (roaring.go:1560-1626)."""

    __slots__ = ("typ", "value")

    def __init__(self, typ: int, value: int):
        self.typ = typ
        self.value = value

    def marshal(self) -> bytes:
        body = _OP_BODY.pack(self.typ, self.value)
        return body + fnv1a32(body).to_bytes(4, "little")

    @staticmethod
    def unmarshal(buf: memoryview) -> "Op":
        if len(buf) < OP_SIZE:
            raise ValueError(f"op data out of bounds: len={len(buf)}")
        body = bytes(buf[:9])
        chk = int.from_bytes(buf[9:13], "little")
        want = fnv1a32(body)
        if chk != want:
            raise ValueError(f"checksum mismatch: exp={want:08x}, got={chk:08x}")
        return Op(body[0], int.from_bytes(body[1:9], "little"))

    def apply(self, b: "Bitmap") -> bool:
        if self.typ == OP_ADD:
            return b._add(self.value)
        if self.typ == OP_REMOVE:
            return b._remove(self.value)
        raise ValueError(f"invalid op type: {self.typ}")


def _replay_ops(b: "Bitmap", rest: memoryview,
                tolerate_torn_tail: bool) -> None:
    """Replay a trailing op-log in bulk.

    The scalar record walk this replaces cost ~10 us/op — a reopen
    after one 250 K-bit wire-import block paid 2.7 s of replay, which
    is what forced a snapshot per import block (MAX_OP_N bounds
    REPLAY time, so replay speed sets how much op-log a fragment may
    carry). Here validation is one vectorized pass (the same FNV fold
    as the `_wal_blob` record builder) and maximal same-type op runs
    apply through add_many/remove_many: order across runs is
    preserved, and within a same-type run set semantics are order-
    and duplicate-insensitive. Error contract matches the scalar
    walk: a torn (partial) trailing record is tolerated only under
    ``tolerate_torn_tail`` (reported via ``torn_bytes``); a complete
    record with a bad checksum or unknown type raises — the caller
    discards ``b``, so prevalidating before any apply is
    unobservable. Container representations may differ from scalar
    replay (bulk lanes upgrade touched run containers to legacy
    kinds); the serialized-set contract is unchanged."""
    n_rest = len(rest)
    n_ops = n_rest // OP_SIZE
    torn = n_rest - n_ops * OP_SIZE
    if torn and not tolerate_torn_tail:
        raise ValueError(f"op data out of bounds: len={torn}")
    if n_ops:
        recs = np.frombuffer(rest, dtype=np.uint8,
                             count=n_ops * OP_SIZE).reshape(n_ops,
                                                            OP_SIZE)
        h = fnv_fold_records(recs)
        stored = np.ascontiguousarray(recs[:, 9:13]).view("<u4").ravel()
        types = recs[:, 0]
        bad_chk = np.flatnonzero(h != stored)
        bad_typ = np.flatnonzero(types > OP_REMOVE)
        first_chk = int(bad_chk[0]) if len(bad_chk) else n_ops
        first_typ = int(bad_typ[0]) if len(bad_typ) else n_ops
        if first_chk <= first_typ and first_chk < n_ops:
            raise ValueError(
                f"checksum mismatch: exp={int(h[first_chk]):08x},"
                f" got={int(stored[first_chk]):08x}")
        if first_typ < n_ops:
            raise ValueError(f"invalid op type: {int(types[first_typ])}")
        vals = np.ascontiguousarray(recs[:, 1:9]).view("<u8").ravel()
        bnd = np.flatnonzero(types[1:] != types[:-1]) + 1
        starts = np.concatenate(([0], bnd))
        ends = np.concatenate((bnd, [n_ops]))
        for s, e in zip(starts.tolist(), ends.tolist()):
            if e - s < 16:
                # Tiny runs (alternating add/remove traffic): the
                # scalar ops beat the bulk lanes' fixed numpy overhead.
                apply = b._add if types[s] == OP_ADD else b._remove
                for v in vals[s:e].tolist():
                    apply(int(v))
            elif types[s] == OP_ADD:
                b.add_many(vals[s:e])
            else:
                b.remove_many(vals[s:e])
        b.op_n += n_ops
    if torn:
        b.torn_bytes = torn


# --- bitmap ------------------------------------------------------------------


class Bitmap:
    """Two-level roaring bitmap: sorted high-48-bit keys → containers.

    ``op_writer`` (a binary file-like) mirrors the reference's OpWriter hook
    (roaring.go:51,616-628): when set, every add/remove appends an op record.
    """

    def __init__(self, *values: int):
        self.keys: list[int] = []
        self.containers: list[Container] = []
        self.op_writer = None
        self.op_n = 0      # ops appended/replayed since last snapshot
        self.torn_bytes = 0  # dangling tail bytes found during unmarshal
        # Parsed integrity footer (storage.integrity.FooterInfo) when
        # the decoded snapshot carried one; None for vintage files and
        # wire-form buffers. Consumers (fragment lazy verify, scrub)
        # re-check its per-block crc table against the backing buffer.
        self.footer = None
        # Monotonic mutation counter: bumped by every mutating entry
        # point so derived-value memos (e.g. the fragment src-key
        # cache) can validate against in-place mutation instead of
        # trusting object identity.
        self.version = 0
        # Frozen-capture COW epoch (see Container.cow) and the
        # incrementally-maintained serialization table (see _SerTable).
        # Point mutations record their container key in _table_dirty
        # instead of invalidating the table — the entries are patched
        # in bulk before any table read (_flush_table_dirty), keeping
        # the MAX_OP_N freeze O(dirty) instead of O(all containers)
        # for per-op write workloads.
        self._cow_epoch = 0
        self._table: Optional[_SerTable] = None
        self._table_dirty: set[int] = set()
        # Containers created by POINT ops while a table exists: their
        # insertion is deferred to _flush_table_dirty (one vectorized
        # table.insert per freeze) instead of invalidating the table —
        # a wholesale rebuild is an O(all containers) Python walk that
        # dominated the per-op write path's MAX_OP_N snapshot cadence
        # on fragments growing by point writes.
        self._table_new: set[int] = set()
        for v in values:
            self._add(v)

    def _guard_inplace(self, c: Container) -> None:
        """Make c's bitmap words safe to mutate in place: copy out of an
        mmap (the mapped flag) or out of a frozen snapshot capture (the
        cow token)."""
        if c.mapped:
            c._unmap()
            c.cow = self._cow_epoch
        elif c.cow != self._cow_epoch:
            if c.bitmap is not None:
                c.bitmap = c.bitmap.copy()
            c.cow = self._cow_epoch

    # -- container lookup

    def _index(self, key: int) -> int:
        """Bisect keys; returns insertion point."""
        return bisect.bisect_left(self.keys, key)

    def container(self, key: int) -> Optional[Container]:
        i = self._index(key)
        if i < len(self.keys) and self.keys[i] == key:
            return self.containers[i]
        return None

    def _container_or_create(self, key: int) -> Container:
        i = self._index(key)
        if i < len(self.keys) and self.keys[i] == key:
            return self.containers[i]
        c = Container()
        self.keys.insert(i, key)
        self.containers.insert(i, c)
        return c

    # -- point ops (public ops write to the op-log; _ops do not)

    def add(self, v: int) -> bool:
        # The per-op write hot path: ONE compiled crossing does the
        # container mutate AND builds the marshaled WAL record
        # (native/fastmutate.c), so Python only appends the returned
        # bytes to the group-commit log. The extension bails (None) on
        # anything unusual — new container, COW-stale bitmap words,
        # odd buffers — and the pure-Python path below re-runs the op
        # from scratch (the extension made no state change when it
        # bails), keeping behavior identical by construction.
        ext = native_ext.EXT
        if ext is not None:
            rec = ext.setbit(self, v)
            if rec is not None:
                if rec is False:
                    return False
                self._write_op_bytes(rec)
                return True
        changed = self._add(v)
        if changed:
            self._write_op(Op(OP_ADD, v))
        return changed

    def _add(self, v: int) -> bool:
        self.version += 1
        key = highbits(v)
        if self._table is not None:
            n0 = len(self.keys)
            c = self._container_or_create(key)
            if len(self.keys) != n0:
                self._table_new.add(key)  # deferred table insert
            else:
                self._table_dirty.add(key)
        else:
            c = self._container_or_create(key)
        if c.bitmap is not None:
            self._guard_inplace(c)
        return c.add(lowbits(v))

    def remove(self, v: int) -> bool:
        ext = native_ext.EXT
        if ext is not None:
            rec = ext.clearbit(self, v)
            if rec is not None:
                if rec is False:
                    return False
                self._write_op_bytes(rec)
                return True
        changed = self._remove(v)
        if changed:
            self._write_op(Op(OP_REMOVE, v))
        return changed

    def _remove(self, v: int) -> bool:
        self.version += 1
        key = highbits(v)
        c = self.container(key)
        if c is None:
            return False
        if self._table is not None:
            self._table_dirty.add(key)
        if c.bitmap is not None:
            self._guard_inplace(c)
        return c.remove(lowbits(v))

    def contains(self, v: int) -> bool:
        c = self.container(highbits(v))
        return c.contains(lowbits(v)) if c is not None else False

    def _write_op(self, op: Op) -> None:
        if self.op_writer is not None:
            _wal_write(self.op_writer, op.marshal())
            self.op_n += 1

    def _write_op_bytes(self, rec: bytes) -> None:
        """Append an already-marshaled op record (the one-crossing
        extension returns the bytes; byte-identical to Op.marshal)."""
        if self.op_writer is not None:
            _wal_write(self.op_writer, rec)
            self.op_n += 1

    # -- bulk ops

    def add_many(self, values: np.ndarray) -> int:
        """Vectorized bulk add of a u64 value vector. Returns #newly set.

        The import hot path (reference: fragment.go:924-989 detaches the op
        writer and bulk-adds); callers snapshot afterwards.
        """
        values = np.asarray(values, dtype=np.uint64)
        if not len(values):
            return 0
        values = sort_dedupe(values)
        self.version += 1
        self._table = None
        highs = values >> np.uint64(16)
        lows = (values & np.uint64(0xFFFF)).astype(np.uint32)
        bounds = np.flatnonzero(highs[1:] != highs[:-1]) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(values)]))
        # One vectorized key probe for every group (sparse imports touch
        # hundreds of thousands of containers; per-group bisect +
        # list.insert was quadratic in the table size).
        uniq = highs[starts]
        key_arr = self._keys_np()
        exists, idx = searchsorted_membership(key_arr, uniq)
        if not exists.all():
            self._insert_containers(uniq[~exists].tolist())
            idx = np.searchsorted(self._keys_np(), uniq)
        containers = self.containers
        conts = [containers[i] for i in idx.tolist()]
        added = 0
        n_g = len(conts)
        for c in conts:
            # Bulk paths transparently upgrade run containers to the
            # legacy kind before merging; optimize() re-compresses
            # after the batch (import contract, arXiv:1709.07821 §2.1).
            if c.runs is not None:
                c._run_to_legacy()
        bm_mask = np.fromiter((c.bitmap is not None for c in conts),
                              bool, n_g)
        for gi in np.flatnonzero(bm_mask).tolist():
            # OR-scatter straight into the word vector: O(chunk + words),
            # no representation churn for the dense-import hot path.
            chunk = lows[starts[gi]:ends[gi]]
            c = conts[gi]
            before = c.n
            self._guard_inplace(c)
            np.bitwise_or.at(
                c.bitmap, chunk >> np.uint32(6),
                np.uint64(1) << (chunk.astype(np.uint64) & np.uint64(63)))
            c.n = int(np.bitwise_count(c.bitmap).sum())
            c._maybe_convert()
            added += c.n - before
        arr_gis = np.flatnonzero(~bm_mask)
        if len(arr_gis) > 256:
            added += self._merge_array_groups_global(
                conts, arr_gis, uniq, values, bm_mask,
                (ends - starts).astype(np.int64))
        else:
            for gi in arr_gis.tolist():
                chunk = lows[starts[gi]:ends[gi]]
                c = conts[gi]
                before = c.n
                if c.n == 0:
                    # Copy the chunk out of the batch vector: a view
                    # would pin the WHOLE batch buffer for the
                    # container's lifetime (a few tiny
                    # surviving containers must not hold a 10 M-value
                    # batch's 80 MB alive). The global-merge path keeps
                    # views because there the base is collectively
                    # covered by its containers.
                    c.array, c.bitmap, c.n = chunk.copy(), None, len(chunk)
                    c.mapped = False
                else:
                    merged = np.union1d(c.array, chunk).astype(np.uint32)
                    c._unmap()
                    c.array, c.n = merged, len(merged)
                c._maybe_convert()
                added += c.n - before
        return added

    def _merge_array_groups_global(self, conts, arr_gis, uniq, values,
                                   bm_mask, group_lens) -> int:
        """Merge a large batch of value groups into their array-form
        containers in ONE vectorized pass: gather every target
        container's current values into a single u64 position vector,
        union it with the incoming values, then re-slice the result
        back into per-container views. Replaces a per-group union1d
        (~8 us/group — the import long pole at 10^5..10^6 touched
        containers, e.g. a 100 K-row sparse frame) with work that is
        O(total values) regardless of group count."""
        sel_conts = [conts[g] for g in arr_gis.tolist()]
        lens = np.fromiter((c.n for c in sel_conts), np.int64,
                           len(sel_conts))
        old_total = int(lens.sum())
        key_sel = uniq[arr_gis]
        if old_total:
            old_low = np.concatenate(
                [c.array for c in sel_conts if c.n])
            old_vals = ((np.repeat(key_sel, lens) << np.uint64(16))
                        | old_low.astype(np.uint64))
        else:
            old_vals = _EMPTY_U64
        new_vals = values[np.repeat(~bm_mask, group_lens)]
        merged = np.union1d(old_vals, new_vals)
        mh = merged >> np.uint64(16)
        ml = (merged & np.uint64(0xFFFF)).astype(np.uint32)
        b2 = np.flatnonzero(mh[1:] != mh[:-1]) + 1
        s2 = np.concatenate(([0], b2))
        e2 = np.concatenate((b2, [len(merged)]))
        # Every selected group contributes >=1 incoming value and every
        # gathered value came from a selected container, so the merged
        # key set equals key_sel exactly and stays aligned by sort order.
        ns2 = (e2 - s2)
        for c, s, e, n in zip(sel_conts, s2.tolist(), e2.tolist(),
                              ns2.tolist()):
            c.array, c.bitmap, c.n, c.mapped = ml[s:e], None, n, False
        for g in np.flatnonzero(ns2 > ARRAY_MAX_SIZE).tolist():
            sel_conts[g]._to_bitmap()
        return len(merged) - old_total

    def remove_many(self, values: np.ndarray) -> int:
        """Vectorized bulk remove of a u64 value vector; returns #cleared.

        The anti-entropy bulk-repair path (reference fragment.go:802-920
        applies merge diffs through the fragment with the op log handled
        by the caller) — callers detach the op writer and snapshot after,
        exactly like add_many's import contract."""
        values = np.asarray(values, dtype=np.uint64)
        if not len(values):
            return 0
        values = sort_dedupe(values)
        self.version += 1
        self._table = None
        highs = values >> np.uint64(16)
        bounds = np.flatnonzero(highs[1:] != highs[:-1]) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(values)]))
        # Vectorized key probe, dropping groups with no (live) container
        # — the same shape as add_many's (a sparse anti-entropy repair
        # touches 10^5+ containers; per-group bisect was the long pole).
        uniq = highs[starts]
        key_arr = self._keys_np()
        present, idx = searchsorted_membership(key_arr, uniq)
        removed = 0
        containers = self.containers
        pres = np.flatnonzero(present)
        pres_conts = [containers[int(i)] for i in idx[pres]]
        n_p = len(pres_conts)
        for c in pres_conts:
            if c.runs is not None:
                c._run_to_legacy()
        live = np.fromiter((c.n > 0 for c in pres_conts), bool, n_p)
        is_bm = np.fromiter((c.bitmap is not None for c in pres_conts),
                            bool, n_p)
        bm_gis = pres[live & is_bm].tolist()
        arr_gis = pres[live & ~is_bm].tolist()
        for gi in bm_gis:
            c = containers[int(idx[gi])]
            chunk = (values[starts[gi]:ends[gi]]
                     & np.uint64(0xFFFF)).astype(np.uint32)
            before = c.n
            # AND-NOT scatter; duplicate words in chunk compose fine
            # because each element clears only its own bit.
            self._guard_inplace(c)
            np.bitwise_and.at(
                c.bitmap, chunk >> np.uint32(6),
                ~(np.uint64(1) << (chunk.astype(np.uint64)
                                   & np.uint64(63))))
            c.n = int(np.bitwise_count(c.bitmap).sum())
            c._maybe_convert()
            removed += before - c.n
        if len(arr_gis) > 256:
            removed += self._remove_array_groups_global(
                [containers[int(idx[g])] for g in arr_gis],
                uniq[arr_gis], values, starts, ends, arr_gis)
        else:
            for gi in arr_gis:
                c = containers[int(idx[gi])]
                chunk = (values[starts[gi]:ends[gi]]
                         & np.uint64(0xFFFF)).astype(np.uint32)
                keep = ~np.isin(c.array, chunk, assume_unique=False)
                if keep.all():
                    continue
                c._unmap()
                before = c.n
                c.array = c.array[keep]
                c.n = len(c.array)
                removed += before - c.n
        return removed

    def _remove_array_groups_global(self, sel_conts, key_sel, values,
                                    starts, ends, arr_gis) -> int:
        """Global-pass removal from array containers: gather all target
        containers' values into one u64 vector, drop members of the
        incoming batch with ONE searchsorted membership test, and
        re-slice the survivors back per container (spans recovered by
        key-boundary searchsorted, so fully-emptied containers come out
        naturally empty). The remove-side twin of
        _merge_array_groups_global."""
        lens = np.fromiter((c.n for c in sel_conts), np.int64,
                           len(sel_conts))
        old_low = np.concatenate([c.array for c in sel_conts if c.n])
        old_vals = ((np.repeat(key_sel, lens) << np.uint64(16))
                    | old_low.astype(np.uint64))
        g_arr = np.zeros(len(ends), dtype=bool)
        g_arr[arr_gis] = True
        new_vals = values[np.repeat(g_arr,
                                    (ends - starts).astype(np.int64))]
        hit, _ = searchsorted_membership(new_vals, old_vals)
        merged = old_vals[~hit]
        ml = (merged & np.uint64(0xFFFF)).astype(np.uint32)
        # Survivor spans derived from the gather layout itself (count
        # of hits per original container span), NOT from key
        # arithmetic: (key+1)<<16 would wrap u64 for the max container
        # key 2^48-1. Every selected container has
        # n>0 (live_gis filter), so reduceat's index vector is strictly
        # increasing.
        gstarts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        surv = lens - np.add.reduceat(hit.astype(np.int64), gstarts)
        e2 = np.cumsum(surv)
        s2 = e2 - surv
        for c, s, e in zip(sel_conts, s2.tolist(), e2.tolist()):
            c.array, c.bitmap, c.n, c.mapped = ml[s:e], None, e - s, False
        return len(old_vals) - len(merged)

    @staticmethod
    def from_sorted(values: np.ndarray) -> "Bitmap":
        b = Bitmap()
        b.add_many(values)
        return b

    # -- batched mutation engine (native write path) --------------------------

    def _keys_np(self) -> np.ndarray:
        """Sorted keys as u64 for vectorized container lookup. Cached
        by key-list length: keys are only ever inserted (empty
        containers persist), so any structural change grows the list
        and invalidates the cache."""
        kc = getattr(self, "_keys_np_cache", None)
        if kc is not None and kc[0] == len(self.keys):
            return kc[1]
        arr = np.array(self.keys, dtype=np.uint64)
        self._keys_np_cache = (len(self.keys), arr)
        return arr

    def _insert_containers(self, new_keys: list[int]) -> None:
        """Insert fresh empty containers for the given (sorted, absent)
        keys. Few keys take bisect inserts; a storm (cold fragment's
        first batches) merges wholesale — one vectorized key merge that
        also refreshes the _keys_np cache in place (rebuilding it from
        the Python list each batch was most of the cold-write cost)."""
        if self._table is not None and self._table_new:
            # Point-created containers awaiting their deferred table
            # splice: land them first — the positions computed below
            # are relative to the CURRENT key array, which already
            # contains them.
            self._flush_table_dirty()
        new_arr = np.array(new_keys, dtype=np.uint64)
        old_arr = self._keys_np()
        pos = np.searchsorted(old_arr, new_arr)
        merged = np.insert(old_arr, pos, new_arr)
        if len(new_keys) <= 64:
            # Positions are original-list-relative; each earlier insert
            # shifts later ones by one.
            for j, (k, p) in enumerate(zip(new_keys, pos.tolist())):
                self.keys.insert(p + j, k)
                self.containers.insert(p + j, Container())
        else:
            # Mask-based two-list merge: one boolean scatter places every
            # new slot, then two zip loops of plain stores — the
            # extend-per-insertion walk this replaces cost ~2.5 us per
            # new key (the add_many long pole when a sparse import
            # creates 10^5..10^6 containers at once).
            total = len(old_arr) + len(new_keys)
            is_new = np.zeros(total, dtype=bool)
            is_new[pos + np.arange(len(new_keys))] = True
            out: list[Container] = [None] * total
            for p, c in zip(np.flatnonzero(~is_new).tolist(),
                            self.containers):
                out[p] = c
            for p in np.flatnonzero(is_new).tolist():
                out[p] = Container()
            self.keys = merged.tolist()
            self.containers = out
        self._keys_np_cache = (len(self.keys), merged)
        if self._table is not None:
            self._table = self._table.insert(pos.astype(np.int64),
                                             len(new_keys))

    def apply_batch(self, values: np.ndarray, set: bool = True,
                    wal: bool = True) -> np.ndarray:
        """Apply a whole batch of adds (or removes) in ONE native
        crossing: container merges, changed-value detection, and WAL
        record construction all happen in bitops.cpp, then the op-log
        gets a single group-commit append covering exactly the changed
        values (idempotent re-sets never hit the WAL, same as the
        per-op path, roaring.go:1560-1626).

        Returns the sorted changed positions. ``wal=False`` (bulk
        import / merge-apply contract, fragment.go:924-989) skips
        record construction entirely; callers snapshot afterwards.
        """
        values = sort_dedupe(np.asarray(values, dtype=np.uint64))
        if not len(values):
            return _EMPTY_U64
        self.version += 1

        highs = values >> np.uint64(16)
        bounds = np.flatnonzero(highs[1:] != highs[:-1]) + 1
        starts = np.concatenate(([0], bounds, [len(values)]))
        group_keys = highs[starts[:-1]]
        chunk_vals = (values & np.uint64(0xFFFF)).astype(np.uint32)

        keys_np = self._keys_np()
        idx = np.searchsorted(keys_np, group_keys)
        present = ((idx < len(keys_np))
                   & (keys_np[np.minimum(idx, len(keys_np) - 1)]
                      == group_keys)) if len(keys_np) else \
            np.zeros(len(group_keys), dtype=bool)
        if set:
            if not present.all():
                self._insert_containers(
                    group_keys[~present].tolist())
                keys_np = self._keys_np()
                idx = np.searchsorted(keys_np, group_keys)
        else:
            if not present.all():
                # Removes against absent containers are no-ops; drop
                # those groups (and their chunk spans).
                keep_g = present
                if not keep_g.any():
                    return _EMPTY_U64
                keep_vals = np.repeat(keep_g,
                                      np.diff(starts).astype(np.int64))
                values = values[keep_vals]
                chunk_vals = chunk_vals[keep_vals]
                highs = values >> np.uint64(16)
                bounds = np.flatnonzero(highs[1:] != highs[:-1]) + 1
                starts = np.concatenate(([0], bounds, [len(values)]))
                group_keys = highs[starts[:-1]]
                idx = np.searchsorted(keys_np, group_keys)

        changed = self._apply_groups(group_keys, idx.tolist(),
                                     chunk_vals, starts, set, wal)
        if wal and len(changed):
            self.op_n += len(changed)
        return changed

    def _apply_groups(self, group_keys, idx_list, chunk_vals, starts,
                      set: bool, wal: bool) -> np.ndarray:
        from . import native
        n_g = len(group_keys)
        chunk_ns = np.diff(starts).astype(np.int64)
        containers = self.containers
        conts: list[Container] = [containers[i] for i in idx_list]
        if not native.available():
            # The fallback neither uses nor maintains the table; prep
            # work (rebuild, pointer gather) would be pure waste here.
            return self._apply_groups_python(conts, group_keys,
                                             chunk_vals, starts, set,
                                             wal)
        # Point mutations since the last table read are parked in the
        # dirty set; their entries MUST be patched before the gather
        # below trusts table pointers/counts (stale entries feed the
        # native engine wrong buffers).
        self._flush_table_dirty()
        if self._table is None and n_g * 4 >= len(containers):
            # Rebuilding once makes this and every later batch's prep
            # fully vectorized; below the ratio a point-op-heavy mix
            # would thrash O(all containers) rebuilds, so fall through
            # to the per-group prep instead.
            self._rebuild_table()
        table = self._table
        if table is not None:
            # Vectorized prep: the serialization table already tracks
            # (type, ptr, n) per container — gather instead of walking
            # groups in Python. Only mapped/frozen bitmap containers
            # need per-group attention (in-place mutation safety).
            gi = np.asarray(idx_list, dtype=np.int64)
            types = table.types[gi]
            ptrs = table.ptrs[gi].copy()
            ns = table.ns[gi].copy()
            epoch = self._cow_epoch
            for g in np.flatnonzero(types == 1).tolist():
                c = conts[g]
                if c.mapped or c.cow != epoch:
                    self._guard_inplace(c)
                    p = c.bitmap.__array_interface__["data"][0]
                    ptrs[g] = p
                    table.ptrs[gi[g]] = p
                    table.bufs[gi[g]] = c.bitmap
        else:
            types = np.empty(n_g, dtype=np.uint8)
            ptrs = np.empty(n_g, dtype=np.uint64)
            ns = np.empty(n_g, dtype=np.int64)
            for g in range(n_g):
                c = conts[g]
                if c.bitmap is not None:
                    # native mutates bitmap words in place: copy out of
                    # an mmap or a frozen capture first
                    self._guard_inplace(c)
                    types[g] = 1
                    ptrs[g] = c.bitmap.__array_interface__["data"][0]
                    ns[g] = c.n
                elif c.runs is not None:
                    # Run groups ship as type 2: the engine decodes the
                    # wire-form interval buffer and merges through the
                    # array path (the "transparent upgrade" contract —
                    # output is array or bitmap, never runs).
                    types[g] = 2
                    ptrs[g] = c.runs.__array_interface__["data"][0]
                    ns[g] = c.n
                else:
                    a = c.array
                    types[g] = 0
                    ptrs[g] = a.__array_interface__["data"][0]
                    ns[g] = len(a)

        if not set:
            # Transparent-upgrade, remove leg: the engine's non-bitmap
            # remove output is array-kind only, so a run group whose
            # cardinality exceeds ARRAY_MAX_SIZE must go in as a bitmap
            # (the in-place branch, whose n<=4096 rule re-unpacks) — an
            # oversized array result would violate the serialization
            # invariant and be mis-sized as a bitmap block on snapshot.
            for g in np.flatnonzero((types == 2)
                                    & (ns > ARRAY_MAX_SIZE)).tolist():
                c = conts[g]
                c._to_bitmap()
                self._guard_inplace(c)
                types[g] = 1
                ptrs[g] = c.bitmap.__array_interface__["data"][0]
                if table is not None:
                    table.types[gi[g]] = 1
                    table.ptrs[gi[g]] = ptrs[g]
                    table.bufs[gi[g]] = c.bitmap

        # Capacity masks: run groups (type 2) consume array-output
        # space like array groups (ns holds their cardinality).
        arr_mask = types != 1
        total_chunk = len(chunk_vals)
        changed = np.empty(total_chunk, dtype=np.uint64)
        wal_buf = (np.empty(total_chunk * OP_SIZE, dtype=np.uint8)
                   if wal else np.empty(0, dtype=np.uint8))
        wal_type = ((OP_ADD if set else OP_REMOVE) if wal else -1)
        out_offsets = np.empty(n_g, dtype=np.int64)
        out_ns = np.empty(n_g, dtype=np.int64)
        out_kind = np.empty(n_g, dtype=np.uint8)
        gk = np.ascontiguousarray(group_keys, dtype=np.uint64)
        cstarts = starts.astype(np.int64)
        if set:
            cap = int((ns[arr_mask] + chunk_ns[arr_mask]).sum())
            out_vals = np.empty(max(cap, 1), dtype=np.uint32)
            n_conv = int((arr_mask
                          & (ns + chunk_ns > ARRAY_MAX_SIZE)).sum())
            out_bitmaps = np.empty((max(n_conv, 1), BITMAP_N),
                                   dtype=np.uint64)
            out_bm_idx = np.empty(n_g, dtype=np.int64)
            n_changed = native.batch_add(
                gk, types, ptrs, ns, chunk_vals, cstarts, out_vals,
                out_offsets, out_ns, out_kind, out_bitmaps, out_bm_idx,
                changed, wal_buf, wal_type)
        else:
            cap = int(ns[arr_mask].sum()) + \
                int((~arr_mask).sum()) * ARRAY_MAX_SIZE  # bitmap unpack room
            out_vals = np.empty(max(cap, 1), dtype=np.uint32)
            out_bitmaps = out_bm_idx = None
            n_changed = native.batch_remove(
                gk, types, ptrs, ns, chunk_vals, cstarts, out_vals,
                out_offsets, out_ns, out_kind, changed, wal_buf,
                wal_type)

        offs = out_offsets.tolist()
        kinds = out_kind.tolist()
        new_ns = out_ns.tolist()
        bm_idx = out_bm_idx.tolist() if out_bm_idx is not None else None
        table = self._table
        epoch = self._cow_epoch
        for g, c in enumerate(conts):
            kind = kinds[g]
            if kind == 0:
                off = offs[g]
                # Copy out of the shared batch buffer: a view would pin
                # the WHOLE out_vals allocation for as long as any one
                # container from this batch survives (review r5) —
                # per-slice memcpy of <=16 KB is noise next to that.
                c.array = out_vals[off:off + new_ns[g]].copy()
                c.bitmap = None
                c.runs = None
                c.mapped = False
            elif kind == 1:
                c.bitmap = out_bitmaps[bm_idx[g]].copy()
                c.array = None
                c.runs = None
                c.mapped = False
                c.cow = epoch
            c.n = new_ns[g]
            if table is not None:
                buf = c.bitmap if c.bitmap is not None else c.array
                table.bufs[idx_list[g]] = buf
                # Pointer taken from the attached buffer itself (the
                # copies above own fresh allocations; an offset into
                # the dead batch buffer would dangle once it's GC'd).
                ptrs[g] = buf.__array_interface__["data"][0]
        if table is not None:
            gi = np.asarray(idx_list, dtype=np.int64)
            table.ns[gi] = out_ns
            table.types[gi] = (out_kind != 0).astype(np.uint8)
            table.ptrs[gi] = ptrs
        if wal and n_changed and self.op_writer is not None:
            _wal_write(self.op_writer,
                       wal_buf[:n_changed * OP_SIZE].tobytes())
        return changed[:n_changed]

    def _apply_groups_python(self, conts, group_keys, chunk_vals,
                             starts, set: bool, wal: bool) -> np.ndarray:
        """Numpy fallback for apply_batch when the native library is
        unavailable — identical semantics, per-group vectorized ops."""
        self._table = None
        changed_parts: list[np.ndarray] = []
        starts_l = starts.tolist()
        for c in conts:
            if c.runs is not None:
                c._run_to_legacy()
        for g, c in enumerate(conts):
            chunk = chunk_vals[starts_l[g]:starts_l[g + 1]]
            base = np.uint64(int(group_keys[g]) << 16)
            if set:
                if c.bitmap is not None:
                    hit = ((c.bitmap[chunk >> np.uint32(6)]
                            >> (chunk.astype(np.uint64) & np.uint64(63)))
                           & np.uint64(1)).astype(bool)
                    new = chunk[~hit]
                    if len(new):
                        self._guard_inplace(c)
                        np.bitwise_or.at(
                            c.bitmap, new >> np.uint32(6),
                            np.uint64(1) << (new.astype(np.uint64)
                                             & np.uint64(63)))
                        c.n += len(new)
                else:
                    new = chunk[~np.isin(chunk, c.array,
                                         assume_unique=True)]
                    if len(new):
                        merged = np.empty(c.n + len(new),
                                          dtype=np.uint32)
                        merged[:c.n] = c.array
                        merged[c.n:] = new
                        merged.sort()
                        c.array = merged
                        c.n = len(merged)
                        c.mapped = False
                        c._maybe_convert()
                if len(new):
                    changed_parts.append(base + new.astype(np.uint64))
            else:
                if c.bitmap is not None:
                    hit = ((c.bitmap[chunk >> np.uint32(6)]
                            >> (chunk.astype(np.uint64) & np.uint64(63)))
                           & np.uint64(1)).astype(bool)
                    gone = chunk[hit]
                    if len(gone):
                        self._guard_inplace(c)
                        np.bitwise_and.at(
                            c.bitmap, gone >> np.uint32(6),
                            ~(np.uint64(1) << (gone.astype(np.uint64)
                                               & np.uint64(63))))
                        c.n -= len(gone)
                        c._maybe_convert()
                else:
                    hit = np.isin(c.array, chunk, assume_unique=True)
                    gone = c.array[hit]
                    if len(gone):
                        c._unmap()
                        c.array = c.array[~hit]
                        c.n = len(c.array)
                if len(gone):
                    changed_parts.append(base + gone.astype(np.uint64))
        if not changed_parts:
            return _EMPTY_U64
        changed = np.concatenate(changed_parts)
        if wal and self.op_writer is not None:
            _wal_write(self.op_writer,
                       _wal_blob(changed, OP_ADD if set else OP_REMOVE))
        return changed

    def values(self) -> np.ndarray:
        """All set positions as a sorted u64 vector."""
        parts = list(self.value_chunks())
        if not parts:
            return _EMPTY_U64
        return np.concatenate(parts)

    def all_positions(self) -> np.ndarray:
        """Every set position as one sorted u64 vector, built with
        minimal per-container Python (one three-list append pass vs
        value_chunks' ~4 us generator step — the difference is the
        whole first-query cost on ultra-sparse fragments: BASELINE c5
        has ~434 K near-empty containers, and the per-container walk
        alone once cost the first src-TopN ~1.8 s). One concatenate +
        one repeat; peak memory is 8 B per set bit, so callers with
        100 M-bit fragments should prefer value_chunks (see
        fragment._host_src_count_map's size gate)."""
        # ONE pass appending to three plain lists: the previous
        # tuple-listcomp + two fromiter(genexpr) re-walks cost ~1 us
        # per container, which WAS the cold src-TopN query at 434 K
        # near-empty containers per c5 fragment sweep.
        keys_l: list = []
        vals_l: list = []
        ns_l: list = []
        for k, c in zip(self.keys, self.containers):
            if c.n:
                keys_l.append(k)
                vals_l.append(c.array if c.bitmap is None
                              and c.runs is None
                              else c.values())
                ns_l.append(c.n)
        if not keys_l:
            return _EMPTY_U64
        vals = np.concatenate(vals_l, dtype=np.uint64)
        bases = np.repeat(
            np.array(keys_l, dtype=np.uint64) << np.uint64(16),
            np.array(ns_l, dtype=np.int64))
        return bases + vals

    def positions_for_key_ranges(self, key_lo: np.ndarray,
                                 key_hi: np.ndarray) -> np.ndarray:
        """Set positions from every container whose key falls in any
        [key_lo[i], key_hi[i]) range, as one sorted u64 vector —
        all_positions restricted to key spans (fragment.fold_rows
        gathers the target rows' spans through this instead of
        duplicating the container-decoding walk)."""
        key_arr = self._keys_np()
        lo = np.searchsorted(key_arr, key_lo)
        hi = np.searchsorted(key_arr, key_hi)
        conts = self.containers
        skeys = self.keys
        keys_l: list = []
        vals_l: list = []
        ns_l: list = []
        for s, e in zip(lo.tolist(), hi.tolist()):
            for i in range(s, e):
                c = conts[i]
                if c.n:
                    keys_l.append(skeys[i])
                    vals_l.append(c.array if c.bitmap is None
                                  and c.runs is None
                                  else c.values())
                    ns_l.append(c.n)
        if not keys_l:
            return _EMPTY_U64
        return (np.repeat(np.array(keys_l, dtype=np.uint64)
                          << np.uint64(16),
                          np.array(ns_l, dtype=np.int64))
                | np.concatenate(vals_l, dtype=np.uint64))

    def value_chunks(self):
        """Sorted set positions as one u64 array per container — the
        streaming form of values() for exports that must not
        materialize a whole 100M+-bit fragment (reference streams
        exports bit-by-bit, handler.go:985-1025)."""
        for key, c in zip(list(self.keys), list(self.containers)):
            if c.n:
                yield np.uint64(key << 16) + c.values().astype(np.uint64)

    # -- counts / ranges

    def count(self) -> int:
        return sum(c.n for c in self.containers)

    def max(self) -> int:
        """Largest set position, or 0 if empty (reference roaring.go Max)."""
        for key, c in zip(reversed(self.keys), reversed(self.containers)):
            if c.n:
                if c.runs is not None:
                    r = c.runs
                    return ((key << 16) + int(r[-2]) + int(r[-1]))
                if c.is_array():
                    return (key << 16) + int(c.array[-1])
                w = int(np.flatnonzero(c.bitmap)[-1])
                return (key << 16) + w * 64 + int(c.bitmap[w]).bit_length() - 1
        return 0

    def rank(self, pos: int) -> int:
        """Number of set positions <= pos (reference Rank semantics)."""
        return self.count_range(0, pos + 1)

    def count_range(self, start: int, end: int) -> int:
        """Set bits in [start, end)."""
        if start >= end:
            return 0
        total = 0
        hi0, hi1 = highbits(start), highbits(end - 1)
        i = self._index(hi0)
        while i < len(self.keys) and self.keys[i] <= hi1:
            key, c = self.keys[i], self.containers[i]
            lo = lowbits(start) if key == hi0 else 0
            hi = lowbits(end - 1) + 1 if key == hi1 else 1 << 16
            total += c.count_range(lo, hi)
            i += 1
        return total

    def slice_range(self, start: int, end: int) -> np.ndarray:
        """Sorted u64 vector of set positions in [start, end)."""
        if start >= end:
            return _EMPTY_U64
        parts = []
        hi0, hi1 = highbits(start), highbits(end - 1)
        i = self._index(hi0)
        while i < len(self.keys) and self.keys[i] <= hi1:
            key, c = self.keys[i], self.containers[i]
            vals = c.values().astype(np.uint64) + np.uint64(key << 16)
            if key == hi0 or key == hi1:
                vals = vals[(vals >= start) & (vals < end)]
            if len(vals):
                parts.append(vals)
            i += 1
        if not parts:
            return _EMPTY_U64
        return np.concatenate(parts)

    def offset_range(self, offset: int, start: int, end: int) -> "Bitmap":
        """New bitmap of bits in [start,end) rebased to ``offset``
        (reference: roaring.go:253-285 — the Fragment.row() primitive).

        offset/start/end must be container-aligned (multiples of 2^16).
        Containers are shared (not copied) and marked mapped for
        copy-on-write, so this is O(containers in range).
        """
        for x, nm in ((offset, "offset"), (start, "start"), (end, "end")):
            if x & 0xFFFF:
                raise ValueError(f"{nm} must be multiple of 2^16")
        off_hi, hi0, hi1 = highbits(offset), highbits(start), highbits(end)
        out = Bitmap()
        i = self._index(hi0)
        while i < len(self.keys) and self.keys[i] < hi1:
            c = self.containers[i]
            if c.n:
                out.keys.append(off_hi + (self.keys[i] - hi0))
                c.mapped = True  # force copy-on-write in both holders
                out.containers.append(_shared_view(c))
            i += 1
        return out

    # -- set algebra

    def _binary_op(self, other: "Bitmap",
                   containers_fn: Callable, union_keys: bool) -> "Bitmap":
        out = Bitmap()
        i = j = 0
        ak, bk = self.keys, other.keys
        while i < len(ak) or j < len(bk):
            if j >= len(bk) or (i < len(ak) and ak[i] < bk[j]):
                if union_keys:
                    r = containers_fn(self.containers[i], None)
                    if r is not None and r.n:
                        out.keys.append(ak[i])
                        out.containers.append(r)
                i += 1
            elif i >= len(ak) or (j < len(bk) and bk[j] < ak[i]):
                if union_keys:
                    r = containers_fn(None, other.containers[j])
                    if r is not None and r.n:
                        out.keys.append(bk[j])
                        out.containers.append(r)
                j += 1
            else:
                r = containers_fn(self.containers[i], other.containers[j])
                if r is not None and r.n:
                    out.keys.append(ak[i])
                    out.containers.append(r)
                i += 1
                j += 1
        return out

    def intersect(self, other: "Bitmap") -> "Bitmap":
        return self._binary_op(other, lambda a, b: _intersect(a, b),
                               union_keys=False)

    def _table_for_read(self) -> Optional["_SerTable"]:
        """The serialization table, built on demand, for native
        whole-bitmap reads. The one-time O(containers) rebuild costs
        about as much as ONE Python container walk and then amortizes
        across every later read of this object (row-cache bitmaps are
        long-lived; the TopN src path re-reads the same source per
        slice)."""
        if not native.available():
            return None
        self._flush_table_dirty()
        if self._table is None:
            self._rebuild_table()
        return self._table

    def intersection_count(self, other: "Bitmap") -> int:
        # Whole-bitmap native crossing: the zip walk below pays ~3-6 us
        # of Python per container PAIR (the reference's inner loop is
        # nanoseconds, roaring.go:1192-1268); one call over both
        # container tables removes it entirely.
        if len(self.keys) and len(other.keys) and native.available():
            ta = self._table_for_read()
            tb = other._table_for_read()
            if (ta is not None and tb is not None
                    and not ta.has_runs and not tb.has_runs):
                # The native crossing only dispatches array/bitmap
                # pairs; run operands keep the per-container walk,
                # whose run kernels are already vectorized.
                return native.bitmap_intersection_count(
                    self._keys_np(), ta.types, ta.ptrs, ta.ns,
                    other._keys_np(), tb.types, tb.ptrs, tb.ns)
        total = 0
        i = j = 0
        while i < len(self.keys) and j < len(other.keys):
            if self.keys[i] < other.keys[j]:
                i += 1
            elif self.keys[i] > other.keys[j]:
                j += 1
            else:
                total += _intersection_count(self.containers[i],
                                             other.containers[j])
                i += 1
                j += 1
        return total

    def union(self, other: "Bitmap") -> "Bitmap":
        def f(a, b):
            if a is None:
                return _shared_copy(b)
            if b is None:
                return _shared_copy(a)
            return _union(a, b)
        return self._binary_op(other, f, union_keys=True)

    def difference(self, other: "Bitmap") -> "Bitmap":
        def f(a, b):
            if a is None:
                return None
            if b is None:
                return _shared_copy(a)
            return _difference(a, b)
        return self._binary_op(other, f, union_keys=True)

    def xor(self, other: "Bitmap") -> "Bitmap":
        def f(a, b):
            if a is None:
                return _shared_copy(b)
            if b is None:
                return _shared_copy(a)
            return _xor(a, b)
        return self._binary_op(other, f, union_keys=True)

    # -- iteration

    def __iter__(self) -> TIterator[int]:
        for key, c in zip(self.keys, self.containers):
            base = key << 16
            for v in c.values():
                yield base + int(v)

    def iterator_from(self, seek: int) -> TIterator[int]:
        """Iterate values >= seek."""
        hi = highbits(seek)
        i = self._index(hi)
        for k in range(i, len(self.keys)):
            key, c = self.keys[k], self.containers[k]
            base = key << 16
            vals = c.values()
            if key == hi:
                vals = vals[vals >= lowbits(seek)]
            for v in vals:
                yield base + int(v)

    def shared(self) -> "Bitmap":
        """A bitmap sharing this one's containers copy-on-write (both
        sides are marked; whichever mutates first copies). O(containers)
        — the executor's result-cache handout."""
        out = Bitmap()
        out.keys = list(self.keys)
        out.containers = [_shared_copy(c) for c in self.containers]
        return out

    def unmap(self) -> None:
        """Copy all mapped container data out of the backing buffer.

        Only required before an operation that INVALIDATES the mapping
        — ftruncate of the backing file (the fragment torn-tail trim)
        or an explicit mmap.close() (numpy views pin the buffer;
        close() raises BufferError otherwise). Ordinary close/snapshot/
        restore paths just drop references instead: live views keep the
        mapping alive, and a copy-out would pay a whole-fragment heap
        copy for nothing (fragment._close_storage).
        """
        self._table = None  # copies move every mapped buffer
        for c in self.containers:
            c._unmap()

    # -- representation optimization (run containers)

    def optimize(self, keys: Optional[np.ndarray] = None) -> dict[str, int]:
        """Cardinality-adaptive representation pass (the whole-bitmap
        runOptimize of the Roaring papers): each container picks the
        smallest of array/bitmap/run. Called after mutation batches
        (fragment import contract); point-op and bulk write paths
        transparently upgrade runs back to legacy kinds, so this is the
        single place run containers are (re)introduced. When ``keys``
        (sorted container keys) is given only those containers are
        visited — the bulk-import path passes the touched keys so a
        small import into a huge fragment stays O(touched), not O(all
        containers). Returns visited-container counts by kind."""
        self.version += 1
        counts = {"array": 0, "bitmap": 0, "run": 0}
        changed = False
        if keys is None:
            visit = self.containers
        else:
            ka = self._keys_np()
            keys = np.asarray(keys, dtype=np.uint64)
            idx = np.searchsorted(ka, keys)
            ok = idx < len(ka)
            sel = idx[ok][ka[idx[ok]] == keys[ok]]
            visit = [self.containers[int(i)] for i in sel.tolist()]
        # Vectorized prefilter for array containers (the bulk-import
        # common case): run counts for EVERY visited array in one
        # concatenated diff + prefix-sum pass, then only the winners
        # pay the per-container conversion. Per-container np.diff on
        # import-sized arrays spent ~10x the work in numpy fixed
        # overhead (measured: the optimize pass was 40% of a 1M-bit
        # import).
        arr_cs: list = []
        others: list = []
        for c in visit:
            if not c.n:
                continue
            if c.runs is None and c.bitmap is None:
                arr_cs.append(c)
            else:
                others.append(c)
        if arr_cs:
            lens = np.fromiter((len(c.array) for c in arr_cs),
                               np.int64, len(arr_cs))
            bounds = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=bounds[1:])
            cat = np.concatenate([c.array for c in arr_cs]).astype(
                np.int64, copy=False)
            adj = (np.diff(cat) == 1).astype(np.int64)
            cum = np.zeros(len(cat), np.int64)
            np.cumsum(adj, out=cum[1:])
            # Adjacent pairs WITHIN container i are adj[s : e-1] —
            # cross-container boundary diffs never enter the slice.
            adj_i = cum[bounds[1:] - 1] - cum[bounds[:-1]]
            # Same size model as Container.optimize — run form
            # (2 + 4R bytes) vs the array form (4n; arrays are <=4096
            # by invariant, so the bitmap form never prices in here) —
            # but with a conversion margin: random data lands enough
            # accidental adjacency that the run form wins by a handful
            # of bytes per container (312 scattered values carry ~1.5
            # adjacent pairs), and paying the ~35us interval build per
            # container for a <2% byte win turned this pass into 40%
            # of a 1M-bit import. Genuinely run-shaped data (timestamp
            # views, sequential ids) clears 8/7 by orders of
            # magnitude; point-op optimize() and _settle keep the
            # exact smallest-size rule.
            win = (2 + 4 * (lens - adj_i)) * 8 < 4 * lens * 7
            for c, w in zip(arr_cs, win.tolist()):
                if w:
                    after = c.optimize()
                    counts[after] += 1
                    changed = changed or after != "array"
                else:
                    counts["array"] += 1
        for c in others:
            before = c.kind()
            after = c.optimize()
            counts[after] += 1
            changed = changed or after != before
        if changed:
            # Types/pointers moved wholesale; the serialization table
            # rebuilds on next read.
            self._table = None
            self._table_dirty.clear()
        return counts

    def container_stats(self) -> dict[str, dict[str, int]]:
        """Live-container counts, resident bytes, and run-interval
        totals by kind — the data source for the
        pilosa_roaring_containers_live / _container_bytes gauges and
        the CLI inspect summary."""
        counts = {"array": 0, "bitmap": 0, "run": 0}
        bytes_ = {"array": 0, "bitmap": 0, "run": 0}
        intervals = 0
        for c in self.containers:
            if not c.n:
                continue
            if c.runs is not None:
                counts["run"] += 1
                bytes_["run"] += int(c.runs.size) * 2
                intervals += (len(c.runs) - 1) >> 1
            elif c.bitmap is None:
                counts["array"] += 1
                bytes_["array"] += len(c.array) * 4
            else:
                counts["bitmap"] += 1
                bytes_["bitmap"] += BITMAP_N * 8
        return {"counts": counts, "bytes": bytes_,
                "intervals": {"run": intervals}}

    # -- integrity

    def check(self) -> None:
        if len(self.keys) != len(self.containers):
            raise ValueError("bitmap: keys/containers length mismatch")
        for k in range(1, len(self.keys)):
            if self.keys[k] <= self.keys[k - 1]:
                raise ValueError("bitmap: keys out of order")
        for c in self.containers:
            c.check()

    # -- serialization (reference-compatible; roaring.go:475-614)

    def write_to(self, w, footer: bool = False) -> int:
        # Normalize representation so the n<=4096⇒array load rule holds even
        # for bitmaps produced by set algebra (run containers are
        # exempt — the runs flag bitset identifies them on disk).
        self._table = None  # normalization may swap representations
        for c in self.containers:
            c._maybe_convert()
        live = []
        for k, c in zip(self.keys, self.containers):
            if c.n <= 0:
                continue
            if c.runs is not None:
                live.append((k, 2, c.runs, c.n))
            elif c.bitmap is not None:
                live.append((k, 1, c.bitmap, c.n))
            else:
                live.append((k, 0, c.array, c.n))
        return _write_snapshot(live, w, footer=footer)

    def _flush_table_dirty(self) -> None:
        """Patch point-mutated containers' entries into the
        serialization table — MUST run before any table read (freeze,
        the batch gather prep). Containers point ops CREATED since the
        last read are first spliced in with ONE vectorized
        table.insert, then patched like any dirty entry. A dirty set
        rivaling the table size falls back to wholesale invalidation
        (rebuild costs the same)."""
        t = self._table
        new = self._table_new
        if new:
            if t is not None:
                new_keys = np.fromiter(new, np.uint64, len(new))
                new_keys.sort()
                ka = self._keys_np()
                idx_now = np.searchsorted(ka, new_keys)
                # Position in the PRE-insert table: each earlier new
                # key shifted this one right by one.
                pos_old = idx_now - np.arange(len(new_keys))
                t = self._table = t.insert(pos_old.astype(np.int64),
                                           len(new_keys))
                self._table_dirty.update(new)
            new.clear()
        dirty = self._table_dirty
        if not dirty:
            return
        if t is None:
            dirty.clear()
            return
        if len(dirty) * 2 >= len(self.keys):
            # Patching costs ~1 us/key (bisect + 4 field stores) vs
            # ~1.2 us/container for a wholesale rebuild — only punt to
            # the rebuild when most of the table is dirty anyway.
            self._table = None
            dirty.clear()
            return
        keys = self.keys
        conts = self.containers
        for key in dirty:
            i = bisect.bisect_left(keys, key)
            if i >= len(keys) or keys[i] != key:
                continue
            c = conts[i]
            if c.runs is not None:
                b = c.runs
                t.types[i] = 2
                t.has_runs = True
            else:
                b = c.bitmap if c.bitmap is not None else c.array
                t.types[i] = 0 if c.bitmap is None else 1
            t.bufs[i] = b
            t.ns[i] = c.n
            t.ptrs[i] = b.__array_interface__["data"][0]
        dirty.clear()

    def _rebuild_table(self) -> "_SerTable":
        """Full rebuild of the serialization table (one pass; after this
        the batched write path keeps it current incrementally and
        freeze() is O(1))."""
        self._table_dirty.clear()
        n = len(self.containers)
        ns = np.empty(n, dtype=np.int64)
        types = np.empty(n, dtype=np.uint8)
        ptrs = np.empty(n, dtype=np.uint64)
        bufs: list = [None] * n
        for i, c in enumerate(self.containers):
            if c.runs is not None:
                b = c.runs
                bufs[i] = b
                ns[i] = c.n
                types[i] = 2
                ptrs[i] = b.__array_interface__["data"][0]
                continue
            if c.n and (c.bitmap is not None) != (c.n > ARRAY_MAX_SIZE):
                c._maybe_convert()
            b = c.bitmap if c.bitmap is not None else c.array
            bufs[i] = b
            ns[i] = c.n
            types[i] = 0 if c.bitmap is None else 1
            ptrs[i] = b.__array_interface__["data"][0]
        self._table = _SerTable(ns, types, ptrs, bufs)
        return self._table

    def freeze(self) -> "_Frozen":
        """Consistent point-in-time capture for ASYNC serialization,
        O(1)+O(point-dirtied entries) when the serialization table is
        current (the batched write path maintains it in place; point
        mutations park their container key in _table_dirty and
        _flush_table_dirty patches just those entries here — only
        structural changes from point ops, i.e. new containers,
        invalidate wholesale). Instead of marking every container
        mapped, freezing bumps the COW epoch: any later in-place
        bitmap-word mutation copies its buffer first (Container.cow),
        and array buffers are replaced, never mutated — so the captured
        pointers stay valid with no per-container work. write_frozen
        serializes the capture with no lock held
        (fragment.snapshot's background path)."""
        self._flush_table_dirty()
        t = self._table
        if t is None:
            t = self._rebuild_table()
        self._cow_epoch += 1
        return _Frozen(self._keys_np().copy(), t.ns.copy(),
                       t.types.copy(), t.ptrs.copy(), list(t.bufs))


    def marshal(self) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    @staticmethod
    def unmarshal(data, mapped: bool = False,
                  tolerate_torn_tail: bool = False,
                  verify_body: bool = False) -> "Bitmap":
        """Decode a snapshot (+trailing op-log) from a bytes-like buffer.

        With ``mapped=True`` container data are zero-copy views into ``data``
        (e.g. an mmap); they are copy-on-write on first mutation.

        With ``tolerate_torn_tail=True``, a trailing partial op record
        (< 13 bytes — the signature of a crash mid-append) stops parsing
        instead of raising; the number of dangling bytes is reported in
        ``.torn_bytes`` so the caller can truncate the file. A bad checksum
        on a *complete* record is still corruption and still raises.

        A footered snapshot (storage.integrity) always has its footer
        self-crc + header-region crc verified; ``verify_body=True``
        additionally checks the whole-body digest (one crc pass over
        the file — the cold-open verification; per-block checks run
        lazily on first read and on the scrub cadence).
        """
        buf = memoryview(data)
        hdr_arr, run_mask, ns, offs, sizes, ops_offset, body_end = \
            parse_snapshot_layout(buf)
        key_n = len(hdr_arr)
        is_arr_mask = ns <= ARRAY_MAX_SIZE
        b = Bitmap()
        b.keys = hdr_arr["key"].tolist()
        containers = b.containers
        run_list = (run_mask.tolist() if run_mask is not None
                    else [False] * key_n)
        for off, n, is_arr, is_run in zip(offs.tolist(), ns.tolist(),
                                          is_arr_mask.tolist(),
                                          run_list):
            c = Container.__new__(Container)
            c.runs = None
            if is_run:
                n_runs = int.from_bytes(buf[off:off + 2], "little")
                runs = np.frombuffer(buf, dtype="<u2",
                                     count=1 + 2 * n_runs, offset=off)
                c.runs = runs if mapped else runs.copy()
                c.array = None
                c.bitmap = None
            elif is_arr:
                arr = np.frombuffer(buf, dtype="<u4", count=n,
                                    offset=off)
                c.array = arr if mapped else arr.copy()
                c.bitmap = None
            else:
                words = np.frombuffer(buf, dtype="<u8", count=BITMAP_N,
                                      offset=off)
                c.array = None
                c.bitmap = words if mapped else words.copy()
            c.n = n
            c.mapped = mapped
            c.cow = 0
            containers.append(c)
        # Integrity footer (storage.integrity), if one sits between the
        # container blocks and the op-log. Vintage files parse None and
        # replay straight from the body end; a footer truncated at EOF
        # is a torn tail (trimmed like a torn op record); a complete
        # footer failing its own or the header-region crc is
        # CORRUPTION and raises — the fragment open path quarantines.
        ops_start = body_end
        try:
            info = _integrity.parse_and_verify_footer(
                buf, key_n, ops_offset, offs, sizes, body_end,
                check_body=verify_body)
        except _integrity.TornFooterError as e:
            if not tolerate_torn_tail:
                raise
            b.torn_bytes = e.torn_bytes
            return b
        if info is not None:
            b.footer = info
            ops_start = body_end + info.size
        # Trailing op-log (bytes after the body / footer).
        _replay_ops(b, buf[ops_start:], tolerate_torn_tail)
        return b


def parse_snapshot_layout(buf) -> tuple:
    """Vectorized parse of a snapshot's header region WITHOUT building
    containers: ``(hdr_arr, run_mask, ns, offs, sizes, ops_offset,
    body_end)``. The ONE layout parser shared by the decoder
    (Bitmap.unmarshal) and the integrity scrubber
    (storage.scrub.scrub_buffer), so a format change cannot
    desynchronize corruption DETECTION from decoding. Raises
    ValueError on any structural violation. ``buf`` must be a
    memoryview.

    The per-container int.from_bytes loop this vectorization replaced
    cost ~100 ms on a 15 K-container fragment — the bulk of every
    open() and of the synchronous remap reopen (the write path's
    worst per-op outlier)."""
    if len(buf) < HEADER_SIZE:
        raise ValueError("data too small")
    cookie = int.from_bytes(buf[0:4], "little")
    if cookie not in (COOKIE, COOKIE_RUNS):
        raise ValueError("invalid roaring file")
    key_n = int.from_bytes(buf[4:8], "little")
    hdr_off = HEADER_SIZE
    run_mask = None
    if cookie == COOKIE_RUNS:
        flag_len = _run_flags_len(key_n)
        if HEADER_SIZE + flag_len > len(buf):
            raise ValueError(
                f"run flags out of bounds: keyN={key_n},"
                f" len={len(buf)}")
        run_mask = np.unpackbits(
            np.frombuffer(buf, np.uint8, count=flag_len,
                          offset=HEADER_SIZE),
            bitorder="little")[:key_n].astype(bool)
        hdr_off += flag_len
    if hdr_off + key_n * 16 > len(buf):
        raise ValueError(
            f"header out of bounds: keyN={key_n}, len={len(buf)}")
    hdr_arr = np.frombuffer(buf, dtype=_HDR_DTYPE, count=key_n,
                            offset=hdr_off)
    ns = (hdr_arr["n"].astype(np.int64) + 1)
    offs = np.frombuffer(buf, dtype="<u4", count=key_n,
                         offset=hdr_off + key_n * 12
                         ).astype(np.int64)
    sizes = _container_sizes(ns)
    if run_mask is not None and run_mask.any():
        # Run block sizes come from each block's own numRuns
        # prefix (2 + 4R bytes); validate the prefix read first.
        sizes = sizes.copy()
        for i in np.flatnonzero(run_mask).tolist():
            off = int(offs[i])
            if off + 2 > len(buf):
                raise ValueError(
                    f"run block out of bounds: off={off},"
                    f" len={len(buf)}")
            sizes[i] = 2 + 4 * int.from_bytes(buf[off:off + 2],
                                              "little")
    if key_n and int((offs + sizes).max()) > len(buf):
        bad = int(offs[np.argmax(offs + sizes)])
        raise ValueError(
            f"offset out of bounds: off={bad}, len={len(buf)}")
    ops_offset = hdr_off + key_n * 16
    body_end = max(ops_offset,
                   int(offs[-1] + sizes[-1]) if key_n
                   else HEADER_SIZE)
    return hdr_arr, run_mask, ns, offs, sizes, ops_offset, body_end


def _shared_view(c: Container) -> Container:
    """A container sharing c's data, mapped (copy-on-write)."""
    out = Container()
    out.array, out.bitmap, out.n, out.mapped = c.array, c.bitmap, c.n, True
    out.runs = c.runs
    return out


def _shared_copy(c: Container) -> Container:
    c.mapped = True
    return _shared_view(c)


class _SerTable:
    """Serialization table aligned with Bitmap.containers: per-container
    (n, type, buffer pointer, buffer ref), maintained incrementally by
    apply_batch so the MAX_OP_N snapshot freeze is O(1) instead of
    O(all containers). Point mutations record their container key in
    Bitmap._table_dirty for bulk patching before any table read; only
    structural changes (new containers from point ops, bulk rewrites)
    invalidate wholesale."""

    __slots__ = ("ns", "types", "ptrs", "bufs", "has_runs")

    def __init__(self, ns, types, ptrs, bufs):
        self.ns = ns          # int64: container cardinality
        self.types = types    # uint8: 0=array, 1=bitmap, 2=run
        self.ptrs = ptrs      # uint64: buffer data pointers
        self.bufs = bufs      # the buffer objects (keep pointers alive)
        # Pessimistic run-presence flag gating native fast paths that
        # only speak array/bitmap; patch sites may only raise it.
        self.has_runs = bool((types == 2).any())

    def insert(self, pos: np.ndarray, empties: int) -> "_SerTable":
        """New table with empty-array entries inserted at ``pos``
        (aligned with Bitmap._insert_containers)."""
        z64 = np.zeros(len(pos), dtype=np.int64)
        ns = np.insert(self.ns, pos, z64)
        types = np.insert(self.types, pos, z64.astype(np.uint8))
        empty_ptr = _EMPTY_U32.__array_interface__["data"][0]
        ptrs = np.insert(self.ptrs, pos,
                         np.full(len(pos), empty_ptr, dtype=np.uint64))
        bufs: list = []
        prev = 0
        old = self.bufs
        for p in pos.tolist():
            bufs.extend(old[prev:p])
            bufs.append(_EMPTY_U32)
            prev = p
        bufs.extend(old[prev:])
        return _SerTable(ns, types, ptrs, bufs)


class _Frozen:
    """Point-in-time snapshot capture (keys + serialization table copy).
    Buffer refs pin the captured arrays; the COW epoch bump taken at
    freeze() time guarantees no in-place mutation of them."""

    __slots__ = ("keys", "ns", "types", "ptrs", "bufs", "has_runs")

    def __init__(self, keys, ns, types, ptrs, bufs):
        self.keys = keys
        self.ns = ns
        self.types = types
        self.ptrs = ptrs
        self.bufs = bufs
        self.has_runs = bool((types == 2).any())

    def as_live_tuples(self) -> list[tuple]:
        """(key, kind, buf, n) rows — the Python-serializer form."""
        out = []
        for k, n, t, b in zip(self.keys.tolist(), self.ns.tolist(),
                              self.types.tolist(), self.bufs):
            if n:
                out.append((k, t, b, n))
        return out


def write_frozen(frozen, w, footer: bool = False) -> int:
    """Serialize a Bitmap.freeze() capture (no locks needed). Real
    files take the native writev path (zero copy, no GIL during the
    write); BytesIO targets, native-less hosts, and captures holding
    run containers (the C writer speaks the legacy cookie only)
    serialize via the Python writer. ``footer=True`` appends the
    storage-integrity footer on BOTH paths (the native body write
    stays C; the footer crcs compute from the frozen buffers, no file
    re-read)."""
    if isinstance(frozen, list):  # legacy tuple-list form
        live = [t if isinstance(t[1], (int, np.integer))
                else (t[0], 0 if t[2] is None else 1,
                      t[1] if t[2] is None else t[2], t[3])
                for t in frozen]
        return _write_snapshot(live, w, footer=footer)
    fileno = getattr(w, "fileno", None)
    if fileno is not None and native.available() and not frozen.has_runs:
        try:
            fd = w.fileno()
        except (OSError, io.UnsupportedOperation):
            fd = None
        if fd is not None:
            w.flush()
            total = native.write_snapshot_fd(fd, frozen.keys, frozen.ns,
                                             frozen.types, frozen.ptrs)
            if total < 0:
                raise OSError("write_snapshot_fd failed")
            if footer:
                # The C writer advanced the shared fd offset past the
                # body; append straight through the fd (the buffered
                # wrapper was flushed above and holds nothing).
                import os as _os
                _os.write(fd, _live_footer(frozen.as_live_tuples()))
            return total
    return _write_snapshot(frozen.as_live_tuples(), w, footer=footer)


def _base_u8_window(base: np.ndarray, ptr: int, nbytes: int) -> np.ndarray:
    """Byte window [ptr, ptr+nbytes) of a contiguous base buffer as a
    u8 view — the coalesced-run form of per-container u8 views in
    _write_snapshot."""
    b8 = base.view(np.uint8) if base.dtype != np.uint8 else base
    off = ptr - b8.__array_interface__["data"][0]
    return b8[off:off + nbytes]


def _run_flags_len(n_cont: int) -> int:
    """Bytes the runs-cookie flag bitset occupies for ``n_cont``
    containers: ceil(n/8), rounded up to a multiple of 8 so every
    container block that follows stays even-aligned."""
    return ((n_cont + 7) >> 3) + (-((n_cont + 7) >> 3) % 8)


_BLOCK_DTYPES = ("<u4", "<u8", "<u2")  # kind 0=array, 1=bitmap, 2=run


def _snapshot_head(live: list[tuple]) -> tuple[bytes, np.ndarray, int]:
    """(header-region bytes, per-block sizes, total body bytes) for a
    snapshot of (key, kind, buf, n) rows — the ONE place the on-disk
    header layout is computed, shared by the Python writer and the
    footer builder for the native writev path (whose C code writes a
    byte-identical header; a format tweak here desynchronizing them is
    caught by the footer verifying against the real file bytes)."""
    n_cont = len(live)
    # Header via numpy, payload via one join + one write: a snapshot
    # used to issue one write() per container (16 K syscalls for a
    # 200 K-bit fragment) and pack headers int-by-int — together
    # most of the snapshot cost on the write path's MAX_OP_N cadence.
    hdr = np.empty(n_cont, dtype=_HDR_DTYPE)
    hdr["key"] = np.fromiter((t[0] for t in live), np.uint64, n_cont)
    ns = np.fromiter((t[3] for t in live), np.uint32, n_cont)
    hdr["n"] = ns - 1
    kinds = np.fromiter((t[1] for t in live), np.uint8, n_cont)
    has_runs = bool((kinds == 2).any())
    if has_runs:
        sizes = np.where(
            kinds == 2,
            np.fromiter((t[2].size * 2 if t[1] == 2 else 0
                         for t in live), np.int64, n_cont),
            _container_sizes(ns))
        flags = np.zeros(_run_flags_len(n_cont), dtype=np.uint8)
        flags[:((n_cont + 7) >> 3)] = np.packbits(kinds == 2,
                                                  bitorder="little")
        flag_bytes = flags.tobytes()
        cookie = COOKIE_RUNS
    else:
        sizes = _container_sizes(ns)
        flag_bytes = b""
        cookie = COOKIE
    data_start = HEADER_SIZE + len(flag_bytes) + n_cont * 12 + n_cont * 4
    offsets = data_start + np.concatenate(
        ([0], np.cumsum(sizes[:-1], dtype=np.int64))) \
        if n_cont else np.empty(0, np.int64)
    # Header + one np.concatenate of per-container byte VIEWS, two
    # buffer-protocol writes: the per-container slice-assign loop
    # this replaces cost ~2x more at 13 K+ containers (concatenate
    # iterates the list in C). LE byte views are free on LE hosts;
    # the rare BE/non-contiguous container falls back to a cast.
    head = (cookie.to_bytes(4, "little")
            + n_cont.to_bytes(4, "little")
            + flag_bytes
            + hdr.tobytes() + offsets.astype("<u4").tobytes())
    total = data_start + int(sizes.sum()) if n_cont \
        else HEADER_SIZE + len(flag_bytes)
    return head, sizes, total


def _live_footer(live: list[tuple]) -> bytes:
    """The integrity footer for a snapshot body of ``live`` rows,
    computed from the in-memory buffers (no file re-read) — the
    native writev path's footer builder."""
    head, _sizes, total = _snapshot_head(live)
    crcs: list[int] = []
    body_crc = zlib.crc32(head)
    for _, kind, buf, _n in live:
        arr = buf
        dt = _BLOCK_DTYPES[kind]
        if arr.dtype.str != dt or not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr, dtype=dt)
        crcs.append(zlib.crc32(arr) & 0xFFFFFFFF)
        body_crc = zlib.crc32(arr, body_crc)
    return _integrity.build_footer(head, crcs, body_crc, total)


def _write_snapshot(live: list[tuple], w, footer: bool = False) -> int:
    """Serialize (key, kind, buf, n) rows. With no run containers the
    output is byte-identical to the legacy 12346 format; any run
    container switches the snapshot to the 12347 runs cookie, which
    inserts the run-flag bitset between keyN and the headers.

    ``footer=True`` (the fragment FILE snapshot paths) appends the
    storage-integrity footer — per-container-block crc32 table +
    whole-body digest (storage.integrity) — after the body. Wire
    serialization (marshal, /fragment/data) stays footer-free, so
    golden vectors and the exchange format are byte-unchanged."""
    n_cont = len(live)
    head, sizes, total = _snapshot_head(live)
    w.write(head)
    block_crcs: list[int] = []
    body_crc = zlib.crc32(head) if footer else 0
    if n_cont:
        # Coalesce runs of payloads that are adjacent views of one
        # shared base buffer (the bulk-import global merge leaves every
        # rebuilt array container a consecutive slice of one lows
        # vector): one memoryview per RUN instead of a u8 view + list
        # append per container, checked by raw pointer continuity so
        # any later per-container mutation (fresh buffer ⇒ new base)
        # simply breaks the run.
        parts = []
        run_base = None
        run_start = 0
        run_len = 0
        for _, kind, buf, _n in live:
            arr = buf
            dt = _BLOCK_DTYPES[kind]
            if arr.dtype.str != dt or not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr, dtype=dt)
            if footer:
                block_crcs.append(zlib.crc32(arr) & 0xFFFFFFFF)
            ptr = arr.__array_interface__["data"][0]
            nbytes = arr.nbytes
            b = arr.base
            base = (b if isinstance(b, np.ndarray)
                    and b.flags.c_contiguous else arr)
            if base is run_base and ptr == run_start + run_len:
                run_len += nbytes
                continue
            if run_base is not None:
                parts.append(_base_u8_window(run_base, run_start,
                                             run_len))
            run_base, run_start, run_len = base, ptr, nbytes
        if run_base is not None:
            parts.append(_base_u8_window(run_base, run_start, run_len))
        if footer:
            for p in parts:
                body_crc = zlib.crc32(p, body_crc)
        w.write(memoryview(np.concatenate(parts))
                if len(parts) > 1 else parts[0])
    if footer:
        w.write(_integrity.build_footer(head, block_crcs,
                                        body_crc, total))
    return total

"""Fragment: the storage unit at one (frame, view, slice) intersection.

Trimmed copy of the JAX package's ``storage/fragment.py``. A fragment
owns one file-backed roaring bitmap holding a rows × 2^20-column block;
bit position ``pos = row * SLICE_WIDTH + (col % SLICE_WIDTH)``
(fragment.go:1511-1514).

Durability model (the JAX package's, and the reference's):
- data file = footered roaring snapshot + appended op-log (WAL); the
  file is opened ``a+b`` unbuffered and ``flock``ed exclusively while
  open, mapped, and its ops replay on open (a torn tail — a crash
  mid-append — is trimmed to the last complete record);
- every mutation appends an op record to the group-commit WAL
  (storage.wal) and the serving layer's commit barrier
  (``wal.barrier_all``) puts it in the OS before a write is acked;
  after MAX_OP_N ops a background snapshot rewrites the file (temp +
  rename) and splices the ops appended meanwhile (fragment.go:991-1057);
- bulk imports take the WAL'd batch lane (small import, large
  fragment), the WAL-first lane (one blob of op records, then the
  bulk add) or, past _WAL_IMPORT_MAX_BYTES, the detach-then-snapshot
  lane (fragment.go:924-989);
- ``close`` is a commit barrier, a snapshot when the op-log holds
  records, and the WAL's close.

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

Left out of the copy: tiering, quarantine and verify-on-read, scrub,
block checksums and sync, the failpoints, accounting and stats, and the
incremental per-row count map (a write recounts its rows).
"""

from __future__ import annotations

import fcntl
import hashlib
import heapq
import math
import mmap
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
from . import wal as wal_mod
from .bitmap import Bitmap
from .cache import Pair

# Number of operations before a snapshot rewrite (the JAX package's
# default; reference fragment.go:63-65). Tests lower it on the module.
MAX_OP_N = 50000

# Replay-cost weight of one bulk-import blob position relative to one
# discrete op record: a blob's single add-run replays through the
# vectorized add_many lane, so a blob bit carries ~1/16th the reopen
# replay pressure MAX_OP_N exists to bound.
_BLOB_OP_WEIGHT = 16

# Snapshots between full close/remap cycles (see Fragment.snapshot).
_REMAP_EVERY = 16

# Largest bulk import the WAL-first lane holds as op records (13 B per
# position) before falling back to the detach-then-snapshot contract —
# bounds transient log growth between snapshot cadences.
_WAL_IMPORT_MAX_BYTES = 32 << 20

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
                 row_attr_store=None, wal_fsync: str = wal_mod.FSYNC_NONE):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        self.wal_fsync = wal_fsync
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
        self._snapshot_n = 0
        self._positions = None
        self._total_bits = None
        self._present_rows = None
        # The group-commit WAL over the data file: mutation paths
        # APPEND records (no syscall); commit barriers flush them.
        self._wal: Optional[wal_mod.GroupCommitWal] = None
        self._mu = threading.RLock()
        # Snapshot lifecycle lock. Ordering rule: ALWAYS acquired
        # BEFORE _mu when blocking (sync snapshot, close); the per-op
        # async trigger — which runs UNDER _mu — only try-acquires and
        # skips when busy, so the order cannot invert. Held by the
        # background worker for its whole run (released cross-thread in
        # its finally), so "with _snap_mu" doubles as the join barrier.
        self._snap_mu = threading.Lock()
        self._file = None
        self._mmap: Optional[mmap.mmap] = None
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
            # The one-crossing mutate extension (built once, cached):
            # serving fragments are where the per-op path runs hot.
            from . import native_ext
            native_ext.load()
            self.cache = cache_mod.new_cache(self.cache_type,
                                             self.cache_size)
            self._open_storage(verify=True)
            self._open_cache()
            self._open = True

    def _open_storage(self, verify: bool = False) -> None:
        # Open (creating) the data file, flock it, seed an empty file
        # with a footered empty snapshot, map, replay snapshot + op-log,
        # then attach the WAL as the op writer (reference
        # fragment.go:179-234). buffering=0: the WAL's leader write
        # reaches the OS in one syscall.
        self._file = open(self.path, "a+b", buffering=0)
        try:
            fcntl.flock(self._file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._file.close()
            self._file = None
            raise
        self._file.seek(0, os.SEEK_END)
        if self._file.tell() == 0:
            roaring.Bitmap().write_to(self._file, footer=True)
        self._mmap = mmap.mmap(self._file.fileno(), 0, prot=mmap.PROT_READ)
        self.storage = roaring.Bitmap.unmarshal(self._mmap, mapped=True,
                                                tolerate_torn_tail=True,
                                                verify_body=verify)
        if self.storage.torn_bytes:
            # A crash mid-append left a partial op record (or a torn
            # footer); the WAL is append-only so the tail is the only
            # casualty — trim it.
            size = self._file.seek(0, os.SEEK_END)
            self.storage.unmap()
            self._mmap = None
            os.ftruncate(self._file.fileno(), size - self.storage.torn_bytes)
            self._file.seek(0, os.SEEK_END)
            self._mmap = mmap.mmap(self._file.fileno(), 0,
                                   prot=mmap.PROT_READ)
            self.storage = roaring.Bitmap.unmarshal(self._mmap, mapped=True,
                                                    verify_body=verify)
        self._wal = wal_mod.GroupCommitWal(self._file, self.wal_fsync)
        self.storage.op_writer = self._wal

    def _close_storage(self) -> None:
        if self._wal is not None:
            # Orderly close = commit barrier: whatever a library caller
            # appended without barriering is durable per policy before
            # the fd goes away.
            try:
                self._wal.barrier()
            except wal_mod.WalError:
                pass  # torn log: reopen trims to the flushed prefix
            self._wal.close()
            self._wal = None
        if self.storage is not None:
            self.storage.op_writer = None
        # No mmap.close() and no copy-out: row-cache entries and escaped
        # query results share zero-copy container views into the map,
        # and those views pin it; dropping our reference lets the OS
        # unmap when the last view goes. The old inode stays valid
        # under os.replace, so mapped views never go stale.
        self._mmap = None
        self.row_cache.clear()
        if self._file is not None:
            # Release the flock EXPLICITLY: mmap dups the fd, and while
            # a container view keeps the old map alive, close() alone
            # would leave the lock held and block the next open.
            try:
                fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
            except OSError:
                pass
            self._file.close()
            self._file = None

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
        when the sidecar is lost — after a crash the replayed WAL holds
        rows the persisted id list lacks) are missing from the count
        cache. Detect by cardinality (exact per-row counts must sum to
        the storage total) and repair from present_rows when the
        fragment is small enough to dump positions, else leave the cache
        flagged incomplete — the single-pass TopN then takes the
        recounting path."""
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
        # _snap_mu first (lock order): waits out any background
        # snapshot and blocks new ones for the whole close.
        with self._snap_mu:
            with self._mu:
                if not self._open:
                    return
                # Barrier, then a snapshot that folds the op-log in:
                # its body covers any record a failed barrier could not
                # write.
                try:
                    self.wal_barrier()
                except wal_mod.WalError:
                    pass
                if self.storage.op_n:
                    self._snapshot_locked()
                self.flush_cache()
                self._close_storage()
                self.device.invalidate_all()
                self.storage = None
                self._open = False

    def wal_barrier(self) -> None:
        """Commit barrier: every mutation applied so far has its WAL
        record in the OS (fsynced per ``wal_fsync``) when this returns.
        The serving layer calls the process-wide
        ``storage.wal.barrier_all()`` before acking write requests;
        library callers mutating fragments directly use this (or
        ``close()``) to get the same durability point."""
        wal = self._wal
        if wal is not None:
            wal.barrier()

    def snapshot(self, sync: bool = True) -> None:
        """Atomically rewrite the data file from current state
        (reference fragment.go:991-1057): a footered snapshot, written
        to a temp file, fsynced and renamed over the data file.

        ``sync=False`` (the per-op MAX_OP_N trigger) serializes a
        COW-frozen capture on a BACKGROUND thread and splices the ops
        appended meanwhile from the old file's WAL tail at swap time;
        durability is unchanged, since every op is already in the old
        file's WAL. Bulk paths that detach the op writer MUST use
        sync=True — their mutations exist nowhere but memory until the
        snapshot lands.

        The rewritten file is swapped under the live storage object —
        only the fd, the flock, the op counter and the WAL's file
        change. Every ``_REMAP_EVERY``-th snapshot takes the full
        reopen instead: it re-establishes zero-copy mapped containers,
        un-pinning old map generations that copy-on-write views would
        otherwise keep alive."""
        if not sync:
            self._snapshot_async()
            return
        # Lock order: _snap_mu (waits out / blocks any worker) then
        # _mu. Callers MUST NOT hold _mu here (the worker needs _mu to
        # finish, so joining under _mu would deadlock).
        with self._snap_mu:
            self._snapshot_locked()

    def _snapshot_locked(self) -> None:
        with self._mu:
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as f:
                self.storage.write_to(f, footer=True)
                f.flush()
                os.fsync(f.fileno())
            self._swap_data_file(tmp, new_op_n=0)

    def _swap_data_file(self, tmp: str, new_op_n: int) -> None:
        """Swap ``tmp`` in as the data file (caller holds _mu; one
        shared implementation for the sync and background paths):
        replace the path, flock + attach a new fd — flock is per-inode,
        so the old fd's lock cannot conflict, and the old map stays
        alive while mapped container views pin it. Every
        ``_REMAP_EVERY``-th snapshot does the full close/reopen instead.
        A failed swap falls back to the full reopen so the WAL is never
        silently left detached."""
        self._snapshot_n += 1
        if self._snapshot_n % _REMAP_EVERY == 0:
            self._close_storage()
            os.replace(tmp, self.path)
            self._open_storage()
            return
        self.storage.op_writer = None
        os.replace(tmp, self.path)
        try:
            new_file = open(self.path, "a+b", buffering=0)
            fcntl.flock(new_file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BaseException:
            self._close_storage()
            self._open_storage()
            return
        old_file, self._file = self._file, new_file
        self._mmap = None
        if old_file is not None:
            try:
                fcntl.flock(old_file.fileno(), fcntl.LOCK_UN)
            except OSError:
                pass
            old_file.close()
        new_file.seek(0, os.SEEK_END)
        self.storage.op_n = new_op_n
        # The snapshot body covers every applied mutation, so any
        # pending (even failed/torn) records are superseded; the WAL
        # continues over the fresh file with a clean slate.
        self._wal.reset_file(new_file, clear_pending=True)
        self.storage.op_writer = self._wal

    def _snapshot_async(self) -> None:
        # Called UNDER _mu (the per-op MAX_OP_N trigger): may only
        # TRY-acquire _snap_mu — blocking here would invert the
        # _snap_mu → _mu lock order against sync snapshot/close.
        if not self._snap_mu.acquire(blocking=False):
            return  # a worker or sync snapshot is running; op_n keeps
            # re-triggering until one lands
        try:
            # The splice below needs the FILE to hold every op appended
            # so far: tail_off divides "covered by the frozen body" from
            # "spliced from the WAL tail". A failed/torn log raises here
            # (fail-stop: a reopen trims to the flushed prefix).
            self._wal.flush(None, sync=False)
            frozen = self.storage.freeze()
            tail_off = self._file.seek(0, os.SEEK_END)
        except BaseException:
            self._snap_mu.release()
            raise
        # _snap_mu intentionally stays held; the worker releases it
        # (threading.Lock allows cross-thread release).
        threading.Thread(
            target=self._snapshot_worker, args=(frozen, tail_off),
            name="frag-snapshot", daemon=True).start()

    def _snapshot_worker(self, frozen, tail_off: int) -> None:
        try:
            tmp = self.path + ".snapshotting"
            try:
                with open(tmp, "wb") as f:
                    # The expensive serialize + fsync of the frozen body
                    # runs with NO fragment lock held; writers keep
                    # appending to the old file's WAL.
                    roaring.write_frozen(frozen, f, footer=True)
                    f.flush()
                    os.fsync(f.fileno())
                    with self._mu:
                        # Splice the ops that landed since the freeze,
                        # then swap. WalError (a torn log) aborts the
                        # swap through the OSError handler: the old
                        # file stays the file of record.
                        self._wal.flush(None, sync=False)
                        with open(self.path, "rb") as rf:
                            rf.seek(tail_off)
                            tail = rf.read()
                        f.write(tail)
                        f.flush()
                        os.fsync(f.fileno())
                        self._swap_data_file(
                            tmp, new_op_n=len(tail) // roaring.OP_SIZE)
            except OSError:
                # Pre-swap IO failure: op_writer was never detached, the
                # old snapshot+WAL remains the file of record, and the
                # next MAX_OP_N trigger retries.
                pass
        finally:
            self._snap_mu.release()

    def _join_snapshot(self) -> None:
        """Barrier: returns once no background snapshot is in flight
        (the worker holds _snap_mu for its entire run)."""
        with self._snap_mu:
            pass

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
        self._increment_op_n()
        return True

    def set_bits(self, row_ids, column_ids) -> np.ndarray:
        """Batched SetBit: one native crossing for container mutation +
        WAL records, one group-commit append, batched cache upkeep.
        Durability is the per-op path's: every changed bit has a
        checksummed WAL record when the next barrier returns. Returns
        the sorted changed positions (row*SLICE_WIDTH + slice-local
        col)."""
        return self._mutate_batch(row_ids, column_ids, set=True)

    def clear_bits(self, row_ids, column_ids) -> np.ndarray:
        """Batched ClearBit (see set_bits)."""
        return self._mutate_batch(row_ids, column_ids, set=False)

    def _mutate_batch(self, row_ids, column_ids, set: bool) -> np.ndarray:
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        if len(rows) != len(cols):
            raise ValueError("row/column id length mismatch")
        if not len(rows):
            return np.empty(0, dtype=np.uint64)
        min_col = self.slice * SLICE_WIDTH
        if (int(cols.min()) < min_col
                or int(cols.max()) >= min_col + SLICE_WIDTH):
            raise ValueError("column out of bounds")
        positions = rows * np.uint64(SLICE_WIDTH) + (
            cols % np.uint64(SLICE_WIDTH))
        return self._mutate_batch_positions(positions, set)

    def _mutate_batch_positions(self, positions: np.ndarray,
                                set: bool) -> np.ndarray:
        row_shift = np.uint64(SLICE_WIDTH.bit_length() - 1)
        with self._mu:
            changed = self.storage.apply_batch(positions, set=set,
                                               wal=True)
            if not len(changed):
                return changed
            self._epoch += 1
            ch_rows = np.unique(changed >> row_shift)
            for rid, cnt in zip(ch_rows.tolist(),
                                self._row_counts_of(ch_rows).tolist()):
                self.row_cache.invalidate(rid)
                self.cache.bulk_add(rid, cnt)
            self.cache.invalidate()
            self.device.invalidate_rows(ch_rows.tolist())
            self._increment_op_n()
            return changed

    def _increment_op_n(self) -> None:
        # locked() is a racy peek, benign both ways: a stale False just
        # try-acquires (and fails fast) inside _snapshot_async; a stale
        # True means the NEXT op re-triggers.
        if self.storage.op_n > MAX_OP_N and not self._snap_mu.locked():
            self.snapshot(sync=False)

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

    def clear_positions(self, positions: np.ndarray) -> np.ndarray:
        """Batched clear of slice-local bit positions through the WAL'd
        batch lane (the BSI value import clears the stale planes of
        re-imported columns with it). Returns the changed positions."""
        return self._mutate_batch_positions(
            np.asarray(positions, dtype=np.uint64), set=False)

    def import_positions(self, positions: np.ndarray) -> None:
        """Bulk import of slice-local bit positions (row*SLICE_WIDTH +
        col%SLICE_WIDTH), through one of three lanes:

        - a small import into a large fragment (16 × its positions
          below the container count) takes the WAL'd batch lane: the
          rows whose count changed are added to the count cache and the
          rankings invalidated;
        - otherwise one blob of add records is appended to the WAL
          (WAL-first) and the positions bulk-added, every touched row
          added to the count cache and the rankings recalculated; the
          snapshot moves to the MAX_OP_N cadence;
        - past _WAL_IMPORT_MAX_BYTES of records the bulk add runs with
          the op writer detached and a sync snapshot persists it.

        The first two end in a commit barrier."""
        positions = np.asarray(positions, dtype=np.uint64)
        with self._mu:
            small = len(positions) * 16 < len(self.storage.keys)
        if small:
            self._mutate_batch_positions(positions, set=True)
            self.wal_barrier()
            return
        wal_first = (len(positions) * roaring.OP_SIZE
                     <= _WAL_IMPORT_MAX_BYTES)
        with self._mu:
            self._epoch += 1
            if wal_first:
                roaring._wal_write(self.storage.op_writer,
                                   roaring._wal_blob(positions,
                                                     roaring.OP_ADD))
                self.storage.op_n += max(
                    1, len(positions) // _BLOB_OP_WEIGHT)
                self.storage.add_many(positions)
            else:
                writer, self.storage.op_writer = \
                    self.storage.op_writer, None
                try:
                    self.storage.add_many(positions)
                finally:
                    self.storage.op_writer = writer
            # Cardinality-adaptive representation pass (run containers),
            # restricted to containers this block put an ADJACENT value
            # pair into: run-shaped data carries its adjacency in the
            # import block itself.
            srt = (positions if len(positions) < 2
                   or positions[0] <= positions[-1] else None)
            srt = np.sort(positions) if srt is None else srt
            adj = np.flatnonzero(np.diff(srt) == np.uint64(1))
            if len(adj):
                self.storage.optimize(
                    arrays_mod.sort_dedupe(srt[adj] >> np.uint64(16)))
            rows = arrays_mod.sort_dedupe(positions
                                          // np.uint64(SLICE_WIDTH))
            for rid, cnt in zip(rows.tolist(),
                                self._row_counts_of(rows).tolist()):
                self.cache.bulk_add(rid, cnt)
            self.cache.recalculate()
            self.row_cache.clear()
            self.device.invalidate_all()
        # Outside _mu: the sync snapshot takes _snap_mu then _mu.
        if wal_first:
            with self._mu:
                self._increment_op_n()
            self.wal_barrier()
        else:
            self.snapshot()

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

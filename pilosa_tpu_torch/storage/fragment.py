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

The anti-entropy half (``blocks``, ``block_data``, ``merge_block``):
SHA1 block checksums of 100-row blocks and the majority merge, the JAX
package's bytes and semantics; a merge's local diff goes through the
WAL'd batch lane.

Storage integrity (the JAX package's, storage.integrity): a data file
whose footer, header or body contradicts its checksums at open — or no
longer parses — QUARANTINES the fragment instead of failing the open.
The file moves aside to ``<path>.corrupt`` (forensics, and the sentinel
that re-quarantines at the next open until a repair removes it), a fresh
empty snapshot takes its place so writes keep buffering through the WAL,
and the holder's QuarantineRegistry tells the executor to serve the
slice from a replica. The first read after an open re-checks every
container block's crc against the footer (``_verify_on_read``);
``verify_on_disk`` is the scrubber's pass (storage.scrub) and
``reset_for_repair`` / ``clear_quarantine`` the repairer's
(server.repair). The ``storage.read`` and ``snapshot.write`` failpoints
sit where the JAX package has them, and a snapshot that fails with
ENOSPC flips the node write-unready (fault.diskfull).

Left out of the copy: tiering, the stats, and the incremental per-row
count map (a write recounts its rows). Bits written are charged to the
current query's cost ledger (obs.accounting) at the three sites the JAX
package charges them.
"""

from __future__ import annotations

import fcntl
import hashlib
import heapq
import logging
import math
import mmap
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..fault import failpoints as _fp
from ..obs import accounting as _accounting
from ..obs import metrics as obs_metrics
from ..parallel.residency import DeviceRowCache
from ..proto import internal as pb
from ..utils import arrays as arrays_mod
from . import cache as cache_mod
from . import integrity as integrity_mod
from . import roaring
from . import wal as wal_mod
from .bitmap import Bitmap
from .cache import Pair

_LOG = logging.getLogger("pilosa_tpu_torch.storage")

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


# Rows per anti-entropy checksum block (reference fragment.go HashBlockSize).
HASH_BLOCK_SIZE = 100


@dataclass
class PairSet:
    """Parallel row/column id arrays (reference fragment.go PairSet)."""
    row_ids: np.ndarray
    column_ids: np.ndarray


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
                 row_attr_store=None, wal_fsync: str = wal_mod.FSYNC_NONE,
                 quarantine=None):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        self.wal_fsync = wal_fsync
        # Storage integrity (storage.integrity): the holder-level
        # quarantine registry (None for bare library fragments), the
        # quarantine flag gating the READ path, and the lazy first-read
        # verification latch (armed on every open of a footered
        # snapshot; one attr check on the read hot path).
        self.quarantine = quarantine
        self.quarantined = False
        self.quarantine_reason = ""
        self._verify_pending = False
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
        self._blocks = None  # (epoch, block checksums), see blocks()
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
            self._open_storage_quarantining(verify=True)
            if not self.quarantined and os.path.exists(
                    self.path + ".corrupt"):
                # A prior quarantine replaced the data file with a fresh
                # one and the process died before the repair completed:
                # the aside file is the crash-safe sentinel. Without it
                # a restart would serve the near-empty replacement as
                # authoritative. The repairer removes the sentinel when
                # the replica re-stream verifies clean.
                self._set_quarantined(
                    "pending repair (restart before repair completed)",
                    site="open")
            self._open_cache()
            self._open = True

    def _open_storage_quarantining(self, verify: bool = False) -> None:
        """_open_storage, but a file whose bytes contradict their
        checksums (or no longer parse at all) QUARANTINES the fragment
        instead of failing the open: the corrupt file moves aside
        (``<path>.corrupt``, for forensics and ``check --deep``), a
        fresh empty snapshot takes its place so writes keep buffering
        through the WAL, reads fail over to a replica (the executor
        consults the registry), and the repairer re-streams the
        content (server.repair)."""
        try:
            self._open_storage(verify=verify)
        except (ValueError, integrity_mod.CorruptionError) as e:
            self._close_storage()
            try:
                os.replace(self.path, self.path + ".corrupt")
            except FileNotFoundError:
                pass
            self._open_storage()
            self._set_quarantined(f"open: {e}", site="open")

    def _open_storage(self, verify: bool = False) -> None:
        # Open (creating) the data file, flock it, seed an empty file
        # with a footered empty snapshot, map, replay snapshot + op-log,
        # then attach the WAL as the op writer (reference
        # fragment.go:179-234). buffering=0: the WAL's leader write
        # reaches the OS in one syscall. The ``storage.read`` failpoint
        # is the deterministic injection site for on-disk corruption
        # (corrupt mode flips real bits in the file before it is read
        # back).
        if _fp.ACTIVE is not None:
            _fp.ACTIVE.hit("storage.read", path=self.path)
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
        # Arm the lazy per-block verification: the first READ after an
        # open re-checks every container block's crc against the mmap;
        # until then only the footer and header crcs have been checked.
        self._verify_pending = self.storage.footer is not None
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

    # -- storage integrity (storage.integrity) -------------------------------

    def _set_quarantined(self, reason: str, site: str) -> None:
        """Mark this fragment's local copy untrustworthy: the executor
        stops serving its slice locally (reads fail over to a replica),
        anti-entropy stops letting it vote, and the repairer re-streams
        it from a replica. Writes keep applying (WAL-buffered) — they
        also fan out to every replica owner, so the repaired copy
        includes them."""
        obs_metrics.STORAGE_CORRUPTION.labels(site).inc()
        self.quarantined = True
        self.quarantine_reason = reason
        # Tail sampling: the query that tripped over the corruption is
        # keep-worthy evidence (obs.sampler reason "corruption").
        from ..sched import context as sched_context
        ctx = sched_context.current()
        if ctx is not None:
            ctx.note_flag("corruption")
        if self.quarantine is not None:
            if self.quarantine.add(self, reason):
                obs_metrics.STORAGE_QUARANTINED.inc()
            obs_metrics.STORAGE_QUARANTINED_LIVE.set(len(self.quarantine))
        else:
            obs_metrics.STORAGE_QUARANTINED.inc()

    def clear_quarantine(self) -> None:
        """Repair complete: the local copy is trustworthy again. The
        ``.corrupt`` aside file goes too — it doubles as the crash-safe
        quarantine sentinel (see open()), so leaving it would
        re-quarantine a REPAIRED fragment at the next restart."""
        try:
            os.remove(self.path + ".corrupt")
        except FileNotFoundError:
            pass
        except OSError as e:
            _LOG.warning(
                "fragment: could not remove quarantine sentinel"
                " %s.corrupt (%s) — the fragment will re-quarantine"
                " at the next restart until it is removed",
                self.path, e)
        self.quarantined = False
        self.quarantine_reason = ""
        if self.quarantine is not None:
            self.quarantine.remove(self)
            obs_metrics.STORAGE_QUARANTINED_LIVE.set(len(self.quarantine))

    def _verify_on_read(self) -> None:
        """Lazy per-block verification on the FIRST read after an open:
        one crc pass over the container blocks against the footer
        table, then free. A mismatch quarantines and raises — the
        executor re-maps the slice onto a healthy replica (the same
        machinery as a failed remote leg)."""
        if not self._verify_pending:
            return
        self._verify_pending = False
        info = getattr(self.storage, "footer", None)
        mm = self._mmap
        if info is None or mm is None:
            return
        bad = integrity_mod.verify_blocks(mm, info)
        obs_metrics.STORAGE_SCRUB_BLOCKS.labels("read").inc(info.block_n)
        if bad:
            self._set_quarantined(
                f"container block crc mismatch (blocks {bad[:4]},"
                f" {len(bad)} total)", site="read")
            raise integrity_mod.CorruptionError(
                f"fragment {self.index}/{self.frame}/{self.view}/"
                f"{self.slice}: {len(bad)} container blocks fail crc")

    def verify_on_disk(self) -> dict:
        """Re-read the data FILE and verify footer + blocks + WAL tail
        — the scrubber's per-fragment pass (storage.scrub). Opens its
        own fd (an os.replace swap pins the old inode, so the read is a
        consistent append-only prefix), sizes it under the fragment lock
        after a commit barrier, and quarantines on any corruption
        verdict."""
        from . import scrub as scrub_mod
        try:
            self.wal_barrier()
        except wal_mod.WalError:
            pass  # torn pending tail: the flushed prefix still verifies
        if _fp.ACTIVE is not None:
            # The scrub leg's deterministic corruption injection site.
            _fp.ACTIVE.hit("storage.read", path=self.path)
        try:
            f = open(self.path, "rb")
        except OSError as e:
            return {"error": f"unreadable: {e}", "coverage": "none"}
        try:
            with self._mu:
                size = os.fstat(f.fileno()).st_size
            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
            try:
                mv = memoryview(mm)
                try:
                    verdict = scrub_mod.scrub_buffer(mv[:size])
                finally:
                    del mv
            finally:
                try:
                    mm.close()
                except BufferError:
                    # A view into the map outlived the verify: a stack
                    # sampler (the continuous profiler) can hold the
                    # returned frame, and its numpy views, for a moment.
                    # The map is released with its last view; the
                    # verdict stands (the JAX package's close raises
                    # here and the scrubber skips the fragment).
                    pass
        finally:
            f.close()
        if verdict.get("corrupt"):
            self._set_quarantined(
                f"scrub: {verdict.get('error', 'checksum mismatch')}",
                site="scrub")
        return verdict

    def reset_for_repair(self) -> None:
        """Drop the suspect local state ahead of a replica re-stream
        (server.repair): the data file moves aside to ``.corrupt``, a
        fresh footered empty snapshot takes its place, and every derived
        cache resets. Writes racing this land in the fresh WAL; reads
        stay quarantined until the repairer verifies the streamed copy
        and clears the flag. Lock order: _snap_mu (waits out any
        background snapshot worker) then _mu."""
        with self._snap_mu, self._mu:
            if not self._open:
                return
            self._close_storage()
            try:
                aside = self.path + ".corrupt"
                if os.path.exists(aside):
                    # An open-time quarantine already moved the original
                    # corrupt bytes aside; keep THAT forensics file.
                    os.remove(self.path)
                else:
                    os.replace(self.path, aside)
            except FileNotFoundError:
                pass
            self._open_storage()
            self._epoch += 1
            self.row_cache.clear()
            self.device.invalidate_all()
            self._src_counts.clear()
            self._cache_complete = False
            self.cache = cache_mod.new_cache(self.cache_type,
                                             self.cache_size)

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
            try:
                with open(tmp, "wb") as f:
                    self.storage.write_to(f, footer=True)
                    # The hit sits AFTER the body write so corrupt mode
                    # can flip real bits in the just-written snapshot
                    # (error/torn/enospc leave the tmp file discarded
                    # and the old file the record).
                    if _fp.ACTIVE is not None:
                        _fp.ACTIVE.hit("snapshot.write", writer=f)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError as e:
                # A full disk flips the node write-unready
                # (fault.diskfull: writes answer 507, reads keep
                # serving) before the failure propagates; the old
                # snapshot + WAL stays the file of record.
                from ..fault import diskfull as _diskfull
                _diskfull.note_if_enospc(e, "snapshot.write", self.path)
                raise
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
            # Quarantining reopen: a snapshot that landed corrupt
            # (failpoint corrupt mode, bit rot in the write path)
            # degrades to quarantine + repair, not a broken fragment.
            self._open_storage_quarantining()
            return
        self.storage.op_writer = None
        os.replace(tmp, self.path)
        try:
            new_file = open(self.path, "a+b", buffering=0)
            fcntl.flock(new_file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BaseException:
            self._close_storage()
            self._open_storage_quarantining()
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
                    # Crash-mid-snapshot injection: a fault here leaves
                    # a partial tmp file that is never swapped in.
                    # Corrupt mode flips real bits in the written body,
                    # which the open-time and scrub checks catch.
                    if _fp.ACTIVE is not None:
                        _fp.ACTIVE.hit("snapshot.write", writer=f)
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
            except OSError as e:
                # Pre-swap IO failure: op_writer was never detached, the
                # old snapshot+WAL remains the file of record, and the
                # next MAX_OP_N trigger retries. ENOSPC also flips the
                # node write-unready (fault.diskfull), so the retry
                # pressure stops at the HTTP layer with 507s.
                from ..fault import diskfull as _diskfull
                _diskfull.note_if_enospc(e, "snapshot.write", self.path)
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
            self._verify_on_read()
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
            self._verify_on_read()
            if cached:
                out[:] = self.device.host_row_words(self.storage, row_id)
            else:
                pack_storage_row(self.storage, row_id, out)
        return out

    def row_count(self, row_id: int) -> int:
        return self.storage.count_range(row_id * SLICE_WIDTH,
                                        (row_id + 1) * SLICE_WIDTH)

    def fold_rows(self, op: str, row_ids: list[int]) -> np.ndarray:
        """Slice-local columns of a left fold of ``op`` over the given
        rows, gathered from the rows' container key spans in one
        vectorized pass instead of one roaring merge a row (the
        reference folds row by row, executor.go:253-268).

        Semantics match the sequential fold: ``or`` = union of all;
        ``and`` = columns present in every distinct row; ``andnot`` =
        the first row minus the union of the rest."""
        if op not in ("or", "and", "andnot"):
            raise ValueError(f"unknown fold op: {op!r}")
        if not row_ids:
            return np.empty(0, dtype=np.uint64)
        with self._mu:
            self._verify_on_read()
            w = np.uint64(SLICE_WIDTH)
            ids = np.unique(np.asarray(row_ids, dtype=np.uint64))
            # A row covers SLICE_WIDTH / 65536 consecutive container keys.
            shift = np.uint64((SLICE_WIDTH // 65536).bit_length() - 1)
            positions = self.storage.positions_for_key_ranges(
                ids << shift, (ids + np.uint64(1)) << shift)
        if not len(positions):
            return np.empty(0, dtype=np.uint64)
        rows = positions // w
        cols = positions % w
        if op == "or":
            return np.unique(cols)
        if op == "and":
            uniq, counts = np.unique(cols, return_counts=True)
            # (row, col) pairs are distinct: a column's count is the
            # number of rows holding it.
            return uniq[counts == len(ids)]
        # andnot: the sequential left-to-right difference is the first
        # row minus the union of the rest; a repeat of the first row
        # later in the list subtracts it from itself.
        first = np.uint64(row_ids[0])
        if any(np.uint64(r) == first for r in row_ids[1:]):
            return np.empty(0, dtype=np.uint64)
        first_cols = np.unique(cols[rows == first])
        rest_cols = np.unique(cols[rows != first])
        return first_cols[~np.isin(first_cols, rest_cols,
                                   assume_unique=True)]

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
        _accounting.note_bits_written(1)
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
            _accounting.note_bits_written(len(changed))
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
            _accounting.note_bits_written(len(positions))
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

    # -- block checksums and the majority merge (anti-entropy) ----------------

    def checksum(self) -> bytes:
        """Whole-fragment checksum = SHA1 over the block checksums
        (reference fragment.go:679-687)."""
        h = hashlib.sha1()
        for _bid, chk in self.blocks():
            h.update(chk)
        return h.digest()

    def blocks(self) -> list[tuple[int, bytes]]:
        """(block_id, sha1) for every non-empty 100-row block
        (reference fragment.go:704-767): SHA1 of the block's big-endian
        u64 positions, the JAX package's (and the reference's
        blockHasher's) bytes. Cached per mutation epoch."""
        with self._mu:
            hit = self._blocks
            if hit is not None and hit[0] == self._epoch:
                return hit[1]
            values = self.storage.all_positions()
            out = []
            if len(values):
                block_ids = values // np.uint64(HASH_BLOCK_SIZE
                                                * SLICE_WIDTH)
                bounds = np.flatnonzero(np.diff(block_ids)) + 1
                starts = np.concatenate(([0], bounds)).tolist()
                ends = np.concatenate((bounds, [len(values)])).tolist()
                for s, e in zip(starts, ends):
                    out.append((int(block_ids[s]), hashlib.sha1(
                        values[s:e].astype(">u8").tobytes()).digest()))
            self._blocks = (self._epoch, out)
            return out

    def block_data(self, block_id: int) -> PairSet:
        """The bits of one block as (row, slice-local column) arrays
        (reference fragment.go:785-795)."""
        span = HASH_BLOCK_SIZE * SLICE_WIDTH
        with self._mu:
            vals = self.storage.slice_range(block_id * span,
                                            (block_id + 1) * span)
        return PairSet(vals // np.uint64(SLICE_WIDTH),
                       vals % np.uint64(SLICE_WIDTH))

    def merge_block(self, block_id: int, data: list[PairSet]
                    ) -> tuple[list[PairSet], list[PairSet]]:
        """Majority merge of one block against peer copies (reference
        fragment.go:802-920, vectorized as in the JAX package): a bit
        ends set iff at least half of the ``len(data) + 1`` copies have
        it, so with two replicas the merge is a union. The local diff
        is applied here through the WAL'd batch lane and committed;
        returns the (sets, clears) diff of each peer."""
        for ps in data:
            if len(ps.row_ids) != len(ps.column_ids):
                raise ValueError("pair set mismatch")
        W = np.uint64(SLICE_WIDTH)
        with self._mu:
            local = self.block_data(block_id)
            copies = [local] + list(data)
            min_row = block_id * HASH_BLOCK_SIZE
            max_row = (block_id + 1) * HASH_BLOCK_SIZE
            positions = []
            for ps in copies:
                rows = np.asarray(ps.row_ids, dtype=np.uint64)
                cols = np.asarray(ps.column_ids, dtype=np.uint64)
                keep = ((rows >= np.uint64(min_row))
                        & (rows < np.uint64(max_row)) & (cols < W))
                # One vote per copy, even for a pair repeated on the wire.
                positions.append(np.unique(rows[keep] * W + cols[keep]))
            uniq, counts = np.unique(np.concatenate(positions),
                                     return_counts=True)
            want = counts >= (len(copies) + 1) // 2
            sets_out, clears_out = [], []
            for pos in positions:
                has = np.isin(uniq, pos, assume_unique=True)
                to_set = uniq[want & ~has]
                to_clear = uniq[~want & has]
                sets_out.append(PairSet(to_set // W, to_set % W))
                clears_out.append(PairSet(to_clear // W, to_clear % W))
            local_set = sets_out[0].row_ids * W + sets_out[0].column_ids
            local_clear = (clears_out[0].row_ids * W
                           + clears_out[0].column_ids)
            if len(local_set):
                self._mutate_batch_positions(local_set, set=True)
            if len(local_clear):
                self._mutate_batch_positions(local_clear, set=False)
        if len(local_set) or len(local_clear):
            # Anti-entropy acks the merge to its peers: commit first.
            self.wal_barrier()
        return sets_out[1:], clears_out[1:]

    # -- the fragment as a tar stream (/fragment/data) ------------------------

    def write_to(self, w) -> None:
        """Stream the fragment as the reference's tar archive of ``data``
        (the snapshot and WAL file bytes) and ``cache`` (the count
        cache's id sidecar), the JAX package's format
        (fragment.go:1113-1155). The data file's size is taken under the
        lock through an fd opened first: a concurrent snapshot replaces
        the path, but the old inode only ever grew by appended ops, so
        that many bytes are a consistent snapshot + WAL prefix."""
        import tarfile
        from ..utils.streams import CappedReader
        self.flush_cache()
        self.wal_barrier()
        tw = tarfile.open(fileobj=w, mode="w|")
        with open(self.path, "rb") as f:
            with self._mu:
                size = os.fstat(f.fileno()).st_size
            info = tarfile.TarInfo("data")
            info.size, info.mode = size, 0o600
            tw.addfile(info, CappedReader(f, size))
        info = tarfile.TarInfo("cache")
        info.mode = 0o600
        try:
            with open(self.cache_path, "rb") as f:
                info.size = os.fstat(f.fileno()).st_size
                tw.addfile(info, f)
        except FileNotFoundError:
            info.size = 0
            tw.addfile(info)
        tw.close()

    def read_from(self, r) -> None:
        """Replace the fragment from a ``write_to`` tar stream: the data
        file swapped in whole, storage reopened, the cache reloaded."""
        import io
        import shutil
        import tarfile
        tr = tarfile.open(fileobj=r, mode="r|")
        # _snap_mu first (lock order): no late snapshot may splice a
        # pre-restore body over the restored file.
        with self._snap_mu, self._mu:
            for info in tr:
                src = tr.extractfile(info) or io.BytesIO()
                if info.name == "data":
                    self._close_storage()
                    tmp = self.path + ".restoring"
                    try:
                        with open(tmp, "wb") as f:
                            shutil.copyfileobj(src, f)
                            f.flush()
                            os.fsync(f.fileno())
                        os.replace(tmp, self.path)
                    finally:
                        # A torn upload leaves the old file in place.
                        self._open_storage()
                    self._epoch += 1
                    self.row_cache.clear()
                    self.device.invalidate_all()
                elif info.name == "cache":
                    with open(self.cache_path, "wb") as f:
                        shutil.copyfileobj(src, f)
                    self.cache = cache_mod.new_cache(self.cache_type,
                                                     self.cache_size)
                    self._cache_flushed = None
                    self._open_cache()

    # -- device upload feeds -------------------------------------------------

    def sparse_row_pairs(self, row_id: int):
        """(word idx, word value) pairs for one row, under the fragment
        lock — the extraction feeding device uploads (ops.packed)."""
        from ..ops import packed
        with self._mu:
            self._verify_on_read()
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

    def container_stats(self) -> dict:
        """Per-kind container counts/resident bytes/run intervals
        (roaring.Bitmap.container_stats), cached per mutation epoch —
        the runtime collector samples every open fragment on its
        cadence, and the walk is O(containers)."""
        hit = getattr(self, "_container_stats", None)
        if hit is not None and hit[0] == self._epoch:
            return hit[1]
        with self._mu:
            stats = self.storage.container_stats()
        self._container_stats = (self._epoch, stats)
        return stats

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
            self._verify_on_read()
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

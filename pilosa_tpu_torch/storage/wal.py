"""Group-committed write-ahead log: buffered appends, one leader flush.

Trimmed copy of the JAX package's ``storage/wal.py``, the classic
database group commit applied to the fragment op-log:

- ``append(blob)`` copies the record(s) into an in-memory pending
  buffer and returns a **sequence number** (the byte offset the record
  ends at). No syscall. Appends are serialized by the owning
  fragment's mutation lock plus this object's own lock, so sequence
  order IS file order.
- ``flush(seq)`` blocks until everything up to ``seq`` is in the OS
  (and fsynced, per policy). The first waiter becomes the **leader**:
  it swaps the pending buffer out, issues ONE ``write()`` (and at most
  one ``fsync``) for the whole batch, then wakes every follower whose
  records the batch covered. Writers that arrive mid-flush land in the
  next batch.
- A shared background flusher bounds how long un-barriered records can
  linger in userspace (``WINDOW_S``, 2 ms). It is a daemon thread that
  exits once no WAL is dirty and is started again by the next append.

Durability contract: a mutation is **acked** when its commit barrier
returns — the serving layer calls ``barrier_all()`` before
acknowledging any write request (acked ⇒ record in the OS, surviving
process death). The fsync policy, a constructor argument threaded from
``Server(wal_fsync=...)`` down to each fragment, upgrades that to
power-loss durability:

    "none"    (default) flush = write(); fsync only at snapshot
    "group"   commit barriers fsync the batch: acked ⇒ on stable
              storage, one fsync per leader flush
    "always"  every leader flush fsyncs

A failed/torn leader write truncates the file back to the durable
prefix (appended bytes are always past the open-time mmap length, so
mapped views stay valid), keeps the whole batch pending, and raises
``WalError`` to its waiters — the ops are unacked but retryable, and a
later barrier re-writes the batch cleanly. Only if the truncate itself
fails does the log fail-stop until the next snapshot swap hands it a
fresh file. A real crash (no truncate) leaves a torn tail that reopen
trims to the last complete record — never past an acked one.

The leader flush carries the ``wal.append`` failpoint (fault.failpoints:
a torn batch, an injected error or ENOSPC), and a leader write that
fails with ENOSPC flips the node write-unready (fault.diskfull) while a
successful one clears it. Left out of the copy: the WAL archive sink
(backup), the flusher health report and the WAL metrics. None of them
changes what is durable or when.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..fault import diskfull as _diskfull
from ..fault import failpoints as _fp

OP_SIZE = 13  # one op record (storage.roaring.OP_SIZE; kept in sync)

# Pending bytes past which append() flushes inline instead of letting
# the buffer grow unboundedly (a 10M-bit import would otherwise hold
# 130 MB of records in userspace before its barrier).
_BUF_MAX = 1 << 18

FSYNC_NONE = "none"
FSYNC_GROUP = "group"
FSYNC_ALWAYS = "always"
FSYNC_POLICIES = (FSYNC_NONE, FSYNC_GROUP, FSYNC_ALWAYS)

# How long an un-barriered record may sit in the pending buffer before
# the background flusher writes it (the JAX package's default window).
WINDOW_S = 0.002


def check_fsync_policy(policy: str) -> str:
    if policy not in FSYNC_POLICIES:
        raise ValueError(f"wal_fsync must be one of {FSYNC_POLICIES},"
                         f" not {policy!r}")
    return policy


class WalError(OSError):
    """A leader flush failed; records past the durable prefix are in
    memory only until the next snapshot swap resets the log."""


class GroupCommitWal:
    """One fragment op-log with group-committed appends (see module
    docstring). Presents ``write()`` so it can stand wherever a plain
    file-like op writer did."""

    __slots__ = ("_file", "_base", "_mu", "_cond", "_pending",
                 "_seq_appended", "_seq_flushed", "_seq_synced",
                 "_leader", "_fail", "_registered", "fsync_policy",
                 "closed")

    def __init__(self, file, fsync_policy: str = FSYNC_NONE):
        self._file = file
        # File offset where this WAL's records begin (current EOF):
        # seq s lives at byte _base + s, which is how a failed leader
        # write can ftruncate back to exactly the durable prefix.
        self._base = file.seek(0, os.SEEK_END) if file is not None else 0
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._pending = bytearray()
        # Sequence numbers are cumulative appended-byte counts since
        # attach — monotone across file swaps.
        self._seq_appended = 0
        self._seq_flushed = 0
        self._seq_synced = 0
        self._leader = False
        self._fail: Optional[BaseException] = None
        self._registered = False  # in the process dirty set
        self.fsync_policy = check_fsync_policy(fsync_policy)
        self.closed = False

    # -- append (the mutation hot path) --------------------------------------

    def append(self, blob: bytes) -> int:
        """Buffer ``blob`` (one or more whole op records); returns the
        commit sequence to pass to ``flush``. No syscall unless the
        pending buffer is past ``_BUF_MAX``."""
        with self._mu:
            self._pending += blob
            self._seq_appended += len(blob)
            seq = self._seq_appended
            big = len(self._pending) >= _BUF_MAX
            if not self._registered:
                # Register BEFORE any inline flush: _registered must
                # imply dirty-set membership, or a racing append that
                # lands mid-leader-write leaves pending records no
                # barrier_all()/flusher pass can see (registry lock is
                # a leaf, safe under _mu).
                self._registered = True
                _register_dirty(self)
        if big:
            self.flush(seq, sync=self.fsync_policy == FSYNC_ALWAYS)
        return seq

    # File-like compatibility: roaring._wal_write calls writer.write().
    write = append

    def pending_bytes(self) -> int:
        with self._mu:
            return len(self._pending)

    def durable_seq(self) -> int:
        with self._mu:
            return self._seq_flushed

    # -- flush / commit barrier ----------------------------------------------

    def flush(self, seq: Optional[int] = None,
              sync: Optional[bool] = None) -> None:
        """Block until everything up to ``seq`` (default: everything
        appended so far) is written to the OS — and fsynced when
        ``sync`` (default: per the fsync policy). First waiter leads;
        the rest follow. Raises the leader's error if its write
        failed."""
        if sync is None:
            sync = self.fsync_policy != FSYNC_NONE
        with self._mu:
            if seq is None:
                seq = self._seq_appended
            while True:
                if self.closed:
                    # A closed WAL never writes again: the orderly
                    # close barriers BEFORE closing, so anything still
                    # pending here is an abandoned batch the background
                    # flusher must not resurrect onto the old fd.
                    return
                if self._fail is not None and seq > self._seq_flushed:
                    raise WalError("wal: group flush failed") \
                        from self._fail
                if (self._seq_flushed >= seq
                        and (not sync or self._seq_synced >= seq)):
                    if not self._pending and self._registered:
                        # A racing append's deferred registration can
                        # land after the flush that drained it; clear
                        # the stale entry (registry lock is a leaf).
                        self._registered = False
                        _deregister_dirty(self)
                    return
                if not self._leader:
                    break
                # A leader is mid-flush: wait for it, then re-check.
                self._cond.wait()
            # Become the leader. Pending stays intact until the write
            # SUCCEEDS — a failed/torn write truncates the file back to
            # the durable prefix and the whole batch remains queued.
            self._leader = True
            batch = bytes(self._pending)
            flushed_before = self._seq_flushed
            file = self._file
        err: Optional[BaseException] = None
        recovered = False
        try:
            if batch:
                if _fp.ACTIVE is not None:
                    # The torn-write injection point: a crash mid group
                    # commit tears the GROUPED batch at an arbitrary
                    # byte offset, not one record.
                    _fp.ACTIVE.hit("wal.append", writer=file, data=batch)
                file.write(batch)
            if sync and not self.closed:
                os.fsync(file.fileno())
        except BaseException as e:  # noqa: BLE001 — must wake waiters
            err = e
            # A full disk is a NODE condition, not this WAL's: flip the
            # process write-unready (fault.diskfull) so the serving
            # layer answers 507 + Retry-After. The batch stays pending
            # either way — recovery retries it cleanly.
            _diskfull.note_if_enospc(e, "wal.append",
                                     getattr(file, "name", None))
            try:
                # An arbitrary prefix of the batch may be on disk; cut
                # the file back to the durable prefix so retries (and
                # crash replay) see only whole acked records.
                os.ftruncate(file.fileno(), self._base + flushed_before)
                recovered = True
            except Exception:  # noqa: BLE001 — fail-stop until the swap
                recovered = False
        else:
            if batch:
                # A durable write succeeded: the cheapest recovery
                # signal when the node was write-unready.
                _diskfull.note_write_ok()
        with self._mu:
            self._leader = False
            if err is None:
                del self._pending[:len(batch)]
                self._seq_flushed = flushed_before + len(batch)
                if sync:
                    self._seq_synced = self._seq_flushed
            elif not recovered:
                self._fail = err
            self._cond.notify_all()
            if err is not None:
                raise WalError("wal: group flush failed") from err
            if self._pending:
                # Another batch formed while we wrote; the WAL stays
                # registered and the flusher re-arms on it.
                _flusher_wake.set()
                return
            # Clear-and-discard atomically under _mu: a racing append
            # re-registering in between would otherwise be discarded.
            self._registered = False
            _deregister_dirty(self)

    def barrier(self) -> None:
        """Commit barrier at the configured durability level: returns
        once every record appended so far is durable per policy."""
        self.flush(None, sync=self.fsync_policy != FSYNC_NONE)

    # -- lifecycle -----------------------------------------------------------

    def reset_file(self, file, clear_pending: bool = False) -> None:
        """Swap the backing file (snapshot rename path). The caller
        guarantees no appends are racing (fragment holds its mutation
        lock) and that pending records were either flushed to the OLD
        file or are covered by the new snapshot body
        (``clear_pending``). Clears any failed state: the new file is
        clean."""
        with self._mu:
            self._file = file
            self._fail = None
            if clear_pending:
                self._pending.clear()
                self._seq_flushed = self._seq_appended
                self._seq_synced = self._seq_appended
            # seq s lives at byte _base + s of the NEW file: its end is
            # where the next flushed record goes. (The JAX package sets
            # _base to the file's size here, so a failed leader write
            # after a snapshot swap truncates to size + every sequence
            # byte ever flushed — a hole of zeros that fails the WAL's
            # checksums at the next open.)
            self._base = ((file.seek(0, os.SEEK_END) if file is not None
                           else 0) - self._seq_flushed)
            if file is None:
                self._registered = False
                _deregister_dirty(self)

    def close(self) -> None:
        with self._mu:
            self.closed = True
            self._cond.notify_all()  # release any blocked followers
            self._registered = False
            _deregister_dirty(self)
            with _dirty_mu:
                _failed.discard(self)


# -- process-wide dirty registry + barrier ------------------------------------
# Every WAL with un-flushed records registers here; the serving layer's
# ack point (write queries, imports) calls barrier_all() so the
# HTTP-level durability contract holds no matter how many fragments a
# request touched — and concurrent requests' barriers coalesce into
# one leader flush per WAL.

_dirty_mu = threading.Lock()
_dirty: set = set()
# WALs whose background flush failed: the flusher stops retrying them
# (a full disk would fail every window), but barrier_all() still flushes
# them, so an ack never goes out while a record it covers sits pending.
# (The JAX package drops such a WAL from its barrier too, so a write
# that appends nothing new — a retried SetBit answering false — acks
# with its record still in userspace.)
_failed: set = set()
# First moment each WAL went dirty (for flusher_health's dirty ages).
_dirty_since: dict = {}
_flusher: Optional[threading.Thread] = None
_flusher_wake = threading.Event()
# Flusher heartbeat: stamped at the top of every flusher pass.
_flusher_beat = 0.0


def _register_dirty(wal: GroupCommitWal) -> None:
    global _flusher
    with _dirty_mu:
        _dirty.add(wal)
        _dirty_since.setdefault(wal, time.monotonic())
        if _flusher is None:
            _flusher = threading.Thread(target=_flush_loop,
                                        name="wal-group-flusher",
                                        daemon=True)
            _flusher.start()
    _flusher_wake.set()


def _deregister_dirty(wal: GroupCommitWal) -> None:
    with _dirty_mu:
        _dirty.discard(wal)
        _dirty_since.pop(wal, None)


def flusher_health() -> dict:
    """The WAL flusher's vital signs (the ``wal`` block of
    ``/debug/cluster``): the dirty set with per-WAL pending bytes and
    dirty age (worst first), the oldest dirty age, and the heartbeat
    age."""
    now = time.monotonic()
    with _dirty_mu:
        items = [(w, t) for w, t in _dirty_since.items() if w in _dirty]
        beat = _flusher_beat
    wals = []
    for w, t in items:
        try:
            pending = w.pending_bytes()
        except Exception:  # noqa: BLE001 - a wedged WAL must still report
            pending = -1
        wals.append({"file": getattr(w._file, "name", None) or "?",
                     "pendingBytes": pending,
                     "dirtyAgeS": round(now - t, 4)})
    wals.sort(key=lambda e: -e["dirtyAgeS"])
    return {
        "dirtyWals": len(wals),
        "oldestDirtyAgeS": wals[0]["dirtyAgeS"] if wals else 0.0,
        "flusherBeatAgeS": (round(now - beat, 4) if beat else None),
        "windowS": WINDOW_S,
        "wals": wals[:8],
    }


def barrier_all() -> None:
    """Flush every dirty WAL at its configured durability level — the
    serving layer's pre-ack commit barrier — and every WAL whose
    background flush failed."""
    with _dirty_mu:
        wals = list(_dirty | _failed)
    for wal in wals:
        try:
            wal.barrier()
        except WalError:
            if not wal.closed:
                raise
        with _dirty_mu:
            _failed.discard(wal)


def _flush_loop() -> None:
    """Bounded-latency background flusher: any record a writer never
    barriers reaches the OS within ~one window (plus write time). The
    thread ends once no WAL is dirty; the next registration starts a
    new one (both decided under ``_dirty_mu``, so a registration never
    finds a flusher that is about to exit)."""
    global _flusher, _flusher_beat
    while True:
        _flusher_wake.wait()
        _flusher_wake.clear()
        time.sleep(WINDOW_S)
        with _dirty_mu:
            _flusher_beat = time.monotonic()
            wals = list(_dirty)
        for wal in wals:
            if wal.closed:
                with wal._mu:
                    wal._registered = False
                    _deregister_dirty(wal)
                continue
            try:
                wal.flush(None, sync=wal.fsync_policy == FSYNC_ALWAYS)
            except WalError:
                # Drop it from the dirty set so the loop doesn't retry
                # a failing disk every window — but clear _registered
                # with it, so the owner's NEXT append re-registers and
                # its barrier surfaces the error. The next barrier_all
                # retries it either way (_failed).
                with wal._mu:
                    wal._registered = False
                    with _dirty_mu:
                        _dirty.discard(wal)
                        _dirty_since.pop(wal, None)
                        _failed.add(wal)
        # Re-arm while anything stays dirty (a flush that early-returns
        # because a batch formed mid-write leaves records pending with
        # no new registration event to wake us); exit when clean.
        with _dirty_mu:
            if _dirty:
                _flusher_wake.set()
            else:
                _flusher = None
                return

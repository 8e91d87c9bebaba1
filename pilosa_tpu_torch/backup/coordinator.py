"""Crash-safe backup coordinator (journaled like cluster/resize.py).

One node drives a cluster-consistent backup end-to-end: per fragment,
a WAL-barriered footered snapshot is pulled over the resize transport
(``GET /fragment/data?snapshot=1`` — the owner folds its WAL into the
body first, so the pushed bytes verify against the snapshot footer),
verified, and decomposed into the archive's shared object pool.
Writes keep flowing during the backup; anything committed after a
fragment's snapshot travels via the continuous WAL archive
(backup.walarchive), which restore replays — so the restored state is
consistent AS OF the restore cut, not as of each fragment's
snapshot instant.

Consistency argument: an op record sets one position's membership
definitively (add→present, remove→absent) and the WAL archive
preserves per-fragment commit order, so replaying the archived op
history onto ANY prefix-folded snapshot of the same fragment converges
to the same state. The manifest records ``walStart`` (the per-node
next-segment watermark taken BEFORE the first snapshot): every op NOT
folded into some pushed snapshot lives in a segment ≥ walStart, and
re-applying ops that WERE folded is idempotent.

The journal (``backup.json`` under the data dir, tmp+fsync+rename,
coalesced to one write per _JOURNAL_COALESCE_S) makes a SIGKILLed
coordinator resumable: recovery
re-runs the same backup id under the journaled ``walStart``,
already-journaled fragments are reused, and the pool's exists-check
skips every object a previous attempt got durable — the whole push is
idempotent. The manifest write is the
single commit point; an id with no manifest is invisible to restore
and reclaimed by GC.
"""

from __future__ import annotations

import json
import os
import tarfile
import threading
import time
import uuid
from typing import Optional

from ..errors import PilosaError
from ..obs import metrics as obs_metrics
from ..storage import integrity as integrity_mod
from ..utils import logger as logger_mod
from . import archive as archive_mod

JOURNAL_FILE = "backup.json"

# Inter-fragment pacing (seconds) — the storage.scrub discipline:
# background work yields between fragments so it never monopolizes
# the serving path. Much longer than scrub's 10 ms because a backup
# STREAMS + re-verifies whole fragments (up to 128 MB each) where
# scrub only read-verifies; at 100 ms/fragment a 256-slice index
# pays ~26 s of pacing per pass — noise for a once-per-operator-
# request op, and what keeps the backup-while-serving p50 inside the
# ≤5% bound (benchmarks/suite.py config_backup).
DEFAULT_PACE_S = 0.1

# Journal-write coalescing window: per-fragment journal fsyncs were
# a per-pass disk tax on the serving path's disk; one fsync per
# window bounds what a SIGKILL re-pushes (exists-check skips) without
# it.
_JOURNAL_COALESCE_S = 0.5

PHASE_IDLE = "idle"
PHASE_SNAPSHOT = "snapshot"
PHASE_MANIFEST = "manifest"
PHASE_DONE = "done"
PHASE_FAILED = "failed"
PHASES = (PHASE_IDLE, PHASE_SNAPSHOT, PHASE_MANIFEST, PHASE_DONE,
          PHASE_FAILED)


def set_state_gauge(phase: str) -> None:
    """One-hot the backup-state gauge across the known phase labels."""
    for p in PHASES:
        obs_metrics.BACKUP_STATE.labels(p).set(
            1.0 if p == phase else 0.0)


class BackupError(PilosaError):
    pass


class BackupJournal:
    """Crash-safe record of the coordinator's progress: one JSON file
    under the data dir, rewritten atomically (tmp + fsync + rename)
    per phase and per coalescing window of fragments. ``Server.open``
    replays it — an in-flight backup resumes under the same id."""

    VERSION = 1

    def __init__(self, path: str):
        self.path = path
        self.state: dict = {}
        self._mu = threading.Lock()

    @classmethod
    def for_data_dir(cls, data_dir: str) -> "BackupJournal":
        return cls(os.path.join(data_dir, JOURNAL_FILE))

    def load(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                loaded = json.load(f)
        except (OSError, ValueError):
            return None
        if loaded.get("version") != self.VERSION:
            return None
        with self._mu:
            self.state = loaded
        return self.state

    def write(self, **updates) -> None:
        with self._mu:
            self.state.update(updates)
            self.state["version"] = self.VERSION
            self.state["updatedAt"] = time.time()
            snapshot = dict(self.state)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    def in_flight(self) -> bool:
        return self.state.get("phase") not in (None, PHASE_DONE,
                                               PHASE_FAILED)

    def clear(self) -> None:
        with self._mu:
            self.state = {}
            try:
                os.remove(self.path)
            except OSError:
                pass


class BackupCoordinator:
    """Drives one backup end-to-end against a live cluster. One at a
    time per node (Server.start_backup enforces it)."""

    def __init__(self, server, store, kind: str = "full",
                 backup_id: Optional[str] = None,
                 journal: Optional[BackupJournal] = None,
                 logger=None, pace_s: float = DEFAULT_PACE_S):
        self.server = server
        self.store = store
        self.kind = kind if kind in ("full", "incremental") else "full"
        # Inter-fragment pacing, the storage-scrub discipline: the
        # snapshot/digest/push work yields between fragments so a
        # backup in flight stays out of serving's way (the ≤5%
        # backup-while-serving bound in benchmarks/suite.py
        # config_backup is measured with this pacing).
        self.pace_s = max(0.0, float(pace_s))
        self.id = backup_id or uuid.uuid4().hex[:12]
        self.journal = journal or BackupJournal.for_data_dir(
            server.holder.path)
        self.logger = logger or getattr(server, "logger",
                                        logger_mod.NOP)
        self.phase = PHASE_IDLE
        self.error: Optional[str] = None
        self.fragments_done = 0
        self.fragments_skipped = 0
        self.objects_pushed = 0
        self.bytes_pushed = 0
        self.started_at = 0.0
        self.finished_at = 0.0
        # Watchdog progress signal (obs.watchdog "backup_stall"): any
        # forward step — a pushed fragment, a phase move — touches it.
        self.last_progress = time.monotonic()
        self._journal_at = 0.0  # last coalesced journal write
        self._mu = threading.Lock()
        self._cancel = threading.Event()

    # -- plumbing --------------------------------------------------------------

    def touch(self) -> None:
        self.last_progress = time.monotonic()

    def cancel(self) -> None:
        """Cooperative stop (server close / operator abort). The
        journal stays in flight — the next open RESUMES the backup
        rather than discarding its pushed objects."""
        self._cancel.set()

    def _check_cancel(self) -> None:
        if self._cancel.is_set():
            raise BackupError(f"backup {self.id}: cancelled")

    def _set_phase(self, phase: str, **journal_updates) -> None:
        if phase in (PHASE_DONE, PHASE_FAILED) and not self.finished_at:
            self.finished_at = time.time()
        with self._mu:
            self.phase = phase
        set_state_gauge(phase)
        self.touch()
        self.journal.write(phase=phase, **journal_updates)
        self.logger.printf("backup %s: phase %s", self.id, phase)

    def status(self) -> dict:
        with self._mu:
            phase = self.phase
        return {"id": self.id, "kind": self.kind, "phase": phase,
                "error": self.error,
                "fragments": self.fragments_done,
                "fragmentsSkipped": self.fragments_skipped,
                "objectsPushed": self.objects_pushed,
                "bytesPushed": self.bytes_pushed,
                "startedAt": self.started_at,
                "finishedAt": self.finished_at}

    # -- the run ---------------------------------------------------------------

    def run(self) -> None:
        self.started_at = time.time()
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - journaled verdict
            self.error = f"{type(e).__name__}: {e}"
            obs_metrics.BACKUP_ERRORS.labels("coordinator").inc()
            # Backup-window errors are tail-sampling evidence: any
            # query in flight while the backup died may be the cause
            # (or the victim) — keep its trace.
            self._force_keep_traces()
            # Cancellation keeps the journal in flight (resume on the
            # next open); a real failure lands a terminal verdict.
            if self._cancel.is_set():
                self.logger.printf("backup %s: cancelled (journal"
                                   " stays in flight)", self.id)
                set_state_gauge(PHASE_IDLE)
            else:
                self._set_phase(PHASE_FAILED, error=self.error)
            self.logger.printf("backup %s: failed: %s", self.id,
                               self.error)

    def _force_keep_traces(self) -> None:
        server = self.server
        registry = getattr(server, "query_registry", None)
        tracer = getattr(server, "tracer", None)
        sampler = getattr(server, "sampler", None)
        if registry is None or tracer is None:
            return
        for ctx in registry.active_contexts():
            trace = getattr(ctx, "trace", None)
            if trace is None or getattr(trace, "keep_reason", ""):
                continue
            try:
                if tracer.keep(trace, reason="backup") \
                        and sampler is not None:
                    sampler.persist(trace, "backup", ctx=ctx)
            except Exception:  # noqa: BLE001
                continue

    def _client(self):
        return self.server.client_for(self.server.host)

    def _run(self) -> None:
        client = self._client()
        # The WAL watermark FIRST — before any snapshot, so every op
        # not folded into a pushed body is in a segment ≥ walStart
        # (the gap-free direction; overlap is idempotent).
        archiver = getattr(self.server, "wal_archiver", None)
        if archiver is not None:
            try:
                archiver.flush()
            except OSError:
                pass  # buffered batches re-ship on the next tick
        wal_start: dict = {}
        for _key, node, seq in archive_mod.list_wal_segments(
                self.store):
            wal_start[node] = max(wal_start.get(node, -1), seq)
        wal_start = {n: s + 1 for n, s in wal_start.items()}
        resumed = (dict(self.journal.state)
                   if self.journal.state.get("id") == self.id else {})
        if resumed.get("walStart") is not None:
            # A resume: the journaled fragments' snapshots came after
            # the FIRST attempt's watermark, so it stays the watermark.
            # A new one would skip the segments written between those
            # snapshots and now (the JAX coordinator takes a new one
            # and loses those writes, ROADMAP fault 3.18).
            wal_start = dict(resumed["walStart"])
        parent = None
        if self.kind == "incremental":
            prior = archive_mod.list_backups(self.store)
            if not prior:
                raise BackupError(
                    "incremental backup needs a prior backup in the"
                    " archive (take a full first)")
            parent = prior[-1]["id"]
        self._set_phase(PHASE_SNAPSHOT, id=self.id, kind=self.kind,
                        coordinator=self.server.host,
                        startedAt=self.started_at,
                        walStart=wal_start, parent=parent)
        schema = client.schema()
        max_slices = client.max_slices()
        for name, n in (resumed.get("maxSlices") or {}).items():
            # A resume runs at open, before this node has polled its
            # peers' max slices: the first attempt's knowledge stands
            # (the JAX coordinator backs up what it knows then and can
            # skip the highest slices, ROADMAP fault 3.19).
            max_slices[name] = max(int(n), int(max_slices.get(name, -1)))
        self.journal.write(maxSlices={k: int(v)
                                      for k, v in max_slices.items()})
        # Resume: fragments a previous (killed) attempt journaled are
        # reused verbatim — their objects are already durable.
        entries: dict = dict(self.journal.state.get("fragments") or {})
        fragments: list[dict] = []
        for idx in schema:
            iname = idx["name"]
            for frame in idx.get("frames", []):
                fname = frame["name"]
                for view in frame.get("views", []):
                    vname = view["name"]
                    for slice in range(
                            int(max_slices.get(iname, 0)) + 1):
                        entry = self._one_fragment(
                            client, entries, iname, fname, vname,
                            slice)
                        if entry is not None:
                            fragments.append(entry)
        # Flush the coalesced tail before the commit point so the
        # journal names every fragment the manifest will.
        self.journal.write(fragments=entries)
        self._set_phase(PHASE_MANIFEST)
        manifest = {
            "version": archive_mod.MANIFEST_VERSION,
            "id": self.id, "kind": self.kind, "parent": parent,
            "t": time.time(),
            "coordinator": self.server.host,
            "epoch": self.server.cluster.epoch,
            "hosts": [n.host for n in self.server.cluster.nodes],
            "schema": schema,
            "maxSlices": {k: int(v) for k, v in max_slices.items()},
            "walStart": wal_start,
            "fragments": fragments,
        }
        archive_mod.write_backup_manifest(self.store, manifest)
        self._set_phase(PHASE_DONE, finishedAt=time.time())
        self.logger.printf(
            "backup %s: done (%d fragments, %d objects, %d bytes)",
            self.id, self.fragments_done, self.objects_pushed,
            self.bytes_pushed)

    def _one_fragment(self, client, entries: dict, index: str,
                      frame: str, view: str, slice: int
                      ) -> Optional[dict]:
        key = f"{index}/{frame}/{view}/{slice}"
        done = entries.get(key)
        if done is not None:
            self.fragments_skipped += 1
            return done
        self._check_cancel()
        spool = client.backup_slice(index, frame, view, slice,
                                    snapshot=True)
        if spool is None:
            return None  # slice doesn't exist on any owner
        with spool:
            with tarfile.open(fileobj=spool, mode="r|") as tr:
                data = b""
                for info in tr:
                    if info.name == "data":
                        src = tr.extractfile(info)
                        data = src.read() if src is not None else b""
                        break
        if not data:
            return None
        prefix = archive_mod.fragment_prefix(index, frame, view,
                                             slice)
        try:
            frag_manifest, digest, pushed, nbytes = \
                archive_mod.push_fragment_bytes(self.store, prefix,
                                                data)
        except integrity_mod.CorruptionError as e:
            obs_metrics.BACKUP_FRAGMENTS.labels("corrupt").inc()
            raise BackupError(f"backup {self.id}: {key}: {e}")
        entry = {"index": index, "frame": frame, "view": view,
                 "slice": slice, "prefix": prefix,
                 "bodyDigest": digest, "manifest": frag_manifest}
        entries[key] = entry
        self.objects_pushed += pushed
        self.bytes_pushed += nbytes
        self.fragments_done += 1
        obs_metrics.BACKUP_FRAGMENTS.labels("backed_up").inc()
        self.touch()
        # Journal write, COALESCED (at most one fsync per
        # _JOURNAL_COALESCE_S): a SIGKILL resumes from the last
        # journaled fragment, and the few since then re-push as pool
        # exists-check skips — resume stays idempotent, the serving
        # path stops sharing its disk with a per-fragment fsync.
        now = time.monotonic()
        if now - self._journal_at >= _JOURNAL_COALESCE_S:
            self.journal.write(fragments=entries)
            self._journal_at = now
        if self.pace_s:
            # Cancel-aware: an abort doesn't wait out the pace.
            self._cancel.wait(self.pace_s)
        return entry


def recover(server, logger=None) -> Optional[dict]:
    """Resume an in-flight journaled backup after a coordinator crash
    (called from Server.open on a background thread). The same id
    re-runs; journaled fragments and pool-resident objects are
    skipped, so recovery converges instead of re-shipping."""
    logger = logger or getattr(server, "logger", logger_mod.NOP)
    journal = BackupJournal.for_data_dir(server.holder.path)
    state = journal.load()
    if not state or not journal.in_flight():
        return None
    store = getattr(server, "backup_store", None)
    if store is None:
        logger.printf("backup %s: journal in flight but no archive"
                      " configured; leaving journal for the operator",
                      state.get("id"))
        return None
    coord = BackupCoordinator(
        server, store, kind=state.get("kind", "full"),
        backup_id=str(state.get("id")), journal=journal,
        logger=logger)
    server.backup_op = coord
    coord.run()
    return coord.status()

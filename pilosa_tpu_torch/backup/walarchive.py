"""Continuous WAL-segment archiving (the point-in-time-recovery feed).

A sink registered on the group-commit WAL (storage.wal) observes every
committed op batch — still on the leader thread, so per-WAL order IS
commit order — maps the WAL file back to its fragment, stamps it with
the commit wall-clock, and buffers it. A background loop flushes the
buffer into crc-named archive segments every ``interval_s`` (also
inline past a byte cap, so a bulk import cannot grow the buffer
unboundedly). The stamp sits between a write's issue and its ack,
which is what makes ``--to-timestamp`` exact: a write issued after the
cut has a stamp after the cut and is excluded; a write acked before
the cut has a stamp before it and is replayed.

Loss window: batches buffered but not yet flushed die with the
process — PITR granularity is bounded by ``interval_s`` (close()
flushes, so an orderly shutdown loses nothing).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..obs import metrics as obs_metrics
from ..storage import roaring
from ..storage import wal as wal_mod
from ..utils import logger as logger_mod
from . import archive as archive_mod

DEFAULT_INTERVAL_S = 2.0
# Inline-flush cap: the sink flushes synchronously past this many
# buffered bytes so a bulk import can't balloon the buffer between
# interval ticks.
MAX_BUFFER_BYTES = 4 << 20


class WalArchiver:
    """One node's WAL→archive shipper (module docstring)."""

    def __init__(self, store, data_dir: str, node: str,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 logger=None):
        self.store = store
        self.root = os.path.abspath(data_dir)
        self.node = node
        self.interval_s = max(0.05, float(interval_s))
        self.logger = logger or logger_mod.NOP
        self._buf: list[dict] = []
        self._buf_bytes = 0
        self._seq: Optional[int] = None  # lazy: node may be renamed
        self.segments_written = 0
        self.records_archived = 0
        self.errors = 0
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        wal_mod.register_archive_sink(self.root, self._on_batch)
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-wal-archive",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        wal_mod.deregister_archive_sink(self.root)
        thread = self._thread
        if thread is not None \
                and thread is not threading.current_thread():
            thread.join(timeout=5.0)
        self._thread = None
        try:
            self.flush()
        except OSError:
            pass  # batches stay buffered; counted in self.errors

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - archiving must not kill serving
                pass

    # -- the WAL sink ----------------------------------------------------------

    def _frag_key(self, path: str) -> Optional[str]:
        """Data-file path → ``index/frame/view/slice`` (the models
        layout ``<data>/<index>/<frame>/views/<view>/fragments/<n>``);
        None for files that aren't fragment WALs."""
        rel = os.path.relpath(os.path.abspath(path), self.root)
        parts = rel.split(os.sep)
        if (len(parts) == 6 and parts[2] == "views"
                and parts[4] == "fragments" and parts[5].isdigit()):
            return f"{parts[0]}/{parts[1]}/{parts[3]}/{parts[5]}"
        return None

    def _on_batch(self, path: str, batch: bytes) -> None:
        frag = self._frag_key(path)
        if frag is None or not batch:
            return
        with self._mu:
            self._buf.append({"frag": frag, "t": time.time(),
                              "ops": bytes(batch)})
            self._buf_bytes += len(batch)
            over = self._buf_bytes >= MAX_BUFFER_BYTES
        obs_metrics.BACKUP_WAL_RECORDS.inc(
            len(batch) // roaring.OP_SIZE)
        self.records_archived += len(batch) // roaring.OP_SIZE
        if over:
            # Synchronous backpressure on the commit path — rare (a
            # bulk import between ticks), bounded (one segment write).
            try:
                self.flush()
            except OSError:
                pass

    # -- segments --------------------------------------------------------------

    def flush(self) -> int:
        """Drain the buffer into one archive segment; returns batches
        shipped (0 = nothing buffered). On a store failure the batches
        go back at the FRONT of the buffer — commit order is the PITR
        replay contract and must survive retries."""
        with self._mu:
            batches, self._buf = self._buf, []
            self._buf_bytes = 0
        if not batches:
            return 0
        try:
            if self._seq is None:
                self._seq = archive_mod.next_wal_seq(self.store,
                                                     self.node)
            seq = self._seq
            body = archive_mod.encode_wal_segment(self.node, seq,
                                                  batches)
            archive_mod.put_object(
                self.store,
                archive_mod.wal_segment_key(self.node, seq, body),
                body)
            self._seq = seq + 1
        except OSError as e:
            with self._mu:
                self._buf[:0] = batches
                self._buf_bytes += sum(len(b["ops"]) for b in batches)
            self.errors += 1
            self.logger.printf("wal archive: segment write failed:"
                               " %s", e)
            raise
        obs_metrics.BACKUP_WAL_SEGMENTS.inc()
        self.segments_written += 1
        return len(batches)

    def state(self) -> dict:
        with self._mu:
            buffered = len(self._buf)
            buffered_bytes = self._buf_bytes
        return {"node": self.node, "intervalS": self.interval_s,
                "nextSeq": self._seq, "buffered": buffered,
                "bufferedBytes": buffered_bytes,
                "segmentsWritten": self.segments_written,
                "recordsArchived": self.records_archived,
                "errors": self.errors}

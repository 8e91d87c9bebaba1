"""Automatic replica repair of quarantined fragments.

Copy of the JAX package's ``server/repair.py``. The read path already
fails over around a quarantined fragment (the executor skips the local
owner; peers' legs re-map), so a quarantine is safe — but a quarantined
copy is a replica DOWN: one more failure and the slice is unavailable.
The repairer closes the loop: for every quarantined fragment it

1. picks a healthy replica owner (breaker-ordered, open circuits
   skipped);
2. drops the suspect local state (``Fragment.reset_for_repair`` — the
   data file moves aside, a fresh footered WAL takes its place so
   concurrent writes keep landing durably);
3. re-streams the content source to local through the directed
   :class:`~pilosa_tpu_torch.server.syncer.FragmentStreamer` — the
   block-diff protocol over ``/fragment/blocks`` and
   ``/fragment/block/data``, with the TARGET side served by an
   in-process adapter (the local fragment answers its block checksums
   and applies the additive import directly; the HTTP fragment routes
   refuse quarantined fragments so remote anti-entropy can't consume
   the incomplete copy);
4. runs the diff until a pass pushes zero bits (every block checksum
   matches the source), snapshots the repaired state to disk under a
   fresh footer, re-verifies the file, and un-quarantines.

Acked writes that arrived while the local copy was corrupt are not
lost: every write fans out to all replica owners, so the source replica
already holds them and the re-stream brings them home. With NO healthy
replica (replicas=1, or every peer down or corrupt) the fragment stays
quarantined — unavailable, never a silent wrong answer — and the
repairer retries on its rescan cadence in case a replica returns.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..cluster.client import Client, ClientError
from ..errors import FragmentNotFoundError
from ..obs import metrics as obs_metrics
from ..utils import logger as logger_mod
from .syncer import FragmentStreamer

DEFAULT_RESCAN_S = 15.0
DEFAULT_RETRY_S = 30.0
MAX_DIFF_PASSES = 8


class _LocalTarget:
    """The FragmentStreamer's view of THIS node as a stream target,
    bypassing HTTP: the fragment routes answer 409 for quarantined
    fragments (a half-streamed copy must not feed remote anti-entropy
    or resize diffs), so the repairer reads block checksums and
    applies the additive import in-process instead."""

    def __init__(self, holder):
        self.holder = holder

    def fragment_blocks(self, index: str, frame: str, view: str,
                        slice: int, host=None):
        frag = self.holder.fragment(index, frame, view, slice)
        if frag is None:
            raise FragmentNotFoundError()
        return frag.blocks()

    def fragment_import(self, index: str, frame: str, view: str,
                        slice: int, positions, host=None) -> None:
        f = self.holder.frame(index, frame)
        if f is None:
            raise FragmentNotFoundError()
        v = f.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(slice)
        frag.import_positions(np.asarray(positions, dtype=np.uint64))


class Repairer:
    """One background thread draining the holder's quarantine
    registry. Wakes on every new quarantine (the registry's
    ``on_quarantine`` hook) and rescans on a slow cadence to catch
    entries recorded before it started (open-time quarantines) and
    no-replica entries whose replica may have returned."""

    def __init__(self, holder, cluster, host: str,
                 client_factory=Client, fault=None,
                 pace_s: float = 0.0,
                 rescan_s: float = DEFAULT_RESCAN_S,
                 retry_s: float = DEFAULT_RETRY_S,
                 logger=logger_mod.NOP):
        self.holder = holder
        self.cluster = cluster
        self.host = host
        self.client_factory = client_factory
        self.fault = fault
        self.pace_s = pace_s
        self.rescan_s = max(0.05, float(rescan_s))
        self.retry_s = float(retry_s)
        self.logger = logger
        self.repairs = 0
        self.failures = 0
        self._local = _LocalTarget(holder)
        self._last_attempt: dict[tuple, float] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        q = getattr(holder, "quarantine", None)
        if q is not None:
            q.on_quarantine = self._note

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-repair",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)

    def _note(self, frag) -> None:
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.rescan_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.repair_all()
            except Exception as e:  # noqa: BLE001 - repairer must not die
                self.logger.printf("repair: pass failed: %s", e)

    # -- repair --------------------------------------------------------------

    def repair_all(self) -> int:
        """One pass over every quarantined fragment; returns the number
        repaired."""
        repaired = 0
        for frag in self.holder.iter_fragments():
            if self._stop.is_set():
                break
            if not frag.quarantined or not frag._open:
                continue
            key = (frag.index, frag.frame, frag.view, frag.slice)
            now = time.monotonic()
            last = self._last_attempt.get(key, 0.0)
            if last and now - last < self.retry_s:
                continue
            self._last_attempt[key] = now
            if self.repair_fragment(frag) == "repaired":
                repaired += 1
                self._last_attempt.pop(key, None)
        return repaired

    def _source_peers(self, frag) -> list:
        """Healthy replica owners to stream from, breaker-ordered —
        local and open-circuit peers excluded. A mid-resize moving
        slice defers (the resize streamer owns those fragments)."""
        if self.cluster.moving_slice(frag.index, frag.slice) is not None:
            return []
        owners = [n for n in self.cluster.fragment_nodes(
            frag.index, frag.slice) if n.host != self.host]
        if self.fault is not None and len(owners) > 1:
            owners = self.fault.order_nodes(owners, local=self.host)
        return [n for n in owners
                if self.fault is None
                or self.fault.would_allow(n.host)]

    def repair_fragment(self, frag) -> str:
        """Repair ONE quarantined fragment; returns the outcome
        (``repaired`` / ``failed`` / ``no_replica``)."""
        peers = self._source_peers(frag)
        if not peers:
            obs_metrics.STORAGE_REPAIRS.labels("no_replica").inc()
            self.logger.printf(
                "repair: %s/%s/%s/%d has no healthy replica — stays"
                " quarantined (partial contract)", frag.index,
                frag.frame, frag.view, frag.slice)
            return "no_replica"
        last_err: Optional[Exception] = None
        for peer in peers:
            try:
                if self._repair_from(frag, peer.host):
                    obs_metrics.STORAGE_REPAIRS.labels(
                        "repaired").inc()
                    self.repairs += 1
                    self.logger.printf(
                        "repair: %s/%s/%s/%d restored from %s",
                        frag.index, frag.frame, frag.view, frag.slice,
                        peer.host)
                    return "repaired"
            except (ClientError, FragmentNotFoundError, OSError) as e:
                last_err = e
                self.logger.printf(
                    "repair: %s/%s/%s/%d from %s failed: %s",
                    frag.index, frag.frame, frag.view, frag.slice,
                    peer.host, e)
        obs_metrics.STORAGE_REPAIRS.labels("failed").inc()
        self.failures += 1
        del last_err
        return "failed"

    def _repair_from(self, frag, source_host: str) -> bool:
        """The re-stream against one source replica: reset, diff-until-
        clean through the FragmentStreamer, persist + re-verify,
        un-quarantine."""
        # The source must actually HOLD the fragment before we trust a
        # zero-bit diff as convergence: stream_fragment answers (0, 0)
        # for a MISSING source too, and un-quarantining against a peer
        # that never materialized the fragment would serve the fresh
        # empty replacement as authoritative — the silent-wrong-answer
        # class this subsystem exists to kill. (An EXISTING empty
        # fragment answers [] here, not 404 — genuinely-empty repairs
        # stay valid.) Raises FragmentNotFoundError/ClientError to the
        # caller's next-peer loop.
        probe = self.client_factory(source_host)
        probe.fragment_blocks(frag.index, frag.frame, frag.view,
                              frag.slice, host=source_host)
        frag.reset_for_repair()

        def factory(host, _src=source_host):
            if host == self.host:
                return self._local
            return self.client_factory(host)

        streamer = FragmentStreamer(client_factory=factory,
                                    logger=self.logger,
                                    fault=self.fault,
                                    pace_s=self.pace_s)
        converged = False
        for _ in range(MAX_DIFF_PASSES):
            bits, _nbytes = streamer.stream_fragment(
                frag.index, frag.frame, frag.view, frag.slice,
                source_host=source_host, target_host=self.host)
            if bits == 0:
                # Every block checksum matches the source: converged.
                converged = True
                break
        if not converged:
            return False
        # Persist the repaired state under a fresh footer, atomically
        # swapping the data file, then re-verify the bytes on disk
        # before trusting them (verify_on_disk re-quarantines on a
        # corrupt verdict, so a bad disk fails loudly here).
        frag.snapshot(sync=True)
        verdict = frag.verify_on_disk()
        if verdict.get("corrupt"):
            return False  # bad disk: stays quarantined, retried later
        frag.clear_quarantine()
        return True

    def state(self) -> dict:
        return {"repairs": self.repairs, "failures": self.failures,
                "rescanS": self.rescan_s, "retryS": self.retry_s}

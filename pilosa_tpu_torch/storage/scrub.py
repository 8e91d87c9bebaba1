"""Background storage scrubber: continuous re-verification of the
on-disk fragment files against their integrity footers.

Copy of the JAX package's ``storage/scrub.py``. Detection at open and
first read (storage.integrity, the fragment's lazy verify) only fires
when a fragment is (re)opened or first touched; a serving node's hot
fragments stay open for weeks, and bit rot under an mmap is invisible
until a page fault re-reads the rotten block. The scrubber closes that
window: a paced pass over every open fragment (a sleep between
fragments, so a scrub never competes with serving for disk bandwidth)
that re-reads each DATA FILE through its own fd (an ``os.replace`` swap
pins the old inode, so the read is always a consistent append-only
prefix), re-computes every container block's crc32 against the footer
table, re-checks the whole-body digest, and cross-validates the WAL
tail's FNV checksums. Any mismatch quarantines the fragment (detection,
then failover, then repair from a replica: server.repair).

``scrub_buffer`` / ``scrub_file`` are the standalone (lock-free)
verdict functions the CLI's offline ``check --deep`` shares.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..obs import metrics as obs_metrics
from ..utils import logger as logger_mod
from . import integrity
from . import roaring

DEFAULT_INTERVAL_S = 600.0   # seconds between passes
DEFAULT_PACE_S = 0.01        # sleep between fragments within a pass


def scrub_buffer(buf) -> dict:
    """Verify one data-file buffer (snapshot body [+footer] [+op-log
    tail]). Returns a verdict dict::

        {"corrupt": bool, "coverage": "full"|"none",
         "blocks": N, "badBlocks": [...], "error": "...",
         "walRecords": N, "walBad": N, "walTornBytes": N}

    ``coverage: none`` (a vintage un-footered file) is NOT corruption
    — the body simply predates checksums; the WAL tail still
    validates. A trailing partial op record (or a footer truncated at
    EOF) is a TEAR, reported but not corruption: it is exactly the
    state a crash mid-append leaves, and the reopen trim handles it.
    """
    out = {"corrupt": False, "coverage": "none", "blocks": 0,
           "badBlocks": [], "error": "", "walRecords": 0, "walBad": 0,
           "walTornBytes": 0}

    def bad(msg: str) -> dict:
        out["corrupt"] = True
        out["error"] = msg
        return out

    buf = memoryview(buf)
    try:
        # The SAME layout parser the decoder uses (roaring.
        # parse_snapshot_layout) — a format change cannot make the
        # scrubber mis-parse clean files the decoder accepts.
        (hdr, _run_mask, _ns, offs, sizes, ops_offset,
         body_end) = roaring.parse_snapshot_layout(buf)
    except ValueError as e:
        return bad(str(e))
    key_n = len(hdr)

    # Footer + block table — the SAME verification sequence the
    # decoder runs (integrity.parse_and_verify_footer), with the
    # per-block table checked up front for the badBlocks detail.
    ops_start = body_end
    try:
        info = integrity.parse_and_verify_footer(
            buf, key_n, ops_offset, offs, sizes, body_end)
    except integrity.TornFooterError as e:
        out["walTornBytes"] = e.torn_bytes
        return out  # torn footer at EOF: a tear, not corruption
    except integrity.CorruptionError as e:
        return bad(str(e))
    if info is not None:
        out["coverage"] = "full"
        out["blocks"] = info.block_n
        ops_start = body_end + info.size
        bad_blocks = integrity.verify_blocks(buf, info)
        if bad_blocks:
            out["badBlocks"] = bad_blocks
            return bad(f"{len(bad_blocks)} container blocks fail crc"
                       f" (first: {bad_blocks[:4]})")
        try:
            integrity.verify_body(buf, info)
        except integrity.CorruptionError as e:
            return bad(str(e))

    # WAL tail: every COMPLETE 13-byte op record must carry a valid
    # FNV-1a checksum and a known type; a trailing partial record is a
    # tear (in-flight append / crash), tolerated.
    rest = buf[ops_start:]
    n_rest = len(rest)
    n_ops = n_rest // roaring.OP_SIZE
    out["walRecords"] = n_ops
    out["walTornBytes"] += n_rest - n_ops * roaring.OP_SIZE
    if n_ops:
        recs = np.frombuffer(rest, dtype=np.uint8,
                             count=n_ops * roaring.OP_SIZE
                             ).reshape(n_ops, roaring.OP_SIZE)
        h = roaring.fnv_fold_records(recs)
        stored = np.ascontiguousarray(recs[:, 9:13]).view("<u4").ravel()
        bad_mask = (h != stored) | (recs[:, 0] > roaring.OP_REMOVE)
        n_bad = int(bad_mask.sum())
        if n_bad:
            out["walBad"] = n_bad
            return bad(f"{n_bad} WAL records fail their FNV checksum"
                       f" (first at record"
                       f" {int(np.flatnonzero(bad_mask)[0])})")
    return out


def scrub_file(path: str) -> dict:
    """Offline verdict for one data file (the CLI ``check --deep``
    lane — no locks, no registry side effects)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        return {"corrupt": True, "coverage": "none",
                "error": f"unreadable: {e}", "blocks": 0,
                "badBlocks": [], "walRecords": 0, "walBad": 0,
                "walTornBytes": 0}
    return scrub_buffer(data)


class Scrubber:
    """The background pass. One thread, paced; a pass walks a
    point-in-time snapshot of the holder's open fragments and defers
    each file's verification to ``Fragment.verify_on_disk`` (which
    quarantines on a corrupt verdict). ``on_corrupt(fragment)`` fires
    per newly-detected corruption so the server's repairer wakes
    without polling."""

    def __init__(self, holder, interval_s: float = DEFAULT_INTERVAL_S,
                 pace_s: float = DEFAULT_PACE_S, on_corrupt=None,
                 logger=logger_mod.NOP):
        self.holder = holder
        self.interval_s = max(0.05, float(interval_s))
        self.pace_s = max(0.0, float(pace_s))
        self.on_corrupt = on_corrupt
        self.logger = logger
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        # Serializes whole passes: an operator ?sync=1 pass racing the
        # background thread would otherwise interleave (doubled scrub
        # IO) and the first finisher would blank _pass_started while
        # the other still runs.
        self._pass_mu = threading.Lock()
        # Pass progress (/debug/integrity reads state(), the watchdog's
        # scrub_stall detector stall_age()).
        self._pass_started: Optional[float] = None
        self._last_progress = 0.0
        self._passes = 0
        self._fragments_scrubbed = 0
        self._blocks_verified = 0
        self._corruptions = 0
        self._last_pass_at = 0.0
        self._last_pass_s = 0.0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-scrub",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def trigger(self) -> None:
        """Request an immediate pass (tests, POST /debug/integrity)."""
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            woke = self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.pass_once()
            except Exception as e:  # noqa: BLE001 - scrub must not die
                self.logger.printf("scrub: pass failed: %s", e)
            del woke

    # -- the pass ------------------------------------------------------------

    def pass_once(self) -> dict:
        """One full scrub pass; returns the pass summary. Passes are
        serialized — a triggered sync pass waits out an in-flight
        background one instead of doubling its IO."""
        with self._pass_mu:
            return self._pass_locked()

    def _pass_locked(self) -> dict:
        t0 = time.monotonic()
        with self._mu:
            self._pass_started = t0
            self._last_progress = t0
        scrubbed = blocks = corrupt = 0
        try:
            for frag in self.holder.iter_fragments():
                if self._stop.is_set():
                    break
                if not frag._open or frag.quarantined:
                    continue
                try:
                    verdict = frag.verify_on_disk()
                except Exception as e:  # noqa: BLE001 - keep walking
                    self.logger.printf(
                        "scrub: %s unverifiable: %s", frag.path, e)
                    continue
                scrubbed += 1
                n_blocks = int(verdict.get("blocks") or 0)
                blocks += n_blocks
                if n_blocks:
                    obs_metrics.STORAGE_SCRUB_BLOCKS.labels(
                        "scrub").inc(n_blocks)
                if verdict.get("corrupt"):
                    corrupt += 1
                    self.logger.printf(
                        "scrub: CORRUPT %s: %s", frag.path,
                        verdict.get("error"))
                    cb = self.on_corrupt
                    if cb is not None:
                        try:
                            cb(frag)
                        except Exception:  # noqa: BLE001 - advisory
                            pass
                with self._mu:
                    self._last_progress = time.monotonic()
                if self.pace_s:
                    # Pacing: serving traffic owns the disk; the scrub
                    # breathes between fragments.
                    if self._stop.wait(self.pace_s):
                        break
        finally:
            now = time.monotonic()
            with self._mu:
                self._pass_started = None
                self._passes += 1
                self._fragments_scrubbed += scrubbed
                self._blocks_verified += blocks
                self._corruptions += corrupt
                self._last_pass_at = time.time()
                self._last_pass_s = now - t0
        return {"fragments": scrubbed, "blocks": blocks,
                "corrupt": corrupt, "seconds": round(now - t0, 3)}

    # -- exposition ----------------------------------------------------------

    def stall_age(self) -> Optional[float]:
        """Seconds since an in-flight pass last made progress, or None
        when no pass is running (the watchdog's scrub_stall input)."""
        with self._mu:
            if self._pass_started is None:
                return None
            return time.monotonic() - self._last_progress

    def state(self) -> dict:
        with self._mu:
            in_flight = self._pass_started is not None
            return {"intervalS": self.interval_s,
                    "paceS": self.pace_s,
                    "passes": self._passes,
                    "inFlight": in_flight,
                    "fragmentsScrubbed": self._fragments_scrubbed,
                    "blocksVerified": self._blocks_verified,
                    "corruptionsFound": self._corruptions,
                    "lastPassAt": self._last_pass_at,
                    "lastPassSeconds": round(self._last_pass_s, 3)}

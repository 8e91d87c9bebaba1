"""Crash-safe on-disk segment ring: the persistence substrate of the
tail-sampled trace store (obs.sampler).

Copy of the JAX package's ``obs/diskring.py`` (whose blackbox flight
recorder shares it; the port has no blackbox yet).

Layout: ``<dir>/seg-<NNNNNNNN>.jsonl``, each line one record framed as

    <crc32-hex-8> <compact-json>\\n

The crc covers the JSON bytes, so reopen-after-crash can tell a whole
record from a torn tail without trusting the filesystem: scanning a
segment stops at the first line whose frame is short, whose crc
mismatches, or whose JSON fails to parse — everything before it is
served, everything after it in THAT segment is skipped (a torn write
tears the tail, never the middle of an fsynced prefix), and every
OTHER segment still serves. Segments rotate at ``segment_bytes`` and
the oldest is unlinked past ``max_segments``, so total disk is bounded
at roughly ``segment_bytes * max_segments`` whatever the write rate.

Writes go through the ``ring.write`` failpoint (fault.failpoints) with
``writer`` + ``data``, so the torn-write chaos tests tear a segment
exactly where power loss mid-append would.

Durability is deliberately the WAL's weakest tier: records are
buffered through the OS (no fsync) — this ring holds *diagnostics*,
and the one crash mode that loses the last buffered records is also
the one a flight recorder cannot help with anyway.
"""

from __future__ import annotations

import json
import os
import re
import threading
import zlib
from typing import Iterator, Optional

from ..fault import failpoints as _fp

_SEG_RE = re.compile(r"^seg-(\d{8})\.jsonl$")

DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_MAX_SEGMENTS = 8


def _frame(record: dict) -> bytes:
    body = json.dumps(record, separators=(",", ":"),
                      default=str).encode()
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return b"%08x " % crc + body + b"\n"


def _unframe(line: bytes) -> Optional[dict]:
    """One framed line back to its record; None for anything torn or
    corrupt (short frame, crc mismatch, broken JSON)."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    try:
        want = int(line[:8], 16)
    except ValueError:
        return None
    body = line[9:].rstrip(b"\n")
    if (zlib.crc32(body) & 0xFFFFFFFF) != want:
        return None
    try:
        out = json.loads(body)
    except ValueError:
        return None
    return out if isinstance(out, dict) else None


class SegmentRing:
    """Bounded ring of crc-framed JSONL segments (module docstring).
    Thread-safe; every method degrades to a no-op (with counters) on
    I/O errors — a diagnostics store must never take serving down."""

    def __init__(self, dir: str,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_segments: int = DEFAULT_MAX_SEGMENTS):
        self.dir = dir
        self.segment_bytes = max(4 << 10, int(segment_bytes))
        self.max_segments = max(1, int(max_segments))
        self._mu = threading.Lock()
        self._file = None
        self._file_bytes = 0
        self._seq = 0
        self.written = 0   # records appended this process
        self.dropped = 0   # appends lost to I/O errors / failpoints
        self.skipped = 0   # corrupt/torn records skipped by scans
        os.makedirs(dir, exist_ok=True)
        segs = self._segments()
        if segs:
            self._seq = segs[-1][0]

    # -- write ----------------------------------------------------------------

    def append(self, record: dict) -> bool:
        """Append one record; True when it reached the OS. A failed or
        torn write closes the current segment (the torn tail is
        skipped by scans; later records open a fresh segment), so one
        bad write can never poison records after it."""
        data = _frame(record)
        with self._mu:
            try:
                f = self._open_locked(len(data))
                if _fp.ACTIVE is not None:
                    _fp.ACTIVE.hit("ring.write", writer=f, data=data)
                f.write(data)
                f.flush()
                self._file_bytes += len(data)
                self.written += 1
                return True
            except Exception:  # noqa: BLE001 - diagnostics must not raise
                self.dropped += 1
                self._close_locked()
                return False

    def _open_locked(self, need: int):
        if self._file is not None \
                and self._file_bytes + need > self.segment_bytes:
            self._close_locked()
        if self._file is None:
            self._seq += 1
            path = os.path.join(self.dir, f"seg-{self._seq:08d}.jsonl")
            self._file = open(path, "ab")
            self._file_bytes = self._file.tell()
            self._prune_locked()
        return self._file

    def _close_locked(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except Exception:  # noqa: BLE001
                pass
            self._file = None
            self._file_bytes = 0

    def _prune_locked(self) -> None:
        segs = self._segments()
        for seq, path in segs[:-self.max_segments]:
            try:
                os.unlink(path)
            except OSError:
                pass

    def close(self) -> None:
        with self._mu:
            self._close_locked()

    # -- read -----------------------------------------------------------------

    def _segments(self) -> list[tuple[int, str]]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            m = _SEG_RE.match(n)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, n)))
        out.sort()
        return out

    def scan(self, newest_first: bool = True) -> Iterator[dict]:
        """Every whole record on disk. A torn/corrupt line ends ITS
        segment's scan (counted in ``skipped``); other segments are
        unaffected — the reopen-skips-the-bad-segment contract."""
        with self._mu:
            # Buffered bytes must be visible to the read-side open.
            if self._file is not None:
                try:
                    self._file.flush()
                except Exception:  # noqa: BLE001
                    pass
        segs = self._segments()
        if newest_first:
            segs = segs[::-1]
        for _seq, path in segs:
            records = []
            try:
                with open(path, "rb") as f:
                    for line in f:
                        rec = _unframe(line)
                        if rec is None:
                            self.skipped += 1
                            break
                        records.append(rec)
            except OSError:
                continue
            yield from (reversed(records) if newest_first else records)

    def stats(self) -> dict:
        segs = self._segments()
        size = 0
        for _seq, path in segs:
            try:
                size += os.path.getsize(path)
            except OSError:
                pass
        return {"dir": self.dir, "segments": len(segs),
                "bytes": size, "segmentBytes": self.segment_bytes,
                "maxSegments": self.max_segments,
                "written": self.written, "dropped": self.dropped,
                "skippedCorrupt": self.skipped}

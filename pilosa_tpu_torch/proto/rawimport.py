"""Raw-array import wire format (a copy of the JAX package's proto/rawimport.py).

The reference's /import endpoint speaks protobuf (handler.go:896-906),
and so does ours by default — but protobuf varint-decodes every u64
individually, which is the measured bound on bulk-import wire
throughput. Between OUR client and server the id vectors travel as
little-endian u64 arrays instead: encode is a buffer copy, decode is
np.frombuffer views into the request body. Content negotiation keeps
reference parity: the client tries this format once per host and falls
back to protobuf on 415 (so a reference-shaped server still works),
and reference clients never see it because protobuf stays accepted.

Layout (all little-endian):
    magic   4s   b"PRAW"
    version u8   1 | 2
    flags   u8   bit 0: timestamps present (v1)
                 bit 1: positions form (v2)
    idx_len u16, idx utf-8 bytes
    frm_len u16, frame utf-8 bytes
    slice   u64
    n       u64
    pad     0-7 zero bytes so the arrays start 8-byte-aligned (an
            unaligned u64 view forces numpy's per-element slow path —
            measured 10x on the apply)
    v1: rows n x u64, cols n x u64, [ts n x i64 iff flags & 1]
    v2: positions n x u64

Version 2 — the **presorted positions form** (the pipelined import
path) — carries slice-local bit positions
(``row*SLICE_WIDTH + col%SLICE_WIDTH``) already sorted and deduped by
the CLIENT: half the wire bytes of v1 (8 vs 16 per bit), and the
server skips its packed-sort entirely (add_many's is-sorted check
passes), so the client-side sort of slice N+1 — np.sort releases the
GIL — genuinely overlaps the server-side apply of slice N. No
timestamp variant: timestamped imports need the per-quantum view
fan-out, which wants (row, col) pairs — they stay on v1. A server
that predates v2 answers 400 "unsupported raw-import version" and the
client drops to v1 for that host (same per-host negotiation idiom as
the 415 protobuf fallback).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

CONTENT_TYPE = "application/x-pilosa-raw-import"
_MAGIC = b"PRAW"
_HDR = struct.Struct("<4sBB")


def encode(index: str, frame: str, slice: int, rows: np.ndarray,
           cols: np.ndarray, ts_ns: Optional[np.ndarray]) -> bytes:
    idx_b = index.encode()
    frm_b = frame.encode()
    flags = 1 if ts_ns is not None else 0
    hdr_len = _HDR.size + 2 + len(idx_b) + 2 + len(frm_b) + 16
    parts = [
        _HDR.pack(_MAGIC, 1, flags),
        struct.pack("<H", len(idx_b)), idx_b,
        struct.pack("<H", len(frm_b)), frm_b,
        struct.pack("<QQ", slice, len(rows)),
        b"\0" * (-hdr_len % 8),
        np.ascontiguousarray(rows, dtype="<u8").tobytes(),
        np.ascontiguousarray(cols, dtype="<u8").tobytes(),
    ]
    if ts_ns is not None:
        parts.append(np.ascontiguousarray(ts_ns, dtype="<i8").tobytes())
    return b"".join(parts)


def encode_positions(index: str, frame: str, slice: int,
                     positions: np.ndarray) -> bytes:
    """Version-2 body: ``positions`` MUST be sorted-unique slice-local
    u64 positions (the server rejects anything else with 400)."""
    idx_b = index.encode()
    frm_b = frame.encode()
    hdr_len = _HDR.size + 2 + len(idx_b) + 2 + len(frm_b) + 16
    return b"".join([
        _HDR.pack(_MAGIC, 2, 2),
        struct.pack("<H", len(idx_b)), idx_b,
        struct.pack("<H", len(frm_b)), frm_b,
        struct.pack("<QQ", slice, len(positions)),
        b"\0" * (-hdr_len % 8),
        np.ascontiguousarray(positions, dtype="<u8").tobytes(),
    ])


def version_of(body: bytes) -> int:
    """Wire version byte (0 when the body is not raw-import at all)."""
    return body[4] if len(body) >= _HDR.size and body[:4] == _MAGIC \
        else 0


def decode(body: bytes):
    """→ (index, frame, slice, rows u64, cols u64, ts_ns i64|None,
    positions u64|None) — exactly one of (rows, cols) / positions is
    populated, by wire version. Arrays are zero-copy views of
    ``body``. Raises ValueError on any structural mismatch (the
    handler maps it to 400)."""
    if len(body) < _HDR.size or body[:4] != _MAGIC:
        raise ValueError("bad raw-import magic")
    _, version, flags = _HDR.unpack_from(body)
    if version not in (1, 2):
        raise ValueError(f"unsupported raw-import version {version}")
    try:
        off = _HDR.size
        (idx_len,) = struct.unpack_from("<H", body, off)
        off += 2
        index = body[off:off + idx_len].decode()
        off += idx_len
        (frm_len,) = struct.unpack_from("<H", body, off)
        off += 2
        frame = body[off:off + frm_len].decode()
        off += frm_len
        slice, n = struct.unpack_from("<QQ", body, off)
        off += 16
    except (struct.error, UnicodeDecodeError) as e:
        # Truncated-header struct.error is not a ValueError subclass;
        # the contract (and the handler's 400 mapping) is ValueError.
        raise ValueError(f"truncated raw-import header: {e}")
    off += -off % 8  # alignment padding (see layout)
    if version == 2:
        if not flags & 2:
            raise ValueError("raw-import v2 without positions flag")
        if len(body) - off != n * 8:
            raise ValueError("raw-import length mismatch")
        positions = np.frombuffer(body, dtype="<u8", count=n,
                                  offset=off)
        return index, frame, slice, None, None, None, positions
    want = n * 16 + (n * 8 if flags & 1 else 0)
    if len(body) - off != want:
        raise ValueError("raw-import length mismatch")
    rows = np.frombuffer(body, dtype="<u8", count=n, offset=off)
    off += n * 8
    cols = np.frombuffer(body, dtype="<u8", count=n, offset=off)
    off += n * 8
    ts_ns = None
    if flags & 1:
        ts_ns = np.frombuffer(body, dtype="<i8", count=n, offset=off)
    return index, frame, slice, rows, cols, ts_ns, None

"""Attribute store: row/column attribute K/V maps, SQLite-backed.

A copy of the JAX package's ``storage/attrs.py`` on the port's wire
codec: the sqlite file and the ``AttrMap`` bytes it holds are the same,
so either package opens the other's stores. Reference: attr.go (BoltDB). Same model: per-id attribute maps stored as
protobuf ``AttrMap`` blobs keyed by big-endian u64 id, an in-memory map
cache in front, 100-id anti-entropy blocks with SHA1 checksums over
(key, value-blob) in id order, and merge-on-update semantics.

SQLite replaces BoltDB as the host-side embedded K/V — a natural fit here
since the store is metadata, not the compute path. The BE-u64 BLOB primary
key keeps cursor order identical to the reference's bucket scan.
"""

from __future__ import annotations

import hashlib
import os
import sqlite3
import threading
from typing import Optional

from ..proto import internal as pb

# Attribute type codes (reference attr.go:34-40).
ATTR_TYPE_STRING = 1
ATTR_TYPE_INT = 2
ATTR_TYPE_BOOL = 3
ATTR_TYPE_FLOAT = 4

# Ids per anti-entropy block (reference attr.go:31).
ATTR_BLOCK_SIZE = 100


def _u64tob(v: int) -> bytes:
    return int(v).to_bytes(8, "big")


def _btou64(b: bytes) -> int:
    return int.from_bytes(b, "big")


def encode_attrs(m: dict) -> bytes:
    """Deterministic (key-sorted) AttrMap blob."""
    return pb.AttrMap(Attrs=encode_attr_list(m)).SerializeToString()


def encode_attr(key: str, v) -> pb.Attr:
    """One attribute; a value of another type keeps only its key,
    matching the reference's encodeAttr."""
    a = pb.Attr(Key=key)
    if isinstance(v, bool):  # check before int — bool is an int subtype
        a.Type, a.BoolValue = ATTR_TYPE_BOOL, v
    elif isinstance(v, str):
        a.Type, a.StringValue = ATTR_TYPE_STRING, v
    elif isinstance(v, int):
        a.Type, a.IntValue = ATTR_TYPE_INT, v
    elif isinstance(v, float):
        a.Type, a.FloatValue = ATTR_TYPE_FLOAT, v
    return a


def encode_attr_list(m: dict) -> list:
    return [encode_attr(k, m[k]) for k in sorted(m)]


def decode_attrs(blob: bytes) -> dict:
    return decode_attr_list(pb.AttrMap.FromString(blob).Attrs)


def decode_attr_list(attrs) -> dict:
    m = {}
    for a in attrs:
        if a.Type == ATTR_TYPE_STRING:
            m[a.Key] = a.StringValue
        elif a.Type == ATTR_TYPE_INT:
            m[a.Key] = a.IntValue
        elif a.Type == ATTR_TYPE_BOOL:
            m[a.Key] = a.BoolValue
        elif a.Type == ATTR_TYPE_FLOAT:
            m[a.Key] = a.FloatValue
    return m


def diff_blocks(a: list[tuple[int, bytes]], b: list[tuple[int, bytes]]
                ) -> list[int]:
    """Block ids in ``a`` that differ from or are missing in ``b``
    (reference attr.go AttrBlocks.Diff)."""
    ids = []
    i = j = 0
    while i < len(a):
        if j >= len(b) or a[i][0] < b[j][0]:
            ids.append(a[i][0])
            i += 1
        elif b[j][0] < a[i][0]:
            j += 1
        else:
            if a[i][1] != b[j][1]:
                ids.append(a[i][0])
            i += 1
            j += 1
    return ids


class AttrStore:
    def __init__(self, path: str):
        self.path = path
        self._db: Optional[sqlite3.Connection] = None
        self._cache: dict[int, dict] = {}
        self._mu = threading.RLock()

    def open(self) -> None:
        with self._mu:
            if self._db is not None:
                return
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._db = sqlite3.connect(self.path, check_same_thread=False)
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS attrs "
                "(id BLOB PRIMARY KEY, value BLOB NOT NULL)")
            self._db.commit()

    def close(self) -> None:
        with self._mu:
            if self._db is not None:
                self._db.close()
                self._db = None
            self._cache.clear()

    def attrs(self, id: int) -> dict:
        """Attributes for an id (cached); {} when unset."""
        with self._mu:
            m = self._cache.get(id)
            if m is not None:
                return dict(m)
            row = self._db.execute(
                "SELECT value FROM attrs WHERE id = ?",
                (_u64tob(id),)).fetchone()
            m = decode_attrs(row[0]) if row else {}
            self._cache[id] = m
            return dict(m)

    def set_attrs(self, id: int, m: dict) -> None:
        """Merge m into the id's attributes; None values delete keys
        (reference attr.go txUpdateAttrs)."""
        with self._mu:
            merged = self._merge(id, m)
            self._db.commit()
            self._cache[id] = merged

    def set_bulk_attrs(self, m: dict[int, dict]) -> None:
        with self._mu:
            merged_all = {}
            for id in sorted(m):
                merged_all[id] = self._merge(id, m[id])
            self._db.commit()
            self._cache.update(merged_all)

    def _merge(self, id: int, m: dict) -> dict:
        row = self._db.execute("SELECT value FROM attrs WHERE id = ?",
                               (_u64tob(id),)).fetchone()
        current = decode_attrs(row[0]) if row else {}
        for k, v in m.items():
            if v is None:
                current.pop(k, None)
            else:
                current[k] = v
        self._db.execute(
            "INSERT OR REPLACE INTO attrs (id, value) VALUES (?, ?)",
            (_u64tob(id), encode_attrs(current)))
        return current

    # -- anti-entropy blocks --------------------------------------------------

    def blocks(self) -> list[tuple[int, bytes]]:
        """(block_id, sha1) per non-empty 100-id block; hash covers
        (BE key, value blob) pairs in key order (reference attr.go:181-209)."""
        with self._mu:
            out = []
            h = None
            cur_block = None
            for key, value in self._db.execute(
                    "SELECT id, value FROM attrs ORDER BY id"):
                bid = _btou64(key) // ATTR_BLOCK_SIZE
                if bid != cur_block:
                    if h is not None:
                        out.append((cur_block, h.digest()))
                    cur_block, h = bid, hashlib.sha1()
                h.update(key)
                h.update(value)
            if h is not None:
                out.append((cur_block, h.digest()))
            return out

    def block_data(self, block_id: int) -> dict[int, dict]:
        """All id→attrs in one block (reference attr.go:211-241)."""
        with self._mu:
            lo = _u64tob(block_id * ATTR_BLOCK_SIZE)
            hi = _u64tob((block_id + 1) * ATTR_BLOCK_SIZE)
            return {
                _btou64(k): decode_attrs(v)
                for k, v in self._db.execute(
                    "SELECT id, value FROM attrs WHERE id >= ? AND id < ?",
                    (lo, hi))
            }

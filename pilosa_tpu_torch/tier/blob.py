"""Pluggable blob store for the truly-cold tier and the backup archive.

Copy of the JAX package's ``tier/blob.py``: the object names, the
manifest JSON and the object bytes are the JAX package's, byte for
byte, so a store either package pushed is fetched by the other.

The store holds demoted fragment snapshots decomposed the same way
the resize FragmentStreamer moves them: per container block, keyed by
content. A fragment's blob layout::

    <prefix>/manifest.json   {"bodyLen", "footerLen", "blockN",
                              "crcs": [u32...], "head": "head-<crc>",
                              "blocks": ["blk-<i>-<crc>", ...],
                              "tail": "tail-<hash>", "size"}
    <prefix>/head-<crc32>    header region [0, offsets[0])
    <prefix>/blk-<i>-<crc32> container block i's bytes
    <prefix>/tail-<hash>     footer bytes [bodyLen, bodyLen+footerLen)
                             (hash-named, not crc: a footer ends with
                             its own crc32, so crc32(tail) is the same
                             constant for every valid footer)

Pushes are block-diffs: a block object whose name (index + crc32,
straight from the snapshot footer's table) already exists is skipped, so
re-pushing a fragment after a small change uploads only the changed
blocks — the same convergence economics as the resize stream, against
a store instead of a peer. Objects are content-named and writes are
tmp+rename, so a crashed push never leaves a readable-but-wrong
object; the manifest lands last and is the commit point.

The object-pool helpers (``build_manifest`` / ``push_objects`` /
``fetch_objects`` / ``verify_objects``) take the manifest explicitly,
so a consumer that stores manifests elsewhere — the backup archive
keeps them inside a whole-backup manifest, letting every backup share
one content-addressed pool — reuses the exact push/verify machinery
the tier uses. ``push_fragment`` / ``fetch_fragment`` /
``verify_fragment`` keep the tier's per-prefix-manifest layout.

:class:`LocalDirBlobStore` stands in for object storage (one file per
object under a root dir). Any object store with put/get/delete/exists
semantics slots in behind :class:`BlobStore`.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zlib
from typing import Optional

from ..storage import integrity as integrity_mod


class BlobStore:
    """Minimal object-store surface the tier manager needs."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def state(self) -> dict:
        return {"kind": type(self).__name__}


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives a host
    crash. Best-effort on platforms whose dirs refuse O_RDONLY opens
    or fsync (the rename itself is still atomic)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class LocalDirBlobStore(BlobStore):
    """One file per object under ``root`` — the local-dir backend
    standing in for object storage. Keys use ``/`` separators and map
    to subdirectories; writes are tmp+rename within the root so a
    concurrent reader never sees a torn object, and both the object
    bytes and the parent directory entry are fsynced before ``put``
    returns — the archive consistency contract requires that a
    visible object is a READABLE object even across a host crash
    (without the directory fsync, the rename itself can be lost while
    a dependent manifest written later survives)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if ".." in key or key.startswith("/"):
            raise ValueError(f"bad blob key: {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        parent = os.path.dirname(path) or self.root
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=parent, prefix=".put-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(parent)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> list[str]:
        out = []
        base = self.root
        for root, _dirs, files in os.walk(base):
            for name in files:
                if name.startswith(".put-"):
                    continue
                rel = os.path.relpath(os.path.join(root, name), base)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def state(self) -> dict:
        keys = self.list()
        return {"kind": "dir", "root": self.root, "objects": len(keys)}


def open_blob_store(spec: str, cold_dir: str) -> Optional[BlobStore]:
    """``[tier] blob`` spec → a store. ``""`` disables the blob tier;
    ``dir`` roots the local-dir backend at ``<cold_dir>/blob``;
    ``dir:<path>`` roots it explicitly."""
    if not spec:
        return None
    if spec == "dir":
        return LocalDirBlobStore(os.path.join(cold_dir, "blob"))
    if spec.startswith("dir:"):
        return LocalDirBlobStore(spec[len("dir:"):])
    raise ValueError(f"unknown tier blob backend: {spec!r}")


def fragment_prefix(index: str, frame: str, view: str, slice: int
                    ) -> str:
    return f"{index}/{frame}/{view}/{slice}"


# -- shared object-pool machinery ---------------------------------------------


def build_manifest(buf: bytes,
                   info: integrity_mod.FooterInfo) -> dict:
    """The per-fragment object manifest for a verified cold snapshot
    (body + footer, no op records): content-derived object names plus
    the footer's block geometry. Pure — no store I/O."""
    offs = info.offsets
    sizes = info.sizes
    head_end = int(offs[0]) if info.block_n else info.body_len
    head = bytes(buf[:head_end])
    tail = bytes(buf[info.body_len:info.body_len + info.size])
    return {"bodyLen": info.body_len, "footerLen": info.size,
            "blockN": info.block_n,
            "crcs": [int(c) for c in info.crcs],
            "offsets": [int(o) for o in offs],
            "sizes": [int(s) for s in sizes],
            "head": f"head-{zlib.crc32(head) & 0xFFFFFFFF:08x}",
            "blocks": [f"blk-{i}-{int(info.crcs[i]):08x}"
                       for i in range(info.block_n)],
            # NOT crc-named: the footer ends with its own crc32, and
            # crc32(data || crc32(data)) is the constant residue
            # 0x2144DF1C for EVERY valid footer — crc-naming (even
            # seeded or prefixed: CRC is affine, equal-length tails
            # shift identically) would alias every tail in a shared
            # pool to one object.
            "tail": f"tail-{hashlib.blake2b(tail, digest_size=4).hexdigest()}",
            "size": info.body_len + info.size}


def push_objects(store: BlobStore, prefix: str, buf: bytes,
                 manifest: dict, put=None) -> tuple[int, int]:
    """Push the head/block/tail objects ``manifest`` names under
    ``prefix``, skipping objects the store already holds — the
    block-diff push. Does NOT write a manifest (the caller owns the
    commit point). ``put`` overrides the store write (fault-injection
    wrappers). Returns (objects_pushed, bytes_pushed)."""
    put = put or (lambda key, data: store.put(key, data))
    offs = manifest["offsets"]
    sizes = manifest["sizes"]
    body_len = int(manifest["bodyLen"])
    block_n = int(manifest["blockN"])
    head_end = int(offs[0]) if block_n else body_len
    pushed = nbytes = 0
    parts = [(manifest["head"], bytes(buf[:head_end]))]
    for i in range(block_n):
        off, size = int(offs[i]), int(sizes[i])
        parts.append((manifest["blocks"][i],
                      bytes(buf[off:off + size])))
    parts.append((manifest["tail"],
                  bytes(buf[body_len:body_len
                            + int(manifest["footerLen"])])))
    for name, data in parts:
        key = f"{prefix}/{name}"
        if store.exists(key):
            continue
        put(key, data)
        pushed, nbytes = pushed + 1, nbytes + len(data)
    return pushed, nbytes


def fetch_objects(store: BlobStore, prefix: str, manifest: dict,
                  get=None) -> bytes:
    """Reassemble a fragment file from the objects ``manifest`` names.
    Raises CorruptionError when any object's bytes contradict the
    manifest's recorded crcs or sizes — the caller discards and
    retries/blocks, never admits bad bytes. ``get`` overrides the
    store read (fault-injection wrappers)."""
    get = get or (lambda key: store.get(key))
    parts = [get(f"{prefix}/{manifest['head']}")]
    for i, name in enumerate(manifest["blocks"]):
        data = get(f"{prefix}/{name}")
        want = int(manifest["crcs"][i])
        if (zlib.crc32(data) & 0xFFFFFFFF) != want:
            raise integrity_mod.CorruptionError(
                f"blob fragment {prefix}: block {i} crc mismatch")
        parts.append(data)
    parts.append(get(f"{prefix}/{manifest['tail']}"))
    buf = b"".join(parts)
    if len(buf) != int(manifest["size"]):
        raise integrity_mod.CorruptionError(
            f"blob fragment {prefix}: reassembled {len(buf)}B,"
            f" manifest says {manifest['size']}B")
    return buf


def verify_objects(store: BlobStore, prefix: str,
                   manifest: dict) -> dict:
    """Scrub one fragment's objects: every object's bytes against the
    manifest crcs (block objects) and the reassembled body against
    the footer digest. Verdict dict in the scrub_file shape."""
    try:
        buf = fetch_objects(store, prefix, manifest)
    except integrity_mod.CorruptionError as e:
        return {"corrupt": True, "error": str(e), "coverage": "full"}
    except OSError as e:
        return {"corrupt": True, "error": f"missing object: {e}",
                "coverage": "none"}
    try:
        info = integrity_mod.parse_footer(buf, int(manifest["bodyLen"]))
        if info is None:
            return {"corrupt": True, "error": "no footer",
                    "coverage": "none"}
        integrity_mod.verify_body(buf, info)
    except ValueError as e:
        return {"corrupt": True, "error": str(e), "coverage": "full"}
    return {"corrupt": False, "coverage": "full",
            "blocks": int(manifest["blockN"]),
            "bytes": len(buf)}


# -- the tier's per-prefix-manifest layout ------------------------------------


def push_fragment(store: BlobStore, prefix: str, buf: bytes,
                  info: integrity_mod.FooterInfo) -> tuple[int, int]:
    """Decompose a verified cold snapshot (body + footer, no op
    records) into content-named objects under ``prefix``, skipping
    blocks the store already holds — the block-diff push. Returns
    (objects_pushed, bytes_pushed). The manifest write is the commit
    point and always lands last."""
    manifest = build_manifest(buf, info)
    pushed, nbytes = push_objects(store, prefix, buf, manifest)
    store.put(f"{prefix}/manifest.json",
              json.dumps(manifest).encode())
    return pushed, nbytes


def read_manifest(store: BlobStore, prefix: str) -> Optional[dict]:
    try:
        return json.loads(store.get(f"{prefix}/manifest.json"))
    except (OSError, ValueError):
        return None


def fetch_fragment(store: BlobStore, prefix: str) -> bytes:
    """Reassemble a fragment file from its blob objects. Raises
    CorruptionError when any object's bytes contradict the manifest's
    recorded crcs or the reassembled footer fails verification — the
    caller discards and retries/blocks, never admits bad bytes."""
    manifest = read_manifest(store, prefix)
    if manifest is None:
        raise integrity_mod.CorruptionError(
            f"blob fragment {prefix}: no manifest")
    return fetch_objects(store, prefix, manifest)


def delete_fragment(store: BlobStore, prefix: str) -> int:
    """Drop every object under ``prefix`` (manifest FIRST, so a crash
    mid-delete leaves an unreadable — not wrong — remainder)."""
    n = 0
    store.delete(f"{prefix}/manifest.json")
    for key in store.list(prefix + "/"):
        store.delete(key)
        n += 1
    return n


def verify_fragment(store: BlobStore, prefix: str) -> dict:
    """Scrub one blob fragment: every object's bytes against the
    manifest crcs (block objects) and the reassembled body against
    the footer digest. Verdict dict in the scrub_file shape."""
    manifest = read_manifest(store, prefix)
    if manifest is None:
        return {"corrupt": True, "error": "no manifest",
                "coverage": "none"}
    return verify_objects(store, prefix, manifest)

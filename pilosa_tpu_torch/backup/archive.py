"""Backup archive layout + failpoint-wrapped object I/O.

The archive is any :class:`tier.blob.BlobStore`; the layout::

    backups/<id>/manifest.json   whole-backup manifest — the COMMIT
                                 POINT: schema, topology epoch/hosts,
                                 per-fragment blob manifests + body
                                 digests, backup lineage (parent), and
                                 the WAL watermark restore replays from
    data/<index>/<frame>/<view>/<slice>/<obj>
                                 ONE content-addressed object pool
                                 shared by every backup — a push skips
                                 objects the pool already holds, so an
                                 incremental backup ships only changed
                                 blocks (the FragmentStreamer
                                 block-diff shape, keyed by the
                                 snapshot footer's per-block crc
                                 table)
    wal/<node>/<seq>-<crc32>     archived WAL segments (JSON batches
                                 of committed op records), crc-named
                                 so ``check --deep`` re-verifies them
                                 without trusting their contents

Every object write goes through :func:`put_object` (the
``backup.push`` failpoint: fires AFTER the store write so error mode
models a crash with the object durable — resume must skip it; torn
mode replaces the object with a prefix; corrupt flips stored bits) and
every restore read through :func:`get_object` (``restore.fetch``:
corrupt flips the stored bytes BEFORE the read so digest-verified
admission must reject them).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import zlib
from typing import Optional

from ..fault import failpoints as _fp
from ..obs import metrics as obs_metrics
from ..storage import integrity as integrity_mod
from ..storage import roaring
from ..tier import blob as blob_mod

BACKUPS_PREFIX = "backups"
DATA_PREFIX = "data"
WAL_PREFIX = "wal"
MANIFEST_VERSION = 1

_WAL_KEY_RE = re.compile(
    r"^wal/(?P<node>[^/]+)/(?P<seq>\d{12})-(?P<crc>[0-9a-f]{8})$")


def open_archive(spec: str, data_dir: str
                 ) -> Optional[blob_mod.BlobStore]:
    """``[backup] archive`` spec → a store (same grammar as the tier's
    blob spec). ``""`` disables the archive; ``dir`` roots the
    local-dir backend at ``<data_dir>/_archive``; ``dir:<path>`` roots
    it explicitly (the only sane choice for real DR — the archive must
    survive the data dir's destruction)."""
    if not spec:
        return None
    if spec == "dir":
        return blob_mod.LocalDirBlobStore(
            os.path.join(data_dir, "_archive"))
    if spec.startswith("dir:"):
        return blob_mod.LocalDirBlobStore(spec[len("dir:"):])
    raise ValueError(f"unknown backup archive backend: {spec!r}")


# -- failpoint-wrapped object I/O ---------------------------------------------


class _PutWriter:
    """Torn-mode adapter: failpoints' torn branch writes a PREFIX of
    the data through this, replacing the just-stored object with a
    truncated one — exactly the state a crashed multipart upload
    leaves behind."""

    def __init__(self, store: blob_mod.BlobStore, key: str):
        self.store = store
        self.key = key

    def write(self, data) -> int:
        self.store.put(self.key, bytes(data))
        return len(data)


def _local_path(store: blob_mod.BlobStore, key: str) -> Optional[str]:
    if isinstance(store, blob_mod.LocalDirBlobStore):
        return store._path(key)
    return None


def put_object(store: blob_mod.BlobStore, key: str,
               data: bytes) -> None:
    """One archive object write. The ``backup.push`` hit sits AFTER
    the store write: error mode models a coordinator crash with the
    object already durable (idempotent resume must skip it), torn mode
    replaces the object with a prefix, corrupt mode flips real stored
    bits; partition mode scopes by object key."""
    try:
        store.put(key, data)
        if _fp.ACTIVE is not None:
            _fp.ACTIVE.hit("backup.push", host=key,
                           writer=_PutWriter(store, key), data=data,
                           path=_local_path(store, key))
    except OSError:
        obs_metrics.BACKUP_ERRORS.labels("backup.push").inc()
        raise
    obs_metrics.BACKUP_OBJECTS.labels("pushed").inc()
    obs_metrics.BACKUP_BYTES.labels("push").inc(len(data))


def get_object(store: blob_mod.BlobStore, key: str) -> bytes:
    """One archive object read. The ``restore.fetch`` hit sits BEFORE
    the store read so corrupt mode rots the stored bytes first — the
    caller's digest check is what keeps rotten bytes out of a restored
    cluster."""
    try:
        if _fp.ACTIVE is not None:
            _fp.ACTIVE.hit("restore.fetch", host=key,
                           path=_local_path(store, key))
        data = store.get(key)
    except OSError:
        obs_metrics.BACKUP_ERRORS.labels("restore.fetch").inc()
        raise
    obs_metrics.BACKUP_BYTES.labels("fetch").inc(len(data))
    return data


# -- fragment bodies -----------------------------------------------------------


def fragment_prefix(index: str, frame: str, view: str,
                    slice: int) -> str:
    return f"{DATA_PREFIX}/{index}/{frame}/{view}/{slice}"


def parse_verified(buf) -> tuple:
    """Parse + fully verify raw fragment-file bytes (snapshot body
    [+footer] [+op tail]); returns ``(FooterInfo, ops_start)`` where
    ``ops_start`` is the end of body+footer. Raises CorruptionError on
    any mismatch or when the file predates integrity footers — an
    unverifiable body must never enter the archive."""
    try:
        (hdr, _run_mask, _ns, offs, sizes, ops_offset,
         body_end) = roaring.parse_snapshot_layout(memoryview(buf))
    except ValueError as e:
        raise integrity_mod.CorruptionError(str(e))
    info = integrity_mod.parse_and_verify_footer(
        buf, len(hdr), ops_offset, offs, sizes, body_end,
        check_body=True)
    if info is None:
        raise integrity_mod.CorruptionError(
            "no integrity footer (vintage file cannot be archived)")
    return info, body_end + info.size


def body_digest(buf) -> str:
    """The per-fragment body digest the backup manifest records and
    restore admission re-checks (independent of the per-object crcs —
    it covers the REASSEMBLY, not just each part)."""
    return hashlib.blake2b(bytes(buf), digest_size=16).hexdigest()


def push_fragment_bytes(store: blob_mod.BlobStore, prefix: str,
                        filebuf: bytes) -> tuple:
    """Verify + decompose one fragment file into the shared object
    pool (block-diff: pool-resident objects are skipped). Any op tail
    is dropped from the pushed body — committed ops travel via the WAL
    archive, and restore replays them. Returns
    ``(frag_manifest, body_digest, objects_pushed, bytes_pushed)``."""
    info, ops_start = parse_verified(filebuf)
    buf = bytes(filebuf[:ops_start])
    manifest = blob_mod.build_manifest(buf, info)
    pushed, nbytes = blob_mod.push_objects(
        store, prefix, buf, manifest,
        put=lambda key, data: put_object(store, key, data))
    skipped = (2 + int(manifest["blockN"])) - pushed
    if skipped > 0:
        obs_metrics.BACKUP_OBJECTS.labels("skipped").inc(skipped)
    return manifest, body_digest(buf), pushed, nbytes


def fetch_fragment_bytes(store: blob_mod.BlobStore, prefix: str,
                         manifest: dict, digest: str = "") -> bytes:
    """Reassemble one fragment body from the pool with FULL admission
    verification (the snapshot footer's contract): per-object crcs, the
    recorded body digest, and the reassembled footer's own
    header/body/block checks. Raises CorruptionError — corrupt or torn
    archive bytes are never admitted, never served."""
    buf = blob_mod.fetch_objects(
        store, prefix, manifest,
        get=lambda key: get_object(store, key))
    if digest and body_digest(buf) != digest:
        raise integrity_mod.CorruptionError(
            f"archive fragment {prefix}: body digest mismatch")
    parse_verified(buf)
    return buf


# -- WAL segments --------------------------------------------------------------


def sanitize_node(host: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", host or "node")


def wal_segment_key(node: str, seq: int, body: bytes) -> str:
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return f"{WAL_PREFIX}/{sanitize_node(node)}/{seq:012d}-{crc:08x}"


def parse_wal_key(key: str) -> Optional[tuple]:
    """``wal/<node>/<seq>-<crc>`` → (node, seq, crc) or None."""
    m = _WAL_KEY_RE.match(key)
    if m is None:
        return None
    return m.group("node"), int(m.group("seq")), int(m.group("crc"),
                                                    16)


def encode_wal_segment(node: str, seq: int,
                       batches: list[dict]) -> bytes:
    """Segment body: committed op batches in commit order. ``ops``
    bytes ride base64 (the segment is JSON so ``check --deep`` and
    humans can read it; the crc in the KEY is the integrity check)."""
    return json.dumps(
        {"version": MANIFEST_VERSION, "node": node, "seq": seq,
         "batches": [{"frag": b["frag"], "t": b["t"],
                      "ops": base64.b64encode(b["ops"]).decode()}
                     for b in batches]}).encode()


def read_wal_segment(store: blob_mod.BlobStore, key: str) -> dict:
    """Fetch + verify one WAL segment (crc from the key name, then
    JSON shape); ``ops`` come back as bytes. CorruptionError on any
    mismatch."""
    parsed = parse_wal_key(key)
    if parsed is None:
        raise integrity_mod.CorruptionError(
            f"wal segment {key}: unparseable key")
    data = get_object(store, key)
    if (zlib.crc32(data) & 0xFFFFFFFF) != parsed[2]:
        raise integrity_mod.CorruptionError(
            f"wal segment {key}: crc mismatch")
    try:
        doc = json.loads(data)
        batches = [{"frag": str(b["frag"]), "t": float(b["t"]),
                    "ops": base64.b64decode(b["ops"])}
                   for b in doc.get("batches", [])]
    except (ValueError, KeyError, TypeError) as e:
        raise integrity_mod.CorruptionError(
            f"wal segment {key}: undecodable: {e}")
    return {"node": str(doc.get("node", parsed[0])),
            "seq": int(doc.get("seq", parsed[1])),
            "batches": batches}


def list_wal_segments(store: blob_mod.BlobStore) -> list[tuple]:
    """Every archived segment as (key, node, seq), seq-ordered per
    node (keys that don't parse are ignored — they are GC's orphan
    sweep's problem, not the replayer's)."""
    out = []
    for key in store.list(WAL_PREFIX + "/"):
        parsed = parse_wal_key(key)
        if parsed is not None:
            out.append((key, parsed[0], parsed[1]))
    out.sort(key=lambda t: (t[1], t[2]))
    return out


def next_wal_seq(store: blob_mod.BlobStore, node: str) -> int:
    """The next unused segment seq for ``node`` — resumes numbering
    across restarts from the store itself."""
    san = sanitize_node(node)
    seqs = [seq for _k, n, seq in list_wal_segments(store)
            if n == san]
    return (max(seqs) + 1) if seqs else 0


# -- backup manifests ----------------------------------------------------------


def backup_manifest_key(backup_id: str) -> str:
    return f"{BACKUPS_PREFIX}/{backup_id}/manifest.json"


def read_backup(store: blob_mod.BlobStore,
                backup_id: str) -> Optional[dict]:
    try:
        doc = json.loads(store.get(backup_manifest_key(backup_id)))
    except (OSError, ValueError):
        return None
    if doc.get("version") != MANIFEST_VERSION:
        return None
    return doc


def list_backups(store: blob_mod.BlobStore) -> list[dict]:
    """Every committed backup's manifest, oldest first. An id dir
    without a readable manifest is an uncommitted (crashed) backup —
    invisible here, reclaimed by GC's orphan sweep."""
    out = []
    for key in store.list(BACKUPS_PREFIX + "/"):
        parts = key.split("/")
        if len(parts) == 3 and parts[2] == "manifest.json":
            doc = read_backup(store, parts[1])
            if doc is not None:
                out.append(doc)
    out.sort(key=lambda d: (d.get("t", 0.0), d.get("id", "")))
    return out


def write_backup_manifest(store: blob_mod.BlobStore,
                          manifest: dict) -> None:
    put_object(store, backup_manifest_key(manifest["id"]),
               json.dumps(manifest).encode())


def manifest_object_keys(manifest: dict) -> set[str]:
    """Every pool object a backup's restore chain references."""
    keys: set[str] = set()
    for frag in manifest.get("fragments", []):
        prefix = frag["prefix"]
        fm = frag["manifest"]
        keys.add(f"{prefix}/{fm['head']}")
        keys.update(f"{prefix}/{name}" for name in fm["blocks"])
        keys.add(f"{prefix}/{fm['tail']}")
    return keys


# -- offline verification (the ``check --deep`` archive walk) ------------------


def verify_backup(store: blob_mod.BlobStore,
                  manifest: dict) -> list[tuple]:
    """Re-crc every object a backup references; per-fragment verdicts
    in the scrub_file shape (the same format as the data-dir walk).
    Returns ``[(name, verdict), ...]``."""
    out = []
    for frag in manifest.get("fragments", []):
        name = (f"{manifest['id']}: {frag['index']}/{frag['frame']}"
                f"/{frag['view']}/{frag['slice']}")
        try:
            buf = fetch_fragment_bytes(store, frag["prefix"],
                                       frag["manifest"],
                                       frag.get("bodyDigest", ""))
            verdict = {"corrupt": False, "coverage": "full",
                       "blocks": int(frag["manifest"]["blockN"]),
                       "bytes": len(buf)}
        except integrity_mod.CorruptionError as e:
            verdict = {"corrupt": True, "error": str(e),
                       "coverage": "full"}
        except OSError as e:
            verdict = {"corrupt": True,
                       "error": f"missing object: {e}",
                       "coverage": "none"}
        out.append((name, verdict))
    return out


def verify_wal(store: blob_mod.BlobStore) -> list[tuple]:
    """Re-crc every archived WAL segment; ``[(key, verdict), ...]``."""
    out = []
    for key, _node, _seq in list_wal_segments(store):
        try:
            seg = read_wal_segment(store, key)
            verdict = {"corrupt": False, "coverage": "full",
                       "batches": len(seg["batches"])}
        except integrity_mod.CorruptionError as e:
            verdict = {"corrupt": True, "error": str(e),
                       "coverage": "full"}
        except OSError as e:
            verdict = {"corrupt": True,
                       "error": f"missing object: {e}",
                       "coverage": "none"}
        out.append((key, verdict))
    return out

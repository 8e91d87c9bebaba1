"""Point-in-time restore: archive → a live cluster of ANY size.

The restorer never places data itself — it recreates the schema, then
asks the TARGET cluster who owns each slice (``/fragment/nodes``, the
same jump-hash placement the executor uses) and POSTs each
reassembled fragment to every owner. A 1-node backup restores onto a
3-node cluster (and vice versa) because placement is re-derived, not
recorded.

Admission is digest-verified (the snapshot footer's contract): every
object is crc-checked, the reassembled body re-checked against the
manifest's recorded digest AND its own integrity footer — torn or
corrupt archive objects raise before any byte reaches a fragment, so they are
never admitted, never served.

``--to-timestamp`` picks the newest backup taken at-or-before the
cut, then replays archived WAL batches with commit stamps ≤ the cut;
batches stamped after it are excluded (the stamp lands between a
write's issue and its ack — see backup.walarchive). Restore without a
cut replays the whole archive: the restored cluster serves the LATEST
archived state, including writes committed after the backup ran.

Per fragment, replay takes the batches of EVERY source node's stream,
merged by commit stamp with each node's own order kept (per-WAL sink
order is commit order). Replicas archive duplicate streams, and op
records are idempotent per position, so the duplicates converge (see
backup.coordinator's consistency argument). A slice that a resize
moved while the archive ran has its writes before the cutover in the
old owner's stream and those after it in the new owner's: both are
replayed. (The JAX package replays only the stream with the most op
bytes and loses the other's writes, ROADMAP fault 3.17.)
"""

from __future__ import annotations

import heapq
import io
import tarfile
from typing import Optional

from ..obs import metrics as obs_metrics
from ..storage import integrity as integrity_mod
from ..storage import roaring
from ..utils import logger as logger_mod
from . import archive as archive_mod


class RestoreError(Exception):
    pass


def pick_backup(store, backup_id: Optional[str] = None,
                to_timestamp: Optional[float] = None) -> dict:
    """The restore base: an explicit id, or the newest committed
    backup taken at-or-before the cut (a backup taken AFTER the cut
    already embeds post-cut state in its snapshots — it can never be
    the base for that cut)."""
    if backup_id:
        manifest = archive_mod.read_backup(store, backup_id)
        if manifest is None:
            raise RestoreError(f"no committed backup {backup_id!r}"
                               f" in the archive")
        if to_timestamp is not None \
                and manifest.get("t", 0.0) > to_timestamp:
            raise RestoreError(
                f"backup {backup_id} was taken after the requested"
                f" timestamp; pick an earlier backup")
        return manifest
    backups = archive_mod.list_backups(store)
    if to_timestamp is not None:
        backups = [b for b in backups
                   if b.get("t", 0.0) <= to_timestamp]
    if not backups:
        raise RestoreError("no usable backup in the archive"
                           + (" at-or-before the requested timestamp"
                              if to_timestamp is not None else ""))
    return backups[-1]


def gather_wal_ops(store, wal_start: dict,
                   cut: Optional[float] = None) -> dict:
    """Archived op batches to replay, keyed by fragment
    (``index/frame/view/slice``): per fragment, every node's batches
    merged by commit stamp (each node's segment order kept), excluding
    batches stamped after the cut. Segments below a node's ``walStart``
    watermark predate the backup's snapshots and are skipped."""
    per_frag: dict = {}  # frag -> node -> [batch, ...] in commit order
    for key, node, seq in archive_mod.list_wal_segments(store):
        if seq < int(wal_start.get(node, 0)):
            continue
        seg = archive_mod.read_wal_segment(store, key)
        for batch in seg["batches"]:
            if cut is not None and batch["t"] > cut:
                continue
            per_frag.setdefault(batch["frag"], {}).setdefault(
                node, []).append(batch)
    return {frag: b"".join(b["ops"] for b in heapq.merge(
                *streams.values(), key=lambda b: b["t"]))
            for frag, streams in per_frag.items()}


def _empty_body() -> bytes:
    """A footered empty-bitmap snapshot — the base for fragments that
    exist ONLY in the WAL archive (created after the backup ran)."""
    buf = io.BytesIO()
    roaring.Bitmap().write_to(buf, footer=True)
    return buf.getvalue()


def _fragment_tar(file_bytes: bytes) -> io.BytesIO:
    """The ``write_to`` wire shape (data + empty cache) around raw
    fragment-file bytes, ready for POST /fragment/data."""
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w|") as tw:
        info = tarfile.TarInfo("data")
        info.size = len(file_bytes)
        info.mode = 0o600
        tw.addfile(info, io.BytesIO(file_bytes))
        cinfo = tarfile.TarInfo("cache")
        cinfo.size = 0
        cinfo.mode = 0o600
        tw.addfile(cinfo)
    out.seek(0)
    return out


def _push_fragment(client, index: str, frame: str, view: str,
                   slice: int, file_bytes: bytes) -> int:
    """POST one reassembled fragment to EVERY owner the TARGET
    cluster names for its slice (any-size placement). Returns the
    owner count."""
    nodes = client.fragment_nodes(index, slice)
    tar = _fragment_tar(file_bytes)
    body = tar.getvalue()
    for node in nodes:
        status, raw = client._do(
            "POST", f"/fragment/data?index={index}&frame={frame}"
                    f"&view={view}&slice={slice}", body,
            {"Content-Type": "application/octet-stream",
             "Content-Length": str(len(body))},
            host=node["host"])
        client._ok(status, raw,
                   f"restore {index}/{frame}/{view}/{slice}")
    return len(nodes)


def run_restore(host: str, store, backup_id: Optional[str] = None,
                to_timestamp: Optional[float] = None,
                client=None, logger=None) -> dict:
    """Restore a backup (+ WAL replay up to ``to_timestamp``) into
    the live cluster at ``host``. Returns a summary dict; raises
    RestoreError / CorruptionError — a restore that cannot verify
    every byte fails loudly rather than serving wrong answers."""
    logger = logger or logger_mod.NOP
    if client is None:
        from ..cluster.client import Client
        client = Client(host)
    manifest = pick_backup(store, backup_id=backup_id,
                           to_timestamp=to_timestamp)
    logger.printf("restore: base backup %s (kind %s, %d fragments)",
                  manifest["id"], manifest.get("kind"),
                  len(manifest.get("fragments", [])))
    for idx in manifest.get("schema", []):
        client.create_index(idx["name"])
        for frame in idx.get("frames", []):
            options = {}
            if frame.get("fields"):
                options["fields"] = frame["fields"]
            client.create_frame(idx["name"], frame["name"], options)
    wal_ops = gather_wal_ops(store,
                             manifest.get("walStart") or {},
                             cut=to_timestamp)
    restored = 0
    ops_bytes = 0
    corrupt: list[str] = []
    for frag in manifest.get("fragments", []):
        key = (f"{frag['index']}/{frag['frame']}/{frag['view']}"
               f"/{frag['slice']}")
        try:
            body = archive_mod.fetch_fragment_bytes(
                store, frag["prefix"], frag["manifest"],
                frag.get("bodyDigest", ""))
        except (integrity_mod.CorruptionError, OSError) as e:
            obs_metrics.BACKUP_FRAGMENTS.labels("corrupt").inc()
            corrupt.append(f"{key}: {e}")
            # Its op history alone is not the fragment: replayed onto an
            # empty base it would serve a partial state (the JAX restore
            # rebuilds it so, ROADMAP fault 3.21).
            wal_ops.pop(key, None)
            continue
        ops = wal_ops.pop(key, b"")
        _push_fragment(client, frag["index"], frag["frame"],
                       frag["view"], frag["slice"], body + ops)
        obs_metrics.BACKUP_FRAGMENTS.labels("restored").inc()
        restored += 1
        ops_bytes += len(ops)
    # Fragments born AFTER the backup exist only as WAL batches:
    # rebuild them from an empty footered base + their op history.
    wal_only = 0
    empty = None
    for key, ops in sorted(wal_ops.items()):
        parts = key.split("/")
        if len(parts) != 4 or not parts[3].isdigit() or not ops:
            continue
        if empty is None:
            empty = _empty_body()
        _push_fragment(client, parts[0], parts[1], parts[2],
                       int(parts[3]), empty + ops)
        obs_metrics.BACKUP_FRAGMENTS.labels("restored").inc()
        wal_only += 1
        ops_bytes += len(ops)
    if corrupt:
        raise RestoreError(
            f"restore {manifest['id']}: {len(corrupt)} fragments"
            f" failed verification and were NOT admitted: "
            + "; ".join(corrupt[:4]))
    summary = {"id": manifest["id"], "kind": manifest.get("kind"),
               "backupT": manifest.get("t"),
               "toTimestamp": to_timestamp,
               "fragments": restored, "walOnlyFragments": wal_only,
               "walOpsBytes": ops_bytes,
               "hosts": [n["host"] for n in
                         (client.nodes() if hasattr(client, "nodes")
                          else [])] or None}
    logger.printf("restore: done (%d fragments, %d wal-only,"
                  " %d op bytes replayed)", restored, wal_only,
                  ops_bytes)
    return summary

"""Archive retention + GC: keep the last N fulls and everything their
restore chains depend on.

Safety invariants (checked twice — at plan time and again inside
``run_gc`` before any delete):

- The newest full backup's restore chain (its manifest, every pool
  object it references, and every WAL segment at-or-past its
  ``walStart`` watermark) is NEVER collectable — an archive must
  always hold at least one restorable backup.
- A dropped backup's objects are deleted only if NO kept backup
  references them (the pool is shared; incrementals alias their
  parents' blocks).
- Incrementals depend on their parent chain: keeping a backup keeps
  every ancestor, even ancestors older than the retention window.
- WAL segments are kept from the MINIMUM ``walStart`` across kept
  backups (a backup without a node's watermark holds that node's floor
  at 0) — point-in-time restore from any kept backup stays possible.
- The orphan sweep (pool objects no committed manifest references —
  debris from crashed, never-committed backups) runs only when asked:
  an IN-FLIGHT backup's objects are unreferenced until its manifest
  commits, so sweeping while a backup runs would eat it. Callers gate
  this on "no backup in flight".
"""

from __future__ import annotations

from . import archive as archive_mod


class GCError(Exception):
    pass


def _chain_closure(by_id: dict, roots: list[dict]) -> dict:
    """roots + every ancestor via ``parent`` lineage, keyed by id."""
    kept: dict = {}
    stack = list(roots)
    while stack:
        m = stack.pop()
        if m["id"] in kept:
            continue
        kept[m["id"]] = m
        parent = m.get("parent")
        if parent and parent in by_id:
            stack.append(by_id[parent])
    return kept


def plan_gc(store, keep_fulls: int = 2) -> dict:
    """The retention plan — pure read, never deletes. Keeps the last
    ``keep_fulls`` full backups (floor 1), every incremental taken
    since the oldest kept full, and every ancestor any kept backup
    depends on; everything else is droppable."""
    keep_fulls = max(1, int(keep_fulls))
    backups = archive_mod.list_backups(store)  # oldest first
    by_id = {m["id"]: m for m in backups}
    fulls = [m for m in backups if m.get("kind") == "full"]
    kept_fulls = fulls[-keep_fulls:]
    if fulls and not kept_fulls:
        raise GCError("retention would drop every full backup")
    roots = list(kept_fulls)
    if kept_fulls:
        horizon = (kept_fulls[0].get("t", 0.0),
                   kept_fulls[0].get("id", ""))
        roots += [m for m in backups if m.get("kind") != "full"
                  and (m.get("t", 0.0), m.get("id", "")) >= horizon]
    else:
        roots = list(backups)  # no fulls at all: keep everything
    kept = _chain_closure(by_id, roots)
    dropped = [m for m in backups if m["id"] not in kept]

    kept_objects: set = set()
    for m in kept.values():
        kept_objects |= archive_mod.manifest_object_keys(m)
    drop_objects: set = set()
    for m in dropped:
        drop_objects |= archive_mod.manifest_object_keys(m)
    drop_objects -= kept_objects

    # WAL horizon: the minimum walStart per node across kept backups —
    # every kept backup must stay point-in-time restorable. A backup
    # without a watermark for a node (it had no segment yet) replays
    # that node's segments from 0, as restore reads it: its floor there
    # is 0. (The JAX plan skips such a backup and drops segments it
    # replays, ROADMAP fault 3.20.)
    drop_wal = []
    if kept:  # no kept backups -> no floor -> keep all WAL
        segments = archive_mod.list_wal_segments(store)
        wal_floor = {node: min(int((m.get("walStart") or {}).get(node, 0))
                               for m in kept.values())
                     for _key, node, _seq in segments}
        for key, node, seq in segments:
            if seq < wal_floor[node]:
                drop_wal.append(key)

    referenced = kept_objects | set()
    for m in backups:
        referenced |= archive_mod.manifest_object_keys(m)
    orphans = [key for key in store.list(archive_mod.DATA_PREFIX + "/")
               if key not in referenced]

    return {"keepFulls": keep_fulls,
            "kept": [m["id"] for m in
                     sorted(kept.values(),
                            key=lambda m: (m.get("t", 0.0),
                                           m.get("id", "")))],
            "newestFull": kept_fulls[-1]["id"] if kept_fulls else None,
            "dropBackups": [m["id"] for m in dropped],
            "dropObjects": sorted(drop_objects),
            "dropWalSegments": sorted(drop_wal),
            "orphanObjects": sorted(orphans)}


def run_gc(store, keep_fulls: int = 2, dry_run: bool = False,
           sweep_orphans: bool = False, logger=None) -> dict:
    """Execute (or with ``dry_run`` just report) the retention plan.
    Re-asserts before deleting that the newest full's restore chain is
    untouched — a GCError here means a planner bug, and nothing has
    been deleted."""
    plan = plan_gc(store, keep_fulls)
    plan["dryRun"] = bool(dry_run)
    plan["sweepOrphans"] = bool(sweep_orphans)
    if not sweep_orphans:
        plan["orphanObjects"] = []

    if plan["newestFull"] is not None:
        newest = archive_mod.read_backup(store, plan["newestFull"])
        if newest is None:
            raise GCError(f"newest full {plan['newestFull']}"
                          f" unreadable; refusing to GC")
        chain = archive_mod.manifest_object_keys(newest)
        doomed = set(plan["dropObjects"]) | set(plan["orphanObjects"])
        clash = chain & doomed
        if clash or plan["newestFull"] in plan["dropBackups"]:
            raise GCError(
                f"plan would break the newest full's restore chain"
                f" ({len(clash)} objects); refusing to GC")
        floors = newest.get("walStart") or {}
        for key in plan["dropWalSegments"]:
            parsed = archive_mod.parse_wal_key(key)
            if parsed is not None \
                    and parsed[1] >= floors.get(parsed[0], 0):
                raise GCError(
                    f"plan would drop WAL segment {key} the newest"
                    f" full still replays; refusing to GC")

    deleted = 0
    if not dry_run:
        for bid in plan["dropBackups"]:
            store.delete(archive_mod.backup_manifest_key(bid))
            deleted += 1
        for key in (plan["dropObjects"] + plan["dropWalSegments"]
                    + plan["orphanObjects"]):
            store.delete(key)
            deleted += 1
    plan["deleted"] = deleted
    if logger is not None:
        logger.printf(
            "backup gc: kept %d, dropped %d backups, %d objects,"
            " %d wal segments, %d orphans%s", len(plan["kept"]),
            len(plan["dropBackups"]), len(plan["dropObjects"]),
            len(plan["dropWalSegments"]), len(plan["orphanObjects"]),
            " (dry run)" if dry_run else "")
    return plan

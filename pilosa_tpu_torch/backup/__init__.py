"""Disaster recovery: consistent cluster backups, WAL archiving, and
verified point-in-time restore.

A copy of the JAX package's ``backup`` package: the archive a port
cluster writes and the archive a JAX cluster writes are the same, object
for object, and each package restores from the other's. The subsystem
behind the ``backup`` and ``restore`` verbs, ``check --deep --archive``
and the ``/backup`` + ``/debug/backup`` routes:

- :mod:`.archive` — the archive layout over a ``tier.blob`` store:
  one shared content-addressed object pool (block-diff economics for
  incrementals), per-backup manifests as the commit point, crc-named
  WAL segments, and the ``backup.push`` / ``restore.fetch``
  failpoint-wrapped object I/O every other module goes through.
- :mod:`.walarchive` — continuous WAL-segment archiving: a sink on
  the group-commit WAL ships every committed op batch into the
  archive, bounding point-in-time-recovery granularity by the flush
  interval.
- :mod:`.coordinator` — the journaled (crash-safe, resumable) backup
  coordinator taking cluster-consistent full/incremental backups.
- :mod:`.restore` — rebuilds a cluster of ANY size from a backup
  (placement re-derived via the target cluster's jump-hash), with
  digest-verified admission and ``--to-timestamp`` WAL replay.
- :mod:`.verify` — restore verification by replaying a captured
  workload (obs.capture) and comparing result digests.
- :mod:`.retention` — archive retention + GC: keep the last N fulls
  plus everything their restore chains depend on.
"""

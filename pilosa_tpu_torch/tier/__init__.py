"""Tiered storage: the working-set manager (the JAX package's ``tier``).

The index may be much bigger than RAM: the tier subsystem decides what
lives where and moves it safely between three residency tiers —

- **hot** — the fragment is fully open: mmap-resident storage, TopN
  cache ranked, device rows eligible for residency on the card.
- **cold** — the fragment was demoted: WAL barriered, op-log folded
  into a fresh checksummed snapshot, caches flushed and the device rows
  dropped, and the file reopened metadata-only. Container blocks fault
  back in on first read, each verified against the snapshot footer's
  per-block crc table (the block map), so queries against cold
  fragments promote exactly what they touch.
- **blob** — the cold file itself left local disk through the
  pluggable blob store (tier.blob; the local-dir backend stands in for
  object storage), pushed block-diff style so a re-push after a small
  change moves only the changed blocks. A ``<path>.blob`` stub keeps
  the fragment discoverable across restarts; the first read fetches,
  verifies the reassembled footer, and re-enters cold.

The cold files, the ``.blob`` stubs, the manifests and the blob objects
are the JAX package's byte for byte: a tiered data directory written by
either package opens in the other.

:class:`~pilosa_tpu_torch.tier.ledger.ResidencyLedger` tracks every
fragment's tier, byte footprint and last-touching tenant;
:class:`~pilosa_tpu_torch.tier.manager.TierManager` runs the demotion,
eviction, blob and prefetch loops against it, honoring the per-tenant
cache shares (sched.tenants) so one tenant's cold scan never flushes
another tenant's working set.
"""

from .blob import BlobStore, LocalDirBlobStore, open_blob_store  # noqa: F401
from .ledger import ResidencyLedger  # noqa: F401
from .manager import ColdFetchError, TierManager  # noqa: F401

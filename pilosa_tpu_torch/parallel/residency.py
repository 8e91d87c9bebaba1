"""Device working-set manager: residency for hot fragment rows.

The torch form of the JAX package's ``parallel/residency.py``. Device
memory is smaller than the on-disk index, so device state is an
explicit, *budgeted* cache:

- ``DeviceBlockCache`` — a process-wide LRU over device-resident packed
  blocks with a byte budget. Entries are the executor's leaf slabs (one
  ``[slices, words]`` int32 slab per PQL leaf row) and its TopN
  candidate blocks (``[slices, rows, words]``).
- ``DeviceRowCache`` — per-fragment host-side LRU of packed row words
  plus the fragment's ``(uid, generation)`` staleness key.

Staleness is handled by keys, not callbacks: every cached block's key
embeds the owning fragments' ``(uid, generation)`` pairs — writes bump
the generation, a reopened fragment gets a fresh uid — so stale entries
stop being referenced and age out of the LRU.

Upload: one extraction per row (ops.packed sparse (word, value) pairs)
feeds a gate (ops.packed.sparse_gate). Sparse blocks upload their
bucketed slots and densify on the device (ops.cuda_kernels.densify);
dense blocks are packed on the host and moved with one ``.to(device)``.
Slabs hold exactly the query's slices — no bucket padding, which the
JAX package needed only to bound XLA compiles.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import packed

# Default packed-row budget per fragment (256 rows × 128 KB = 32 MB
# host-side).
DEFAULT_MAX_ROWS = 256

# Process-wide device budget for resident blocks: a tenth of an H100's
# 80 GB, leaving the rest for streaming blocks and kernel outputs.
DEFAULT_BUDGET_BYTES = 8 << 30

_uid_counter = itertools.count(1)


class DeviceBlockCache:
    """Budgeted process-wide LRU of device-resident tensors.

    Thread-safe. An entry larger than the whole budget is returned
    uncached (one-shot upload) rather than evicting everything else.
    """

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.budget_bytes = budget_bytes
        self._mu = threading.Lock()
        self._lru: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _nbytes(arr: torch.Tensor) -> int:
        return arr.numel() * arr.element_size()

    def get_or_build(self, key: tuple,
                     build: Callable[[], torch.Tensor]) -> torch.Tensor:
        with self._mu:
            arr = self._lru.get(key)
            if arr is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return arr
            self.misses += 1
        # Build outside the lock: packing + upload can take long and
        # must not serialize unrelated queries. Concurrent builders of
        # the same key race benignly (last insert wins).
        arr = build()
        nbytes = self._nbytes(arr)
        if nbytes > self.budget_bytes:
            return arr  # one-shot: bigger than the whole working set
        with self._mu:
            if key not in self._lru:
                self._lru[key] = arr
                self.used_bytes += nbytes
            self._lru.move_to_end(key)
            # len > 1 keeps the just-built entry (now most-recent) alive.
            while self.used_bytes > self.budget_bytes and len(self._lru) > 1:
                _, old = self._lru.popitem(last=False)
                self.used_bytes -= self._nbytes(old)
                self.evictions += 1
        return arr

    def contains(self, key: tuple) -> bool:
        """Residency probe WITHOUT touching LRU order."""
        with self._mu:
            return key in self._lru

    def clear(self) -> None:
        with self._mu:
            self._lru.clear()
            self.used_bytes = 0

    def snapshot(self) -> dict:
        with self._mu:
            return {"entries": len(self._lru),
                    "usedBytes": self.used_bytes,
                    "budgetBytes": self.budget_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


_device_cache: Optional[DeviceBlockCache] = None
_device_cache_mu = threading.Lock()


def device_cache() -> DeviceBlockCache:
    """The process-wide device block cache (lazy singleton)."""
    global _device_cache
    with _device_cache_mu:
        if _device_cache is None:
            _device_cache = DeviceBlockCache()
        return _device_cache


def _upload_pairs(device: torch.device, pairs: list,
                  lead_shape: tuple) -> torch.Tensor:
    """Extracted (idx, val) row pairs → a device int32 block of shape
    ``lead_shape + (WORDS_PER_SLICE,)``: bucketed slots + the densify
    kernel when the sparse gate says so, else a host dense pack and one
    copy."""
    from . import mesh as mesh_mod
    n_words = packed.WORDS_PER_SLICE
    use_sparse, plan = packed.sparse_gate(pairs, n_words)
    if use_sparse:
        subs = n_words // packed._DENSIFY_LANES
        lanes, vals = packed.bucket_prepared(pairs, subs, plan=plan)
        shp = lead_shape + lanes.shape[1:]
        return mesh_mod.densify_sharded(device, lanes.reshape(shp),
                                        vals.reshape(shp))
    block = packed.densify_host(pairs, n_words)
    return torch.from_numpy(
        block.view(np.int32).reshape(lead_shape + (n_words,))).to(device)


def leaf_slab(device: torch.device, key: tuple, frags: list,
              row_id: int) -> torch.Tensor:
    """Device-resident ``[n_slices, words]`` int32 slab of one PQL leaf
    row across ``frags`` (one fragment per slice, None = absent = zero
    words), held in the budgeted cache under ``key``. The caller owns
    the key contract (every backing fragment's (uid, generation))."""

    def build():
        pairs = [frag.sparse_row_pairs(row_id) if frag is not None
                 else None for frag in frags]
        return _upload_pairs(device, pairs, (len(frags),))

    return device_cache().get_or_build(key, build)


def candidate_block(device: torch.device, key: tuple, frags: list,
                    row_ids: tuple) -> torch.Tensor:
    """Device-resident ``[n_slices, n_rows, words]`` TopN candidate
    block (same key/staleness contract as ``leaf_slab``)."""

    def build():
        pairs = [None if frag is None else frag.sparse_row_pairs(rid)
                 for frag in frags for rid in row_ids]
        return _upload_pairs(device, pairs, (len(frags), len(row_ids)))

    return device_cache().get_or_build(key, build)


class DeviceRowCache:
    """Per-fragment residency state: host packed-row LRU plus the
    ``(uid, generation)`` key part of every device block built from the
    fragment."""

    def __init__(self, max_rows: int = DEFAULT_MAX_ROWS):
        self.max_rows = max_rows
        self._host_rows: OrderedDict[int, np.ndarray] = OrderedDict()
        # generation bumps on every write-invalidation; uid is unique
        # per instance so a reopened fragment at generation 0 can never
        # alias a prior instance's entries.
        self.uid = next(_uid_counter)
        self.generation = 0

    def host_row_words(self, storage, row_id: int) -> np.ndarray:
        """Packed host words for one row (read-only view); caches on
        miss. ``storage`` is the fragment-local roaring bitmap."""
        words = self._host_rows.get(row_id)
        if words is not None:
            self._host_rows.move_to_end(row_id)
            return words
        words = np.zeros(packed.WORDS_PER_SLICE, dtype=np.uint32)
        packed.pack_storage_row(storage, row_id, words)
        words.flags.writeable = False  # callers copy, never mutate
        self._host_rows[row_id] = words
        while len(self._host_rows) > self.max_rows:
            self._host_rows.popitem(last=False)
        return words

    def invalidate_row(self, row_id: int) -> None:
        self._host_rows.pop(row_id, None)
        self.generation += 1

    def invalidate_rows(self, row_ids) -> None:
        """Batch invalidation: one generation bump for the whole write
        batch (the key embeds the generation, so one bump suffices)."""
        pop = self._host_rows.pop
        for rid in row_ids:
            pop(rid, None)
        self.generation += 1

    def invalidate_all(self) -> None:
        self._host_rows.clear()
        self.generation += 1

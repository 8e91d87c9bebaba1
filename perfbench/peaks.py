"""Peaks of the card and the byte counts that rooflines divide by them.

NVIDIA's H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full
700 W power limit. A card set below it runs slower under load: the
harness writes the limit beside every share it reports.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

SLICE_BYTES = (1 << 20) // 8  # one row of one slice, dense: 131,072 B


def count_bytes(n_leaves: int, n_slices: int) -> int:
    """Least bytes an expression count reads: each distinct leaf row of
    every slice once, whether a single or a batched entry runs."""
    return n_leaves * n_slices * SLICE_BYTES

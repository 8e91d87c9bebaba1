"""The plain reference: PQL answers from the generated columns, in plain
PyTorch (on the card in a run, on the CPU in the tests).

It imports nothing of the program and reads none of its files, caches or
answers except to judge them. It works from the generated (row, column)
pairs and works out again what the program derives from them. Each
call's answer is its module's (``perfbench/calls/<Name>.py``), from the
pieces here:

- Count: an expression of ``Bitmap`` leaves folded over dense bitsets of
  the leaf rows (one int64 word per 64 columns), then popcounted.
- TopN with a source (reference Pilosa's two phases, executor.go:273-310
  and fragment.go:490-625): per slice, a walk of the rank cache in rank
  order (count descending, id ascending) that keeps the first n rows
  whose source count is positive and then every row whose source count
  reaches the smallest kept one, up to the first row whose own count
  falls below it; then the exact source counts of the union of kept
  rows summed over every slice, count descending, id ascending,
  trimmed to n.
- The rank cache (cache.go:126-275, ``cacheType=ranked``): a bulk
  import adds every row and re-ranks once, keeping the first
  ``cacheSize`` rows and setting the threshold to the next row's count;
  past ``1.1 * cacheSize`` entries only rows above the threshold stay,
  so the re-rank that follows (at most every 10 s) holds those rows
  alone. The harness starts the window after that re-rank
  (``settle_s``), and the reference models that steady state.

The controls (each call module's) break the guarantee the
configurations state (exact answers over every slice): ``Count`` over
all slices but the last, and TopN from its first phase alone, without
the exact count of the union.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import traffic
from perfbench.traffic import OPS

SLICE_WIDTH = 1 << 20
WORDS_PER_SLICE = SLICE_WIDTH // 64  # int64 words
THRESHOLD_FACTOR = 1.1


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Per-word bit counts of an int64 tensor (SWAR; wrapping int64
    arithmetic; the masks clear the bits an arithmetic shift fills)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def dense_rows(rows: np.ndarray, cols: np.ndarray, n_rows: int,
               n_cols: int, device) -> torch.Tensor:
    """``[n_rows, n_cols / 64]`` int64 bitsets of the (row, column)
    pairs, duplicates counted once."""
    n_words = n_cols // 64
    key = torch.from_numpy((rows.astype(np.int64) * n_cols
                            + cols.astype(np.int64))).to(device)
    key = torch.unique(key)
    r, c = key // n_cols, key % n_cols
    words = torch.zeros(n_rows * n_words, dtype=torch.int64, device=device)
    # Distinct bits of one word sum to their OR.
    words.index_add_(0, r * n_words + (c >> 6),
                     torch.ones_like(c) << (c & 63))
    return words.view(n_rows, n_words)


class Reference:
    """Answers of one configuration's data. Each frame's state is built
    at its first use: the dense bitsets of a frame whose rows are
    ``Bitmap`` leaves (``bits``), the rank caches of a frame that TopN
    ranks (``ranked``), or any other a call module keeps (``state``)."""

    def __init__(self, cfg: dict, data: dict, device):
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)
        self.n_slices = int(cfg["slices"])
        self.n_cols = self.n_slices * SLICE_WIDTH
        self._state: dict = {}

    def state(self, key, build):
        """``build()`` once for ``key``."""
        if key not in self._state:
            self._state[key] = build()
        return self._state[key]

    def bits(self, frame: str) -> torch.Tensor:
        return self.state(("bits", frame), lambda: dense_rows(
            *self.data[frame], int(self.cfg["frames"][frame]["rows"]),
            self.n_cols, self.device))

    def ranked(self, frame: str) -> "RankedFrame":
        return self.state(("ranked", frame), lambda: RankedFrame(
            self.cfg["frames"][frame], *self.data[frame], self.n_slices,
            self.device))

    # -- expressions -----------------------------------------------------------

    def words(self, t) -> torch.Tensor:
        if t[0] == "leaf":
            return self.bits(t[1])[t[2]]
        if t[0] not in OPS:
            return traffic.call_kind(t[0]).words(self, t)
        kids = [self.words(c) for c in t[1]]
        out = kids[0].clone()
        for k in kids[1:]:
            if t[0] == "Union":
                out |= k
            elif t[0] == "Intersect":
                out &= k
            elif t[0] == "Difference":
                out &= ~k
            else:
                out ^= k
        return out

    def count(self, expr, drop_last_slice: bool = False) -> int:
        w = self.words(expr)
        if drop_last_slice:
            w = w[:(self.n_slices - 1) * WORDS_PER_SLICE]
        return int(popcount64(w).sum())

    def column_mask(self, expr) -> torch.Tensor:
        """``[n_cols]`` bool of the expression's columns."""
        w = self.words(expr)
        shifts = torch.arange(64, device=w.device, dtype=torch.int64)
        return ((w.unsqueeze(1) >> shifts) & 1).bool().view(-1)

    # -- calls -------------------------------------------------------------------

    def answer(self, call, control: bool = False):
        """The JSON-comparable answer of one call (its module's
        ``answer``), or the control's."""
        return traffic.call_kind(call[0]).answer(self, call, control)


class RankedFrame:
    """A TopN target frame: each (slice, row)'s count, each slice's rank
    cache, and the (slice, row, column) of every bit for the source
    counts."""

    def __init__(self, spec: dict, rows: np.ndarray, cols: np.ndarray,
                 n_slices: int, device):
        opts = spec.get("options", {})
        if opts.get("cacheType", "lru") != "ranked":
            raise ValueError("the reference models ranked caches only")
        self.cache_size = int(opts.get("cacheSize", 50000))
        self.n_rows = int(spec["rows"])
        self.n_slices = n_slices
        n_cols = n_slices * SLICE_WIDTH
        key = torch.from_numpy((rows.astype(np.int64) * n_cols
                                + cols.astype(np.int64))).to(device)
        key = torch.unique(key)
        r, c = key // n_cols, key % n_cols
        self.cols = c
        self.cell = (c >> 20) * self.n_rows + r  # slice * R + row
        counts = torch.bincount(self.cell, minlength=n_slices * self.n_rows)
        self.counts = counts.view(n_slices, self.n_rows).cpu().numpy()
        self.ranks = [self._rank(self.counts[s]) for s in range(n_slices)]

    def _rank(self, counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(ids, counts) of one slice's steady rank cache, rank order."""
        ids = np.flatnonzero(counts > 0)
        cnt = counts[ids]
        order = np.lexsort((ids, -cnt))
        ids, cnt = ids[order], cnt[order]
        size = self.cache_size
        if len(ids) > size:
            threshold = cnt[size]
            if len(ids) > int(THRESHOLD_FACTOR * size):
                keep = cnt > threshold
                ids, cnt = ids[keep], cnt[keep]
            else:
                ids, cnt = ids[:size], cnt[:size]
        return ids, cnt

    def top(self, src_mask: torch.Tensor, n: int,
            phase1_only: bool = False) -> list:
        hit = src_mask[self.cols]
        inter = torch.bincount(self.cell[hit],
                               minlength=self.n_slices * self.n_rows)
        inter = inter.view(self.n_slices, self.n_rows).cpu().numpy()
        cand: set = set()
        phase1: dict = {}
        for s in range(self.n_slices):
            ids, cnt = self.ranks[s]
            c = inter[s, ids]
            kept = _walk(cnt, c, n)
            for rid, v in zip(ids[kept].tolist(), c[kept].tolist()):
                cand.add(rid)
                phase1[rid] = phase1.get(rid, 0) + v
        if phase1_only:
            totals = phase1
        else:
            ids = np.fromiter(sorted(cand), dtype=np.int64, count=len(cand))
            sums = inter[:, ids].sum(axis=0)
            totals = dict(zip(ids.tolist(), sums.tolist()))
        pairs = sorted(((i, v) for i, v in totals.items() if v > 0),
                       key=lambda p: (-p[1], p[0]))
        return [[i, v] for i, v in (pairs[:n] if n else pairs)]


def _walk(cnt: np.ndarray, c: np.ndarray, n: int) -> np.ndarray:
    """Indexes kept by one slice's rank walk with a source (threshold 1):
    the first n rows with a positive source count; then, with ``low``
    the least of their source counts, every later row whose source count
    is at least ``low``, up to the first row whose own count is below
    ``low``."""
    pos = np.flatnonzero(c > 0)
    if not n or len(pos) <= n:
        return pos
    first = pos[:n]
    low = c[first].min()
    start = first[-1] + 1
    # cnt is descending: the walk ends at the first count below low.
    end = max(start, int(np.searchsorted(-cnt, -low, side="right")))
    rest = start + np.flatnonzero(c[start:end] >= low)
    return np.concatenate([first, rest])

"""The plain reference's pieces against direct computations, and the
controls against the reference."""

import heapq

import numpy as np
import pytest
import torch

from perfbench import datagen, reference
from perfbench.tests.sizes import tiny


def test_popcount64_matches_python():
    rng = np.random.default_rng(3)
    vals = rng.integers(-2**63, 2**63 - 1, size=500, dtype=np.int64)
    vals[:4] = [0, -1, -2**63, 2**63 - 1]
    got = reference.popcount64(torch.from_numpy(vals)).tolist()
    want = [bin(int(v) & (2**64 - 1)).count("1") for v in vals]
    assert got == want


def test_dense_rows_holds_each_bit_once():
    rows = np.array([0, 0, 0, 1, 1, 2], dtype=np.uint64)
    cols = np.array([5, 5, 63, 64, 200, 127], dtype=np.uint64)
    w = reference.dense_rows(rows, cols, 3, 256, "cpu")
    assert w.shape == (3, 4)
    assert int(w[0, 0]) == (1 << 5) | -(1 << 63)
    assert int(w[1, 1]) == 1 and int(w[1, 3]) == 1 << 8
    assert int(w[2, 1]) == -(1 << 63)
    assert int(reference.popcount64(w).sum()) == 5


def _heap_walk(ids, cnt, c, n):
    """Reference Pilosa's Fragment.Top heap replay with a source and
    threshold 1 (fragment.go:490-625), row by row."""
    heap, kept = [], []
    for rid, k, v in zip(ids.tolist(), cnt.tolist(), c.tolist()):
        if len(heap) < n:
            if v == 0:
                continue
            heapq.heappush(heap, (v, -rid))
            kept.append(rid)
            continue
        low = heap[0][0]
        if low < 1 or k < low:
            break
        if v < low:
            continue
        heapq.heappush(heap, (v, -rid))
        kept.append(rid)
    return kept


@pytest.mark.parametrize("seed", range(6))
def test_vectorized_walk_replays_the_heap(seed):
    rng = np.random.default_rng(seed)
    n_rows = 3000
    cnt = np.sort(rng.zipf(1.6, n_rows).clip(1, 500))[::-1].astype(np.int64)
    ids = rng.permutation(n_rows).astype(np.int64)
    c = rng.binomial(cnt, rng.uniform(0.01, 0.5)).astype(np.int64)
    for n in (1, 5, 100, 1000, 5000):
        got = ids[reference._walk(cnt, c, n)].tolist()
        assert got == _heap_walk(ids, cnt, c, n), n


@pytest.mark.parametrize("name", ["c4_segments", "c3_topn"])
def test_controls_differ_from_the_reference(name):
    from perfbench import control
    mix = {"c4_segments": "intersect_batch", "c3_topn": "filtered_topn"}[name]
    cell = {"name": f"{name}.{mix}", "config": name, "traffic": mix}
    out = control.readings(cell, 2**31 + 99, 40, "cpu", cfg=tiny(name))
    assert out["requests"] == 40
    assert out["wrong_answers"] > 0


@pytest.mark.parametrize("n_present", [7, 10, 11, 12, 40])
def test_rank_cache_model_is_the_programs_steady_cache(n_present):
    """The model against the program's RankCache after a bulk import and
    the re-rank that follows: counts tie across the cache's boundary."""
    from pilosa_tpu_torch.storage.cache import RankCache
    rng = np.random.default_rng(n_present)
    counts = np.zeros(50, dtype=np.int64)
    present = rng.choice(50, n_present, replace=False)
    counts[present] = rng.integers(1, 5, n_present)
    cache = RankCache(10)
    for rid in present.tolist():
        cache.bulk_add(rid, int(counts[rid]))
    cache.recalculate()
    cache.recalculate()
    f = reference.RankedFrame.__new__(reference.RankedFrame)
    f.cache_size = 10
    ids, cnt = f._rank(counts)
    want_ids, want_cnt = cache.top_arrays()
    assert ids.tolist() == want_ids.tolist()
    assert cnt.tolist() == want_cnt.tolist()


def test_tiny_topn_frame_overflows_its_rank_cache():
    cfg = tiny("c3_topn")
    ref = reference.Reference(cfg, datagen.make(cfg, 1), "cpu")
    fr = ref.ranked("f")
    for s in range(cfg["slices"]):
        assert (fr.counts[s] > 0).sum() > 1.1 * 800
        assert 0 < len(fr.ranks[s][0]) <= 800

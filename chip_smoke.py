"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels (nvcc, sm_90a) from the sources in this
checkout, then runs six phases and prints one JSON line for each:

1. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card, exact (integer results), at the serving shapes,
   the odd shapes, bit-31 words, a 64-leaf mixed tree, a 1000-child
   Union (a program longer than the expression count stages in shared
   memory) and a tree that needs spill slots; the expression count at
   S = 1, 10 and 256 rows of 32,768 words and at W = 4; densify at
   G = 0, 1, 8, 32 and 40, T × subs groups that its 32-group tile does
   not divide, a group with lanes 0 and 127 set, bit-31 values and
   all-padding rows; both of them again into an output that
   ``torch.empty`` hands back dirty (a freed all-ones tensor of its
   size), one launch each; and the op count at the benchmark's shape
   [16, 2^25] for every op, at one long row, 1-D, W = 4k+1..3, W below
   one CTA's chunk, all-ones and bit-31 words and views at odd word
   offsets. Then four times of each kernel at the main path's shapes,
   with the inputs rotated through copies so that the 50 MB L2 does not
   hold what a launch reads (pilosa_tpu_torch/ops/timing.py):
   ``ms``, the device time alone — K wrapper calls captured in one CUDA
   graph, the graph replayed between CUDA events, divided by K;
   ``call_ms``, what a caller pays — CUDA events around a loop of
   wrapper calls (``call_ms - ms`` is the wrapper's host cost);
   ``profiler_ms``, torch.profiler's device time per call (null where
   the profiler records none), a cross-check of ``ms``; and
   ``plain_ms``, CUDA events around calls of the plain version.
2. ``count``: Count queries through ``Executor.execute`` over an index of
   256 slices (268,435,456 columns), cold and then resident.
3. ``topn``: exact TopN through ``Executor.execute`` over 10 slices, the
   resident form (200 candidates) and the streaming form (1,000
   candidates). Phases 2-4 write one data directory (indexes
   ``smoke``, ``smoke_topn`` and ``t3``).
4. ``topn1000``: every form of TopN at BASELINE configuration 3's full
   size — index ``t3``, 100,000 rows × 10 slices, the JAX suite's data
   (rows 0-1999 at counts 1000 down to 21, the rest at 4 bits) in an
   LRU frame ``f`` and a ranked frame ``fr`` — and over phase 3's
   index: ``TopN(frame=f, n=1000)`` (the single pass over complete LRU
   caches), ``TopN(frame=fr, n=1000)`` (two phases, the refetch on the
   host), ``TopN(frame=fr, n=50)`` (two phases, the refetch a device
   top-k: n is lowered until the candidate union fits the resident
   block), a source with no ids, the same with ``threshold=3`` and a
   Tanimoto query whose source holds a sparse leaf (densify); each cold
   and warm (p50 of 5), every answer held to a plain two-phase
   reference over roaring row counts (``_ref_topn``).
5. ``server``: ``pilosa_tpu_torch.server.server.Server`` on
   127.0.0.1:0 on the card over that directory, driven over HTTP with
   urllib: it creates frame ``g`` in ``smoke``, imports row 1 of ``g``
   at density 1/64 over all 256 slices as raw v2 positions and row 2 at
   1/4096 as 256 protobuf ``ImportRequest``s (the port's codec), sets a
   ``category`` row attribute on the 200 resident TopN candidates in
   one query of ``SetRowAttrs`` calls and a ``tag`` on three columns;
   then phase 2's Count queries, two Counts over ``g`` (one with sparse
   leaves, through densify), the resident TopN with and without
   ``field="category", filters=[0, 1]``, one ``Bitmap`` with
   ``columnAttrs=true`` and three of phase 4's TopN queries (the
   reopened ``.cache`` sidecars rank their frames), each cold
   (residency cache empty) and warm,
   with a JSON and with a protobuf answer. Every answer is held to the
   host roaring answer from the server's own fragments; beside the
   client's times, each query's warm time through
   ``server.executor.execute`` in this process (the difference is the
   HTTP front's cost).
6. ``bench``: the benchmark of record, ``pilosa_tpu_torch.bench``, in
   this process at its default width and rows (16 pairs of 2^30-bit
   rows), with fewer chained dispatches (BENCH_ITERS); its line is the
   phase's line.

Every answer of phases 2-5 is held to the host roaring answer computed
from the port's own fragments, and every count of phase 6 to the host
``popcnt_and``. The kernels' launch counters are set to 0 before phase
2 and before phase 5 and read after phases 4, 5 and 6: every kernel must
have launched on that main path, the TopN block count in phase 4's
device top-k, the TopN block count, the expression count and densify in
its sourced queries and again in the server phase by itself, and the op
count in phase 6. Then it prints the card's name and power limit, the kernel
table as one JSON object, and as its last line
``{"ok": true, "device": {...}}``. Any mismatch or
error exits non-zero before that line. Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
BENCH_WORDS = 1 << 25      # words of a benchmark row (2^30 bits)
BENCH_ITERS = 64           # chained dispatches a trial in the bench phase


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _check_equal(name: str, got, want) -> int:
    """Max abs difference of kernel and plain results; fails unless 0
    (the results are integers)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        _fail(f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, "
              f"plain {tuple(want.shape)} {want.dtype}")
    diff = int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0
    if diff:
        _fail(f"{name}: kernel differs from its plain version "
              f"(max abs diff {diff})")
    return diff


def _rand_words(gen, shape, device):
    """Random int32-viewed u32 words (half of them with bit 31 set) and
    one all-ones word."""
    import torch
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64).to(torch.int32)
    w.view(-1)[0] = -1
    return w.to(device)


def _op_count_checks(device, seed: int) -> tuple[int, int]:
    """op_count_rows against its plain version, exact, at the shapes of
    the benchmark and the odd ones; returns (checks, max abs error)."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops.kernel_ab import dev_words

    gen = torch.Generator(device=device).manual_seed(seed)
    W = BENCH_WORDS
    cases = [(op, (16, W)) for op in ("and", "or", "xor", "andnot")]
    cases += [("and", (1, W)), ("xor", (W + 3,)), ("or", (3, 4 * 8193 + 1)),
              ("andnot", (3, 4 * 8193 + 2)), ("xor", (3, 4 * 8193 + 3)),
              ("and", (5, 37)), ("andnot", (4, 3))]
    checks = err = 0
    for op, shape in cases:
        a, b = dev_words(gen, shape, device), dev_words(gen, shape, device)
        err = max(err, _check_equal(f"op_count_rows[{op} {list(shape)}]",
                                    ck.op_count_rows(op, a, b),
                                    ck.op_count_rows_torch(op, a, b)))
        checks += 1
        del a, b
    for word in (-1, -2**31):  # all-ones words, bit-31 words
        a = torch.full((4, 4099), word, dtype=torch.int32, device=device)
        for op in ("and", "andnot"):
            err = max(err, _check_equal(f"op_count_rows[{op} {word:#x}]",
                                        ck.op_count_rows(op, a, a),
                                        ck.op_count_rows_torch(op, a, a)))
            checks += 1
    base = dev_words(gen, (2, 8 * 1001 + 4), device)  # rows on the grid
    for off in (1, 2, 3):  # views at 4, 8 and 12 bytes past the grid
        a = base[0, off:off + 8 * 1001].view(8, 1001)
        b = base[1, off:off + 8 * 1001].view(8, 1001)
        err = max(err, _check_equal(f"op_count_rows[offset {off}]",
                                    ck.op_count_rows("xor", a, b),
                                    ck.op_count_rows_torch("xor", a, b)))
        checks += 1
    try:
        ck.op_count_rows("and", base[0, 1:9], base[0, 2:10])
    except ValueError:
        checks += 1
    else:
        _fail("op_count_rows: operands at different 16-byte offsets "
              "neither counted nor refused")
    return checks, err


def _fold(op, n):
    e = ("leaf", 0)
    for i in range(1, n):
        e = (op, e, ("leaf", i))
    return e


def _balanced(lo, hi, ops):
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    return (ops[(lo * 7 + hi) % len(ops)], _balanced(lo, mid, ops),
            _balanced(mid, hi, ops))


def _dirty_check(name, out_shape, call, want, device) -> int:
    """``call()`` once to warm the wrapper's caches, then again into
    memory that ``torch.empty`` hands back dirty (a freed all-ones tensor
    of the output's size): one launch, and exactly ``want``."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    call()
    junk = torch.full(out_shape, -1, dtype=torch.int32, device=device)
    del junk
    before = ck.LAUNCHES[name]
    got = call()
    if ck.LAUNCHES[name] != before + 1:
        _fail(f"{name}: {ck.LAUNCHES[name] - before} launches for one call")
    return _check_equal(f"{name}[dirty output {list(out_shape)}]", got,
                        want)


def phase_kernels(device, seed: int, w_serving: int = 32768) -> dict:
    """Each kernel equal to its plain version on the card; times at the
    main path's shapes (rows of ``w_serving`` words)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import timing
    from pilosa_tpu_torch.ops.kernel_ab import (dev_words, odd_slots,
                                                sparse_slots)

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    W = w_serving
    checks = 0
    err = dict.fromkeys(ck.LAUNCHES, 0)

    # expr_count_rows: serving shapes, odd shapes, wide trees.
    ops4 = ["and", "or", "xor", "andnot"]
    exprs = {
        "intersect": ("and", ("leaf", 0), ("leaf", 1)),
        "mixed": ("or", ("and", ("leaf", 0), ("leaf", 1)),
                  ("andnot", ("xor", ("leaf", 2), ("leaf", 0)),
                   ("leaf", 1))),
        "union8": _fold("or", 8),
        "mixed64": _balanced(0, 64, ops4),
        "union1000": _fold("or", 1000),
        "spill256": _balanced(0, 256, ops4),  # 7 spill slots
    }
    cases = [("intersect", 2, 256, W), ("union8", 8, 256, W),
             ("mixed", 3, 9, 2048), ("mixed64", 64, 16, 2048),
             ("union1000", 1000, 4, 2048), ("intersect", 2, 1, W),
             ("mixed", 3, 10, W), ("mixed", 3, 7, 4),
             ("spill256", 256, 3, 2048)]
    for name, n_leaves, s, w in cases:
        leaves = _rand_words(gen, (n_leaves, s, w), device)
        err["expr_count_rows"] = max(err["expr_count_rows"], _check_equal(
            f"expr_count_rows[{name} {s}x{w}]",
            ck.expr_count_rows(exprs[name], leaves),
            ck.expr_count_rows_torch(exprs[name], leaves)))
        checks += 1

    # topn_block_count: resident serving shape, odd shape, no expr; the
    # sourceless device top-k (no expression, 163 candidates) and the
    # Tanimoto refetch (an Intersect of two leaves) at 10 slices.
    for s, r, w, expr, n_leaves in ((10, 200, W, ("leaf", 0), 1),
                                    (9, 5, 2048, exprs["mixed"], 3),
                                    (9, 5, 2048, None, 0),
                                    (10, 163, W, None, 0),
                                    (10, 131, W, exprs["intersect"], 2),
                                    (4, 3, 2048, exprs["union1000"], 1000)):
        rows = _rand_words(gen, (s, r, w), device)
        leaves = list(_rand_words(gen, (max(n_leaves, 1), s, w),
                                  device))[:n_leaves]
        err["topn_block_count"] = max(err["topn_block_count"], _check_equal(
            f"topn_block_count[{s}x{r}x{w}]",
            ck.topn_block_count(expr, rows, leaves),
            ck.topn_block_count_torch(expr, rows, leaves)))
        checks += 1

    # densify: serving shape (256 slices, sparse leaf rows), odd shapes
    # through the host bucketing, then slots built directly for any G.
    slot_sets = []
    for t, per_row, w in ((256, W // 128, W), (11, 300, 2048),
                          (11, 0, 2048)):
        slot_sets.append((f"{t}x{w} bucketed",)
                         + sparse_slots(rng, t, per_row, w) + (w,))
    for t, subs, g, empty in ((5, 33, 1, ()), (3, 47, 8, (1,)),
                              (3, 47, 32, (2,)), (2, 16, 40, ()),
                              (4, 16, 0, ()), (2, 1, 32, (1,))):
        slot_sets.append((f"{t}x{subs}x{g}",)
                         + odd_slots(rng, t, subs, g, empty)
                         + (subs * 128,))
    for name, lanes, vals, w in slot_sets:
        lane = torch.from_numpy(lanes.view(np.int32)).to(device)
        val = torch.from_numpy(vals.view(np.int32)).to(device)
        err["densify"] = max(err["densify"], _check_equal(
            f"densify[{name}]", ck.densify(lane, val, w),
            ck.densify_torch(lane, val, w)))
        checks += 1

    # Both redesigned kernels into dirty memory: nothing relies on a
    # memset.
    leaves = _rand_words(gen, (2, 256, W), device)
    want = ck.expr_count_rows_torch(exprs["intersect"], leaves)
    err["expr_count_rows"] = max(err["expr_count_rows"], _dirty_check(
        "expr_count_rows", (256,),
        lambda: ck.expr_count_rows(exprs["intersect"], leaves), want,
        device))
    lanes, vals = odd_slots(rng, 3, 47, 32, (2,))
    lane = torch.from_numpy(lanes.view(np.int32)).to(device)
    val = torch.from_numpy(vals.view(np.int32)).to(device)
    want = ck.densify_torch(lane, val, 47 * 128)
    err["densify"] = max(err["densify"], _dirty_check(
        "densify", (3, 47 * 128), lambda: ck.densify(lane, val, 47 * 128),
        want, device))
    checks += 2
    del leaves, want

    n, err["op_count_rows"] = _op_count_checks(device, seed)
    checks += n

    # Times at the shapes of the main path.
    copies = 4
    inter = [(exprs["intersect"], _rand_words(gen, (2, 256, W), device))
             for _ in range(copies)]
    ec_bytes = 2 * 256 * W * 4 + 256 * 4
    rows_sets = [(("leaf", 0), _rand_words(gen, (10, 200, W), device),
                  [_rand_words(gen, (10, W), device)]) for _ in range(2)]
    tb_bytes = 10 * 200 * W * 4 + 10 * W * 4 + 10 * 200 * 4
    lanes, vals = sparse_slots(rng, 256, W // 128, W)
    dens = [(torch.from_numpy(lanes.view(np.int32)).to(device),
             torch.from_numpy(vals.view(np.int32)).to(device), W)
            for _ in range(copies)]
    de_bytes = lanes.size * 8 + 256 * W * 4
    gen_dev = torch.Generator(device=device).manual_seed(seed + 3)
    bench_ops = [("and", dev_words(gen_dev, (16, BENCH_WORDS), device),
                  dev_words(gen_dev, (16, BENCH_WORDS), device))]
    oc_bytes = 2 * 16 * BENCH_WORDS * 4 + 16 * 4
    long_row = [("and", dev_words(gen_dev, (1, BENCH_WORDS), device),
                 dev_words(gen_dev, (1, BENCH_WORDS), device))]
    lr_bytes = 2 * BENCH_WORDS * 4 + 4

    def times(kern, plain, args, iters, launches):
        try:
            prof_ms, prof_names = timing.profiler_ms(kern, args)
        except Exception as e:  # the profiler is a cross-check only
            prof_ms, prof_names = None, [f"profiler failed: {e}"[:200]]
        return {"ms": timing.graph_ms(kern, args, launches),
                "call_ms": timing.events_ms(kern, args, iters),
                "profiler_ms": prof_ms, "profiler_kernels": prof_names,
                "plain_ms": timing.events_ms(plain, args,
                                             max(3, iters // 20),
                                             warmup=1)}

    table = []
    for name, src, rep, kern, plain, args, nbytes, iters, launches, shape in (
            ("expr_count_rows", "pilosa_tpu_torch/ops/csrc/expr_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:143", ck.expr_count_rows,
             ck.expr_count_rows_torch, inter, ec_bytes, 200, 20,
             f"Count(Intersect): leaves [2, 256, {W}]"),
            ("topn_block_count",
             "pilosa_tpu_torch/ops/csrc/topn_block_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:210", ck.topn_block_count,
             ck.topn_block_count_torch, rows_sets, tb_bytes, 50, 20,
             f"resident TopN: rows [10, 200, {W}], 1 leaf"),
            ("densify", "pilosa_tpu_torch/ops/csrc/densify.cu",
             "pilosa_tpu/ops/pallas_kernels.py:323", ck.densify,
             ck.densify_torch, dens, de_bytes, 200, 20,
             f"leaf slab upload: slots {list(lanes.shape)}"),
            ("op_count_rows", "pilosa_tpu_torch/ops/csrc/op_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:86", ck.op_count_rows,
             ck.op_count_rows_torch, bench_ops, oc_bytes, 20, 4,
             f"bench of record: a, b [16, {BENCH_WORDS}]")):
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": err[name],
            **times(kern, plain, args, iters, launches),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape,
            "bytes": nbytes})
    keys = ("name", "shape", "ms", "call_ms", "profiler_ms", "plain_ms",
            "bound_ms", "library_ms")
    timings = [{k: e[k] for k in keys} for e in table]
    lr = times(ck.op_count_rows, ck.op_count_rows_torch, long_row, 50, 10)
    timings.append({
        "name": "op_count_rows",
        "shape": f"one long row: a, b [1, {BENCH_WORDS}]",
        **{k: lr[k] for k in ("ms", "call_ms", "profiler_ms", "plain_ms")},
        "bound_ms": lr_bytes / HBM_BYTES_PER_S * 1e3, "library_ms": None})
    _emit({"phase": "kernels", "checks": checks, "exact": True,
           "library_ms": "null: no single PyTorch call computes any of "
                         "these functions (torch has no popcount op)",
           "timings": timings})
    return {e["name"]: e for e in table}


def _timed_query(ex, index, q):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ex.execute(index, q)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _random_row(rng, n_cols, n_bits):
    import numpy as np
    return np.unique(rng.integers(0, n_cols, size=n_bits, dtype=np.uint64))


def _union(f, rows):
    out = f.row(rows[0])
    for r in rows[1:]:
        out = out.union(f.row(r))
    return out


def _count_queries() -> dict:
    """Phase 2's Count queries over index ``smoke``, frame ``f``."""
    u8 = ", ".join(f"Bitmap(rowID={r}, frame=f)" for r in range(1, 9))
    u16 = ", ".join(f"Bitmap(rowID={r}, frame=f)" for r in range(9, 17))
    queries = {
        "intersect": "Count(Intersect(Bitmap(rowID=1, frame=f),"
                     " Bitmap(rowID=2, frame=f)))",
        "union8": f"Count(Union({u8}))",
        "difference": f"Count(Difference(Union({u16}),"
                      " Bitmap(rowID=1, frame=f)))",
    }
    queries["all3"] = " ".join(queries[k] for k in
                               ("intersect", "union8", "difference"))
    return queries


def _count_wants(holder, n_slices: int) -> dict:
    """Host roaring answers of ``_count_queries`` from the holder's own
    fragments (no kernel code)."""
    frags = [holder.fragment("smoke", "f", "standard", s)
             for s in range(n_slices)]

    def host_count(fn):
        return sum(fn(f).count() for f in frags if f is not None)

    want = {
        "intersect": host_count(lambda f: f.row(1).intersect(f.row(2))),
        "union8": host_count(lambda f: _union(f, list(range(1, 9)))),
        "difference": host_count(
            lambda f: _union(f, list(range(9, 17))).difference(f.row(1))),
    }
    want["all3"] = [want["intersect"], want["union8"], want["difference"]]
    return want


def _topn_host_pairs(holder, n_slices: int, src_fn, ids) -> list:
    """Per-candidate exact counts of frame ``t`` against a source of
    frame ``src`` from host roaring, then count-descending, id-ascending
    (ids given: no n-trim)."""
    counts = dict.fromkeys(ids, 0)
    for s in range(n_slices):
        sf = holder.fragment("smoke_topn", "src", "standard", s)
        tf = holder.fragment("smoke_topn", "t", "standard", s)
        if sf is None or tf is None:
            continue
        srow = src_fn(sf)
        for rid in ids:
            counts[rid] += tf.row(rid).intersection_count(srow)
    return sorted(((r, c) for r, c in counts.items() if c > 0),
                  key=lambda p: (-p[1], p[0]))


def phase_count(holder, device, seed: int, n_slices: int = 256) -> dict:
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency

    n_cols = n_slices * SLICE_WIDTH
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    frame = holder.create_index("smoke").create_frame("f")
    for row in range(1, 17):
        density = 64 if row <= 8 else 4096
        cols = _random_row(rng, n_cols, n_cols // density)
        frame.import_bits(np.full(len(cols), row, np.uint64), cols)
    load_s = time.perf_counter() - t0

    want = _count_wants(holder, n_slices)
    queries = _count_queries()
    ex = Executor(holder, device=device)
    results = []
    for name, q in queries.items():
        residency.device_cache().clear()
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ck.LAUNCHES)
        for state in ("cold", "warm"):
            out, ms = _timed_query(ex, "smoke", q)
            got = out if name == "all3" else out[0]
            expect = want[name]
            if got != expect:
                _fail(f"count {name} ({state}): device {got} != host "
                      f"{expect}")
            results.append({"query": name, "state": state, "ms": ms,
                            "answer": got})
        results[-1]["peak_mib"] = torch.cuda.max_memory_allocated(
            device) / 2**20
        results[-1]["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                   for k in before}
    snap = residency.device_cache().snapshot()
    out = {"phase": "count", "slices": n_slices, "columns": n_cols,
           "load_s": load_s, "resident_mib": snap["usedBytes"] / 2**20,
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out


def phase_topn(holder, device, seed: int, n_slices: int = 10,
               n_rows: int = 1000, total_bits: int = 30_000_000
               ) -> tuple[dict, list]:
    """Returns the phase's line and the 200 resident candidates."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency

    n_cols = n_slices * SLICE_WIDTH
    rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    idx = holder.create_index("smoke_topn")
    src = idx.create_frame("src")
    for row, density in ((1, 4), (2, 3)):
        cols = _random_row(rng, n_cols, n_cols // density)
        src.import_bits(np.full(len(cols), row, np.uint64), cols)
    t = idx.create_frame("t")
    zipf = 1.0 / np.arange(1, n_rows + 1)
    sizes = np.maximum(1, (zipf / zipf.sum() * total_bits).astype(np.int64))
    order = rng.permutation(n_rows)  # skew not aligned with row id
    t_bits = 0
    for rid in range(n_rows):
        cols = _random_row(rng, n_cols, int(sizes[order[rid]]))
        t_bits += len(cols)
        t.import_bits(np.full(len(cols), rid, np.uint64), cols)
    load_s = time.perf_counter() - t0

    def host_pairs(src_fn, ids):
        return _topn_host_pairs(holder, n_slices, src_fn, ids)

    ids200 = sorted(rng.choice(n_rows, size=min(200, n_rows),
                               replace=False).tolist())
    ids_all = list(range(n_rows))
    queries = [
        ("resident", f"TopN(Bitmap(rowID=1, frame=src), frame=t, n=100,"
                     f" ids={ids200})",
         host_pairs(lambda f: f.row(1), ids200)),
        ("streaming", "TopN(Intersect(Bitmap(rowID=1, frame=src),"
                      " Bitmap(rowID=2, frame=src)), frame=t, n=1000,"
                      f" ids={ids_all})",
         host_pairs(lambda f: f.row(1).intersect(f.row(2)), ids_all)),
    ]
    ex = Executor(holder, device=device)
    results = []
    for name, q, want in queries:
        residency.device_cache().clear()
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ck.LAUNCHES)
        for state in ("cold", "warm"):
            out, ms = _timed_query(ex, "smoke_topn", q)
            got = [(p.id, p.count) for p in out[0]]
            if got != want:
                _fail(f"topn {name} ({state}): device pairs differ from "
                      f"host (first device {got[:3]}, host {want[:3]})")
            results.append({"query": name, "state": state, "ms": ms,
                            "pairs": len(got), "top": got[:3]})
        results[-1]["peak_mib"] = torch.cuda.max_memory_allocated(
            device) / 2**20
        results[-1]["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                   for k in before}
    out = {"phase": "topn", "slices": n_slices, "columns": n_cols,
           "t_rows": n_rows, "t_bits": t_bits, "load_s": load_s,
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out, ids200


def _build_topn1000_frames(holder, n_rows: int, n_slices: int) -> int:
    """BASELINE configuration 3's frame, made as the JAX suite makes it
    (benchmarks/suite.py _build_topn_frame, ``default_rng(33)``): rows
    0-1999 at counts 1000 down to 21, the rest at 4 bits each, columns
    uniform over ``n_slices`` slices, imported in 20 slice-grouped
    batches — into frame ``f`` (LRU cache, the default) and frame
    ``fr`` (``cacheType=ranked``) of index ``t3``. Returns the bits a
    frame holds."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.models.frame import FrameOptions

    rng = np.random.default_rng(33)
    idx = holder.create_index("t3")
    frames = [idx.create_frame("f"),
              idx.create_frame("fr", FrameOptions(cache_type="ranked"))]
    head = min(2000, n_rows)
    counts = np.concatenate([
        np.maximum(21, 1000 - np.arange(head)).astype(np.int64),
        np.full(n_rows - head, 4, dtype=np.int64)])
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), counts)
    cols = rng.integers(0, n_slices * SLICE_WIDTH, size=len(rows),
                        dtype=np.uint64)
    order = np.argsort(cols // np.uint64(SLICE_WIDTH), kind="stable")
    rows, cols = rows[order], cols[order]
    step = max(1, len(rows) // 20)
    for frame in frames:
        for i in range(0, len(rows), step):
            frame.import_bits(rows[i:i + step], cols[i:i + step])
    return int(counts.sum())


_ROW_SHIFT = 20  # log2(SLICE_WIDTH): a position's row is pos >> 20


def _slice_counts(frag):
    """{row: bit count} of one fragment, from its roaring positions."""
    import numpy as np
    pos = frag.storage.all_positions()
    rows, counts = np.unique(pos >> np.uint64(_ROW_SHIFT),
                             return_counts=True)
    return rows, counts


def _ref_topn(holder, index, frame, n_slices, n, src_cols=None,
              threshold=1, tanimoto=0):
    """Plain reference of ``TopN`` over the port's fragments, from
    roaring row counts, with the reference's two phases
    (executor.go:273-310, fragment.go:490-625): per slice, a walk of the
    rows in rank order (count descending, id ascending) that keeps the
    first n passing rows (all of them without a source) and, with a
    source, every later row whose source count reaches the smallest kept
    one, up to the first row whose own count falls below it; then the
    union's exact sums, each slice's contribution kept only where that
    slice's row count and intersection count pass the threshold (or the
    Tanimoto bounds, as integer inequalities), count descending, id
    ascending, trimmed to n. ``src_cols`` holds each slice's slice-local
    source columns. Returns (pairs, candidate union size)."""
    import numpy as np
    mask = np.uint64((1 << _ROW_SHIFT) - 1)
    cand: set = set()
    per_slice = []
    for s in range(n_slices):
        frag = holder.fragment(index, frame, "standard", s)
        if frag is None:
            continue
        rows, counts = _slice_counts(frag)
        rc = dict(zip(rows.tolist(), counts.tolist()))
        inter, s_n = rc, 0
        if src_cols is not None:
            pos = frag.storage.all_positions()
            hit = pos[np.isin(pos & mask, src_cols[s])]
            irows, icounts = np.unique(hit >> np.uint64(_ROW_SHIFT),
                                       return_counts=True)
            inter = dict(zip(irows.tolist(), icounts.tolist()))
            s_n = len(src_cols[s])
        per_slice.append((rc, inter, s_n))
        order = np.lexsort((rows, -counts))
        kept: list = []  # (count, row)
        for rid, cnt in zip(rows[order].tolist(), counts[order].tolist()):
            if tanimoto:
                if not (100 * cnt > s_n * tanimoto
                        and cnt * tanimoto < 100 * s_n):
                    continue
            elif cnt < threshold:
                continue
            if not n or len(kept) < n:
                c = inter.get(rid, 0)
                if c == 0:
                    continue
                if tanimoto:
                    if 100 * c <= tanimoto * (cnt + s_n - c):
                        continue
                elif c < threshold:
                    continue
                kept.append((c, rid))
                if len(kept) == n and src_cols is None:
                    break
                continue
            low = min(kept)[0]
            if low < threshold or cnt < low:
                break
            c = inter.get(rid, 0)
            if c >= low:
                kept.append((c, rid))
        cand.update(r for _, r in kept)
    totals = {}
    for rid in cand:
        tot = 0
        for rc, inter, s_n in per_slice:
            cnt, c = rc.get(rid, 0), inter.get(rid, 0)
            if tanimoto:
                keep = (100 * cnt > s_n * tanimoto
                        and cnt * tanimoto < 100 * s_n and c > 0
                        and 100 * c > tanimoto * (cnt + s_n - c))
            else:
                keep = cnt >= threshold and c >= threshold
            tot += c if keep else 0
        if tot > 0:
            totals[rid] = tot
    pairs = sorted(totals.items(), key=lambda p: (-p[1], p[0]))
    return (pairs[:n] if n else pairs), len(cand)


def phase_topn1000(holder, device, seed: int, n_rows: int = 100_000,
                   n_slices: int = 10, warm_runs: int = 5
                   ) -> tuple[dict, list]:
    """Every form of TopN at BASELINE configuration 3's full size
    (``t3``: 100,000 rows × 10 slices) and over phase 3's ``smoke_topn``
    index; each query cold (device cache empty) and warm (p50 of
    ``warm_runs``), every answer held to ``_ref_topn``. Returns the
    phase's line and the (name, index, query, answer) list that the
    server phase asks again over HTTP."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import mesh as mesh_mod
    from pilosa_tpu_torch.parallel import residency

    t_phase = t0 = time.perf_counter()
    t3_bits = _build_topn1000_frames(holder, n_rows, n_slices)
    # A sparse source row (1/4096) and four rows of t near its
    # intersection with row 1, so that a Tanimoto query answers pairs
    # and its source takes densify. Rows 0-999 of t stay as phase 3
    # made them.
    rng = np.random.default_rng(seed + 5)
    n_cols = n_slices * SLICE_WIDTH
    src = holder.frame("smoke_topn", "src")
    sparse = _random_row(rng, n_cols, n_cols // 4096)
    src.import_bits(np.full(len(sparse), 3, np.uint64), sparse)
    sim = np.concatenate([
        holder.fragment("smoke_topn", "src", "standard", s).row(1)
        .intersect(holder.fragment("smoke_topn", "src", "standard", s)
                   .row(3)).bits() for s in range(n_slices)])
    extra = _random_row(rng, n_cols, len(sim))
    near = [sim, np.delete(sim, np.arange(0, len(sim), 10)),
            np.union1d(sim, extra[:len(sim) // 10]),
            np.union1d(sim[::2], extra[:len(sim) // 2])]
    t = holder.frame("smoke_topn", "t")
    for i, cols in enumerate(near):
        t.import_bits(np.full(len(cols), 1000 + i, np.uint64),
                      cols.astype(np.uint64))
    load_s = time.perf_counter() - t0

    def src_cols(rows_of):
        out = []
        for s in range(n_slices):
            fr = holder.fragment("smoke_topn", "src", "standard", s)
            out.append(rows_of(fr).bits().astype(np.uint64)
                       % np.uint64(SLICE_WIDTH))
        return out

    row1 = src_cols(lambda f: f.row(1))
    inter13 = src_cols(lambda f: f.row(1).intersect(f.row(3)))
    # Query 3's n: the largest of these whose candidate union fits the
    # resident block budget, so that the refetch is the device top-k.
    row_bytes = n_slices * SLICE_WIDTH // 8
    for n3 in (50, 40, 30, 20, 10):
        want3, union3 = _ref_topn(holder, "t3", "fr", n_slices, n3)
        if union3 * row_bytes <= mesh_mod.TOPN_BLOCK_BYTES:
            break
    else:
        _fail(f"topn1000: no n gives a union under the block budget "
              f"({union3} rows at n=10)")
    want1, union1 = _ref_topn(holder, "t3", "f", n_slices, 1000)
    want2, union2 = _ref_topn(holder, "t3", "fr", n_slices, 1000)
    src1 = "Bitmap(rowID=1, frame=src)"
    tan_src = f"Intersect({src1}, Bitmap(rowID=3, frame=src))"
    want4, union4 = _ref_topn(holder, "smoke_topn", "t", n_slices, 100,
                              row1)
    want5, union5 = _ref_topn(holder, "smoke_topn", "t", n_slices, 100,
                              row1, threshold=3)
    want6, union6 = _ref_topn(holder, "smoke_topn", "t", n_slices, 10,
                              inter13, tanimoto=50)
    queries = [
        ("lru_n1000", "t3", "TopN(frame=f, n=1000)", want1, union1),
        ("ranked_n1000", "t3", "TopN(frame=fr, n=1000)", want2, union2),
        (f"ranked_n{n3}", "t3", f"TopN(frame=fr, n={n3})", want3, union3),
        ("src", "smoke_topn", f"TopN({src1}, frame=t, n=100)", want4,
         union4),
        ("src_threshold3", "smoke_topn",
         f"TopN({src1}, frame=t, n=100, threshold=3)", want5, union5),
        ("tanimoto50", "smoke_topn",
         f"TopN({tan_src}, frame=t, n=10, tanimotoThreshold=50)", want6,
         union6),
    ]
    if not want6:
        _fail("topn1000: the Tanimoto reference answers no pair")
    ex = Executor(holder, device=device)
    results = []
    for name, index, q, want, union in queries:
        residency.device_cache().clear()
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ck.LAUNCHES)
        out, cold_ms = _timed_query(ex, index, q)
        warm = []
        for _ in range(warm_runs):
            out_w, ms = _timed_query(ex, index, q)
            warm.append(ms)
            if out_w != out:
                _fail(f"topn1000 {name}: warm answer differs from cold")
        got = [(p.id, p.count) for p in out[0]]
        if got != want:
            _fail(f"topn1000 {name}: pairs differ from the reference "
                  f"({len(got)} vs {len(want)}; first {got[:3]} vs "
                  f"{want[:3]})")
        launches = {k: ck.LAUNCHES[k] - before[k] for k in before}
        results.append({
            "query": name, "pql": q if len(q) < 120 else q[:117] + "...",
            "union": union, "pairs": len(got), "top": got[:3],
            "cold_ms": cold_ms, "warm_p50_ms": sorted(warm)[len(warm) // 2],
            "warm_ms": warm,
            "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20,
            "launches": launches})
    by = {r["query"]: r for r in results}
    if by[f"ranked_n{n3}"]["launches"]["topn_block_count"] <= 0:
        _fail(f"topn1000: topn_block_count did not launch in "
              f"TopN(frame=fr, n={n3})")
    for name in ("topn_block_count", "expr_count_rows", "densify"):
        if sum(by[q]["launches"][name] for q in
               ("src", "src_threshold3", "tanimoto50")) <= 0:
            _fail(f"topn1000: {name} did not launch in the sourced "
                  "queries")
    out = {"phase": "topn1000", "rows": n_rows, "slices": n_slices,
           "columns": n_slices * SLICE_WIDTH, "t3_bits": t3_bits,
           "load_s": load_s, "phase_s": time.perf_counter() - t_phase,
           "n3": n3, "tanimoto_pairs": len(want6),
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out, [(name, index, q, want) for name, index, q, want, _ in
                 queries if name in ("lru_n1000", f"ranked_n{n3}",
                                     "tanimoto50")]


def _http(host: str, path: str, body: bytes, headers=None):
    """One POST with urllib; fails the run on any status but 200.
    Returns (body, client ms)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST", headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        _fail(f"server: POST {path}: HTTP {e.code}: {e.read()[:300]!r}")
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        _fail(f"server: POST {path}: HTTP {status}")
    return out, ms


def _answer_of(kind: str, r):
    """Canonical form of one call's result ``r``: the executor's result,
    a JSON result or a protobuf ``QueryResult``."""
    if hasattr(r, "Pairs"):  # protobuf
        if kind == "count":
            return r.N
        if kind == "topn":
            return [(p.Key, p.Count) for p in r.Pairs]
        return r.Bitmap.Bits.tolist()
    if kind == "count":
        return r
    if kind == "topn":
        return [(p["id"], p["count"]) if isinstance(p, dict)
                else (p.id, p.count) for p in r]
    return r["bits"] if isinstance(r, dict) else r.bits().tolist()


def phase_server(data_dir, device, seed: int, ids200: list,
                 topn1000=(), n_slices: int = 256,
                 n_topn_slices: int = 10) -> dict:
    """The port's server on the card over phases 2, 3 and 4's directory,
    driven over HTTP; every answer held to the host roaring answer from
    the server's own fragments, and each (name, index, query, answer) of
    ``topn1000`` to the answer it gave through the executor in phase 4
    (the reopened ``.cache`` sidecars rank its frames)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.proto import rawimport
    from pilosa_tpu_torch.server.server import Server

    PB = "application/x-protobuf"
    rng = np.random.default_rng(seed + 4)
    t0 = time.perf_counter()
    srv = Server(data_dir, host="127.0.0.1:0", device=device)
    srv.open()
    open_s = time.perf_counter() - t0
    try:
        host = srv.host
        holder = srv.holder
        # Writes over HTTP: frame g, row 1 of g at 1/64 as raw v2
        # positions, row 2 at 1/4096 as protobuf ImportRequests.
        _http(host, "/index/smoke/frame/g", b"{}")
        t0 = time.perf_counter()
        raw_bytes = 0
        for s in range(n_slices):
            cols = np.unique(rng.integers(0, SLICE_WIDTH,
                                          size=SLICE_WIDTH // 64,
                                          dtype=np.uint64))
            body = rawimport.encode_positions(
                "smoke", "g", s, np.uint64(SLICE_WIDTH) + cols)
            raw_bytes += len(body)
            _http(host, "/import", body,
                  {"Content-Type": rawimport.CONTENT_TYPE, "Accept": PB})
        raw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pb_bytes = 0
        for s in range(n_slices):
            cols = np.unique(rng.integers(0, SLICE_WIDTH,
                                          size=SLICE_WIDTH // 4096,
                                          dtype=np.uint64))
            body = pb.ImportRequest(
                Index="smoke", Frame="g", Slice=s,
                RowIDs=np.full(len(cols), 2, np.uint64),
                ColumnIDs=cols + np.uint64(s * SLICE_WIDTH)
            ).SerializeToString()
            pb_bytes += len(body)
            _http(host, "/import", body,
                  {"Content-Type": PB, "Accept": PB})
        pb_s = time.perf_counter() - t0
        # Attributes: a category on each resident TopN candidate (one
        # query of SetRowAttrs calls), a tag on three columns of row 9.
        _http(host, "/index/smoke_topn/query", " ".join(
            f"SetRowAttrs(frame=t, rowID={r}, category={r % 3})"
            for r in ids200).encode())
        f0 = holder.fragment("smoke", "f", "standard", 0)
        tagged = f0.row(9).bits()[:3].tolist()
        _http(host, "/index/smoke/query", " ".join(
            f'SetColumnAttrs(id={c}, tag="c{i}")'
            for i, c in enumerate(tagged)).encode())

        # Host answers from the server's own fragments.
        want = _count_wants(holder, n_slices)
        queries = {k: ("smoke", q, "count")
                   for k, q in _count_queries().items()}
        fg = [(holder.fragment("smoke", "f", "standard", s),
               holder.fragment("smoke", "g", "standard", s))
              for s in range(n_slices)]
        queries["g_intersect"] = (
            "smoke", "Count(Intersect(Bitmap(rowID=1, frame=g),"
                     " Bitmap(rowID=2, frame=g)))", "count")
        want["g_intersect"] = sum(g.row(1).intersect(g.row(2)).count()
                                  for _, g in fg)
        queries["g_union_sparse"] = (
            "smoke", "Count(Union(Bitmap(rowID=2, frame=g),"
                     " Bitmap(rowID=9, frame=f)))", "count")
        want["g_union_sparse"] = sum(g.row(2).union(f.row(9)).count()
                                     for f, g in fg)
        pairs = _topn_host_pairs(holder, n_topn_slices,
                                 lambda f: f.row(1), ids200)
        topn = (f"TopN(Bitmap(rowID=1, frame=src), frame=t, n=100,"
                f" ids={ids200})")
        queries["topn"] = ("smoke_topn", topn, "topn")
        want["topn"] = pairs
        queries["topn_filtered"] = (
            "smoke_topn", topn[:-1] + ', field="category", filters=[0, 1])',
            "topn")
        want["topn_filtered"] = [p for p in pairs if p[0] % 3 in (0, 1)]
        queries["bitmap_column_attrs"] = ("smoke", "Bitmap(rowID=9, frame=f)",
                                          "bitmap")
        want["bitmap_column_attrs"] = np.concatenate(
            [f.row(9).bits() for f, _ in fg]).tolist()
        want_attr_sets = [(c, {"tag": f"c{i}"}) for i, c in
                          enumerate(tagged)]
        for name, index, q, answer in topn1000:
            queries[f"topn1000_{name}"] = (index, q, "topn")
            want[f"topn1000_{name}"] = answer

        results = []
        for name, (index, q, kind) in queries.items():
            expect = want[name]
            n_calls = 3 if name == "all3" else 1
            path = f"/index/{index}/query"
            if kind == "bitmap":
                path += "?columnAttrs=true"
            entry = {"query": name, "index": index}
            for fmt in ("json", "protobuf"):
                headers = {"Accept": PB} if fmt == "protobuf" else {}
                residency.device_cache().clear()
                for state in ("cold", "warm"):
                    body, ms = _http(host, path, q.encode(), headers)
                    if fmt == "json":
                        doc = json.loads(body)
                        got = [_answer_of(kind, r) for r in doc["results"]]
                        sets = [(c["id"], c.get("attrs", {}))
                                for c in doc.get("columnAttrs", [])]
                    else:
                        resp = pb.QueryResponse.FromString(body)
                        if resp.Err:
                            _fail(f"server {name}: {resp.Err}")
                        got = [_answer_of(kind, r) for r in resp.Results]
                        sets = [(c.ID, {a.Key: a.StringValue
                                        for a in c.Attrs})
                                for c in resp.ColumnAttrSets]
                    got = got if n_calls > 1 else got[0]
                    if got != expect:
                        _fail(f"server {name} ({fmt}, {state}): HTTP answer"
                              f" differs from host ({str(got)[:120]} vs"
                              f" {str(expect)[:120]})")
                    if kind == "bitmap" and sets != want_attr_sets:
                        _fail(f"server {name} ({fmt}): columnAttrs {sets}"
                              f" != {want_attr_sets}")
                    entry[f"{state}_{fmt}_ms"] = ms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = srv.executor.execute(index, q)
            torch.cuda.synchronize()
            entry["executor_ms"] = (time.perf_counter() - t0) * 1e3
            got = [_answer_of(kind, r) for r in out]
            if (got if n_calls > 1 else got[0]) != expect:
                _fail(f"server {name}: executor answer differs from host")
            entry["front_ms"] = entry["warm_json_ms"] - entry["executor_ms"]
            results.append(entry)
    finally:
        srv.close()
    launches = dict(ck.LAUNCHES)
    for name in ("expr_count_rows", "topn_block_count", "densify"):
        if launches[name] <= 0:
            _fail(f"{name}: no launch in the server phase")
    out = {"phase": "server", "host": host, "device": str(device),
           "open_s": open_s, "raw_import_s": raw_s,
           "raw_import_bytes": raw_bytes, "pb_import_s": pb_s,
           "pb_import_bytes": pb_bytes, "queries": results,
           "launches": launches}
    _emit(out)
    return out


def phase_bench(device) -> dict:
    """The benchmark of record in this process, at its default width and
    rows; ``bench.run`` raises when a device count differs from the
    host's."""
    from pilosa_tpu_torch import bench
    knobs = {"PILOSA_BENCH_BITS": str(BENCH_WORDS * 32),
             "PILOSA_BENCH_ROWS": "16",
             "PILOSA_BENCH_ITERS": str(BENCH_ITERS),
             "PILOSA_BENCH_TRIALS": "3"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        line = bench.run(device)
    except RuntimeError as e:
        _fail(f"bench: {e}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (line["metric"] != "intersect_count_1024Mbit_rows"
            or line["rows"] != 16 or line["platform"] != "gpu"):
        _fail(f"bench: unexpected line {line}")
    _emit({"phase": "bench", **line})
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pilosa_tpu_torch import bench
        from pilosa_tpu_torch.device import resolve_device
        from pilosa_tpu_torch.models.holder import Holder
        from pilosa_tpu_torch.ops import build
        from pilosa_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        _fail(f"the port is not importable here: {e}")
    device = resolve_device()

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.libraries()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "torch": torch.__version__, "cuda": torch.version.cuda})

    table = phase_kernels(device, args.seed)
    ck.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_dir = os.path.join(tmp, "data")
        holder = Holder(data_dir)
        holder.open()
        phase_count(holder, device, args.seed)
        _, ids200 = phase_topn(holder, device, args.seed)
        _, topn1000 = phase_topn1000(holder, device, args.seed)
        holder.close()
        launches = dict(ck.LAUNCHES)
        ck.reset_launches()
        phase_server(data_dir, device, args.seed, ids200, topn1000)
        for name, n in ck.LAUNCHES.items():
            launches[name] += n
    before_bench = ck.LAUNCHES["op_count_rows"]
    phase_bench(device)
    if ck.LAUNCHES["op_count_rows"] <= before_bench:
        _fail("op_count_rows: no launch in the bench phase")
    launches["op_count_rows"] += ck.LAUNCHES["op_count_rows"] - before_bench
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name}: no launch on the main path")
        table[name]["launches"] = n

    print(f"nvidia-smi: {bench.card_info()}", flush=True)
    _emit({"kernels": list(table.values())})
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

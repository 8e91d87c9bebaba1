"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels (nvcc, sm_90a) from the sources in this
checkout, then runs nine phases and prints one JSON line for each:

1. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card, exact (integer results), at the serving shapes,
   the odd shapes, bit-31 words, a 64-leaf mixed tree, a 1000-child
   Union (a program longer than the expression count stages in shared
   memory), a tree that needs spill slots and the BSI comparison folds
   of phase 6 (22 planes of 256 slices); the expression count at
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
5. ``planner``: the planner's decisions over ``t3`` (10 slices, under
   its EXACT_SLICES): a Count whose Intersect holds a proven-empty row
   beside a missing frame answers 0 with no launch (over the 256 slices
   of ``smoke`` it raises the missing frame instead, as the JAX package
   does); a Union with a proven-empty operand answers and launches what
   it does without it; a reordered Intersect answers what the
   planner-off executor answers; a subtree repeated over three queries
   hits the subresult cache on every slice the third time; and the
   warm p50 of ``TopN(frame=f, n=1000)`` and of a Count with the
   planner on and off, in turns. Each query's decisions and launches
   are printed.
6. ``fields``: BSI integer fields, time views and the inverse view
   through ``Executor.execute`` (``phase_fields``): configuration 4's
   256 slices with field ``amount`` of ``b4/v`` in [-10^6, 10^6]
   (depth 21, 4,194,304 values, 704 MiB of plane slabs on the card),
   Count(Range) of each operator and both clamps, Sum plain and
   filtered, Min and Max; time views of ``tv/t`` (YMDH, ~2 M
   timestamped bits through protobuf ``/import`` over 10 slices) under
   Range Counts whose covers mix Y, M, D and H views; ``tv/inv``'s
   inverse view under ``Bitmap(columnID=...)`` and a Count of two
   columns. Every answer held to a numpy reference from the seeded
   data; each Count's program length and device time against its bound.
7. ``server``: ``pilosa_tpu_torch.server.server.Server`` on
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
   HTTP front's cost). Then phase 6's queries again (the protobuf
   ``ValCount`` decoded), a new field created over HTTP with its values
   through the protobuf field-import route, and a time quantum set by
   ``PATCH`` under a timestamped SetBit and a Range.
8. ``durability``: the port's ``server`` verb as a subprocess on the
   card over a fresh directory, seeded by protobuf ``/import`` with
   configuration 4's rows over 256 slices, takes a write storm (8
   threads of SetBit/ClearBit queries; after a quarter of it 2 threads
   of 65,536-bit ``/import`` batches and one thread that drives slice 0
   past MAX_OP_N so that background snapshots swap its WAL) and is
   killed with SIGKILL.
   A ``Server`` in this process reopens the directory on the card: every
   acked write must be there and every acked ClearBit gone, no bit that
   was never written may appear, and Counts of every touched row over
   HTTP (expression count, densify) and a sourced TopN over six of them
   (TopN block count) must equal the reopened fragments' host answers.
   It prints acked writes/s, import bits/s, the ack latency p50/p99
   (also for the writers alone and beside the imports), the
   WAL bytes at the kill, the respawn-to-ready seconds, the launches and
   the card's name and power limit.
9. ``bench``: the benchmark of record, ``pilosa_tpu_torch.bench``, in
   this process at its default width and rows (16 pairs of 2^30-bit
   rows), with fewer chained dispatches (BENCH_ITERS); its line is the
   phase's line.

Every answer of phases 2-5 and 7 is held to the host roaring answer
computed from the port's own fragments, every answer of phase 6 to
numpy, and every count of phase 9 to the host ``popcnt_and``. The
kernels' launch counters are set to 0 before phase 2, before phase 6,
before phase 7 and before phase 8's reopen, and read after phases 5,
6, 7, 8 and 9: every kernel must have launched on that main path, the
TopN block count in phase 4's device top-k, the TopN block count, the
expression count and densify in its sourced queries, the expression
count (every device Count(Range) and Sum) and densify in phase 6,
again in the server phase by itself and again after phase 8's reopen,
and the op count in phase 9. Then it prints the card's name and power limit, the kernel
table as one JSON object, and as its last line
``{"ok": true, "device": {...}}``. Any mismatch or
error exits non-zero before that line. Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
BENCH_WORDS = 1 << 25      # words of a benchmark row (2^30 bits)
BENCH_ITERS = 64           # chained dispatches a trial in the bench phase
_EPOCH = dt.datetime(2017, 1, 1)  # the time phase's data starts here
_UNIX = dt.datetime(1970, 1, 1)


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

    # The BSI comparison folds of the fields phase: depth 21 at the
    # serving shape (22 planes of 256 slices); "><" needs a spill slot.
    from pilosa_tpu_torch.storage import bsi
    planes = _rand_words(gen, (22, 256, W), device)
    for op, upred in (("<", 1_123_456), (">=", 654_321), ("==", 999_999),
                      ("!=", 5), ("><", (333_333, 1_500_000))):
        expr = bsi.compare_fold_expr(
            op, upred, 21, lambda p: ("leaf", 0 if p == bsi.EXISTS_PLANE
                                      else p + 1))
        err["expr_count_rows"] = max(err["expr_count_rows"], _check_equal(
            f"expr_count_rows[bsi {op} 256x{W}]",
            ck.expr_count_rows(expr, planes),
            ck.expr_count_rows_torch(expr, planes)))
        checks += 1
    del planes

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


def _http(host: str, path: str, body: bytes, headers=None,
          method: str = "POST"):
    """One request with urllib; fails the run on any status but 200.
    Returns (body, client ms)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method=method, headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        _fail(f"server: {method} {path}: HTTP {e.code}:"
              f" {e.read()[:300]!r}")
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        _fail(f"server: {method} {path}: HTTP {status}")
    return out, ms


def _answer_of(kind: str, r):
    """Canonical form of one call's result ``r``: the executor's result,
    a JSON result or a protobuf ``QueryResult``."""
    if hasattr(r, "Pairs"):  # protobuf
        if kind == "count":
            return r.N
        if kind == "valcount":
            return (r.ValCount.Val, r.ValCount.Count)
        if kind == "topn":
            return [(p.Key, p.Count) for p in r.Pairs]
        return r.Bitmap.Bits.tolist()
    if kind == "count":
        return r
    if kind == "valcount":
        return ((r["value"], r["count"]) if isinstance(r, dict)
                else (r.value, r.count))
    if kind == "topn":
        return [(p["id"], p["count"]) if isinstance(p, dict)
                else (p.id, p.count) for p in r]
    return r["bits"] if isinstance(r, dict) else r.bits().tolist()


def phase_server(data_dir, device, seed: int, ids200: list,
                 topn1000=(), fields=(), n_slices: int = 256,
                 n_topn_slices: int = 10) -> dict:
    """The port's server on the card over phases 2-6's directory,
    driven over HTTP; every answer held to the host roaring answer from
    the server's own fragments, each (name, index, query, answer) of
    ``topn1000`` to the answer it gave through the executor in phase 4
    (the reopened ``.cache`` sidecars rank its frames), and each (name,
    index, query, kind, answer) of ``fields`` to phase 6's numpy answer
    (the first JSON ask cold, the rest warm). Then the field routes: a
    new field of ``b4/v``, its values through the protobuf field import,
    a Sum and a Count(Range) over it against numpy, and a time quantum
    set by ``PATCH`` on ``tv/inv`` followed by a timestamped SetBit and
    a Range over it."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.proto import rawimport
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage import native_ext

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
        warm_from_json = set()
        for name, index, q, kind, answer in fields:
            queries[f"fields_{name}"] = (index, q, kind)
            want[f"fields_{name}"] = answer
            warm_from_json.add(f"fields_{name}")

        results = []
        for name, (index, q, kind) in queries.items():
            expect = want[name]
            n_calls = 3 if name == "all3" else 1
            path = f"/index/{index}/query"
            if name == "bitmap_column_attrs":
                path += "?columnAttrs=true"
            entry = {"query": name, "index": index}
            for fmt in ("json", "protobuf"):
                headers = {"Accept": PB} if fmt == "protobuf" else {}
                if name not in warm_from_json:
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
                    if (name == "bitmap_column_attrs"
                            and sets != want_attr_sets):
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
        if fields:
            results += _server_field_routes(host, rng)
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


def _server_field_routes(host: str, rng) -> list:
    """A new field over HTTP: create it, import its values with the
    protobuf field-import route (one ImportValueRequest a slice), then a
    Sum (JSON and protobuf) and a Count(Range) against numpy; and a time
    quantum set by PATCH, a timestamped SetBit and a Range over it."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.proto import internal as pb

    PB = "application/x-protobuf"
    out = []
    _http(host, "/index/b4/frame/v/field/score", b'{"min": 0, "max": 1000}')
    t0 = time.perf_counter()
    all_vals = []
    for s in range(4):
        cols = np.unique(rng.integers(0, SLICE_WIDTH, size=20_000,
                                      dtype=np.uint64))
        vals = rng.integers(0, 1001, size=len(cols))
        body = pb.ImportValueRequest(
            Index="b4", Frame="v", Field="score", Slice=s,
            ColumnIDs=cols + np.uint64(s * SLICE_WIDTH), Values=vals
        ).SerializeToString()
        _http(host, "/index/b4/frame/v/field/score/import", body,
              {"Content-Type": PB, "Accept": PB})
        all_vals.append(vals)
    vals = np.concatenate(all_vals)
    import_ms = (time.perf_counter() - t0) * 1e3
    checks = [("score_sum", "Sum(frame=v, field=score)", "valcount",
               (int(vals.sum()), len(vals))),
              ("score_count_gt", "Count(Range(frame=v, score > 500))",
               "count", int((vals > 500).sum()))]
    for name, q, kind, want in checks:
        for fmt, headers in (("json", {}), ("protobuf", {"Accept": PB})):
            body, ms = _http(host, "/index/b4/query", q.encode(), headers)
            if fmt == "json":
                got = _answer_of(kind, json.loads(body)["results"][0])
            else:
                got = _answer_of(kind, pb.QueryResponse.FromString(
                    body).Results[0])
            if got != want:
                _fail(f"server {name} ({fmt}): {got} != numpy {want}")
            out.append({"query": name, "format": fmt, "ms": ms,
                        "answer": want})
    out[0]["import_ms"] = import_ms
    _http(host, "/index/tv/frame/inv/time-quantum",
          b'{"timeQuantum": "YM"}', method="PATCH")
    _http(host, "/index/tv/query",
          b'SetBit(frame=inv, rowID=5, columnID=7,'
          b' timestamp="2017-05-06T07:08")')
    body, ms = _http(host, "/index/tv/query",
                     b'Count(Range(frame=inv, rowID=5,'
                     b' start="2017-05-01T00:00", end="2017-06-01T00:00"))')
    if json.loads(body)["results"] != [1]:
        _fail(f"server: Range over the patched time quantum gave {body!r}")
    out.append({"query": "patched_time_quantum_range", "ms": ms,
                "answer": 1})
    return out


def phase_planner(holder, device) -> dict:
    """The planner's decisions on the card, over ``t3`` (10 slices, at
    most EXACT_SLICES: the planner proves emptiness only when it
    enumerates every slice). A Count whose Intersect holds a
    proven-empty row beside a missing frame answers 0 with no launch;
    the same query over the 256 slices of ``smoke`` raises the missing
    frame, as the JAX package does; a Union with a proven-empty operand answers and
    launches what it does without that operand; a reordered Intersect
    answers what the planner-off executor and host roaring answer; a
    subtree repeated across three queries hits the subresult cache on
    every slice the third time. Every answer is held to host roaring.
    Last, what planning costs a warm query: ``TopN(frame=f, n=1000)``
    and a device Count, 20 runs each with the planner on and off in
    turns."""
    import numpy as np
    from pilosa_tpu_torch.errors import FrameNotFoundError
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.plan.planner import EXACT_SLICES

    n_slices = holder.index("t3").max_slice() + 1
    if n_slices > EXACT_SLICES:
        _fail(f"planner: t3 has {n_slices} slices > {EXACT_SLICES}")
    frags = [holder.fragment("t3", "f", "standard", s)
             for s in range(n_slices)]
    empty = 200_000  # a row of t3/f with no bit
    if any(f.row_count(empty) for f in frags):
        _fail(f"planner: row {empty} of t3/f is not empty")
    ex = Executor(holder, device=device)
    plain = Executor(holder, device=device)
    plain.planner_enabled = False
    results = []

    def run(name, q, executor=ex):
        residency.device_cache().clear()
        before = dict(ck.LAUNCHES)
        out, ms = _timed_query(executor, "t3", q)
        rec = {"query": name, "pql": q, "ms": ms,
               "launches": {k: ck.LAUNCHES[k] - before[k] for k in before
                            if ck.LAUNCHES[k] != before[k]},
               "planner": executor.planner_enabled}
        if executor.planner_enabled:
            plan = ex.explain("t3", q)
            rec["decisions"] = plan.get("decisions", {})
            rec["plan"] = plan["calls"]
        results.append(rec)
        return out[0], rec

    def host(fn):
        out = None
        for f in frags:
            bm = fn(f)
            out = bm if out is None else out.union(bm)
        return out

    def bf(r):
        return f"Bitmap(rowID={r}, frame=f)"

    # A proven-empty row beside a missing frame: 0 and no launch at
    # ≤ EXACT_SLICES ...
    q32 = f"Count(Intersect({bf(empty)}, Bitmap(rowID=1, frame=nope)))"
    got, rec = run("empty_beside_missing_frame", q32)
    if got != 0 or rec["launches"] or \
            "short_circuit" not in rec["decisions"]:
        _fail(f"planner: the empty-beside-missing-frame Count gave "
              f"{got}, launches {rec['launches']}, decisions "
              f"{rec['decisions']}")
    # ... and the missing frame's error above it (no proof over 256).
    try:
        ex.execute("smoke", q32.replace(f"rowID={empty}", "rowID=999999"))
    except FrameNotFoundError as e:
        results.append({"query": "empty_beside_missing_frame_256_slices",
                        "error": str(e)})
    else:
        _fail("planner: the empty-beside-missing-frame Count answered"
              " over 256 slices")

    # A Union with a proven-empty operand, beside the same Union
    # without it.
    want1 = host(lambda f: f.row(1)).count()
    got_e, rec_e = run("union_with_empty",
                       f"Count(Union({bf(1)}, {bf(empty)}))")
    got_1, rec_1 = run("union_without", f"Count(Union({bf(1)}))")
    if not (got_e == got_1 == want1) or rec_e["launches"] != \
            rec_1["launches"]:
        _fail(f"planner: Union with an empty operand {got_e} with "
              f"launches {rec_e['launches']}, without {got_1} with "
              f"launches {rec_1['launches']}, host {want1}")
    if not rec_1["launches"]:
        _fail("planner: the Union launched no kernel")

    # A reordered Intersect: the larger row first.
    q_re = f"Count(Intersect({bf(0)}, {bf(1500)}))"
    want_re = host(lambda f: f.row(0).intersect(f.row(1500))).count()
    got_re, rec_re = run("reordered_intersect", q_re)
    got_off, _ = run("reordered_intersect_planner_off", q_re, plain)
    if got_re != want_re or got_off != want_re or \
            "reordered" not in rec_re["decisions"]:
        _fail(f"planner: reordered Intersect {got_re}, planner off "
              f"{got_off}, host {want_re}, decisions "
              f"{rec_re['decisions']}")

    # CSE: Intersect(0, 1) in three queries; the third hits per slice.
    inter = f"Intersect({bf(0)}, {bf(1)})"
    cse = [("cse_first", f"Union({inter}, {bf(2)})",
            lambda f: f.row(0).intersect(f.row(1)).union(f.row(2))),
           ("cse_second", f"Difference({inter}, {bf(3)})",
            lambda f: f.row(0).intersect(f.row(1)).difference(f.row(3))),
           ("cse_third", f"Union({inter}, {bf(2)})",
            lambda f: f.row(0).intersect(f.row(1)).union(f.row(2)))]
    sub = ex.planner.subresults
    for name, q, fn in cse:
        hits0 = sub.hits
        got, rec = run(name, q)
        want = host(fn).bits().tolist()
        rec["subresult_hits"] = sub.hits - hits0
        if got.bits().tolist() != want:
            _fail(f"planner: {name} differs from host roaring")
    if results[-1]["subresult_hits"] != n_slices:
        _fail(f"planner: the third CSE query hit "
              f"{results[-1]['subresult_hits']} of {n_slices} slices")

    # What planning costs a warm query: the metric of record's TopN and
    # a device Count, planner on and off in turns (on/off, off/on, ...),
    # warm (device cache kept), the same answer both ways.
    overhead = []
    for name, q in (("topn_n1000", "TopN(frame=f, n=1000)"),
                    ("count_intersect", f"Count(Intersect({bf(0)}, "
                                        f"{bf(1)}))")):
        times = {True: [], False: []}
        answers = set()
        for i in range(21):
            for on in ((True, False) if i % 2 else (False, True)):
                ex.planner_enabled = on
                out, ms = _timed_query(ex, "t3", q)
                answers.add(repr(out))
                if i:  # the first round warms both
                    times[on].append(ms)
        ex.planner_enabled = True
        if len(answers) != 1:
            _fail(f"planner: {name} answers differ with the planner off")
        on_p50 = float(np.median(times[True]))
        off_p50 = float(np.median(times[False]))
        overhead.append({"query": name, "runs": len(times[True]),
                         "on_p50_ms": on_p50, "off_p50_ms": off_p50,
                         "on_minus_off_ms": on_p50 - off_p50})
    out = {"phase": "planner", "index": "t3", "slices": n_slices,
           "queries": results, "overhead": overhead,
           "subresults": sub.stats(),
           "decision_totals": dict(ex.planner.decision_totals)}
    _emit(out)
    return out


FIELD_MIN, FIELD_MAX = -1_000_000, 1_000_000  # configuration 4's field
TIME_QUANTUM = "YMDH"


def _hour(t):
    return int((t - _EPOCH).total_seconds() // 3600)


def _fields_bsi_queries(vals):
    """(name, PQL, numpy answer) of the BSI Count queries over ``vals``
    (configuration 4's field ``amount`` of frame ``v``)."""
    import numpy as np
    x = int(vals[len(vals) // 3])
    lo, hi = -250_000, 400_000
    ops = {"eq": ("==", np.equal), "ne": ("!=", np.not_equal),
           "lt": ("<", np.less), "le": ("<=", np.less_equal),
           "gt": (">", np.greater), "ge": (">=", np.greater_equal)}
    out = []
    for name, (op, fn) in ops.items():
        p = x if op in ("==", "!=") else 123_456
        out.append((f"count_{name}",
                    f"Count(Range(frame=v, amount {op} {p}))",
                    int(fn(vals, p).sum())))
    out.append(("count_between",
                f"Count(Range(frame=v, amount >< [{lo}, {hi}]))",
                int(((vals >= lo) & (vals <= hi)).sum())))
    out.append(("count_clamp_all", "Count(Range(frame=v, amount < 2000000))",
                len(vals)))
    out.append(("count_clamp_none", "Count(Range(frame=v, amount > 1000000))",
                0))
    return out


def phase_fields(holder, device, seed: int, n_slices: int = 256,
                 n_time_slices: int = 10, time_bits: int = 2_000_000,
                 n_rows: int = 100, n_days: int = 24) -> tuple:
    """BSI integer fields, time views and the inverse view through
    ``Executor.execute`` on the card, every answer held to a numpy
    reference built from the seeded data (no code of the port).

    - Index ``b4``, frame ``v``, field ``amount`` in [-10^6, 10^6]
      (depth 21) at configuration 4's 256 slices: one column in 64
      valued (4,194,304 values through ``import_field_values``), a
      filter row in frame ``seg``; Count(Range) of every operator and
      both clamps, Sum unfiltered and filtered, Min and Max, cold and
      warm. For each Count: its launches, the comparison's program
      length and spill slots, and the expression count's device time
      over the resident plane slabs against its bound (each slab its
      program reads, read once) and the one-pass bound of all 22
      planes; for each Sum the device time of its 22 launches against
      the same bound. Each of those kernel answers is also held to its
      plain version on the same slabs.
    - Index ``tv``, frame ``t`` (timeQuantum YMDH, 100 rows, 10 slices):
      ~2 M timestamped bits over ``n_days`` days of 2017 (two hours a
      day, at minute 0 or 30: 96 distinct timestamps) through protobuf ``/import`` with Timestamps (the port's
      handler, in process) and 50 timestamped SetBit calls;
      Count(Range(...)) over windows whose covers mix Y, M, D and H
      views.
    - Frame ``inv`` of ``tv`` (inverseEnabled, 10 slices):
      ``Bitmap(columnID=c)`` and a Count of an Intersect of two columns.

    Returns the phase's line and the (name, index, query, kind, answer)
    list that the server phase asks again over HTTP."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.frame import Field, FrameOptions
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server.handler import Handler
    from pilosa_tpu_torch.utils import timequantum as tq

    rng = np.random.default_rng(seed + 7)
    t_phase = time.perf_counter()
    slices = tuple(range(n_slices))
    slab_bytes = n_slices * SLICE_WIDTH // 8

    # -- BSI: configuration 4 ------------------------------------------------
    t0 = time.perf_counter()
    idx = holder.create_index("b4")
    v = idx.create_frame("v")
    field = v.create_field(Field("amount", FIELD_MIN, FIELD_MAX))
    n_cols = n_slices * SLICE_WIDTH
    cols = (np.arange(0, n_cols, 64, dtype=np.uint64)
            + rng.integers(0, 64, size=n_cols // 64).astype(np.uint64))
    vals = rng.integers(FIELD_MIN, FIELD_MAX + 1, size=len(cols))
    v.import_field_values("amount", cols, vals)
    in_seg = rng.random(len(cols)) < 0.125
    seg_cols = np.concatenate([cols[in_seg], cols[~in_seg][:1000] + 1])
    idx.create_frame("seg").import_bits(
        np.full(len(seg_cols), 1, np.uint64), np.sort(seg_cols))
    bsi_load_s = time.perf_counter() - t0

    ex = Executor(holder, device=device)
    depth = field.bit_depth
    full_bound_ms = (depth + 1) * slab_bytes / HBM_BYTES_PER_S * 1e3
    served = []
    results = []

    def ask(name, index, q, want, kind, device_time=False):
        residency.device_cache().clear()
        entry = {"query": name, "pql": q}
        before = dict(ck.LAUNCHES)
        for state in ("cold", "warm"):
            out, ms = _timed_query(ex, index, q)
            got = _answer_of(kind, out[0])
            if got != want:
                _fail(f"fields {name} ({state}): {str(got)[:120]} !="
                      f" numpy {str(want)[:120]}")
            entry[f"{state}_ms"] = ms
            if state == "cold":
                entry["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                     for k in before
                                     if ck.LAUNCHES[k] != before[k]}
        entry["answer"] = (want if not isinstance(want, list)
                           else f"{len(want)} bits")
        if device_time:
            entry.update(_count_device_time(index, q, name))
        results.append(entry)
        return entry

    def _count_device_time(index, q, name):
        leaves = []
        expr = ex._compile_device_expr(index, parse(q).calls[0].children[0],
                                       leaves)
        if expr is None:
            return {"program": None}
        prog, slots = ck.compile_program(expr)
        arrs = [ex._leaf_device_array(index, leaf, slices)
                for leaf in leaves]
        return {"program": len(prog), "spill_slots": slots,
                **_fields_device_time(name, [expr], arrs, n_slices),
                "full_pass_bound_ms": full_bound_ms}

    for name, q, want in _fields_bsi_queries(vals):
        ask(name, "b4", q, want, "count", device_time=True)
        if name in ("count_eq", "count_lt", "count_between",
                    "count_clamp_all"):
            served.append((name, "b4", q, "count", want))
    seg_vals = vals[np.isin(cols, seg_cols)]
    aggs = [("sum", "Sum(frame=v, field=amount)",
             (int(vals.sum()), len(vals))),
            ("sum_filtered", "Sum(Bitmap(frame=seg, rowID=1), frame=v,"
                             " field=amount)",
             (int(seg_vals.sum()), len(seg_vals))),
            ("min", "Min(frame=v, field=amount)",
             (int(vals.min()), int((vals == vals.min()).sum()))),
            ("max", "Max(frame=v, field=amount)",
             (int(vals.max()), int((vals == vals.max()).sum())))]
    for name, q, want in aggs:
        e = ask(name, "b4", q, want, "valcount")
        served.append((name, "b4", q, "valcount", want))
        if name.startswith("sum"):
            if e["launches"].get("expr_count_rows") != depth + 1:
                _fail(f"fields {name}: {e['launches']} launches, not "
                      f"{depth + 1} expression counts")
            c = parse(q).calls[0]
            exprs, leaves = ex._sum_exprs("b4", "v", field, (
                c.children[0] if c.children else None))
            arrs = [ex._leaf_device_array("b4", leaf, slices)
                    for leaf in leaves]
            e.update(_fields_device_time(name, exprs, arrs, n_slices))

    # -- time views ----------------------------------------------------------
    t0 = time.perf_counter()
    tv = holder.create_index("tv")
    tv.create_frame("t", FrameOptions(time_quantum=TIME_QUANTUM))
    handler = Handler(holder, ex)
    days = np.sort(rng.choice(365, size=n_days, replace=False))
    stamps = [_EPOCH + dt.timedelta(days=int(d), hours=int(h))
              for d in days for h in rng.choice(24, size=2, replace=False)]
    t_rows, t_cols, t_hours = [], [], []
    per = time_bits // n_time_slices
    for s in range(n_time_slices):
        rows = rng.integers(0, n_rows, size=per).astype(np.uint64)
        c = (rng.integers(0, SLICE_WIDTH, size=per).astype(np.uint64)
             + np.uint64(s * SLICE_WIDTH))
        pick = rng.integers(0, len(stamps), size=per)
        minutes = rng.choice((0, 30), size=per)
        ns = np.array([int((stamps[i] - _UNIX).total_seconds())
                       for i in range(len(stamps))], np.int64)[pick]
        ns = (ns + minutes * 60) * 10**9
        body = pb.ImportRequest(Index="tv", Frame="t", Slice=s, RowIDs=rows,
                                ColumnIDs=c, Timestamps=ns
                                ).SerializeToString()
        status = _wsgi_post(handler, "/import", body)
        if status != 200:
            _fail(f"fields: timestamped /import answered {status}")
        t_rows.append(rows)
        t_cols.append(c)
        t_hours.append(np.array([_hour(stamps[i]) for i in
                                 range(len(stamps))])[pick])
    for k in range(50):
        t = stamps[int(rng.integers(len(stamps)))] + dt.timedelta(minutes=k)
        r, c = int(rng.integers(n_rows)), int(rng.integers(
            n_time_slices * SLICE_WIDTH))
        ex.execute("tv", f'SetBit(frame=t, rowID={r}, columnID={c},'
                         f' timestamp="{t.strftime("%Y-%m-%dT%H:%M")}")')
        t_rows.append(np.array([r], np.uint64))
        t_cols.append(np.array([c], np.uint64))
        t_hours.append(np.array([_hour(t)]))
    t_rows, t_cols = np.concatenate(t_rows), np.concatenate(t_cols)
    t_hours = np.concatenate(t_hours)
    time_load_s = time.perf_counter() - t0
    n_views = len(holder.frame("tv", "t").views)

    windows = [("year", dt.datetime(2017, 1, 1), dt.datetime(2018, 1, 1)),
               ("months", dt.datetime(2017, 3, 1), dt.datetime(2017, 7, 1)),
               ("mixed", stamps[3] - dt.timedelta(hours=5),
                stamps[-4] + dt.timedelta(hours=9)),
               ("days_hours", stamps[10] - dt.timedelta(hours=3),
                stamps[12] + dt.timedelta(hours=2))]
    for wname, a, b in windows:
        a = a.replace(minute=0)
        b = b.replace(minute=0)
        units = {len(vn) - len("standard_")
                 for vn in tq.views_by_time_range("standard", a, b,
                                                  TIME_QUANTUM)}
        for r in (1, int(rng.integers(n_rows))):
            m = ((t_rows == r) & (t_hours >= _hour(a))
                 & (t_hours < _hour(b)))
            want = len(np.unique(t_cols[m]))
            q = (f'Count(Range(frame=t, rowID={r},'
                 f' start="{a.strftime("%Y-%m-%dT%H:%M")}",'
                 f' end="{b.strftime("%Y-%m-%dT%H:%M")}"))')
            e = ask(f"time_{wname}_row{r}", "tv", q, want, "count")
            e["cover_units"] = sorted(units)
            if wname in ("year", "mixed") and r == 1:
                served.append((f"time_{wname}_row{r}", "tv", q, "count",
                               want))

    # -- inverse view ----------------------------------------------------------
    t0 = time.perf_counter()
    inv = tv.create_frame("inv", FrameOptions(inverse_enabled=True))
    hot = rng.integers(0, n_time_slices * SLICE_WIDTH, size=4,
                       dtype=np.uint64)
    i_rows = np.concatenate([rng.integers(0, 1000, size=400_000),
                             rng.integers(0, 1000, size=1200)]
                            ).astype(np.uint64)
    i_cols = np.concatenate([
        rng.integers(0, n_time_slices * SLICE_WIDTH, size=400_000,
                     dtype=np.uint64), hot[rng.integers(0, 4, size=1200)]])
    inv.import_bits(i_rows, i_cols)
    inv_load_s = time.perf_counter() - t0

    def rows_of(c):
        return np.unique(i_rows[i_cols == c]).tolist()

    a, b = int(hot[0]), int(hot[1])
    for name, q, want, kind in (
            ("inverse_bitmap", f"Bitmap(columnID={a}, frame=inv)",
             rows_of(a), "bitmap"),
            ("inverse_count_intersect",
             f"Count(Intersect(Bitmap(columnID={a}, frame=inv),"
             f" Bitmap(columnID={b}, frame=inv)))",
             len(set(rows_of(a)) & set(rows_of(b))), "count")):
        ask(name, "tv", q, want, kind)
        served.append((name, "tv", q, kind, want))
    if results[-1]["launches"].get("expr_count_rows", 0) < 1:
        _fail("fields: the inverse Count launched no expression count")

    out = {"phase": "fields", "slices": n_slices, "values": len(vals),
           "depth": depth, "bsi_load_s": bsi_load_s,
           "plane_slab_mib": (depth + 1) * slab_bytes / 2**20,
           "full_pass_bound_ms": full_bound_ms,
           "time_slices": n_time_slices, "time_bits": int(len(t_rows)),
           "time_views": n_views, "time_load_s": time_load_s,
           "inverse_bits": int(len(i_rows)), "inverse_load_s": inv_load_s,
           "resident_mib": residency.device_cache().snapshot()["usedBytes"]
           / 2**20, "queries": results,
           "phase_s": time.perf_counter() - t_phase,
           "card": _card()}
    _emit(out)
    return out, served


def _fields_device_time(name, exprs, arrs, n_slices) -> dict:
    """The expressions of one query (a Count's one, a Sum's depth+1)
    over its resident slabs ``arrs``: each count held to its plain
    version, then the device time of all of them (one CUDA graph) and
    the plain versions' time, against the bound of reading each slab
    once. Launches made here do not count as the main path's."""
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import timing
    from pilosa_tpu_torch.parallel import mesh as mesh_mod

    per = []
    for e in exprs:
        ids = mesh_mod.expr_leaf_ids(e)
        per.append((mesh_mod.remap_expr_leaves(
            e, {g: i for i, g in enumerate(ids)}), [arrs[i] for i in ids]))

    def run():
        return [ck.expr_count_rows(e, ls) for e, ls in per]

    def plain():
        return [ck.expr_count_rows_torch(e, ls) for e, ls in per]

    saved = dict(ck.LAUNCHES)
    try:
        for got, want in zip(run(), plain()):
            if not torch.equal(got, want):
                _fail(f"fields {name}: expr_count_rows differs from its"
                      " plain version on the resident slabs")
        device_ms = timing.graph_ms(run, [()], 10 if len(per) == 1 else 2)
        plain_ms = timing.events_ms(plain, [()], 3, warmup=1)
    finally:
        ck.LAUNCHES.update(saved)
    n_read = len({i for e in exprs for i in mesh_mod.expr_leaf_ids(e)})
    slab = n_slices * SLICE_WIDTH // 8
    return {"leaves": n_read, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": (n_read * slab + len(per) * n_slices * 4)
            / HBM_BYTES_PER_S * 1e3}


def _wsgi_post(app, path, body):
    """POST ``body`` (protobuf) to a WSGI app in this process → status."""
    import io
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])

    b"".join(app({"REQUEST_METHOD": "POST", "PATH_INFO": path,
                  "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
                  "CONTENT_TYPE": "application/x-protobuf",
                  "HTTP_ACCEPT": "application/x-protobuf",
                  "wsgi.input": io.BytesIO(body)}, start_response))
    return out["status"]


def _card() -> str:
    """``name, power limit`` of the card (nvidia-smi)."""
    from pilosa_tpu_torch import bench
    return bench.card_info()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_up(host: str, proc, deadline_s: float) -> float:
    """Seconds until ``host`` answers /version; fails if ``proc`` dies
    or the deadline passes."""
    import urllib.request
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline_s:
        if proc.poll() is not None:
            _fail(f"durability: the server exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://{host}/version",
                                        timeout=5) as r:
                r.read()
            return time.perf_counter() - t0
        except OSError:
            time.sleep(0.2)
    _fail(f"durability: {host} not up in {deadline_s} s")


def _oplog_bytes(path: str) -> tuple[int, int]:
    """(op-log bytes, snapshot bytes) of one fragment data file: what a
    reopen replays past the footered snapshot body."""
    from pilosa_tpu_torch.storage import integrity, roaring
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    hdr, _, _, offs, sizes, ops_offset, body_end = \
        roaring.parse_snapshot_layout(buf)
    info = integrity.parse_and_verify_footer(buf, len(hdr), ops_offset,
                                             offs, sizes, body_end)
    start = body_end + (info.size if info is not None else 0)
    return len(data) - start, start


def phase_durability(device, seed: int, tmp: str, n_slices: int = 256,
                     storm_s: float = 20.0) -> dict:
    """Acked writes survive SIGKILL on the card. The port's ``server``
    verb runs as a subprocess on the card over a fresh directory,
    seeded by protobuf ``/import`` with BASELINE configuration 4's rows
    (1-8 at 1/64, 9-16 at 1/4096 over 256 slices). A write storm of
    ``storm_s`` seconds follows, every stream from ``seed``: 8 client
    threads of SetBit/ClearBit queries (rows 100-179) throughout, and
    after its first quarter (the ack latency of each window is printed)
    2 threads of 65,536-bit protobuf ``/import`` batches over random
    slices (rows 200-219) and one thread importing 65,536-bit batches
    into slice 0 (rows 300-309), which drives that fragment past
    MAX_OP_N so that background snapshots swap its WAL (the data file's
    inode changes) mid-storm. Each thread records what was acked (HTTP
    200). The
    server is killed with SIGKILL; a ``Server`` in this process reopens
    the directory on the card and must hold (a) every acked SetBit and
    import bit and none of the acked ClearBits (for bits whose last op
    was acked), (b) no bit of a storm row that was never attempted;
    (c) Count of every touched row over HTTP (the expression count,
    densify for these sparse rows) must equal the reopened fragments'
    host row counts, and a sourced TopN over six touched rows (the TopN
    block count) its host answer."""
    import signal
    import subprocess
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH as SW
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage import native_ext

    PB = "application/x-protobuf"
    W = np.uint64(SW)
    repo = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(tmp, "durable")
    frag_dir = os.path.join(data_dir, "c4", "f", "views", "standard",
                            "fragments")
    port = _free_port()
    host = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    log_path = os.path.join(tmp, "durable_server.log")
    halt = threading.Event()
    rng = np.random.default_rng(seed + 17)

    def post(path, body, headers=None, timeout=60.0):
        req = urllib.request.Request(f"http://{host}{path}", data=body,
                                     method="POST", headers=headers or {})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()

    points: list = []      # [thread, pos (row * 2^28 + col), op, acked]
    batches: list = []     # [row * 2^28 + col positions, acked]
    lat_ms: list = []
    swaps = [0]
    cols_total = np.uint64(n_slices * SW)

    def writer(k):
        g = np.random.default_rng(seed * 1000 + k)
        mine = []
        while not halt.is_set():
            if mine and g.random() < 0.3:
                pos, op = mine[int(g.integers(len(mine)))], "clear"
            else:
                pos = (np.uint64(100 + 10 * k + int(g.integers(10)))
                       * cols_total + np.uint64(g.integers(cols_total)))
                op = "set"
                mine.append(pos)
            entry = [k, pos, op, False]
            points.append(entry)
            call = "SetBit" if op == "set" else "ClearBit"
            t0 = time.perf_counter()
            try:
                post("/index/c4/query",
                     f"{call}(frame=f, rowID={int(pos // cols_total)},"
                     f" columnID={int(pos % cols_total)})".encode(),
                     timeout=30)
            except (OSError, urllib.error.URLError):
                continue
            lat_ms.append((t0, (time.perf_counter() - t0) * 1e3))
            entry[3] = True

    def importer(row0, slice_=None, k=0):
        g = np.random.default_rng(seed * 1000 + 100 + row0)
        while not halt.is_set():
            s = int(g.integers(n_slices)) if slice_ is None else slice_
            rows = row0 + g.integers(10, size=65536).astype(np.uint64)
            cols = np.uint64(s) * W + g.integers(SW, size=65536
                                                  ).astype(np.uint64)
            entry = [rows * cols_total + cols, False]
            batches.append(entry)
            body = pb.ImportRequest(Index="c4", Frame="f", Slice=s,
                                    RowIDs=rows, ColumnIDs=cols
                                    ).SerializeToString()
            try:
                post("/import", body, {"Content-Type": PB, "Accept": PB},
                     timeout=120)
            except (OSError, urllib.error.URLError):
                continue
            entry[1] = True

    def watcher():
        path = os.path.join(frag_dir, "0")
        last = os.stat(path).st_ino
        while not halt.is_set():
            try:
                ino = os.stat(path).st_ino
            except FileNotFoundError:
                ino = last  # mid-rename
            if ino != last:
                swaps[0] += 1
                last = ino
            time.sleep(0.02)

    t_spawn = time.perf_counter()
    with open(log_path, "w") as log:
        # On the card the verb runs with no --device (its default);
        # "--device cpu" only where the phase itself runs on the host.
        dev_args = [] if device.type == "cuda" else ["--device", "cpu"]
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "-d", data_dir, "-b", host] + dev_args, cwd=repo, env=env,
            stdout=log, stderr=subprocess.STDOUT)
    threads = []
    try:
        spawn_s = _wait_up(host, proc, 300)
        post("/index/c4", b"{}")
        post("/index/c4/frame/f", b"{}")
        t0 = time.perf_counter()
        seed_bits = 0
        for s in range(n_slices):
            rows, cols = [], []
            for row in range(1, 17):
                density = 64 if row <= 8 else 4096
                c = np.unique(rng.integers(0, SW, size=SW // density,
                                           dtype=np.uint64))
                rows.append(np.full(len(c), row, np.uint64))
                cols.append(c + np.uint64(s) * W)
            rows, cols = np.concatenate(rows), np.concatenate(cols)
            seed_bits += len(rows)
            post("/import", pb.ImportRequest(
                Index="c4", Frame="f", Slice=s, RowIDs=rows,
                ColumnIDs=cols).SerializeToString(),
                {"Content-Type": PB, "Accept": PB}, timeout=300)
        seed_s = time.perf_counter() - t0
        writers = [threading.Thread(target=writer, args=(k,))
                   for k in range(8)]
        loaders = [threading.Thread(target=importer, args=(200,)),
                   threading.Thread(target=importer, args=(210,)),
                   threading.Thread(target=importer, args=(300, 0)),
                   threading.Thread(target=watcher)]
        threads = writers + loaders
        # The point writers alone for the first quarter of the storm,
        # then the import threads join: the ack latency of each window.
        t_storm = time.perf_counter()
        for t in writers:
            t.start()
        time.sleep(storm_s / 4)
        t_loaded = time.perf_counter()
        for t in loaders:
            t.start()
        time.sleep(storm_s * 3 / 4)
        proc.send_signal(signal.SIGKILL)
        storm_wall = time.perf_counter() - t_storm
        halt.set()
        proc.wait(timeout=60)
    finally:
        halt.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        for t in threads:
            t.join(timeout=150)
    if any(t.is_alive() for t in threads):
        _fail("durability: a storm thread did not stop")
    if not swaps[0]:
        _fail("durability: no snapshot swapped slice 0's WAL mid-storm")

    wal_bytes = snap_bytes = 0
    for name in os.listdir(frag_dir):
        if name.isdigit():
            w, b = _oplog_bytes(os.path.join(frag_dir, name))
            wal_bytes += w
            snap_bytes += b

    # What the reopened directory must hold.
    acked_points = [e for e in points if e[3]]
    last = {}
    for k, pos, op, acked in points:
        last[pos] = (op, acked)
    must = [np.asarray([p for p, (op, a) in last.items()
                        if a and op == "set"], dtype=np.uint64)]
    must_not = np.asarray([p for p, (op, a) in last.items()
                           if a and op == "clear"], dtype=np.uint64)
    attempted = [np.asarray(list(last), dtype=np.uint64)]
    import_bits = 0
    for pos, acked in batches:
        attempted.append(pos)
        if acked:
            must.append(pos)
            import_bits += len(pos)
    must = np.unique(np.concatenate(must))
    attempted = np.unique(np.concatenate(attempted))
    if not len(acked_points) or not import_bits:
        _fail("durability: the storm acked no write")

    ck.reset_launches()
    residency.device_cache().clear()
    t0 = time.perf_counter()
    srv = Server(data_dir, host="127.0.0.1:0", device=device)
    srv.open()
    ready_s = time.perf_counter() - t0
    try:
        frags = [srv.holder.fragment("c4", "f", "standard", s)
                 for s in range(n_slices)]
        present = []
        for s, f in enumerate(frags):
            if f is None:
                continue
            p = f.positions()
            rows = p // W
            keep = rows >= 100
            present.append(rows[keep] * cols_total + np.uint64(s) * W
                           + p[keep] % W)
        present = np.unique(np.concatenate(present))
        missing = np.setdiff1d(must, present)
        if len(missing):
            _fail(f"durability: {len(missing)} acked writes missing "
                  f"after SIGKILL, e.g. {missing[:3].tolist()}")
        back = np.intersect1d(must_not, present)
        if len(back):
            _fail(f"durability: {len(back)} acked clears came back")
        stray = np.setdiff1d(present, attempted)
        if len(stray):
            _fail(f"durability: {len(stray)} bits were never written")

        touched = np.unique(attempted // cols_total).tolist()
        rows_p, counts_p = np.unique(present // cols_total,
                                     return_counts=True)
        have = dict(zip(rows_p.tolist(), counts_p.tolist()))
        host_counts = [have.get(r, 0) for r in touched]
        q = " ".join(f"Count(Bitmap(rowID={r}, frame=f))" for r in touched)
        body, count_ms = _http(srv.host, "/index/c4/query", q.encode())
        got = json.loads(body)["results"]
        if got != host_counts:
            _fail(f"durability: Count over HTTP {got[:5]} != host "
                  f"{host_counts[:5]}")
        ids = [touched[0], touched[7], touched[-21], touched[-20],
               touched[-10], touched[-1]]
        src_cols = [f.row(1).bits().astype(np.uint64) if f else None
                    for f in frags]
        pairs = []
        for r in ids:
            n = 0
            for s, f in enumerate(frags):
                if f is not None:
                    n += len(np.intersect1d(f.row(r).bits(), src_cols[s]))
            if n:
                pairs.append([r, n])
        pairs.sort(key=lambda p: (-p[1], p[0]))
        body, topn_ms = _http(
            srv.host, "/index/c4/query",
            f"TopN(Bitmap(rowID=1, frame=f), frame=f, ids={ids})".encode())
        got_topn = [[p["id"], p["count"]]
                    for p in json.loads(body)["results"][0]]
        if got_topn != pairs:
            _fail(f"durability: TopN {got_topn} != host {pairs}")
        launches = dict(ck.LAUNCHES)
        for name in ("expr_count_rows", "densify", "topn_block_count"):
            if not launches[name]:
                _fail(f"durability: {name} did not launch after the reopen")
    finally:
        t0 = time.perf_counter()
        srv.close()
        close_s = time.perf_counter() - t0
    alone = np.asarray([ms for t0, ms in lat_ms if t0 < t_loaded])
    loaded = np.asarray([ms for t0, ms in lat_ms if t0 >= t_loaded])
    both = np.concatenate([alone, loaded])
    import_s = storm_wall - (t_loaded - t_storm)
    out = {"phase": "durability", "slices": n_slices,
           "columns": n_slices * SW, "seed_bits": seed_bits,
           "seed_s": seed_s, "spawn_to_ready_s": spawn_s,
           "storm_s": storm_wall, "acked_writes": len(acked_points),
           "acked_writes_per_s": len(acked_points) / storm_wall,
           "unacked_writes": len(points) - len(acked_points),
           "acked_import_batches": sum(1 for _, a in batches if a),
           "import_bits_per_s": import_bits / import_s,
           "ack_ms_p50": float(np.percentile(both, 50)),
           "ack_ms_p99": float(np.percentile(both, 99)),
           "acks_alone": len(alone),
           "ack_ms_p50_alone": float(np.percentile(alone, 50)),
           "ack_ms_p99_alone": float(np.percentile(alone, 99)),
           "acks_with_imports": len(loaded),
           "ack_ms_p50_with_imports": float(np.percentile(loaded, 50)),
           "ack_ms_p99_with_imports": float(np.percentile(loaded, 99)),
           "import_s": import_s,
           "wal_swaps_seen": swaps[0], "wal_bytes_at_kill": wal_bytes,
           "snapshot_bytes_at_kill": snap_bytes,
           "respawn_to_ready_s": ready_s, "oplog_bytes_replayed": wal_bytes,
           "bits_checked": int(len(must)), "clears_checked":
           int(len(must_not)), "rows_counted": len(touched),
           "count_ms": count_ms, "topn_ms": topn_ms, "close_s": close_s,
           "mutate_ext": native_ext.EXT is not None,
           "launches": launches, "card": _card()}
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
        phase_planner(holder, device)
        launches = dict(ck.LAUNCHES)
        ck.reset_launches()
        _, fields = phase_fields(holder, device, args.seed)
        for name in ("expr_count_rows", "densify"):
            if ck.LAUNCHES[name] <= 0:
                _fail(f"{name}: no launch in the fields phase")
        for name, n in ck.LAUNCHES.items():
            launches[name] += n
        holder.close()
        ck.reset_launches()
        phase_server(data_dir, device, args.seed, ids200, topn1000, fields)
        for name, n in ck.LAUNCHES.items():
            launches[name] += n
        phase_durability(device, args.seed, tmp)
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

    print(f"nvidia-smi: {_card()}", flush=True)
    _emit({"kernels": list(table.values())})
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

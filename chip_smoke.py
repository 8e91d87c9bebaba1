"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels (nvcc, sm_90a) from the sources in this
checkout, then runs four phases and prints one JSON line for each:

1. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card, exact (integer results), at the serving shapes,
   the odd shapes, bit-31 words, a 64-leaf mixed tree and a 1000-child
   Union, and the op count at the benchmark's shape [16, 2^25] for every
   op, at one long row, 1-D, W = 4k+1..3, W below one CTA's chunk,
   all-ones and bit-31 words and views at odd word offsets; kernel and
   plain times from CUDA events, with the inputs rotated so that the
   50 MB L2 is exceeded as the serving path meets it.
2. ``count``: Count queries through ``Executor.execute`` over an index of
   256 slices (268,435,456 columns), cold and then resident.
3. ``topn``: exact TopN through ``Executor.execute`` over 10 slices, the
   resident form (200 candidates) and the streaming form (1,000
   candidates).
4. ``bench``: the benchmark of record, ``pilosa_tpu_torch.bench``, in
   this process at its default width and rows (16 pairs of 2^30-bit
   rows), with fewer chained dispatches (BENCH_ITERS); its line is the
   phase's line.

Every answer of phases 2 and 3 is held to the host roaring answer
computed from the port's own fragments, and every count of phase 4 to
the host ``popcnt_and``. The kernels' launch counters are set to 0
before phase 2 and read after phase 4: every kernel must have launched
on that main path, and the op count in phase 4. Then it prints the
card's name and power limit, the kernel table as one JSON object, and
as its last line ``{"ok": true, "device": {...}}``. Any mismatch or
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


def _events_ms(fn, args_list: list, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(*args)`` per call, from CUDA events over
    ``iters`` calls cycling through ``args_list`` (distinct copies of
    the inputs, so each launch reads what L2 does not hold)."""
    import torch
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def _dev_words(gen, shape, device):
    """Random int32-viewed u32 words made on the card (the 4 GiB
    benchmark operands would take long on the host)."""
    import torch
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64, device=device).to(torch.int32)
    w.view(-1)[0] = -1
    return w


def _op_count_checks(device, seed: int) -> tuple[int, int]:
    """op_count_rows against its plain version, exact, at the shapes of
    the benchmark and the odd ones; returns (checks, max abs error)."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=device).manual_seed(seed)
    W = BENCH_WORDS
    cases = [(op, (16, W)) for op in ("and", "or", "xor", "andnot")]
    cases += [("and", (1, W)), ("xor", (W + 3,)), ("or", (3, 4 * 8193 + 1)),
              ("andnot", (3, 4 * 8193 + 2)), ("xor", (3, 4 * 8193 + 3)),
              ("and", (5, 37)), ("andnot", (4, 3))]
    checks = err = 0
    for op, shape in cases:
        a, b = _dev_words(gen, shape, device), _dev_words(gen, shape, device)
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
    base = _dev_words(gen, (2, 8 * 1001 + 4), device)  # rows on the grid
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


def _sparse_slots(rng, t_rows, per_row, n_words):
    """Bucketed (lane, value) slots of ``t_rows`` rows with ``per_row``
    single-bit words each, through the port's host bucketing."""
    import numpy as np
    from pilosa_tpu_torch.ops import packed
    pairs = []
    for _ in range(t_rows):
        idx = np.sort(rng.choice(n_words, size=per_row, replace=False)
                      ).astype(np.int32)
        val = (np.uint32(1) << rng.integers(0, 32, size=per_row,
                                            dtype=np.uint32))
        pairs.append((idx, val.astype(np.uint32)))
    return packed.bucket_prepared(pairs, n_words // 128)


def phase_kernels(device, seed: int, w_serving: int = 32768) -> dict:
    """Each kernel equal to its plain version on the card; times at the
    main path's shapes (rows of ``w_serving`` words)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    W = w_serving
    checks = 0
    err = dict.fromkeys(ck.LAUNCHES, 0)

    # expr_count_rows: serving shapes, odd shapes, wide trees.
    exprs = {
        "intersect": ("and", ("leaf", 0), ("leaf", 1)),
        "mixed": ("or", ("and", ("leaf", 0), ("leaf", 1)),
                  ("andnot", ("xor", ("leaf", 2), ("leaf", 0)),
                   ("leaf", 1))),
        "union8": _fold("or", 8),
        "mixed64": _balanced(0, 64, ["and", "or", "xor", "andnot"]),
        "union1000": _fold("or", 1000),
    }
    cases = [("intersect", 2, 256, W), ("union8", 8, 256, W),
             ("mixed", 3, 9, 2048), ("mixed64", 64, 16, 2048),
             ("union1000", 1000, 4, 2048)]
    for name, n_leaves, s, w in cases:
        leaves = _rand_words(gen, (n_leaves, s, w), device)
        err["expr_count_rows"] = max(err["expr_count_rows"], _check_equal(
            f"expr_count_rows[{name}]",
            ck.expr_count_rows(exprs[name], leaves),
            ck.expr_count_rows_torch(exprs[name], leaves)))
        checks += 1

    # topn_block_count: resident serving shape, odd shape, no expr.
    for s, r, w, expr, n_leaves in ((10, 200, W, ("leaf", 0), 1),
                                    (9, 5, 2048, exprs["mixed"], 3),
                                    (9, 5, 2048, None, 0),
                                    (4, 3, 2048, exprs["union1000"], 1000)):
        rows = _rand_words(gen, (s, r, w), device)
        leaves = list(_rand_words(gen, (max(n_leaves, 1), s, w),
                                  device))[:n_leaves]
        err["topn_block_count"] = max(err["topn_block_count"], _check_equal(
            f"topn_block_count[{s}x{r}x{w}]",
            ck.topn_block_count(expr, rows, leaves),
            ck.topn_block_count_torch(expr, rows, leaves)))
        checks += 1

    # densify: serving shape (256 slices, sparse leaf rows), odd shape.
    for t, per_row, w in ((256, W // 128, W), (11, 300, 2048),
                          (11, 0, 2048)):
        lanes, vals = _sparse_slots(rng, t, per_row, w)
        lane = torch.from_numpy(lanes.view(np.int32)).to(device)
        val = torch.from_numpy(vals.view(np.int32)).to(device)
        err["densify"] = max(err["densify"], _check_equal(
            f"densify[{t}x{w}]", ck.densify(lane, val, w),
            ck.densify_torch(lane, val, w)))
        checks += 1

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
    lanes, vals = _sparse_slots(rng, 256, W // 128, W)
    dens = [(torch.from_numpy(lanes.view(np.int32)).to(device),
             torch.from_numpy(vals.view(np.int32)).to(device), W)
            for _ in range(copies)]
    de_bytes = lanes.size * 8 + 256 * W * 4
    gen_dev = torch.Generator(device=device).manual_seed(seed + 3)
    bench_ops = [("and", _dev_words(gen_dev, (16, BENCH_WORDS), device),
                  _dev_words(gen_dev, (16, BENCH_WORDS), device))]
    oc_bytes = 2 * 16 * BENCH_WORDS * 4 + 16 * 4
    long_row = [("and", _dev_words(gen_dev, (1, BENCH_WORDS), device),
                 _dev_words(gen_dev, (1, BENCH_WORDS), device))]
    table = []
    for name, src, rep, kern, plain, args, nbytes, iters, shape in (
            ("expr_count_rows", "pilosa_tpu_torch/ops/csrc/expr_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:143", ck.expr_count_rows,
             ck.expr_count_rows_torch, inter, ec_bytes, 200,
             f"Count(Intersect): leaves [2, 256, {W}]"),
            ("topn_block_count",
             "pilosa_tpu_torch/ops/csrc/topn_block_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:210", ck.topn_block_count,
             ck.topn_block_count_torch, rows_sets, tb_bytes, 50,
             f"resident TopN: rows [10, 200, {W}], 1 leaf"),
            ("densify", "pilosa_tpu_torch/ops/csrc/densify.cu",
             "pilosa_tpu/ops/pallas_kernels.py:323", ck.densify,
             ck.densify_torch, dens, de_bytes, 200,
             f"leaf slab upload: slots {list(lanes.shape)}"),
            ("op_count_rows", "pilosa_tpu_torch/ops/csrc/op_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:86", ck.op_count_rows,
             ck.op_count_rows_torch, bench_ops, oc_bytes, 20,
             f"bench of record: a, b [16, {BENCH_WORDS}]")):
        ms = _events_ms(kern, args, iters)
        plain_ms = _events_ms(plain, args, max(3, iters // 20), warmup=1)
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape,
            "bytes": nbytes})
    timings = [{k: e[k] for k in ("name", "shape", "ms", "plain_ms",
                                  "bound_ms", "library_ms")}
               for e in table]
    lr_bytes = 2 * BENCH_WORDS * 4 + 4
    timings.append({
        "name": "op_count_rows",
        "shape": f"one long row: a, b [1, {BENCH_WORDS}]",
        "ms": _events_ms(ck.op_count_rows, long_row, 50),
        "plain_ms": _events_ms(ck.op_count_rows_torch, long_row, 3,
                               warmup=1),
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


def phase_count(holder_dir, device, seed: int, n_slices: int = 256
                ) -> dict:
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency

    n_cols = n_slices * SLICE_WIDTH
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    holder = Holder(os.path.join(holder_dir, "count"))
    holder.open()
    frame = holder.create_index("smoke").create_frame("f")
    for row in range(1, 17):
        density = 64 if row <= 8 else 4096
        cols = _random_row(rng, n_cols, n_cols // density)
        frame.import_bits(np.full(len(cols), row, np.uint64), cols)
    load_s = time.perf_counter() - t0

    # Host roaring answers from the port's fragments (no kernel code).
    frags = [holder.fragment("smoke", "f", "standard", s)
             for s in range(n_slices)]

    def host_count(fn):
        return sum(fn(f).count() for f in frags if f is not None)

    def union(f, rows):
        out = f.row(rows[0])
        for r in rows[1:]:
            out = out.union(f.row(r))
        return out

    want = {
        "intersect": host_count(lambda f: f.row(1).intersect(f.row(2))),
        "union8": host_count(lambda f: union(f, list(range(1, 9)))),
        "difference": host_count(
            lambda f: union(f, list(range(9, 17))).difference(f.row(1))),
    }
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
    want["all3"] = [want["intersect"], want["union8"], want["difference"]]
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
    holder.close()
    out = {"phase": "count", "slices": n_slices, "columns": n_cols,
           "load_s": load_s, "resident_mib": snap["usedBytes"] / 2**20,
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out


def phase_topn(holder_dir, device, seed: int, n_slices: int = 10,
               n_rows: int = 1000, total_bits: int = 30_000_000) -> dict:
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency

    n_cols = n_slices * SLICE_WIDTH
    rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    holder = Holder(os.path.join(holder_dir, "topn"))
    holder.open()
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
        """Per-candidate exact counts from host roaring, then
        count-descending, id-ascending (ids given: no n-trim)."""
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
    holder.close()
    out = {"phase": "topn", "slices": n_slices, "columns": n_cols,
           "t_rows": n_rows, "t_bits": t_bits, "load_s": load_s,
           "queries": results, "launches": dict(ck.LAUNCHES)}
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as holder_dir:
        phase_count(holder_dir, device, args.seed)
        phase_topn(holder_dir, device, args.seed)
    before_bench = ck.LAUNCHES["op_count_rows"]
    phase_bench(device)
    if ck.LAUNCHES["op_count_rows"] <= before_bench:
        _fail("op_count_rows: no launch in the bench phase")
    launches = dict(ck.LAUNCHES)
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

"""A/B of this tree's CUDA kernels against an earlier design's, on one card.

    python -m pilosa_tpu_torch.ops.kernel_ab --baseline DIR [--rounds 2]

``DIR`` is the ``pilosa_tpu_torch/ops/csrc`` directory of an earlier
commit with the same C interface, unpacked for example with
``git archive <commit> pilosa_tpu_torch/ops/csrc | tar -x -C <dir>``
into a directory that .gitignore lists; a kernel whose entry point one
of the two designs lacks is left out. Both sets of sources are built
(ops.build.load) and loaded side by side, and the wrappers of
ops.cuda_kernels launch whichever set ``build._libs`` holds. For each
kernel, at the shape the main path gives it (chip_smoke.py's timing
shapes), both designs' results are first held exactly to the plain
PyTorch version on the same inputs; then device-only times
(ops.timing.graph_ms, as chip_smoke.py takes ``ms``) are taken in turns
— baseline, tree, tree, baseline — ``--rounds`` times. Beside them, the
same way: ``zero_`` of the densify output (32 MiB written) and a copy
of it (32 MiB read, 32 MiB written), what the card's memory does for
plain writes and for mixed traffic. Prints one JSON line: every time,
the medians, and the card's name and power limit. Exits 1 on any
mismatch or without a card.

The input makers (``dev_words``, ``sparse_slots``, ``odd_slots``) are
also what chip_smoke.py and the card tests build their inputs with.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
W = 32768                  # words of a slice row (WORDS_PER_SLICE)
BENCH_WORDS = 1 << 25      # words of a benchmark row (2^30 bits)
COPIES = 4                 # input copies a timing cycles through


def dev_words(gen, shape, device):
    """Random int32-viewed u32 words made on the card (half of them with
    bit 31 set) and one all-ones word."""
    import torch
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64, device=device).to(torch.int32)
    w.view(-1)[0] = -1
    return w


def sparse_slots(rng, t_rows, per_row, n_words):
    """Bucketed (lane, value) slots of ``t_rows`` rows with ``per_row``
    single-bit words each, through the port's host bucketing
    (ops.packed.bucket_prepared), u32."""
    from . import packed
    pairs = []
    for _ in range(t_rows):
        idx = np.sort(rng.choice(n_words, size=per_row, replace=False))
        val = np.uint32(1) << rng.integers(0, 32, size=per_row,
                                           dtype=np.uint32)
        pairs.append((idx.astype(np.int32), val.astype(np.uint32)))
    return packed.bucket_prepared(pairs, n_words // 128)


def odd_slots(rng, t_rows, subs, g_slots, empty_rows=()):
    """Bucketed (lane, value) slots ``[T, subs, G]`` u32 built directly,
    for any G: each group holds a random number (0..G) of distinct lanes
    with random values (bit 31 set in half of them); group (0, 0) is
    full and, for G >= 2, holds lanes 0 and 127 with a bit-31 and an
    all-ones value; padding slots (value 0) name random lanes;
    ``empty_rows`` are all padding."""
    lanes = np.zeros((t_rows, subs, g_slots), np.uint32)
    vals = np.zeros((t_rows, subs, g_slots), np.uint32)
    if g_slots == 0:
        return lanes, vals
    lanes[:] = rng.integers(0, 128, size=lanes.shape, dtype=np.uint32)
    for t in range(t_rows):
        if t in empty_rows:
            continue
        for s in range(subs):
            k = (g_slots if (t, s) == (0, 0)
                 else int(rng.integers(0, g_slots + 1)))
            lanes[t, s, :k] = rng.choice(128, size=k, replace=False)
            vals[t, s, :k] = rng.integers(1, 2**32, size=k,
                                          dtype=np.uint32)
    if g_slots >= 2 and 0 not in empty_rows:
        lanes[0, 0, :2] = [0, 127]
        vals[0, 0, :2] = [0x80000000, 0xFFFFFFFF]
        lanes[0, 0, 2:] = rng.choice(np.arange(1, 127), size=g_slots - 2,
                                     replace=False)
    return lanes, vals


def _cases(device, seed: int) -> list[dict]:
    """Per kernel: its wrapper, its plain version, the input copies and
    the bytes of its bound."""
    import torch
    from . import cuda_kernels as ck
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    inter = ("and", ("leaf", 0), ("leaf", 1))
    lanes, vals = sparse_slots(rng, 256, W // 128, W)
    lane = torch.from_numpy(lanes.view(np.int32)).to(device)
    val = torch.from_numpy(vals.view(np.int32)).to(device)
    c2_args = [(_or_fold(1000), dev_words(gen, (1000, 1, W), device))
               for _ in range(2)]
    return [
        {"name": "expr_count_rows", "shape": f"leaves [2, 256, {W}]",
         "fn": ck.expr_count_rows, "plain": ck.expr_count_rows_torch,
         "args": [(inter, dev_words(gen, (2, 256, W), device))
                  for _ in range(COPIES)],
         "bytes": 2 * 256 * W * 4 + 256 * 4},
        {"name": "topn_block_count", "shape": f"rows [10, 200, {W}], 1 leaf",
         "fn": ck.topn_block_count, "plain": ck.topn_block_count_torch,
         "args": [(("leaf", 0), dev_words(gen, (10, 200, W), device),
                   [dev_words(gen, (10, W), device)]) for _ in range(2)],
         "bytes": 10 * 200 * W * 4 + 10 * W * 4 + 10 * 200 * 4},
        {"name": "densify", "shape": f"slots {list(lanes.shape)}",
         "fn": ck.densify, "plain": ck.densify_torch,
         "args": [(lane.clone(), val.clone(), W) for _ in range(COPIES)],
         "bytes": lanes.size * 8 + 256 * W * 4},
        {"name": "op_count_rows", "shape": f"a, b [16, {BENCH_WORDS}]",
         "fn": ck.op_count_rows, "plain": ck.op_count_rows_torch,
         "args": [("and", dev_words(gen, (16, BENCH_WORDS), device),
                   dev_words(gen, (16, BENCH_WORDS), device))],
         "bytes": 2 * 16 * BENCH_WORDS * 4 + 16 * 4},
        {"name": "expr_words", "shape": f"leaves [16, 256, {W}]",
         "fn": ck.expr_words, "plain": ck.expr_words_torch,
         "symbol": ("expr_words", "pilosa_expr_fold_words"),
         "args": [(_or_fold(16), dev_words(gen, (16, 256, W), device))
                  for _ in range(2)],
         "bytes": 17 * 256 * W * 4},
        {"name": "expr_words", "shape": f"leaves [1000, 1, {W}]",
         "fn": ck.expr_words, "plain": ck.expr_words_torch,
         "symbol": ("expr_words", "pilosa_expr_fold_words"),
         "args": c2_args, "bytes": 1001 * W * 4},
        {"name": "expr_words grid-stride kernel (no leaf split)",
         "shape": f"leaves [1000, 1, {W}]",
         "fn": _grid_stride_words, "plain": ck.expr_words_torch,
         "symbol": ("expr_words", "pilosa_expr_words"),
         "args": c2_args, "bytes": 1001 * W * 4},
        {"name": "expr_count_batch", "shape": f"K = 22, leaves [23, 256, {W}]",
         "fn": ck.expr_count_batch, "plain": ck.expr_count_batch_torch,
         "symbol": ("expr_count", "pilosa_expr_count_batch"),
         "args": [(tuple(("and", ("leaf", 1 + i), ("leaf", 0))
                         for i in range(22)),
                   dev_words(gen, (23, 256, W), device)) for _ in range(2)],
         "bytes": 23 * 256 * W * 4 + 22 * 256 * 4},
    ]


def _grid_stride_words(expr, leaves):
    """cuda_kernels.expr_words through the grid-stride kernel
    (pilosa_expr_words) for any program, a flat fold too: the design
    the leaf-split fold is measured against."""
    import torch
    from . import build
    from . import cuda_kernels as ck
    leaves, device, n_slices, n_words = ck._cuda_leaves("expr_words", leaves)
    meta, n_ins = ck._program_meta(expr, leaves, device)
    out = torch.empty((n_slices, n_words), dtype=torch.int32, device=device)
    ck._raise_on("expr_words", build.libraries()["expr_words"]
                 .pilosa_expr_words(meta.data_ptr(),
                                    meta.data_ptr() + 8 * len(leaves), n_ins,
                                    n_slices, n_words, out.data_ptr(),
                                    ck._stream(device)))
    return out


def _or_fold(n):
    e = ("leaf", 0)
    for i in range(1, n):
        e = ("or", e, ("leaf", i))
    return e


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="csrc directory of the earlier design")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: FAIL: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from .. import bench
    from . import build, timing
    device = torch.device("cuda:0")
    libs = {"baseline": build.load(args.baseline), "tree": build.load()}
    rows = []
    for case in _cases(device, args.seed):
        lib, symbol = case.get("symbol", (None, None))
        if lib is not None and any(
                getattr(libs[side].get(lib), symbol, None) is None
                for side in libs):
            continue  # an entry point one of the designs lacks
        fn, copies = case["fn"], case["args"]
        for side, lib in libs.items():
            build._libs = lib
            for a in copies:
                if not torch.equal(fn(*a), case["plain"](*a)):
                    print(f"kernel_ab: FAIL: {case['name']} ({side}) "
                          "differs from its plain version", file=sys.stderr)
                    sys.exit(1)
        times: dict[str, list[float]] = {"baseline": [], "tree": []}
        for _ in range(args.rounds):
            for side in ("baseline", "tree", "tree", "baseline"):
                build._libs = libs[side]
                times[side].append(timing.graph_ms(fn, copies))
        rows.append({
            "name": case["name"], "shape": case["shape"],
            "baseline_ms": times["baseline"], "tree_ms": times["tree"],
            "baseline_median_ms": statistics.median(times["baseline"]),
            "tree_median_ms": statistics.median(times["tree"]),
            "bound_ms": case["bytes"] / HBM_BYTES_PER_S * 1e3})
    build._libs = libs["tree"]
    outs = [torch.empty((256, W), dtype=torch.int32, device=device)
            for _ in range(COPIES)]
    idx = [(i,) for i in range(COPIES)]
    refs = {
        "zero_32MiB_ms": timing.graph_ms(lambda i: outs[i].zero_(), idx),
        "copy_32MiB_ms": timing.graph_ms(
            lambda i: outs[i].copy_(outs[(i + 1) % COPIES]), idx)}
    print(json.dumps({"ab": rows, "references": refs,
                      "order": "baseline, tree, tree, baseline per round",
                      "rounds": args.rounds, "card": bench.card_info()}),
          flush=True)


if __name__ == "__main__":
    main()

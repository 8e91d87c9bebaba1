"""Benchmark of record on the card: Intersect+Count row-ops/s on 1 Gbit
rows.

    python -m pilosa_tpu_torch.bench [--seed 42] [--device cpu]

The port's counterpart of the root ``bench.py`` (metric in BASELINE.md):
``K`` pairs of ``bits``-bit packed rows, each pair counted with
``ops.kernels.op_count("and", a, b)`` — on the card, the hand kernel
``ops/csrc/op_count.cu``. The denominator is the same rows through the
port's host C++ kernel (``storage.native.popcnt_and`` over u64 views),
timed in this run: ``vs_baseline`` is the same-run ratio (nothing is
pinned across runs).

Method, as the root bench: the operands are made from
``np.random.default_rng(seed)`` exactly as ``bench._rows`` makes them,
uploaded once, and every row's device count is checked against the host
count. Then ``iters`` dispatches are chained with one
``torch.cuda.synchronize()`` per trial; the reported time is the median
over trials, per row-op. There is no fail-soft: a device or kernel
failure, or a count that differs from the host's, exits non-zero and
prints no line.

Knobs (environment, as the root bench reads them; they size the run and
choose no path): ``PILOSA_BENCH_BITS`` (row width, default 2^30, below
2^31 and a multiple of 64), ``PILOSA_BENCH_ROWS`` (K, default 16: 4 GiB
of operands), ``PILOSA_BENCH_ITERS`` (default 256),
``PILOSA_BENCH_TRIALS`` (default 3).

Prints one JSON line: metric, bits, rows, value (ops/sec), unit,
vs_baseline, host_ops_this_run, platform, the card's name and power
limit, bound_ops (the card's memory-bound ceiling) and the counts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet


def params() -> tuple[int, int, int, int]:
    """(bits, rows, iters, trials) from the environment."""
    bits = int(os.environ.get("PILOSA_BENCH_BITS", str(1 << 30)))
    if bits >= 1 << 31:
        raise SystemExit("PILOSA_BENCH_BITS must be < 2^31 "
                         "(per-row device counts are int32)")
    if bits % 64:
        raise SystemExit("PILOSA_BENCH_BITS must be a multiple of 64")
    return (bits,
            int(os.environ.get("PILOSA_BENCH_ROWS", "16")),
            int(os.environ.get("PILOSA_BENCH_ITERS", "256")),
            int(os.environ.get("PILOSA_BENCH_TRIALS", "3")))


def metric_name(bits: int) -> str:
    return f"intersect_count_{bits // (1 << 20)}Mbit_rows"


def bound_ops(bits: int) -> float:
    """Row-ops/s at the card's memory rate: each row-op reads two rows."""
    return HBM_BYTES_PER_S / (2 * bits / 8)


def rows(bits: int, k_rows: int, seed: int = 42
         ) -> tuple[np.ndarray, np.ndarray]:
    """The operands, made as the root bench's ``_rows`` makes them."""
    rng = np.random.default_rng(seed)
    n_words = bits // 32
    a = rng.integers(0, 2**32, size=(k_rows, n_words), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(k_rows, n_words), dtype=np.uint32)
    return a, b


def card_info() -> str:
    """``name, power limit`` of the card, as nvidia-smi reports it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def host_leg(a: np.ndarray, b: np.ndarray) -> tuple[float, list[int]]:
    """(median seconds per row, per-row counts) of the host C++ kernel
    over two passes."""
    from .storage import native
    a64, b64 = a.view(np.uint64), b.view(np.uint64)
    native.popcnt_and(a64[0], b64[0])  # warmup: page in + lib load
    times: list[float] = []
    for _ in range(2):
        counts = []
        for i in range(len(a)):
            t0 = time.perf_counter()
            counts.append(native.popcnt_and(a64[i], b64[i]))
            times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], counts


def device_leg(a: np.ndarray, b: np.ndarray, device: torch.device,
               iters: int, trials: int) -> tuple[float, list[int]]:
    """(median seconds per row-op, per-row device counts)."""
    from .ops.kernels import op_count

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    da = torch.from_numpy(a.view(np.int32)).to(device)
    db = torch.from_numpy(b.view(np.int32)).to(device)
    counts = op_count("and", da, db).tolist()  # warmup + verify
    per_op = []
    for _ in range(trials):
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            op_count("and", da, db)
        sync()
        per_op.append((time.perf_counter() - t0) / (len(a) * iters))
    return sorted(per_op)[len(per_op) // 2], counts


def run(device=None, seed: int = 42) -> dict:
    """Measure both legs and return the benchmark's line. Raises when a
    device count differs from the host count."""
    from .device import resolve_device
    device = resolve_device(device)
    bits, k_rows, iters, trials = params()
    a, b = rows(bits, k_rows, seed)
    host_s, want = host_leg(a, b)
    device_s, got = device_leg(a, b, device, iters, trials)
    if got != want:
        raise RuntimeError(f"device counts {got} differ from host "
                           f"popcnt_and {want}")
    on_card = device.type == "cuda"
    return {
        "metric": metric_name(bits),
        "bits": bits,
        "rows": k_rows,
        "iters": iters,
        "trials": trials,
        "value": 1.0 / device_s,
        "unit": "ops/sec",
        "vs_baseline": host_s / device_s,
        "vs_baseline_is": "same-run ratio to host popcnt_and (not pinned)",
        "host_ops_this_run": 1.0 / host_s,
        "platform": "gpu" if on_card else device.type,
        "card": card_info() if on_card else None,
        "bound_ops": bound_ops(bits) if on_card else None,
        "counts": got,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    args = ap.parse_args(argv)
    try:
        line = run(args.device, args.seed)
    except RuntimeError as e:
        print(f"bench: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

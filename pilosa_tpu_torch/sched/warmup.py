"""Cold-start warmup: build and load the kernels at server open.

The torch form of the JAX package's ``sched/warmup.py``. There the first
device query paid the trace + compile of each XLA program, and the
warmup compiled the program catalogue on a daemon thread. Here the
first device query would pay the ``nvcc`` build (a fresh checkout) and
the load of the kernel extensions (ops/build.py), and each kernel
entry's first launch. So at server open, on a daemon thread:

1. the planner gets its cost constants (parallel.costmodel: the
   calibration persisted under the executor's ``cal_dir``, else the
   committed defaults), as the JAX warmup primes it;
2. the kernel extensions are built (where needed) and loaded;
3. each of the six kernel entries launches once on zero slabs of the
   holder's slice count: the expression count, its batched entry, the
   TopN block count, densify, the expression-words kernel and the op
   count.

State is exposed at ``/status`` in the JAX ``warmup`` block
(``pending → running → done``; ``disabled`` on the CPU, where no kernel
runs; ``failed`` carries the error), with ``coverage`` counted in
kernels. The launches count in ``ops.cuda_kernels.LAUNCHES`` like any
other.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# The kernel entries the warmup launches, by their LAUNCHES names.
KERNELS = ("expr_count_rows", "expr_count_batch", "topn_block_count",
           "densify", "expr_words", "op_count_rows")


class Warmup:
    """Build, load and launch every kernel entry on a background
    thread."""

    def __init__(self, executor, logger=None):
        from ..utils import logger as logger_mod
        self.executor = executor
        self.logger = logger or logger_mod.NOP
        self.state = "pending"
        self.error = ""
        self.compiled: list[str] = []
        self.bucket: Optional[int] = None
        self.elapsed_s: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.executor.device.type != "cuda":
            self.state = "disabled"  # no kernel runs on the CPU
            return
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-warmup",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def to_json(self) -> dict:
        return {"state": self.state, "compiled": list(self.compiled),
                "error": self.error or None,
                "bucket": self.bucket,
                "coverage": {
                    "warmed": len(self.compiled),
                    "programs": len(KERNELS),
                    "missing": [k for k in KERNELS
                                if k not in self.compiled]},
                "elapsedS": (round(self.elapsed_s, 3)
                             if self.elapsed_s is not None else None)}

    def _holder_max_slices(self) -> int:
        """Slice count the open holder serves (max over indexes of
        max_slice+1) — what the first real queries will run over."""
        n = 0
        holder = getattr(self.executor, "holder", None)
        if holder is None:
            return n
        try:
            for idx in dict(holder.indexes).values():
                n = max(n, idx.max_slice() + 1)
        except Exception:  # noqa: BLE001 - holder may be mid-open
            pass
        return n

    def _prime_planner(self) -> None:
        """Hand the planner its cost constants before the first query:
        the persisted calibration of the executor's ``cal_dir`` when
        there is one, the committed defaults otherwise."""
        from ..parallel import costmodel
        ex = self.executor
        planner = getattr(ex, "planner", None)
        if planner is None or planner.calibration is not None:
            return
        planner.calibration = costmodel.default_calibration(
            ex.cal_dir, costmodel.cal_key(ex.device))

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        t0 = time.monotonic()
        self.state = "running"
        try:
            device = self.executor.device
            self._prime_planner()
            import torch

            from ..ops import build
            from ..ops import cuda_kernels as ck
            from ..ops.packed import WORDS_PER_SLICE
            build.libraries()
            S = self.bucket = max(1, self._holder_max_slices())
            W = WORDS_PER_SLICE

            def slab(*shape):
                return torch.zeros(shape, dtype=torch.int32, device=device)

            a, b = slab(S, W), slab(S, W)
            leaf, both = ("leaf", 0), ("and", ("leaf", 0), ("leaf", 1))
            subs = W // ck.DENSIFY_LANES
            steps = {
                "expr_count_rows": lambda: ck.expr_count_rows(both, [a, b]),
                "expr_count_batch": lambda: ck.expr_count_batch(
                    (leaf, both), [a, b]),
                "topn_block_count": lambda: ck.topn_block_count(
                    leaf, slab(S, 4, W), [a]),
                "densify": lambda: ck.densify(slab(S, subs, 8),
                                              slab(S, subs, 8), W),
                "expr_words": lambda: ck.expr_words(
                    ("or", ("leaf", 0), ("leaf", 1)), [a, b]),
                "op_count_rows": lambda: ck.op_count_rows("and", a, b),
            }
            for name in KERNELS:
                if self._stop.is_set():
                    break
                steps[name]()
                self.compiled.append(name)
            torch.cuda.synchronize(device)
            self.state = "done"
            self.elapsed_s = time.monotonic() - t0
            self.logger.printf("warmup: launched %s at %d slices in %.2fs",
                               ",".join(self.compiled), S, self.elapsed_s)
        except Exception as e:  # noqa: BLE001 - warmup must never kill serving
            self.state = "failed"
            self.error = f"{type(e).__name__}: {e}"
            self.elapsed_s = time.monotonic() - t0
            self.logger.printf("warmup failed: %s", self.error)

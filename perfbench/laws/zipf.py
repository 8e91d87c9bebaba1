"""``{"kind": "zipf", "s": s, "total": t}``: size stratum r (from 1)
holds ``max(1, floor(t / (H * r**s)))`` bits, H normalising the
weights (see ``density.py`` for what a law module gives)."""

import numpy as np


def by_rank(spec, n_rows, n_cols):
    w = 1.0 / np.arange(1, n_rows + 1, dtype=np.float64) ** float(
        spec.get("s", 1.0))
    return np.maximum(1, np.floor(float(spec["total"]) * w / w.sum())
                      ).astype(np.int64)

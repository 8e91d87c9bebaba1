"""``{"kind": "density", "lo": a, "hi": b}``: row densities spread
log-uniformly over [a, b] of the index's columns, one per size stratum,
so every seed holds the same sizes.

A law module gives ``by_rank(spec, n_rows, n_cols)``, the bits of each
size stratum as an int64 array; ``datagen`` places the strata on row
ids by the seed and draws each row's columns uniformly. It may also give
``make(spec, sizes, n_cols, rng)``, the frame's data in place of those
(row, column) pairs, and ``load(frame, data)``, how the run imports
that data into the program's frame (default: one ``import_bits``).
"""

import numpy as np


def by_rank(spec, n_rows, n_cols):
    lo, hi = np.log(float(spec["lo"])), np.log(float(spec["hi"]))
    dens = np.exp(lo + (hi - lo) * (np.arange(n_rows) + 0.5) / n_rows)
    return np.rint(dens * n_cols).astype(np.int64)

"""A configuration's data, made from the run's seed with NumPy.

A configuration (``perfbench/configs/<config>.json``) names its index,
its slice count (2^20 columns each) and its frames. Each frame gives
``rows`` and ``bits``, the law of its row sizes, whose ``kind`` names a
module ``perfbench/laws/<kind>.py`` (``density``, ``zipf``; a new law is
a new file there). Every seed holds the same sizes; which row holds
which size stratum is ``traffic.row_order`` of the seed.

Columns are uniform over the index. Rows may repeat a column: the
program's import and the reference both deduplicate. ``make`` returns
``{frame: (row_ids uint64, column_ids uint64)}``, or what the law's own
``make`` returns.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np

from perfbench.traffic import rng_for, row_order

HERE = os.path.dirname(os.path.abspath(__file__))
SLICE_WIDTH = 1 << 20
_LAWS: dict = {}


def load(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def law(kind: str):
    """The module ``perfbench/laws/<kind>.py``, loaded once."""
    mod = _LAWS.get(kind)
    if mod is None:
        path = os.path.join(HERE, "laws", kind + ".py")
        if not os.path.isfile(path):
            raise ValueError(f"unknown row-size law {kind!r}: no {path}")
        sp = importlib.util.spec_from_file_location("perfbench_law_" + kind,
                                                    path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        _LAWS[kind] = mod
    return mod


def columns(cfg: dict) -> int:
    return int(cfg["slices"]) * SLICE_WIDTH


def row_sizes(spec: dict, n_rows: int, n_cols: int,
              order: np.ndarray) -> np.ndarray:
    """Bits of each row id, ``[n_rows]`` int64; ``order[j]`` is the row
    of size stratum j."""
    by_rank = law(spec["kind"]).by_rank(spec, n_rows, n_cols)
    sizes = np.empty(n_rows, dtype=np.int64)
    sizes[order] = by_rank
    return sizes


def make(cfg: dict, seed: int) -> dict:
    n_cols = columns(cfg)
    out = {}
    for name, fr in sorted(cfg["frames"].items()):
        rng = rng_for(seed, "data", name)
        n_rows = int(fr["rows"])
        sizes = row_sizes(fr["bits"], n_rows, n_cols,
                          row_order(seed, name, n_rows))
        own = getattr(law(fr["bits"]["kind"]), "make", None)
        if own is not None:
            out[name] = own(fr["bits"], sizes, n_cols, rng)
            continue
        rows = np.repeat(np.arange(n_rows, dtype=np.uint64), sizes)
        cols = rng.integers(0, n_cols, size=len(rows), dtype=np.uint64)
        out[name] = (rows, cols)
    return out


def load_frame(frame, spec: dict, data) -> None:
    """Import one frame's data into the program's frame: the law's own
    ``load``, else one bulk ``import_bits`` call."""
    own = getattr(law(spec["bits"]["kind"]), "load", None)
    if own is not None:
        own(frame, data)
    else:
        frame.import_bits(*data)


def frame_rows(cfg: dict) -> dict:
    return {name: int(fr["rows"]) for name, fr in cfg["frames"].items()}

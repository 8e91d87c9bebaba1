"""Calibrated device/host routing for the executor's device legs.

The torch form of the JAX package's ``parallel/costmodel.py``. The port
has two paths for a Count, a Sum, a fused batch, a TopN refetch and a
materializing fold — the roaring host path and the device path on the
card — and the right one depends on measured costs:

- ``sync_s``   — one launch of the expression-count wrapper on a
                 one-slice-row slab plus its fetch: the device leg's
                 fixed cost, the wrapper's host work included;
- ``upload_bps`` — the host-to-card copy the residency layer does
                 (``torch.from_numpy(...).to(device)`` from pageable
                 numpy memory);
- ``host_bps`` — the port's roaring intersection count on this host,
                 the slower of a dense and a sparse container mix;
- ``pack_bps`` — the port's roaring-to-dense row pack
                 (ops.packed.pack_storage_row);
- ``device_bps`` — the expression count's bytes over its device time on
                 a resident block bigger than the L2.

Routing rule: the device serves unless the predicted host cost is a
CLEAR win (< margin × device cost, margin 0.5 by default): the margin
keeps marginal shapes on the device, where residency makes repeats
cheaper. The calibration runs once per process and card at first
device use (``get_model``) through the port's own wrappers, and
persists as JSON under a key of host and card name in the directory
the caller gives (``cal_dir``; none = not persisted). A calibration
that fails raises: nothing switches the model off silently. On the CPU
the executor has no model unless the caller passes one (tests do).

The committed defaults below are the medians of the calibration on the
card; ``default_calibration`` returns them (or the persisted
calibration of ``cal_dir``) before the first measurement, for the
planner's placement pricing.
"""

from __future__ import annotations

import json
import os
import platform as platform_mod
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

# Committed defaults: medians of the five calibrations of chip_smoke.py's
# control phase (phase_control) in its run from a git archive of this
# tree on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (torch
# 2.11.0+cu128; PERF.md §6).
DEFAULT_SYNC_S = 9.1373e-05    # expression-count launch + fetch
DEFAULT_HOST_BPS = 1.2865e9    # roaring intersection count (slower mix)
DEFAULT_UPLOAD_BPS = 1.4143e10  # pageable host → card copy
DEFAULT_PACK_BPS = 1.4683e8    # roaring → dense row pack
DEFAULT_DEVICE_BPS = 2.9682e12  # expression count on a resident block

# Rows of the resident block device_bps is measured on: 2 leaves × 2,048
# slice rows × 128 KiB = 512 MiB, past the card's 50 MB L2 and long
# enough (~0.2 ms a launch) that the wrapper's host work between
# launches cannot starve the card (at 64 MiB a slow host did, and the
# rate read 35 % low).
_DEVICE_PROBE_SLICES = 2048


@dataclass
class Calibration:
    sync_s: float       # one launch + fetch round trip, seconds
    host_bps: float     # roaring count throughput, bytes/second
    upload_bps: float = DEFAULT_UPLOAD_BPS  # host→device transfer rate
    pack_bps: float = DEFAULT_PACK_BPS  # roaring→dense pack rate
    device_bps: float = DEFAULT_DEVICE_BPS  # expression count on device
    # Drift-correction multipliers, adjusted by the feedback loop when
    # predicted and observed leg costs diverge (CostModel.record).
    host_scale: float = 1.0
    device_scale: float = 1.0
    # Extra multiplier for STREAMING device legs (block re-packed every
    # query), so the drift loop can correct streaming-only error
    # without fighting the resident legs' device_scale.
    stream_scale: float = 1.0

    def device_cost(self, total_bytes: int, cold_bytes: int = 0,
                    streaming: bool = False,
                    crossings: int = 1) -> float:
        # cold_bytes = data not device-resident: it must be PACKED
        # host-side (roaring → dense words at pack_bps) and copied at
        # the measured transfer rate. crossings = launch + fetch round
        # trips the plan pays (a fused multi-call tree pays one).
        cost = (self.sync_s * crossings + cold_bytes / self.upload_bps
                + cold_bytes / self.pack_bps
                + total_bytes / self.device_bps) * self.device_scale
        if streaming:
            cost *= self.stream_scale
        return cost

    def host_cost(self, total_bytes: int) -> float:
        return total_bytes / self.host_bps * self.host_scale

    def to_dict(self) -> dict:
        return {"sync_s": self.sync_s, "host_bps": self.host_bps,
                "upload_bps": self.upload_bps,
                "pack_bps": self.pack_bps,
                "device_bps": self.device_bps,
                "host_scale": self.host_scale,
                "device_scale": self.device_scale,
                "stream_scale": self.stream_scale}

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls(sync_s=float(d["sync_s"]),
                   host_bps=float(d["host_bps"]),
                   upload_bps=float(d.get("upload_bps",
                                          DEFAULT_UPLOAD_BPS)),
                   pack_bps=float(d.get("pack_bps", DEFAULT_PACK_BPS)),
                   device_bps=float(d.get("device_bps",
                                          DEFAULT_DEVICE_BPS)),
                   host_scale=float(d.get("host_scale", 1.0)),
                   device_scale=float(d.get("device_scale", 1.0)),
                   stream_scale=float(d.get("stream_scale", 1.0)))


# Feedback-loop tuning: recalibrate a leg once it has DRIFT_MIN_SAMPLES
# observations whose median actual/predicted ratio leaves
# [1/DRIFT_BOUND, DRIFT_BOUND]; scales clamp to
# [1/_SCALE_CLAMP, _SCALE_CLAMP].
DRIFT_MIN_SAMPLES = 12
DRIFT_BOUND = 2.0
_SCALE_CLAMP = 256.0


class CostModel:
    """Routing predictions + the closed feedback loop over them: every
    routed query can record (predicted, actual) for the leg it ran;
    when the median drift of a leg exceeds DRIFT_BOUND x, that leg's
    scale multiplier is folded by the observed median and the
    calibration is re-persisted (when it has a directory)."""

    def __init__(self, cal: Calibration, margin: float = 0.5,
                 persist_path: str | None = None):
        self.cal = cal
        self.margin = margin
        self.persist_path = persist_path
        self.recalibrations = 0
        self._mu = threading.Lock()
        self._drift = {"host": deque(maxlen=64),
                       "device": deque(maxlen=64),
                       "device_stream": deque(maxlen=64)}

    _SCALE_ATTR = {"host": "host_scale", "device": "device_scale",
                   "device_stream": "stream_scale"}

    def device_pays(self, total_bytes: int, cold_bytes: int = 0,
                    streaming: bool = False,
                    host_bytes: int | None = None,
                    crossings: int = 1) -> bool:
        """False only when the host path is a clear predicted win.

        ``host_bytes`` prices the host alternative on ITS real byte
        walk when it differs from the device operand block (a fused
        multi-call tree deduplicates shared leaf slabs on the device,
        while the per-call host path re-walks each call's leaves).
        ``crossings`` is the number of launch + fetch round trips the
        plan pays."""
        host = self.cal.host_cost(
            host_bytes if host_bytes is not None else total_bytes)
        device = self.cal.device_cost(total_bytes, cold_bytes,
                                      streaming, crossings=crossings)
        return host >= self.margin * device

    def predict(self, leg: str, total_bytes: int,
                cold_bytes: int = 0) -> float:
        if leg == "device":
            return self.cal.device_cost(total_bytes, cold_bytes)
        if leg == "device_stream":
            return self.cal.device_cost(total_bytes, cold_bytes,
                                        streaming=True)
        return self.cal.host_cost(total_bytes)

    def record(self, leg: str, predicted_s: float,
               actual_s: float) -> None:
        """Feed one routed query's (predicted, actual) leg cost back
        into the model; recalibrates when the median drift of that leg
        exceeds DRIFT_BOUND in either direction."""
        if predicted_s <= 0 or actual_s <= 0:
            return
        with self._mu:
            d = self._drift.get(leg)
            if d is None:
                return
            d.append(actual_s / predicted_s)
            if len(d) < DRIFT_MIN_SAMPLES:
                return
            med = sorted(d)[len(d) // 2]
            if 1.0 / DRIFT_BOUND <= med <= DRIFT_BOUND:
                return
            attr = self._SCALE_ATTR[leg]
            scale = getattr(self.cal, attr) * med
            scale = min(max(scale, 1.0 / _SCALE_CLAMP), _SCALE_CLAMP)
            setattr(self.cal, attr, scale)
            d.clear()
            self.recalibrations += 1
        if self.persist_path:
            _persist(self.persist_path, self.cal)

    def drift_snapshot(self) -> dict:
        with self._mu:
            out = {}
            for leg, d in self._drift.items():
                vals = sorted(d)
                out[leg] = {
                    "n": len(vals),
                    "median": round(vals[len(vals) // 2], 3) if vals
                    else None}
            out["recalibrations"] = self.recalibrations
            out["hostScale"] = round(self.cal.host_scale, 4)
            out["deviceScale"] = round(self.cal.device_scale, 4)
            out["streamScale"] = round(self.cal.stream_scale, 4)
            return out


def pinned(margin: float) -> CostModel:
    """A model over the committed defaults with a fixed ``margin``:
    0.0 vetoes nothing (the device leg always pays — what the card
    tests and chip_smoke.py's kernel phases pass to pin the device
    leg), ``float('inf')`` vetoes every device leg."""
    return CostModel(Calibration(sync_s=DEFAULT_SYNC_S,
                                 host_bps=DEFAULT_HOST_BPS),
                     margin=margin)


# -- measurement on the card --------------------------------------------------

def _best(fn, runs: int) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_sync_s(device, runs: int = 20) -> float:
    """One launch of the expression-count wrapper on a one-slice-row
    slab plus its fetch (mesh.count_expr_sharded), timed after
    ``torch.cuda.synchronize()``, best of ``runs``."""
    import torch

    from ..ops.packed import WORDS_PER_SLICE
    from . import mesh as mesh_mod
    slab = torch.zeros((1, WORDS_PER_SLICE), dtype=torch.int32,
                       device=device)
    mesh_mod.count_expr_sharded(("leaf", 0), [slab])  # build + load
    torch.cuda.synchronize(device)
    return max(_best(lambda: mesh_mod.count_expr_sharded(
        ("leaf", 0), [slab]), runs), 1e-7)


def measure_upload_bps(device, sync_s: float, runs: int = 5) -> float:
    """The residency layer's host → card copy (torch.from_numpy of a
    packed block, then ``.to(device)``: pageable numpy memory, as
    parallel.residency uploads a dense block), 32 MiB, less one
    round-trip floor (device_cost prices it as sync_s)."""
    import torch

    buf = np.zeros(8 << 20, dtype=np.uint32)  # 32 MiB
    host = torch.from_numpy(buf.view(np.int32))

    def copy():
        host.to(device)
        torch.cuda.synchronize(device)

    copy()  # warm the path
    best = _best(copy, runs)
    transfer_s = max(best - sync_s, best / 10, 1e-9)
    return buf.nbytes / transfer_s


def measure_pack_bps(runs: int = 3) -> float:
    """Host-side roaring → dense row packing rate (ops.packed)."""
    from ..ops import packed
    from ..storage import roaring

    rng = np.random.default_rng(3)
    storage = roaring.Bitmap.from_sorted(np.sort(rng.choice(
        1 << 23, size=1 << 18, replace=False)).astype(np.uint64))
    out = np.zeros(packed.WORDS_PER_SLICE, dtype=np.uint32)
    packed.pack_storage_row(storage, 0, out)  # warm

    def pack():
        for row in range(8):
            out[:] = 0
            packed.pack_storage_row(storage, row % 8, out)

    return 8 * out.nbytes / max(_best(pack, runs), 1e-9)


def measure_host_bps(runs: int = 3) -> float:
    """The host path's per-byte rate: the port's roaring
    intersection_count, both operands' packed (dense) bytes counted,
    over two container mixes — dense bitmap containers, and array
    containers at configuration 4's density of 1/64 (~1,024 values a
    container) — and the slower of the two. The dense pair alone makes
    the host look ~20x faster per byte than it is on sparse rows, and
    the model then never lets such rows reach the device."""
    from ..storage import roaring

    n_bits = 1 << 23  # 8 Mbit → 128 containers → 1 MB dense operands
    rng = np.random.default_rng(5)

    def rate(a, b) -> float:
        a.intersection_count(b)  # warm
        return (2 * n_bits / 8) / max(
            _best(lambda: a.intersection_count(b), runs), 1e-9)

    def sparse():
        return roaring.Bitmap.from_sorted(np.unique(rng.integers(
            0, n_bits, size=n_bits // 64, dtype=np.uint64)))

    dense = rate(roaring.Bitmap.from_sorted(
        np.arange(0, n_bits, 2, dtype=np.uint64)),
        roaring.Bitmap.from_sorted(
            np.arange(0, n_bits, 3, dtype=np.uint64)))
    return min(dense, rate(sparse(), sparse()))


def measure_device_bps(device, iters: int = 5, runs: int = 3) -> float:
    """The expression count's bytes over its device time: an Intersect
    of two resident ``[2048, 32768]`` slabs, ``iters`` launches between
    CUDA events, the best of ``runs``."""
    import torch

    from ..ops import cuda_kernels
    from ..ops.packed import WORDS_PER_SLICE
    leaves = [torch.randint(-2**31, 2**31 - 1,
                            (_DEVICE_PROBE_SLICES, WORDS_PER_SLICE),
                            dtype=torch.int32, device=device)
              for _ in range(2)]
    expr = ("and", ("leaf", 0), ("leaf", 1))
    cuda_kernels.expr_count_rows(expr, leaves)  # warm
    seconds = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            cuda_kernels.expr_count_rows(expr, leaves)
        end.record()
        end.synchronize()
        seconds = min(seconds, start.elapsed_time(end) / 1e3 / iters)
    nbytes = sum(t.numel() * 4 for t in leaves)
    return nbytes / max(seconds, 1e-9)


def calibrate(device) -> Calibration:
    """Measure all five quantities on ``device`` (a CUDA device)
    through the port's own code. Raises on any failure."""
    sync_s = measure_sync_s(device)
    cal = Calibration(sync_s=sync_s,
                      host_bps=measure_host_bps(),
                      upload_bps=measure_upload_bps(device, sync_s),
                      pack_bps=measure_pack_bps(),
                      device_bps=measure_device_bps(device))
    for k, v in cal.to_dict().items():
        if not (v > 0 and np.isfinite(v)):
            raise RuntimeError(f"calibration: {k} = {v}")
    return cal


# -- persistence --------------------------------------------------------------

def cal_key(device) -> str:
    """Host and card name: a calibration holds for that pair."""
    import torch
    name = torch.cuda.get_device_name(device)
    safe = "".join(ch if ch.isalnum() or ch in "-_." else "_"
                   for ch in f"{platform_mod.node()}-{name}")
    return safe


def cal_path(cal_dir: str, key: str) -> str:
    return os.path.join(cal_dir, f"costcal-{key}.json")


def _persist(path: str, cal: Calibration) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(cal.to_dict(), f)
    os.replace(path + ".tmp", path)


def load_calibration(path: str) -> Calibration | None:
    try:
        with open(path) as f:
            return Calibration.from_dict(json.load(f))
    except (OSError, ValueError, KeyError):
        return None


def default_calibration(cal_dir: str | None = None,
                        key: str | None = None) -> Calibration:
    """Best constants WITHOUT touching the card: the persisted
    calibration of ``cal_dir`` under ``key`` when there is one, the
    committed defaults otherwise. Reads nothing outside ``cal_dir``."""
    if cal_dir and key:
        cal = load_calibration(cal_path(cal_dir, key))
        if cal is not None:
            return cal
    return Calibration(sync_s=DEFAULT_SYNC_S, host_bps=DEFAULT_HOST_BPS)


_cache: dict[str, Calibration] = {}
_cache_mu = threading.Lock()


def get_model(device, cal_dir: str | None = None,
              margin: float = 0.5) -> CostModel:
    """Calibrate once per process and card; the margin is per caller.
    A persisted calibration in ``cal_dir`` is reused (with its drift
    corrections); otherwise the card is measured and, with a
    directory, the result persisted. Measurement runs outside the lock;
    a losing racer discards its duplicate."""
    key = cal_key(device)
    path = cal_path(cal_dir, key) if cal_dir else None
    with _cache_mu:
        cal = _cache.get(key)
    if cal is None:
        if path is not None:
            cal = load_calibration(path)
        if cal is None:
            cal = calibrate(device)
            if path is not None:
                _persist(path, cal)
        with _cache_mu:
            cal = _cache.setdefault(key, cal)
    return CostModel(cal, margin, persist_path=path)

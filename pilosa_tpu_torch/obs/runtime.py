"""Runtime collector: periodic gauges of process internals.

Copy of the JAX package's ``obs/runtime.py``. Samples, on a background
thread (and on demand at ``/status``), the sizes that explain serving
behavior but have no natural increment site:

- holder shape: open indexes/frames/fragments, row-cache entries, and
  the live container mix — counts and resident bytes by kind
  (array/bitmap/run) aggregated from each fragment's epoch-cached
  ``container_stats`` — published as ``pilosa_roaring_containers_live``
  / ``pilosa_roaring_container_bytes``;
- device residency: bytes used/budgeted, hit/miss/eviction counts
  (parallel.residency.device_cache);
- roaring container op counts by container kind
  (storage.roaring.op_counts);
- thread activity: live threads, and on-CPU threads (a thread whose
  innermost frame is not an idle wait);
- admission controller depth/in-flight.

Everything lands twice: as gauges/counters in the metrics registry and
as the ``runtime`` JSON block in ``/status``. The JAX package's compile
cache block has no counterpart (the port builds no XLA programs), and
its ``slo``, ``profiler`` and ``history`` hooks stay None until the
port has those modules.
"""

from __future__ import annotations

import platform
import sys
import threading
import time
from typing import Optional

from . import metrics as obs_metrics

DEFAULT_INTERVAL_S = 10.0

# Innermost frames of a thread that is parked, not running (the JAX
# package's utils.profiling idle-leaf filter).
_IDLE_LEAVES = {
    ("threading.py", "wait"),
    ("threading.py", "_wait_for_tstate_lock"),
    ("threading.py", "join"),
    ("selectors.py", "select"),
    ("socketserver.py", "serve_forever"),
    ("connection.py", "poll"),
}


def build_info() -> dict:
    """Build identity: the four keys of the JAX package's
    ``build_info`` (the ``build`` block of ``/status`` and the gossip
    piggyback), as that function reports them in a process that has
    not loaded jax. The port never loads it, so its ``pilosa_build_info``
    gauge is not published."""
    from .. import __version__
    return {"version": __version__, "python": platform.python_version(),
            "jax": "unloaded", "backend": "unloaded"}


def _on_cpu_threads() -> int:
    n = 0
    for frame in sys._current_frames().values():
        code = frame.f_code
        if (code.co_filename.rsplit("/", 1)[-1],
                code.co_name) not in _IDLE_LEAVES:
            n += 1
    return n


class RuntimeCollector:
    def __init__(self, holder=None, executor=None, admission=None,
                 registry=None, interval_s: float = DEFAULT_INTERVAL_S,
                 slo=None, profiler=None, history=None):
        self.holder = holder
        self.executor = executor
        self.admission = admission
        # SLO burn-rate trackers, the continuous profiler and the
        # metric history: the JAX package's hooks, None until the port
        # has those modules.
        self.slo = slo
        self.profiler = profiler
        self.history = history
        self.registry = registry or obs_metrics.default_registry()
        self.interval_s = interval_s
        self._mu = threading.Lock()
        self._last: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="pilosa-runtime-collector",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop and join, so no collect runs past the holder's close."""
        self._stop.set()
        thread = self._thread
        if thread is not None \
                and thread is not threading.current_thread():
            thread.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.collect()
            except Exception:  # noqa: BLE001 - sampling must not kill serving
                pass

    # -- sampling ------------------------------------------------------------

    def collect(self) -> dict:
        """One sampling pass: update registry gauges, return (and
        retain for /status) the snapshot dict."""
        snap: dict = {"sampledAt": time.time()}
        snap["build"] = build_info()
        snap["holder"] = self._holder_sizes()
        snap["threads"] = self._thread_sample()
        snap["deviceBlockCache"] = residency_sample()
        snap["roaringOps"] = roaring_ops_sample()
        if self.admission is not None:
            adm = self.admission.snapshot()
            snap["admission"] = adm
            obs_metrics.ADMISSION_IN_FLIGHT.set(adm.get("inFlight", 0))
            for lane, depth in (adm.get("queued") or {}).items():
                obs_metrics.ADMISSION_QUEUE_DEPTH.labels(lane).set(depth)
        if self.executor is not None:
            snap["deviceFallbacks"] = getattr(self.executor,
                                              "device_fallbacks", 0)
            snap["costModelVetoes"] = getattr(self.executor,
                                              "cost_vetoes", 0)
        if self.slo is not None:
            try:
                snap["slo"] = self.slo.record()
            except Exception:  # noqa: BLE001 - visibility only
                pass
        if self.profiler is not None:
            snap["profiler"] = self.profiler.snapshot()
        if self.history is not None:
            try:
                self.history.sample()
                snap["history"] = self.history.stats()
            except Exception:  # noqa: BLE001 - history must not break /status
                pass
        with self._mu:
            self._last = snap
        return snap

    def snapshot(self) -> dict:
        """Most recent sample (collecting one if none exists yet)."""
        with self._mu:
            last = self._last
        if not last:
            try:
                return self.collect()
            except Exception:  # noqa: BLE001 - visibility, not serving
                return {}
        return last

    # -- individual samplers -------------------------------------------------

    def _holder_sizes(self) -> dict:
        out = {"indexes": 0, "frames": 0, "fragments": 0,
               "cacheEntries": 0}
        kind_counts = {"array": 0, "bitmap": 0, "run": 0}
        kind_bytes = {"array": 0, "bitmap": 0, "run": 0}
        holder = self.holder
        if holder is None:
            return out
        try:
            indexes = dict(holder.indexes)
        except Exception:  # noqa: BLE001 - holder may be mid-close
            return out
        out["indexes"] = len(indexes)
        for idx in indexes.values():
            frames = dict(idx.frames)
            out["frames"] += len(frames)
            for frame in frames.values():
                for view in dict(frame.views).values():
                    frags = dict(view.fragments)
                    out["fragments"] += len(frags)
                    for frag in frags.values():
                        cache = getattr(frag, "cache", None)
                        if cache is not None:
                            try:
                                out["cacheEntries"] += len(cache)
                            except TypeError:
                                pass
                        try:
                            cs = frag.container_stats()
                        except Exception:  # noqa: BLE001 - mid-close
                            continue
                        for kind in kind_counts:
                            kind_counts[kind] += cs["counts"][kind]
                            kind_bytes[kind] += cs["bytes"][kind]
        out["containers"] = {"counts": kind_counts, "bytes": kind_bytes}
        obs_metrics.HOLDER_FRAGMENTS.set(out["fragments"])
        obs_metrics.HOLDER_CACHE_ENTRIES.set(out["cacheEntries"])
        for kind in kind_counts:
            obs_metrics.ROARING_CONTAINERS.labels(kind).set(
                kind_counts[kind])
            obs_metrics.ROARING_CONTAINER_BYTES.labels(kind).set(
                kind_bytes[kind])
        return out

    def _thread_sample(self) -> dict:
        live = threading.active_count()
        on_cpu = _on_cpu_threads()
        obs_metrics.RUNTIME_THREADS.labels("live").set(live)
        obs_metrics.RUNTIME_THREADS.labels("on_cpu").set(on_cpu)
        return {"live": live, "onCpu": on_cpu}



def residency_sample() -> dict:
    """The device residency cache's snapshot, published as the
    ``pilosa_residency_hbm_bytes`` gauges (also at each /metrics
    scrape: the reading is cheap)."""
    from ..parallel import residency
    snap = residency.device_cache().snapshot()
    obs_metrics.RESIDENCY_BYTES.labels("used").set(snap.get("usedBytes", 0))
    obs_metrics.RESIDENCY_BYTES.labels("budget").set(
        snap.get("budgetBytes", 0))
    return snap


def roaring_ops_sample() -> dict:
    """The roaring container-op counters, mirrored into
    ``pilosa_roaring_container_ops_total``; ``{"op:kind": n}``."""
    from ..storage import roaring
    out = {}
    for (op, kind), n in roaring.op_counts().items():
        if n:
            obs_metrics.ROARING_OPS.labels(op, kind).set_total(n)
            out[f"{op}:{kind}"] = n
    return out

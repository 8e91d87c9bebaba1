"""A pod of processes as one counting device: torch.distributed legs.

The torch form of the JAX package's ``parallel/multihost.py``. There a
pod is one ``jax.distributed`` job whose global mesh spans every chip
of every host, and a Count or TopN is one SPMD program whose ``psum``
rides the interconnect. Here each pod process counts its own shard of
the slice axis on its own device through the port's single-device
entry points (``parallel.mesh``: the expression count and its batched
entry, the TopN block count and its threshold/Tanimoto pruning), and
one ``torch.distributed.all_reduce(SUM)`` of the int64 totals — K
counts, or R for a TopN — joins the processes. Every process must
enter each collective together with identically shaped shards: the
pod-internal work-item broadcast in ``parallel.pod`` drives this layer
from the Server/Executor stack (the coordinator posts each
device-batched Count/TopN to every process's ``/pod/exec`` route and
all of them enter the reduce together).

Environment contract (the JAX package's keys, so one launcher starts
either package):

  PILOSA_TPU_DIST_COORDINATOR  host:port of process 0's rendezvous
                               (used as ``tcp://host:port``)
  PILOSA_TPU_DIST_NUM_PROCS    total process count
  PILOSA_TPU_DIST_PROC_ID      this process's id (0-based)
  PILOSA_TPU_DIST_BACKEND      the one key the port adds: ``gloo`` makes
                               a CUDA process reduce over gloo (NCCL
                               takes one rank of a communicator per
                               device, so two pod processes that share
                               one card cannot use it). Without it a
                               CUDA process gets NCCL and a CPU process
                               gloo; nothing falls back on its own.

The JAX package's ``PILOSA_TPU_DIST_CPU_DEVICES`` made N virtual CPU
devices a process; a torch process has one device (the caller's), so
the port reads that key for nothing. One card a process on a
multi-card host: start each process with ``CUDA_VISIBLE_DEVICES`` set
to its card.

Left out on purpose: ``pod_mesh``, the int32 hi/lo split,
``_local_chunk`` and ``_pad_local``'s slice buckets exist for XLA's
compile cache and its int32 reduction. The port's kernels count in
int32 per slice and sum in int64, take any slice count, and the mesh
entry points bound their own blocks (TOPN_BLOCK_BYTES).

The process group's timeout is ``PILOSA_TPU_POD_TIMEOUT`` (300 s by
default), so a collective parked on a dead peer raises after the same
bound at which the pod's dispatcher gives up on it.
"""

from __future__ import annotations

import datetime as dt
import os
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_mod

ENV_COORDINATOR = "PILOSA_TPU_DIST_COORDINATOR"
ENV_NUM_PROCS = "PILOSA_TPU_DIST_NUM_PROCS"
ENV_PROC_ID = "PILOSA_TPU_DIST_PROC_ID"
ENV_BACKEND = "PILOSA_TPU_DIST_BACKEND"
ENV_TIMEOUT = "PILOSA_TPU_POD_TIMEOUT"
_BACKENDS = ("gloo", "nccl")

_mu = threading.Lock()
_initialized = False
# The device the reduce's tensors live on: the CPU for gloo, the
# process's card for NCCL.
_comm_device = torch.device("cpu")
# Seconds spent in this process's collectives (the all_gather of shard
# dims and the all_reduce of totals) and in its counting legs, and how
# many of each: the collective's share of a pod dispatch.
_stats = {"legs": 0, "leg_s": 0.0, "reduces": 0, "reduce_s": 0.0}


def initialize_from_env(device) -> bool:
    """Join the pod's process group when the env contract is set.

    Idempotent; returns True when running as part of a multi-process
    group (a one-process group too, which is how tests exercise the
    path), False without ``PILOSA_TPU_DIST_COORDINATOR``."""
    global _initialized, _comm_device
    with _mu:
        if _initialized:
            return True
        coord = os.environ.get(ENV_COORDINATOR)
        if not coord:
            return False
        device = torch.device(device)
        if device.type == "cpu":
            backend = "gloo"
        else:
            backend = os.environ.get(ENV_BACKEND) or "nccl"
        if backend not in _BACKENDS:
            raise ValueError(f"{ENV_BACKEND}={backend!r}: expected one of"
                             f" {', '.join(_BACKENDS)}")
        if backend == "nccl":
            torch.cuda.set_device(device)
            _comm_device = device
        else:
            _comm_device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}",
            world_size=int(os.environ.get(ENV_NUM_PROCS, "1")),
            rank=int(os.environ.get(ENV_PROC_ID, "0")),
            timeout=dt.timedelta(
                seconds=float(os.environ.get(ENV_TIMEOUT, "300"))))
        _initialized = True
        return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _initialized
    with _mu:
        if _initialized and dist.is_initialized():
            dist.destroy_process_group()
        _initialized = False


def backend() -> Optional[str]:
    """The process group's backend, or None outside one."""
    return dist.get_backend() if dist.is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def stats() -> dict:
    """This process's collective and leg counters (a copy)."""
    return dict(_stats)


def process_slice_range(n_slices: int) -> tuple[int, int]:
    """[lo, hi) of the global slice axis this process must feed: the
    axis split evenly over the processes in rank order."""
    n_procs = process_count()
    if n_slices % n_procs:
        raise ValueError(f"{n_slices} slices not divisible by"
                         f" {n_procs} processes (pad first)")
    per = n_slices // n_procs
    pid = process_index()
    return pid * per, (pid + 1) * per


def _assert_uniform_shards(*dims: int) -> None:
    """Every process must enter the reduce with identically shaped
    shards; one all_gather of the dims (entered by all processes
    together) finds a mismatch first, and every process then raises
    instead of entering the reduce."""
    if process_count() == 1:
        return
    mine = torch.tensor(dims, dtype=torch.int64, device=_comm_device)
    everyone = [torch.empty_like(mine) for _ in range(process_count())]
    t0 = time.perf_counter()
    dist.all_gather(everyone, mine)
    _stats["reduce_s"] += time.perf_counter() - t0
    rows = [t.tolist() for t in everyone]
    if any(r != list(dims) for r in rows):
        raise ValueError(
            "pod shard shapes differ across processes:"
            f" {rows} — every process must pass the same"
            " local slice/row counts (pad with zero slices)")


def _all_reduce(totals: list[int]) -> list[int]:
    """One all_reduce(SUM) of int64 totals over the group."""
    if not dist.is_initialized():
        return list(totals)
    t = torch.tensor(totals, dtype=torch.int64, device=_comm_device)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    _stats["reduce_s"] += time.perf_counter() - t0
    _stats["reduces"] += 1
    return t.tolist()


def _leg(fn):
    t0 = time.perf_counter()
    out = fn()
    _stats["leg_s"] += time.perf_counter() - t0
    _stats["legs"] += 1
    return out


def count_expr(device, expr: tuple, local_leaves: np.ndarray) -> int:
    """Pod-wide Count: each process passes its local ``[L, S_local, W]``
    leaf shard; the K=1 form of count_exprs."""
    return count_exprs(device, (expr,), local_leaves)[0]


def count_exprs(device, exprs: tuple, local_leaves: np.ndarray) -> list[int]:
    """Pod-wide batched Counts: K expressions over one shared local
    leaf shard, counted here (the expression count for K = 1, its
    batched entry for more: mesh.count_exprs_sharded), then one
    all_reduce of the K totals."""
    exprs = tuple(exprs)
    _assert_uniform_shards(*local_leaves.shape, len(exprs))
    n_leaves, n_slices = local_leaves.shape[:2]
    if n_leaves and n_slices:
        arrs = list(mesh_mod._to_device(torch.device(device), local_leaves))
        totals = _leg(lambda: mesh_mod.count_exprs_sharded(exprs, arrs))
    else:
        totals = [0] * len(exprs)
    return _all_reduce(totals)


def topn_exact(device, expr, local_rows: np.ndarray,
               local_leaves: Optional[np.ndarray], threshold: int = 1,
               tanimoto: int = 0) -> list[int]:
    """Pod-wide TopN exact counts: this process's candidate block
    ``[S_local, R, W]`` and leaf shard through mesh.topn_exact (the TopN
    block count; threshold > 1 or Tanimoto engage its per-slice
    pruning, whose masks are per slice, so shard-local evaluation
    composes exactly), then one all_reduce of the R counts."""
    n_local, n_rows, n_words = local_rows.shape
    threshold = min(int(threshold), 2**31 - 1)  # counts never exceed 2^31
    _assert_uniform_shards(n_local, n_rows, n_words, threshold, tanimoto)
    if n_local and n_rows:
        counts = _leg(lambda: mesh_mod.topn_exact(
            torch.device(device), expr, local_rows, local_leaves,
            threshold=threshold, tanimoto=tanimoto))
    else:
        counts = [0] * n_rows
    return _all_reduce(counts)

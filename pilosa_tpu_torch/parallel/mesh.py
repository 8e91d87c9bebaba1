"""One-device slice executor: Count (one expression or a batch of
them), the fused multi-call tree, TopN exact counts, the TopN
threshold/Tanimoto pruning, the sourceless TopN top-k and the
materializing fold and field Range over packed slice blocks — the torch
form of the JAX package's ``parallel/mesh.py`` (main-path subset).

The JAX module shards the slice axis over a TPU mesh and reduces with
psum, splitting per-slice counts into 16-bit halves because int64 is
off there. Here the slice axis lives on one card: per-slice counts come
back int32 from the kernels (exact: a slice row holds at most 2^20
bits) and totals are summed in int64 on the device, so there is no
hi/lo split, no ``slice_chunk_bound`` and no bucket padding, and one
call takes any slice count. The count bodies are the CUDA kernels of
ops.cuda_kernels (their plain versions for CPU tensors).

Expressions are the executor's hashable trees: ``("leaf", i)`` selects
leaf slab i, ``(op, a, b)`` combines subtrees with and/or/xor/andnot.
Functions that upload take the ``torch.device`` explicitly; the
resident forms run where their tensors lie.

Every dispatch entry passes ``_dispatch``: the query's deadline and
cancel check (sched.context.check_current — a check falls before the
launch; a launched kernel runs to its end), one device program and its
operand bytes on the query's cost ledger (obs.accounting), and a
``mesh_dispatch`` trace span tagged with the entry's kind (the JAX
package's kinds). A launch is asynchronous, so the span covers launch
AND fetch (tag ``timing="launch+fetch"``) and with it the device time;
densify's output stays on the card, so its span covers the launch
alone (``timing="launch"``).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..obs import accounting as _accounting
from ..obs import trace as obs_trace
from ..ops import cuda_kernels
from ..sched import context as sched_context
from ..storage import bsi

# Device-block budget for one topn_exact row chunk (the JAX package's
# bound, mesh.py:1195).
TOPN_BLOCK_BYTES = 256 << 20


# Device-to-host result fetches of this module: one added where a
# result leaves the device (each waits for the device), so a caller that
# zeroes it before a query and reads it after sees that query's syncs
# here (chip_smoke.py's batch phase, the batch tests).
FETCHES = {"host": 0}


@contextmanager
def _dispatch(kind: str, operands, timing: str = "launch+fetch", **tags):
    """The gate and the bookkeeping of one device dispatch (see the
    module docstring)."""
    sched_context.check_current()
    cost = _accounting.current_cost()
    if cost is not None:
        cost.note_device_dispatch(
            sum(t.numel() * t.element_size() for t in operands))
    with obs_trace.span_current("mesh_dispatch", kind=kind, timing=timing,
                                **tags):
        yield


def _fetch(t: torch.Tensor) -> list:
    """``t.tolist()``, counted in FETCHES."""
    FETCHES["host"] += 1
    return t.tolist()


def _to_device(device: torch.device, words: np.ndarray) -> torch.Tensor:
    """Host u32 words → device int32 view (one copy)."""
    return torch.from_numpy(
        np.ascontiguousarray(words).view(np.int32)).to(device)


def expr_leaf_ids(expr) -> list[int]:
    """Ordered unique leaf ids referenced by an expr tree (iterative —
    wide folds are ~leaf-count deep)."""
    seen: list[int] = []
    stack = [expr]
    while stack:
        node = stack.pop()
        if node[0] == "leaf":
            if node[1] not in seen:
                seen.append(node[1])
        else:
            stack.append(node[2])
            stack.append(node[1])
    return seen


def remap_expr_leaves(expr, remap: dict[int, int]) -> tuple:
    """Rebuild an expr tree with leaf ids remapped (iterative)."""
    done: dict[int, tuple] = {}
    stack = [expr]
    while stack:
        node = stack[-1]
        if node[0] == "leaf":
            done[id(node)] = ("leaf", remap[node[1]])
            stack.pop()
            continue
        left, right = node[1], node[2]
        if id(left) in done and id(right) in done:
            done[id(node)] = (node[0], done[id(left)], done[id(right)])
            stack.pop()
        else:
            if id(right) not in done:
                stack.append(right)
            if id(left) not in done:
                stack.append(left)
    return done[id(expr)]


def _own_leaves(expr, leaf_arrays: list) -> tuple:
    """(``expr`` over only the leaves it reads, those leaves)."""
    ids = expr_leaf_ids(expr)
    if ids == list(range(len(leaf_arrays))):
        return expr, leaf_arrays
    local = remap_expr_leaves(expr, {g: li for li, g in enumerate(ids)})
    return local, [leaf_arrays[i] for i in ids]


def _expr_slice_counts(expr, leaf_arrays: list) -> torch.Tensor:
    """[S] int32 counts of ``expr``, reading only ITS leaves."""
    return cuda_kernels.expr_count_rows(*_own_leaves(expr, leaf_arrays))


def _count_totals(exprs: tuple, leaf_arrays: list) -> torch.Tensor:
    """``[K]`` int64 totals of K expressions over shared leaf slabs, on
    the device: the expression count for one (reading only its leaves),
    its batched entry for more (one launch)."""
    if len(exprs) == 1:
        per_slice = _expr_slice_counts(exprs[0], leaf_arrays)[None]
    else:
        per_slice = cuda_kernels.expr_count_batch(exprs, leaf_arrays)
    return per_slice.sum(dim=1, dtype=torch.int64)


def count_exprs_sharded(exprs: tuple, leaf_arrays: list) -> list[int]:
    """K expression counts over shared device-resident ``[S, W]`` leaf
    slabs (each expression names leaves of the whole list): one kernel
    launch, the K totals summed in int64 on the device and fetched in
    one copy — the torch form of the JAX count batch (``count_batch``,
    programs.py:133)."""
    kind = "count_expr" if len(exprs) == 1 else "count_exprs"
    with _dispatch(kind, leaf_arrays, slices=_slices(leaf_arrays)):
        return _fetch(_count_totals(tuple(exprs), leaf_arrays))


def _slices(arrays: list) -> int:
    return int(arrays[0].shape[0]) if arrays else 0


def count_expr_sharded(expr: tuple, leaf_arrays: list) -> int:
    """Count over per-leaf device-resident ``[n_slices, n_words]`` slabs
    (e.g. from the residency cache): the K=1 form of
    count_exprs_sharded."""
    return count_exprs_sharded((expr,), leaf_arrays)[0]


def count_expr(device: torch.device, expr: tuple,
               leaves: np.ndarray) -> int:
    """Count the bitmap expression over a host leaf block ``[n_leaves,
    n_slices, n_words]`` u32 (uploaded once; any slice count)."""
    return count_expr_sharded(expr, list(_to_device(device, leaves)))


def fused_tree_sharded(count_exprs: tuple, topn_items: list,
                       leaf_arrays: list, rows_arrays: list
                       ) -> tuple[list[int], list[list[int]]]:
    """A multi-call tree — K expression Counts and M exact-count TopN
    blocks — over shared device-resident leaf slabs: one batched count
    launch (none without Counts) and one TopN block count a block, the
    totals summed in int64 on the device and fetched in ONE copy.
    ``topn_items`` is ``[(expr, n_rows), ...]`` with ``rows_arrays[i]``
    the matching ``[S, R_i, W]`` candidate block. Returns (count values,
    per-TopN count lists): the torch form of the JAX ``fused_tree``
    (mesh.py:801, programs.py:307)."""
    if not count_exprs and not topn_items:
        return [], []
    with _dispatch("fused_tree", list(leaf_arrays) + list(rows_arrays),
                   slices=_slices(leaf_arrays)):
        parts = []
        if count_exprs:
            parts.append(_count_totals(tuple(count_exprs), leaf_arrays))
        for (expr, _), rows in zip(topn_items, rows_arrays):
            parts.append(cuda_kernels.topn_block_count(
                expr, rows, leaf_arrays).sum(dim=0, dtype=torch.int64))
        flat = _fetch(torch.cat(parts))
    counts = flat[:len(count_exprs)]
    out_topn: list[list[int]] = []
    off = len(count_exprs)
    for _, n_rows in topn_items:
        out_topn.append(flat[off:off + n_rows])
        off += n_rows
    return counts, out_topn


def materialize_words(expr, leaf_arrays: list) -> torch.Tensor:
    """``[S, W]`` int32 words of ``expr`` on the device, reading only
    its leaves (the expression-words kernel)."""
    return cuda_kernels.expr_words(*_own_leaves(expr, leaf_arrays))


def fetch_words(words: torch.Tensor) -> np.ndarray:
    """Device int32 words → host ``[S, W]`` u32 (one copy, counted in
    FETCHES)."""
    FETCHES["host"] += 1
    return words.cpu().numpy().view(np.uint32)


def materialize_expr_sharded(expr, leaf_arrays: list) -> np.ndarray:
    """``[S, W]`` u32 dense words of the expression bitmap: one
    expression-words launch over the resident leaf slabs, fetched to the
    host for the roaring repack — the torch form of the JAX
    ``materialize`` (mesh.py:1144, programs.py:265)."""
    with _dispatch("materialize", leaf_arrays, slices=_slices(leaf_arrays)):
        return fetch_words(materialize_words(expr, leaf_arrays))


def bsi_range_sharded(op: str, upred, depth: int,
                      plane_arrays: list) -> np.ndarray:
    """``[S, W]`` u32 dense matched words of a BSI comparison over
    device-resident plane slabs (``plane_arrays[0]`` the existence row,
    ``plane_arrays[1+i]`` offset-value bit i, each ``[S, W]``): the
    port's fold of the JAX circuit (storage.bsi.compare_fold_expr; the
    same words as ``ops.kernels.bsi_compare_select`` for every operator)
    through the expression-words kernel — the torch form of the JAX
    ``bsi_range_sharded`` (mesh.py:1164, programs.py:282). ``op`` "><"
    takes ``upred = (lo, hi)`` in offset space. A provably empty
    comparison is zero words with no launch."""
    expr = bsi.compare_fold_expr(
        op, upred, depth,
        lambda plane: ("leaf", 0 if plane == bsi.EXISTS_PLANE
                       else plane + 1))
    if expr is None:
        n_slices, n_words = plane_arrays[0].shape
        return np.zeros((n_slices, n_words), dtype=np.uint32)
    with _dispatch("bsi_range", plane_arrays, depth=depth):
        return fetch_words(materialize_words(expr, plane_arrays))


def topn_exact_sharded(expr, rows: torch.Tensor,
                       leaf_arrays: list) -> list[int]:
    """TopN exact counts over a device-resident candidate block ``rows
    [n_slices, R, W]`` and per-leaf slabs: ``[R]`` counts of
    ``popcount(row ∩ expr)`` (plain row popcounts when ``expr`` is
    None) summed over every slice."""
    with _dispatch("topn_exact", [rows, *leaf_arrays],
                   slices=int(rows.shape[0]), rows=int(rows.shape[1])):
        return _topn_counts(expr, rows, leaf_arrays)


def _topn_counts(expr, rows: torch.Tensor, leaf_arrays: list) -> list[int]:
    per_slice = cuda_kernels.topn_block_count(expr, rows, leaf_arrays)
    return _fetch(per_slice.sum(dim=0, dtype=torch.int64))


def _filtered_counts(expr, rows: torch.Tensor, leaf_arrays: list,
                     threshold: int, tanimoto: int) -> torch.Tensor:
    """``[S, R]`` int32 intersection counts with the reference's
    per-slice threshold/Tanimoto pruning applied (fragment.go:560-614:
    a slice's contribution drops when that slice's row count or
    intersection count fails the bar), in the exact integer forms of
    the JAX package's float comparisons (mesh.py:907-914):

    - Tanimoto: ``100·rowc > srcc·t``, ``rowc·t < 100·srcc``,
      ``inter > 0`` and ``100·inter > t·(rowc + srcc − inter)``;
    - threshold: ``rowc >= threshold`` and ``inter >= threshold``.

    ``inter`` and ``rowc`` are TopN block counts with the source program
    and with none, ``srcc`` the source's expression count per slice;
    the comparisons run in int64 on the device."""
    inter = cuda_kernels.topn_block_count(expr, rows, leaf_arrays)
    rowc = cuda_kernels.topn_block_count(None, rows, []).long()
    s = _expr_slice_counts(expr, leaf_arrays).long()[:, None]
    wide = inter.long()
    if tanimoto > 0:
        keep = ((100 * rowc > s * tanimoto)
                & (rowc * tanimoto < s * 100)
                & (wide > 0)
                & (100 * wide > tanimoto * (rowc + s - wide)))
    else:
        keep = (rowc >= threshold) & (wide >= threshold)
    return torch.where(keep, inter, torch.zeros_like(inter))


def topn_filtered_sharded(expr, rows: torch.Tensor, leaf_arrays: list,
                          threshold: int = 1,
                          tanimoto: int = 0) -> list[int]:
    """TopN counts with per-slice threshold/Tanimoto pruning on the
    device (``_filtered_counts``) summed over every slice in int64:
    the same residency contract as ``topn_exact_sharded``."""
    threshold = min(threshold, 2**31 - 1)  # counts never exceed 2^31
    with _dispatch("topn_filtered", [rows, *leaf_arrays],
                   slices=int(rows.shape[0]), rows=int(rows.shape[1])):
        per_slice = _filtered_counts(expr, rows, leaf_arrays, threshold,
                                     tanimoto)
        return _fetch(per_slice.sum(dim=0, dtype=torch.int64))


def topn_topk_sharded(expr, rows: torch.Tensor, leaf_arrays: list,
                      k: int) -> tuple[list[int], list[int]]:
    """Sourceless-TopN top-k over a device-resident candidate block:
    the exact counts on the device, then the selection on the host with
    ``np.lexsort((arange, -counts))[:k]`` — count descending, ascending
    row index on ties, the ``pairs_sort`` order (what the JAX package
    does on a Pallas mesh, mesh.py:1012-1017). Returns (counts, row
    indices)."""
    k = max(1, min(int(k), int(rows.shape[1])))
    with _dispatch("topn_topk", [rows, *leaf_arrays],
                   slices=int(rows.shape[0]), rows=int(rows.shape[1])):
        counts = _topn_counts(expr, rows, leaf_arrays)
    order = np.lexsort((np.arange(len(counts)), -np.asarray(counts)))[:k]
    return [counts[i] for i in order.tolist()], order.tolist()


def topn_exact(device: torch.device, expr, rows: np.ndarray,
               leaves: np.ndarray | None, threshold: int = 1,
               tanimoto: int = 0) -> list[int]:
    """[R] exact counts of each candidate row against ``expr`` (or the
    rows' own popcounts when ``expr`` is None), summed over all slices,
    from host blocks ``rows [S, R, W]`` and ``leaves [L, S, W]``;
    threshold > 1 or Tanimoto engage the per-slice pruning.

    The streaming form: the leaves upload once, candidate rows upload
    in chunks of at most TOPN_BLOCK_BYTES — counts are independent per
    row and the pruning masks are per slice, so any row tiling is
    exact."""
    n_slices, n_rows, n_words = rows.shape
    leaf_arrays = (list(_to_device(device, leaves))
                   if leaves is not None and len(leaves) else [])
    filtered = threshold > 1 or tanimoto > 0
    row_chunk = max(1, TOPN_BLOCK_BYTES // max(1, n_slices * n_words * 4))
    totals: list[int] = []
    for r_off in range(0, n_rows, row_chunk):
        sched_context.check_current()
        chunk = _to_device(device, rows[:, r_off:r_off + row_chunk])
        if filtered:
            totals += topn_filtered_sharded(expr, chunk, leaf_arrays,
                                            threshold, tanimoto)
        else:
            totals += topn_exact_sharded(expr, chunk, leaf_arrays)
    return totals


def densify_sharded(device: torch.device, lanes: np.ndarray,
                    vals: np.ndarray) -> torch.Tensor:
    """Upload bucketed sparse rows (ops.packed.bucket_prepared) and
    densify them on the device: ``[S, (R,) subs, G]`` →
    ``[S, (R,) subs*128]`` int32 words."""
    lead, (subs, g_slots) = lanes.shape[:-2], lanes.shape[-2:]
    n_words = subs * cuda_kernels.DENSIFY_LANES
    lanes_d = _to_device(device, lanes.reshape(-1, subs, g_slots))
    vals_d = _to_device(device, vals.reshape(-1, subs, g_slots))
    with _dispatch("densify", [lanes_d, vals_d], timing="launch"):
        out = cuda_kernels.densify(lanes_d, vals_d, n_words)
    return out.reshape(lead + (n_words,))

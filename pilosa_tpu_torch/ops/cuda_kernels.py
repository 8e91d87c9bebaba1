"""The hand-written CUDA kernels of the port, their plain PyTorch
versions and their launch counters.

Each TPU kernel of ``pilosa_tpu/ops/pallas_kernels.py`` has a
counterpart here:

====================  ======================================  =========================
wrapper               replaces (pilosa_tpu/ops/pallas_kernels)  CUDA source (ops/csrc)
====================  ======================================  =========================
expr_count_rows       expr_count_rows_pallas (:129-153)         expr_count.cu
topn_block_count      topn_block_count_pallas (:180-223)        topn_block_count.cu
densify               densify_pallas (:294-339)                 densify.cu
op_count_rows         op_count_rows_pallas (:226-254)           op_count.cu
====================  ======================================  =========================

Words are int32 views of the u32 words (see ops.kernels). A wrapper given
CPU tensors computes its plain version (``*_torch``, same signature);
given CUDA tensors it launches its kernel on the current stream or
raises — there is no fallback. ``LAUNCHES[name]`` counts the kernel
launches a wrapper made, and nothing else.

Expressions are the hashable trees of the executor: ``("leaf", i)`` or
``(op, left, right)`` with op in and/or/xor/andnot. The kernels take
them as a postfix program (``compile_program``) and the leaves as a
device array of slab base pointers, so resident slabs are read where
they lie with no stacking copy.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .kernels import _BITWISE, op_count_rows as op_count_rows_torch
from .kernels import popcount_rows

LAUNCHES = {"expr_count_rows": 0, "topn_block_count": 0, "densify": 0,
            "op_count_rows": 0}

# Opcodes of csrc/expr_program.cuh.
OP_LOAD = 0
_OP_LEAF = {"and": 1, "or": 2, "xor": 3, "andnot": 4}    # acc = acc OP leaf
_OP_RLEAF = {"and": 1, "or": 2, "xor": 3, "andnot": 5}   # acc = leaf OP acc
OP_PUSH = 6
_OP_POP = {"and": 7, "or": 8, "xor": 9, "andnot": 10}    # acc = top OP acc
_OP_RPOP = {"and": 7, "or": 8, "xor": 9, "andnot": 11}   # acc = acc OP top
MAX_STACK = 32  # csrc/expr_program.cuh MAX_STACK

DENSIFY_LANES = 128  # words per bucket group (ops.packed._DENSIFY_LANES)

_OP_CODE = {"and": 0, "or": 1, "xor": 2, "andnot": 3}  # csrc/op_count.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- the expression program --------------------------------------------------

def _stack_need(expr) -> dict[int, int]:
    """Spill slots each subtree needs under Sethi-Ullman ordering,
    keyed by ``id(node)`` (iterative: a 1000-child fold is 1000 deep)."""
    need: dict[int, int] = {}
    work = [(expr, False)]
    while work:
        node, done = work.pop()
        if node[0] == "leaf" or id(node) in need:
            need.setdefault(id(node), 0)
            continue
        left, right = node[1], node[2]
        if not done:
            work += [(node, True), (right, False), (left, False)]
            continue
        nl, nr = need[id(left)], need[id(right)]
        if right[0] == "leaf":
            need[id(node)] = nl
        elif left[0] == "leaf":
            need[id(node)] = nr
        elif nl >= nr:
            need[id(node)] = max(nl, nr + 1)
        else:
            need[id(node)] = max(nr, nl + 1)
    return need


def compile_program(expr) -> tuple[np.ndarray, int]:
    """``expr`` → (``[n, 2]`` int32 (opcode, argument) program, spill
    slots it needs). A leaf operand is applied straight to the running
    value, so a left fold of any width needs no spill slot; otherwise
    the child that needs more slots is evaluated first (with the
    reversed andnot forms), so a tree of L leaves needs at most
    floor(log2 L) slots."""
    need = _stack_need(expr)
    prog: list[tuple[int, int]] = []
    work: list = [("emit", expr)]
    while work:
        item = work.pop()
        if item[0] == "ins":
            prog.append((item[1], item[2]))
            continue
        node = item[1]
        if node[0] == "leaf":
            prog.append((OP_LOAD, node[1]))
            continue
        op, left, right = node
        if op not in _OP_LEAF:
            raise ValueError(f"unknown bitmap op: {op!r}")
        if right[0] == "leaf":
            work += [("ins", _OP_LEAF[op], right[1]), ("emit", left)]
        elif left[0] == "leaf":
            work += [("ins", _OP_RLEAF[op], left[1]), ("emit", right)]
        elif need[id(left)] >= need[id(right)]:
            work += [("ins", _OP_POP[op], 0), ("emit", right),
                     ("ins", OP_PUSH, 0), ("emit", left)]
        else:
            work += [("ins", _OP_RPOP[op], 0), ("emit", left),
                     ("ins", OP_PUSH, 0), ("emit", right)]
    slots = need[id(expr)]
    if slots > MAX_STACK:
        raise ValueError(f"expression needs {slots} stack slots; the "
                         f"kernel holds {MAX_STACK}")
    return np.asarray(prog, dtype=np.int32).reshape(-1, 2), slots


def eval_expr_torch(expr, leaves) -> torch.Tensor:
    """Evaluate ``expr`` over ``leaves`` (indexable by leaf id, each
    ``[S, W]``) with plain torch ops; iterative post-order, so fold
    depth is unbounded."""
    vals: list[torch.Tensor] = []
    work = [(expr, False)]
    while work:
        node, done = work.pop()
        if node[0] == "leaf":
            vals.append(leaves[node[1]])
        elif done:
            b = vals.pop()
            vals.append(_BITWISE[node[0]](vals.pop(), b))
        else:
            work += [(node, True), (node[2], False), (node[1], False)]
    return vals[0]


# -- plain versions ----------------------------------------------------------

def expr_count_rows_torch(expr, leaves) -> torch.Tensor:
    """``[S]`` int32 of ``sum(popcount(expr(leaves[:, s])))``."""
    return popcount_rows(eval_expr_torch(expr, leaves))


def topn_block_count_torch(expr, rows: torch.Tensor,
                           leaves) -> torch.Tensor:
    """``[S, R]`` int32 of ``popcount(rows[s, r] & expr(leaves[:, s]))``,
    plain row popcounts when ``expr`` is None."""
    if expr is None:
        return popcount_rows(rows)
    src = eval_expr_torch(expr, leaves)
    return popcount_rows(torch.bitwise_and(rows, src.unsqueeze(1)))


def densify_torch(lane: torch.Tensor, val: torch.Tensor,
                  n_words: int) -> torch.Tensor:
    """``[T, n_words]`` dense words from ``[T, n_words/128, G]``
    bucketed (lane, value) slots; ``val == 0`` slots are padding."""
    t_rows, subs, _ = lane.shape
    _check_densify_shape(lane, val, n_words)
    out = torch.zeros((t_rows, n_words), dtype=torch.int32,
                      device=lane.device)
    hit = val != 0
    t_idx, s_idx, _ = hit.nonzero(as_tuple=True)
    cols = s_idx * DENSIFY_LANES + (lane[hit] & (DENSIFY_LANES - 1)).long()
    out[t_idx, cols] = val[hit]
    return out


# -- wrappers ----------------------------------------------------------------

def _check_words(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: words must be int32 views of u32, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_cuda_words(name: str, t: torch.Tensor) -> None:
    if t.shape[-1] % 4 or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte word groups; "
                         f"word count must be a multiple of 4 and the "
                         f"data 16-byte aligned")


def _check_densify_shape(lane, val, n_words: int) -> None:
    if lane.shape != val.shape or lane.dim() != 3:
        raise ValueError("densify: lane/val must share a [T, subs, G] shape")
    if lane.shape[1] * DENSIFY_LANES != n_words:
        raise ValueError("lane/val buckets do not match n_words")


def _leaf_list(leaves, n_slices: int, n_words: int, device) -> list:
    leaves = list(leaves)
    for leaf in leaves:
        _check_words("leaf", leaf, 2, device)
        if tuple(leaf.shape) != (n_slices, n_words):
            raise ValueError(f"leaf shape {tuple(leaf.shape)} != "
                             f"{(n_slices, n_words)}")
    return leaves


_META_ENTRIES = 256
_meta_cache: OrderedDict = OrderedDict()
_meta_mu = threading.Lock()


def _program_meta(expr, leaves: list, device) -> tuple[torch.Tensor, int]:
    """One device int64 buffer: the leaf base pointers, then the
    program's (opcode, arg) int32 pairs (one int64 slot each). Its
    content is a pure function of (expr, pointers), so buffers are kept
    in a small LRU: a repeat query over resident slabs launches with no
    host work and no host-to-device copy."""
    key = (expr, tuple(t.data_ptr() for t in leaves), str(device))
    with _meta_mu:
        hit = _meta_cache.get(key)
        if hit is not None:
            _meta_cache.move_to_end(key)
            return hit
    meta = _build_meta(expr, leaves, device)
    with _meta_mu:
        _meta_cache[key] = meta
        while len(_meta_cache) > _META_ENTRIES:
            _meta_cache.popitem(last=False)
    return meta


def _build_meta(expr, leaves: list, device) -> tuple[torch.Tensor, int]:
    prog = (compile_program(expr)[0] if expr is not None
            else np.zeros((0, 2), np.int32))
    named = prog[prog[:, 0] < OP_PUSH, 1]  # leaf-reading opcodes
    if len(named) and int(named.max()) >= len(leaves):
        raise ValueError(f"expression names leaf {int(named.max())} of "
                         f"{len(leaves)}")
    ptrs = np.asarray([t.data_ptr() for t in leaves], dtype=np.int64)
    host = np.concatenate([ptrs, prog.view(np.int64).ravel()])
    return torch.from_numpy(host).to(device), len(prog)


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"(cudaError {err})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def expr_count_rows(expr, leaves) -> torch.Tensor:
    """``[S]`` int32 counts of ``expr`` over ``leaves`` — L ``[S, W]``
    slabs (a list, or an ``[L, S, W]`` tensor)."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("expr_count_rows: no leaves")
    device = leaves[0].device
    n_slices, n_words = leaves[0].shape
    leaves = _leaf_list(leaves, n_slices, n_words, device)
    if device.type == "cpu":
        return expr_count_rows_torch(expr, leaves)
    if device.type != "cuda":
        raise ValueError(f"expr_count_rows: unsupported device {device}")
    for leaf in leaves:
        _check_cuda_words("expr_count_rows", leaf)
    from .build import libraries
    meta, n_ins = _program_meta(expr, leaves, device)
    out = torch.empty(n_slices, dtype=torch.int32, device=device)
    LAUNCHES["expr_count_rows"] += 1
    _raise_on("expr_count_rows", libraries()["expr_count"].pilosa_expr_count(
        meta.data_ptr(), meta.data_ptr() + 8 * len(leaves), n_ins,
        n_slices, n_words, out.data_ptr(), _stream(device)))
    return out


def topn_block_count(expr, rows: torch.Tensor, leaves) -> torch.Tensor:
    """``[S, R]`` int32 of ``popcount(rows[s, r] & expr(leaves[:, s]))``
    (plain row popcounts when ``expr`` is None; ``leaves`` may then be
    empty)."""
    device = rows.device
    _check_words("rows", rows, 3, device)
    n_slices, n_rows, n_words = rows.shape
    leaves = _leaf_list(leaves, n_slices, n_words, device)
    if device.type == "cpu":
        return topn_block_count_torch(expr, rows, leaves)
    if device.type != "cuda":
        raise ValueError(f"topn_block_count: unsupported device {device}")
    for t in (rows, *leaves):
        _check_cuda_words("topn_block_count", t)
    from .build import libraries
    meta, n_ins = _program_meta(expr, leaves, device)
    out = torch.empty((n_slices, n_rows), dtype=torch.int32, device=device)
    LAUNCHES["topn_block_count"] += 1
    _raise_on("topn_block_count",
              libraries()["topn_block_count"].pilosa_topn_block_count(
                  rows.data_ptr(), n_slices, n_rows, n_words,
                  meta.data_ptr(), meta.data_ptr() + 8 * len(leaves), n_ins,
                  out.data_ptr(), _stream(device)))
    return out


def densify(lane: torch.Tensor, val: torch.Tensor,
            n_words: int) -> torch.Tensor:
    """Bucketed sparse rows → ``[T, n_words]`` dense int32-viewed words
    (the input contract of ops.packed.bucket_prepared)."""
    device = lane.device
    _check_words("lane", lane, 3, device)
    _check_words("val", val, 3, device)
    _check_densify_shape(lane, val, n_words)
    if device.type == "cpu":
        return densify_torch(lane, val, n_words)
    if device.type != "cuda":
        raise ValueError(f"densify: unsupported device {device}")
    from .build import libraries
    t_rows, subs, g_slots = lane.shape
    out = torch.empty((t_rows, n_words), dtype=torch.int32, device=device)
    LAUNCHES["densify"] += 1
    _raise_on("densify", libraries()["densify"].pilosa_densify(
        lane.data_ptr(), val.data_ptr(), t_rows, subs, g_slots,
        out.data_ptr(), _stream(device)))
    return out


def op_count_rows(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(popcount(a OP b), -1)``: int32 ``[R]`` for ``[R, W]``
    operands, a 0-d int32 tensor for ``[W]`` (as the JAX wrapper
    op_count_rows_pallas returns). The plain version on the CPU is
    ``op_count_rows_torch`` (ops.kernels.op_count_rows)."""
    if op not in _OP_CODE:
        raise ValueError(f"unknown bitmap op: {op!r}")
    device = a.device
    ndim = 1 if a.dim() == 1 else 2
    _check_words("a", a, ndim, device)
    _check_words("b", b, ndim, device)
    if a.shape != b.shape:
        raise ValueError(f"op_count_rows: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    n_words = a.shape[-1]
    if n_words * 32 >= 2**31:
        raise ValueError(f"op_count_rows: a row of {n_words} words may "
                         "hold 2^31 bits or more; counts are int32")
    if device.type == "cpu":
        return op_count_rows_torch(op, a, b)
    if device.type != "cuda":
        raise ValueError(f"op_count_rows: unsupported device {device}")
    if a.data_ptr() % 16 != b.data_ptr() % 16:
        raise ValueError("op_count_rows: a and b must share their address "
                         "modulo 16 bytes (the kernel reads both in the "
                         "same 16-byte word groups); got offsets "
                         f"{a.data_ptr() % 16} and {b.data_ptr() % 16}")
    from .build import libraries
    n_rows = a.shape[0] if ndim == 2 else 1
    out = torch.empty(n_rows, dtype=torch.int32, device=device)
    LAUNCHES["op_count_rows"] += 1
    _raise_on("op_count_rows", libraries()["op_count"].pilosa_op_count(
        a.data_ptr(), b.data_ptr(), n_rows, n_words, _OP_CODE[op],
        out.data_ptr(), _stream(device)))
    return out if ndim == 2 else out[0]

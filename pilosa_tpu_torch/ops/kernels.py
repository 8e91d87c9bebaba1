"""Plain PyTorch bit kernels over packed words — the torch form of the
JAX package's ``ops/kernels.py``.

Words travel as **int32 views of the u32 words** (``np.ndarray.view
(np.int32)`` on the host, ``torch.int32`` on the device): torch has no
popcount op and, on the CPU, no ``~`` or ``>>`` for ``torch.uint32``,
while every bitwise op on int32 gives the same bit pattern as on u32.
Counts are int32 per row (a slice row holds at most 2^20 bits); totals
are summed in int64, so no 16-bit hi/lo split is needed.

Conventions as in the JAX module: operands are ``[n_words]`` (one row)
or ``[n_rows, n_words]`` (a row block); ops are elementwise in the last
axis. A BSI comparison is an expression over plane leaves
(storage.bsi.compare_fold_expr), counted like any other; the JAX
module's materializing circuit comes with the device ``materialize``.
"""

from __future__ import annotations

import torch


def _andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_and(a, torch.bitwise_not(b))


_BITWISE = {
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
    "andnot": _andnot,
}

def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of non-negative int32 values below 2^16: every
    intermediate stays below 2^16, so no step can overflow int32."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32-viewed u32 words → int32 (0..32).

    ``>>`` on int32 is arithmetic, so the word is split into its two
    16-bit halves, each masked after the shift; a word with bit 31 set
    counts 32 bits, never a negative number."""
    return _popcount16(words & 0xFFFF) + _popcount16((words >> 16) & 0xFFFF)


def popcount_rows(a: torch.Tensor) -> torch.Tensor:
    """Per-row popcount → int32."""
    return popcount(a).sum(dim=-1, dtype=torch.int32)


def op_count_rows(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``popcount(a ⊕ b)`` summed over the word axis → int32 per row."""
    return popcount_rows(_BITWISE[op](a, b))


def op_count_total(op: str, a: torch.Tensor, b: torch.Tensor) -> int:
    """``popcount(a ⊕ b)`` over every axis → exact Python int (per-row
    counts in int32, the total in int64: no row-count bound)."""
    rows = op_count_rows(op, a, b)
    return int(rows.sum(dtype=torch.int64))


def op_count(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused ``sum(popcount(a ⊕ b), -1)`` over ``[n_words]`` or
    ``[n_rows, n_words]``: on a CUDA tensor the hand kernel
    (ops.cuda_kernels.op_count_rows, which launches or raises), on a CPU
    tensor the plain ``op_count_rows``. The device of the operands
    chooses; nothing else does."""
    if a.device.type == "cpu":
        return op_count_rows(op, a, b)
    from . import cuda_kernels  # imports this module: no top-level cycle
    return cuda_kernels.op_count_rows(op, a, b)


def row_block_op_count(op: str, rows: torch.Tensor,
                       other: torch.Tensor) -> torch.Tensor:
    """``popcount(rows[i] ⊕ other)`` for every row of a ``[n_rows,
    n_words]`` block against one ``[n_words]`` row → int32 per row."""
    return popcount_rows(_BITWISE[op](rows, other.unsqueeze(0)))

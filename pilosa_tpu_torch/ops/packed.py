"""Packed dense bitmap layout — the device-side data representation.

Copied from the JAX package's ``ops/packed.py`` with its imports
repointed. A fragment's rows live on the card as a row-major
``uint32[n_rows, 32768]`` matrix — 2^20 columns / 32 bits per word — and
all set algebra is elementwise ops over whole rows
(pilosa_tpu_torch.ops.kernels and the CUDA kernels of
pilosa_tpu_torch.ops.cuda_kernels, which take int32 views of these
words).

The layout lines up with the storage format for free: a roaring bitmap
container is 1024 little-endian u64 words covering a 2^16 position
range, which reinterpret as exactly the 2048 little-endian u32 device
words of that range — so packing a dense container is a memcpy, no bit
manipulation.

Column ids are u64 host-side (positions up to 2^64); the device only ever
sees word indices within a slice, which fit comfortably in i32.
"""

from __future__ import annotations

import numpy as np

from .. import SLICE_WIDTH
from ..storage.roaring import Bitmap, runs_to_words

WORD_BITS = 32
# u32 words per slice row: 2^20 / 32 = 32768 (a multiple of the 128-word
# densify group and of the kernels' 16-byte loads).
WORDS_PER_SLICE = SLICE_WIDTH // WORD_BITS
# u32 words per roaring container range (2^16 positions / 32).
_WORDS_PER_CONTAINER = (1 << 16) // WORD_BITS


def pack_bitmap(b: Bitmap, n_words: int, out: np.ndarray | None = None,
                base_word: int = 0) -> np.ndarray:
    """Pack a roaring bitmap into a dense u32 word vector.

    ``b``'s positions are interpreted relative to ``base_word * 32``; words
    outside [0, n_words) are ignored. Dense containers blit via u64→u32
    reinterpretation; array containers scatter.
    """
    if out is None:
        out = np.zeros(n_words, dtype=np.uint32)
    for key, c in zip(b.keys, b.containers):
        if c.n == 0:
            continue
        word0 = key * _WORDS_PER_CONTAINER - base_word
        if word0 >= n_words or word0 + _WORDS_PER_CONTAINER <= 0:
            continue
        if not c.is_array():
            dst0, dst1 = max(word0, 0), min(word0 + _WORDS_PER_CONTAINER,
                                            n_words)
            # Run containers decode to dense words here — the device
            # residency upload path (parallel.residency leaf_slab /
            # candidate_block) sees bit-plane slabs regardless of the
            # host storage kind.
            words64 = (c.bitmap if c.bitmap is not None
                       else runs_to_words(c.runs))
            src = words64.view("<u4")[dst0 - word0:dst1 - word0]
            out[dst0:dst1] |= src
        else:
            a = c.array
            widx = word0 + (a >> np.uint32(5)).astype(np.int64)
            keep = (widx >= 0) & (widx < n_words)
            np.bitwise_or.at(out, widx[keep],
                             np.uint32(1) << (a[keep] & np.uint32(31)))
    return out


def pack_storage_row(storage: Bitmap, row_id: int,
                     out: np.ndarray) -> np.ndarray:
    """Pack one row of a fragment-local storage bitmap into dense words.

    ``storage`` holds positions ``pos = row * SLICE_WIDTH + col`` (the
    fragment bit layout, reference fragment.go:1511-1514); the result is
    the dense words of columns [0, 2^20) of that row.
    """
    row_bm = storage.offset_range(0, row_id * SLICE_WIDTH,
                                  (row_id + 1) * SLICE_WIDTH)
    return pack_bitmap(row_bm, out.shape[-1], out=out)


def pack_rows(storage: Bitmap, row_ids) -> np.ndarray:
    """Pack rows of a fragment-local storage bitmap into u32[n, 32768]."""
    row_ids = list(row_ids)
    out = np.zeros((len(row_ids), WORDS_PER_SLICE), dtype=np.uint32)
    for i, row in enumerate(row_ids):
        pack_storage_row(storage, row, out[i])
    return out


def unpack_words(words: np.ndarray) -> np.ndarray:
    """Dense u32 word vector → sorted u64 bit positions (host)."""
    from ..storage import native
    return native.unpack_words(np.ascontiguousarray(words))


def unpack_to_bitmap(words: np.ndarray, base_word: int = 0) -> Bitmap:
    """Dense u32 word vector → roaring bitmap with positions offset by
    ``base_word * 32``.

    Container-direct build: the dense vector IS the container layout
    (2048 u32 words per 2^16-value container), so dense containers
    become zero-copy u64 views of the fetched array and only sparse
    ones expand to value arrays — the expand-every-position
    ``from_sorted`` path cost ~8 B/bit plus a full re-merge, which was
    most of the device materialize leg's repack time. Requires container alignment (base_word and len multiples of
    2048), which every device block satisfies; anything else falls
    back to the general path."""
    from ..storage.roaring import ARRAY_MAX_SIZE, Container
    per_container = _WORDS_PER_CONTAINER  # 2048 u32 words
    if (base_word % per_container or len(words) % per_container
            or words.dtype != np.uint32 or not words.flags.c_contiguous):
        pos = unpack_words(words)
        if base_word:
            pos = pos + np.uint64(base_word * WORD_BITS)
        return Bitmap.from_sorted(pos)
    counts = np.bitwise_count(words).astype(np.int64) \
        .reshape(-1, per_container).sum(axis=1)
    b = Bitmap()
    base_key = base_word // per_container
    w64 = words.view("<u8").reshape(-1, _WORDS_PER_CONTAINER // 2)
    arrays = _sparse_container_values(w64, counts, ARRAY_MAX_SIZE)
    for ci in np.flatnonzero(counts).tolist():
        n = int(counts[ci])
        if n > ARRAY_MAX_SIZE:
            # Zero-copy view into the fetched block, COW-marked: the
            # block outlives the bitmap via the view references.
            c = Container.from_bitmap(w64[ci], n=n, mapped=True)
        else:
            # A view into one array of every sparse container's values,
            # COW-marked like the dense views.
            c = Container.from_array(arrays[ci], mapped=True)
        b.keys.append(base_key + ci)
        b.containers.append(c)
    return b


def _sparse_container_values(w64: np.ndarray, counts: np.ndarray,
                             max_n: int) -> dict:
    """{container: sorted u32 values} of every container holding 1 to
    ``max_n`` bits, expanded in one vectorized pass over their nonzero
    bytes (one pass a container cost most of a sparse repack)."""
    sparse = np.flatnonzero((counts > 0) & (counts <= max_n))
    if not len(sparse):
        return {}
    sub8 = np.ascontiguousarray(w64[sparse]).view(np.uint8)
    per = sub8.shape[1]  # bytes a container
    nzb = np.flatnonzero(sub8)
    flat = np.flatnonzero(np.unpackbits(sub8.ravel()[nzb],
                                        bitorder="little"))
    vals = ((nzb[flat >> 3] % per) * 8 + (flat & 7)).astype(np.uint32)
    ends = np.cumsum(counts[sparse])
    return {int(ci): vals[e - int(n):e]
            for ci, n, e in zip(sparse.tolist(), counts[sparse].tolist(),
                                ends.tolist())}


def sparse_words(b: Bitmap, n_words: int, base_word: int = 0
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sparse word form of a roaring bitmap: (sorted unique i32 word
    indices, u32 word values) — the upload payload of the device
    densify kernel (ops.cuda_kernels.densify). Bounded by SET
    words (= on-disk density), not row width: bitmap containers list
    their nonzero u32 words directly, array containers group positions
    by word with one reduceat. Positions relative to ``base_word*32``;
    words outside [0, n_words) are dropped."""
    idx_parts: list[np.ndarray] = []
    val_parts: list[np.ndarray] = []
    for key, c in zip(b.keys, b.containers):
        if c.n == 0:
            continue
        word0 = key * _WORDS_PER_CONTAINER - base_word
        if word0 >= n_words or word0 + _WORDS_PER_CONTAINER <= 0:
            continue
        if not c.is_array():
            view = (c.bitmap if c.bitmap is not None
                    else runs_to_words(c.runs)).view("<u4")
            nz = np.flatnonzero(view)
            widx = word0 + nz.astype(np.int64)
            keep = (widx >= 0) & (widx < n_words)
            idx_parts.append(widx[keep].astype(np.int32))
            val_parts.append(view[nz[keep]])
        else:
            a = c.array
            widx = word0 + (a >> np.uint32(5)).astype(np.int64)
            keep = (widx >= 0) & (widx < n_words)
            widx, a = widx[keep], a[keep]
            if not len(widx):
                continue
            bits = np.uint32(1) << (a & np.uint32(31))
            # positions are sorted, so equal word indices are adjacent:
            # one reduceat ORs each word's bits together.
            starts = np.concatenate(
                ([0], np.flatnonzero(np.diff(widx)) + 1))
            idx_parts.append(widx[starts].astype(np.int32))
            val_parts.append(np.bitwise_or.reduceat(bits, starts))
    if not idx_parts:
        return (np.empty(0, np.int32), np.empty(0, np.uint32))
    return np.concatenate(idx_parts), np.concatenate(val_parts)


def sparse_row_words(storage: Bitmap, row_id: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """sparse_words for one fragment row (pos = row*SLICE_WIDTH + col)."""
    row_bm = storage.offset_range(0, row_id * SLICE_WIDTH,
                                  (row_id + 1) * SLICE_WIDTH)
    return sparse_words(row_bm, WORDS_PER_SLICE)


# 128 words per bucket group - must match the densify kernel's group width.
_DENSIFY_LANES = 128


def bucket_rows(storage: Bitmap, row_ids,
                n_words: int = WORDS_PER_SLICE
                ) -> tuple[np.ndarray, np.ndarray]:
    """Bucketed sparse form of a row block for the device densify
    kernel (ops.cuda_kernels.densify): ``([T, n_words/128, G]
    u32 lanes, same-shape u32 values)``, where slot g of 128-word group
    s of row t is one set word (its lane 0-127 and value); ``val == 0``
    slots are padding. G is the max set-word count in any row's group,
    rounded up to a power of two (shape-bucketing keeps the kernel's
    compile cache small). Transfer size is ``T * n_words/16 * G`` bytes
    vs ``4 * T * n_words`` dense — the win whenever G stays small,
    which is exactly the sparse/clustered case the cost model routes
    here."""
    subs = n_words // _DENSIFY_LANES
    rows = [sparse_row_words(storage, r) for r in row_ids]
    return bucket_prepared(rows, subs)


def _bucket_plan(rows: list, subs: int) -> tuple[int, list]:
    """One bincount pass over pre-extracted pairs: (g_pad, metas) —
    shared by sparse_gate (the decision) and bucket_prepared (the
    fill), so the cold path pays the grouping exactly once."""
    g_max = 1
    metas = []
    for pair in rows:
        if pair is None or not len(pair[0]):
            metas.append(None)
            continue
        idx, val = pair
        groups = (idx >> 7).astype(np.int64)
        counts = np.bincount(groups, minlength=subs)
        g_max = max(g_max, int(counts.max()))
        starts = np.zeros(subs + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(len(idx), dtype=np.int64) - starts[groups]
        metas.append((groups, rank, idx, val))
    return 1 << (g_max - 1).bit_length(), metas


def bucket_prepared(rows: list, subs: int, plan=None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """bucket_rows over pre-extracted ``(idx, val)`` pairs (None for
    absent rows) — the shared form for multi-fragment blocks, where
    extraction happens once and feeds either the sparse upload or the
    host dense scatter (ops.packed.densify_host). ``plan`` is the
    (g_pad, metas) a prior sparse_gate computed."""
    g_pad, metas = plan if plan is not None else _bucket_plan(rows, subs)
    lanes = np.zeros((len(rows), subs, g_pad), dtype=np.uint32)
    vals = np.zeros((len(rows), subs, g_pad), dtype=np.uint32)
    for t, meta in enumerate(metas):
        if meta is None:
            continue
        groups, rank, idx, val = meta
        lanes[t, groups, rank] = (idx & 127).astype(np.uint32)
        vals[t, groups, rank] = val
    return lanes, vals


def densify_host(rows: list, n_words: int) -> np.ndarray:
    """Pre-extracted ``(idx, val)`` pairs → dense ``[T, n_words]`` u32
    host-side (the dense-upload leg when the sparse gate says no —
    reuses the extraction instead of re-walking containers)."""
    out = np.zeros((len(rows), n_words), dtype=np.uint32)
    for t, pair in enumerate(rows):
        if pair is None or not len(pair[0]):
            continue
        out[t, pair[0]] = pair[1]
    return out


def sparse_gate(rows: list, n_words: int,
                margin: float = 2.0) -> tuple[bool, tuple]:
    """Should a block of pre-extracted rows ship sparse? Returns
    (use_sparse, plan) — pass ``plan`` to bucket_prepared to reuse the
    grouping pass. Sparse pays when the bucketed payload —
    ``T * n_words/16 * G`` bytes — is under ``dense/margin`` and G is
    within the kernel's VMEM envelope; the measured crossover
    (benchmarks/DENSIFY.json) shows 3-6x wins at G<=16 and a 0.5x LOSS
    at G=128, so the gate is deliberately conservative."""
    subs = n_words // _DENSIFY_LANES
    plan = _bucket_plan(rows, subs)
    g_pad = plan[0]
    sparse_bytes = len(rows) * subs * g_pad * 8
    dense_bytes = len(rows) * n_words * 4
    return (g_pad <= 32
            and sparse_bytes * margin <= dense_bytes), plan

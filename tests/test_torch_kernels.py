"""The port's kernels against the JAX package's, on the same numpy input.

Each plain PyTorch version of ops.cuda_kernels (the function a CPU tensor
gets) is held to the TPU kernel it replaces, run as the JAX package's
own tests run it on the CPU: ``interpret=True`` Pallas
(tests/test_pallas_serving.py). Trees over 16 leaves are held to
``pilosa_tpu.parallel.mesh._eval_expr``. The postfix program the CUDA
kernels execute is checked here by a numpy interpreter of its opcodes.
All results are integers, so every comparison is exact. The CUDA
kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pilosa_tpu.ops import kernels as jax_kernels
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel import mesh as jax_mesh
from pilosa_tpu.storage.roaring import Bitmap as JaxRoaring

from pilosa_tpu_torch.ops import cuda_kernels as ck
from pilosa_tpu_torch.ops import kernel_ab
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.ops import packed
from pilosa_tpu_torch.storage.roaring import Bitmap as TorchRoaring

MIXED = ("or", ("and", ("leaf", 0), ("leaf", 1)),
         ("andnot", ("xor", ("leaf", 2), ("leaf", 0)), ("leaf", 1)))


def _t(words: np.ndarray) -> torch.Tensor:
    """u32 numpy words → the port's int32 view on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _words(rng, shape, bit31=True):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    if bit31:
        w |= np.uint32(1 << 31)  # every word has bit 31 set
    return w


def _fold(op, n):
    e = ("leaf", 0)
    for i in range(1, n):
        e = (op, e, ("leaf", i))
    return e


def _balanced(lo, hi, ops):
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    return (ops[(lo * 7 + hi) % len(ops)], _balanced(lo, mid, ops),
            _balanced(mid, hi, ops))


def _rand_tree(rng, n_leaves, depth):
    if depth == 0 or rng.random() < 0.25:
        return ("leaf", int(rng.integers(n_leaves)))
    op = ["and", "or", "xor", "andnot"][int(rng.integers(4))]
    return (op, _rand_tree(rng, n_leaves, depth - 1),
            _rand_tree(rng, n_leaves, depth - 1))


WIDE = {
    "mixed64": _balanced(0, 64, ["and", "or", "xor", "andnot"]),
    "union1000": _fold("or", 1000),
    "intersect40": _fold("and", 40),
    "difference40": _fold("andnot", 40),
}


def _jax_expr_counts(expr, leaves):
    words = np.asarray(jax_mesh._eval_expr(expr, jnp.asarray(leaves)))
    return np.bitwise_count(words).sum(axis=-1).astype(np.int64)


class TestPopcount:
    def test_bit31_words_count_32(self):
        w = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1],
                     dtype=np.uint32)
        assert tk.popcount(_t(w)).tolist() == [32, 1, 31, 0, 1]

    def test_matches_numpy(self):
        w = np.random.default_rng(1).integers(0, 2**32, size=(4, 4096),
                                              dtype=np.uint32)
        got = tk.popcount(_t(w)).numpy()
        assert np.array_equal(got, np.bitwise_count(w))


class TestOpsKernelsTwins:
    @pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
    def test_op_count_rows(self, op):
        rng = np.random.default_rng(2)
        a, b = _words(rng, (5, 2048)), _words(rng, (5, 2048), False)
        want = np.asarray(jax_kernels.op_count_rows(op, a, b))
        got = tk.op_count_rows(op, _t(a), _t(b)).numpy()
        assert got.tolist() == want.tolist()

    @pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
    def test_op_count_total(self, op):
        rng = np.random.default_rng(3)
        a, b = _words(rng, (9, 256)), _words(rng, (9, 256), False)
        assert tk.op_count_total(op, _t(a), _t(b)) == \
            jax_kernels.op_count_total(op, a, b)

    def test_popcount_rows(self):
        a = _words(np.random.default_rng(4), (3, 512))
        assert tk.popcount_rows(_t(a)).tolist() == \
            np.asarray(jax_kernels.popcount_rows(a)).tolist()

    @pytest.mark.parametrize("op", ["and", "andnot"])
    def test_row_block_op_count(self, op):
        rng = np.random.default_rng(5)
        rows, other = _words(rng, (7, 384)), _words(rng, (384,), False)
        want = np.asarray(jax_kernels.row_block_op_count(op, rows, other))
        got = tk.row_block_op_count(op, _t(rows), _t(other))
        assert got.tolist() == want.tolist()


class TestExprCountRows:
    # The last three are the card tests' small shapes: S = 1, W = 4.
    @pytest.mark.parametrize("expr,shape", [
        (MIXED, (9, 2048)), (("leaf", 2), (9, 2048)),
        (("and", ("leaf", 0), ("leaf", 1)), (9, 2048)),
        (("andnot", ("leaf", 1), ("leaf", 0)), (9, 2048)),
        (("xor", ("leaf", 0), ("leaf", 2)), (9, 2048)),
        (("and", ("leaf", 0), ("leaf", 1)), (1, 32768)),
        (MIXED, (9, 4)), (MIXED, (1, 4))],
        ids=["expr0", "expr1", "expr2", "expr3", "expr4", "s1", "w4",
             "s1_w4"])
    def test_matches_pallas_interpret(self, expr, shape):
        leaves = _words(np.random.default_rng(6), (3,) + shape)
        want = np.asarray(pk.expr_count_rows_pallas(expr, leaves,
                                                    interpret=True))
        got = ck.expr_count_rows_torch(expr, list(_t(leaves)))
        assert got.dtype == torch.int32
        assert got.tolist() == want.tolist()

    @pytest.mark.parametrize("name", sorted(WIDE))
    def test_wide_trees_match_jax_eval(self, name):
        expr = WIDE[name]
        n = 64 if name == "mixed64" else (1000 if name == "union1000"
                                          else 40)
        leaves = _words(np.random.default_rng(7), (n, 3, 128), False)
        got = ck.expr_count_rows_torch(expr, _t(leaves))
        assert got.tolist() == _jax_expr_counts(expr, leaves).tolist()

    def test_wrapper_takes_plain_version_on_cpu(self):
        leaves = _words(np.random.default_rng(8), (3, 9, 2048))
        before = dict(ck.LAUNCHES)
        got = ck.expr_count_rows(MIXED, _t(leaves))
        want = np.asarray(pk.expr_count_rows_pallas(MIXED, leaves,
                                                    interpret=True))
        assert got.tolist() == want.tolist()
        assert ck.LAUNCHES == before  # no kernel launch on the CPU

    def test_zero_slices(self):
        leaves = np.zeros((2, 0, 128), np.uint32)
        got = ck.expr_count_rows(("and", ("leaf", 0), ("leaf", 1)),
                                 _t(leaves))
        assert got.tolist() == []


class TestTopNBlockCount:
    @pytest.mark.parametrize("expr", [MIXED, ("leaf", 1),
                                      ("andnot", ("leaf", 0), ("leaf", 2))])
    def test_matches_pallas_interpret(self, expr):
        rng = np.random.default_rng(9)
        leaves = _words(rng, (3, 9, 2048))
        rows = _words(rng, (9, 5, 2048))
        want = np.asarray(pk.topn_block_count_pallas(expr, rows, leaves,
                                                     interpret=True))
        got = ck.topn_block_count(expr, _t(rows), list(_t(leaves)))
        assert got.tolist() == want.tolist()

    def test_no_expr_empty_leaf_set(self):
        rows = _words(np.random.default_rng(10), (9, 5, 2048))
        want = np.asarray(pk.topn_block_count_pallas(
            None, rows, np.zeros((0, 9, 1), np.uint32), interpret=True))
        got = ck.topn_block_count(None, _t(rows), [])
        assert got.tolist() == want.tolist()

    def test_wide_source(self):
        rng = np.random.default_rng(11)
        leaves = _words(rng, (1000, 2, 128), False)
        rows = _words(rng, (2, 3, 128))
        expr = WIDE["union1000"]
        src = np.asarray(jax_mesh._eval_expr(expr, jnp.asarray(leaves)))
        want = np.bitwise_count(rows & src[:, None, :]).sum(axis=-1)
        got = ck.topn_block_count(expr, _t(rows), list(_t(leaves)))
        assert got.tolist() == want.tolist()


def _bucketed(rng, t_rows, n_words, per_row):
    """Sparse rows through the port's own host bucketing
    (ops.packed.bucket_rows) — the densify kernel's input contract."""
    bm = TorchRoaring()
    for t in range(t_rows):
        cols = rng.choice(n_words * 32, size=per_row, replace=False)
        bm.add_many((np.uint64(t) * np.uint64(1 << 20)
                     + cols.astype(np.uint64)))
    return packed.bucket_rows(bm, range(t_rows), n_words)


class TestDensify:
    # "gN": the card tests' slots built directly at G = N (lanes 0 and
    # 127 of one group, bit-31 values, an all-padding row).
    @pytest.mark.parametrize("per_row", [0, 7, 300, "g1", "g32", "g40"])
    def test_matches_pallas_interpret(self, per_row):
        rng = np.random.default_rng(12)
        if isinstance(per_row, str):
            lanes, vals = kernel_ab.odd_slots(rng, 11, 16, int(per_row[1:]),
                                              (3,))
        else:
            lanes, vals = _bucketed(rng, 11, 2048, per_row)  # subs=16
        want = np.asarray(pk.densify_pallas(lanes, vals, 2048,
                                            interpret=True))
        got = ck.densify(_t(lanes), _t(vals), 2048).numpy().view(np.uint32)
        assert np.array_equal(got, want)

    def test_bit31_values(self):
        lanes = np.zeros((2, 1, 2), np.uint32)
        vals = np.zeros((2, 1, 2), np.uint32)
        lanes[0, 0] = [3, 127]
        vals[0, 0] = [0x80000001, 0xFFFFFFFF]
        want = np.asarray(pk.densify_pallas(lanes, vals, 128,
                                            interpret=True))
        got = ck.densify(_t(lanes), _t(vals), 128).numpy().view(np.uint32)
        assert np.array_equal(got, want)

    def test_bucket_mismatch_raises(self):
        z = _t(np.zeros((1, 2, 1), np.uint32))
        with pytest.raises(ValueError):
            ck.densify(z, z, 128)

    def test_packed_copy_matches_reference_packing(self):
        """The port's copy of ops/packed buckets a roaring row exactly as
        the JAX package's does."""
        from pilosa_tpu.ops import packed as jax_packed
        rng = np.random.default_rng(13)
        pos = np.unique(rng.integers(0, 3 << 20, size=5000,
                                     dtype=np.uint64))
        a, b = JaxRoaring(), TorchRoaring()
        a.add_many(pos)
        b.add_many(pos)
        for x, y in zip(jax_packed.bucket_rows(a, [0, 1, 2]),
                        packed.bucket_rows(b, [0, 1, 2])):
            assert np.array_equal(x, y)


def _run_program(prog, leaves):
    """numpy interpreter of the CUDA kernels' opcodes
    (csrc/expr_program.cuh), with the stack depth it reaches."""
    acc, stack, depth = None, [], 0
    for op, arg in prog.tolist():
        if op == ck.OP_LOAD:
            acc = leaves[arg]
        elif op in (1, 2, 3, 4):
            f = {1: np.bitwise_and, 2: np.bitwise_or, 3: np.bitwise_xor,
                 4: lambda a, b: a & ~b}[op]
            acc = f(acc, leaves[arg])
        elif op == 5:
            acc = leaves[arg] & ~acc
        elif op == ck.OP_PUSH:
            stack.append(acc)
            depth = max(depth, len(stack))
        elif op in (7, 8, 9, 10):
            f = {7: np.bitwise_and, 8: np.bitwise_or, 9: np.bitwise_xor,
                 10: lambda a, b: a & ~b}[op]
            acc = f(stack.pop(), acc)
        elif op == 11:
            acc = acc & ~stack.pop()
        else:
            raise AssertionError(f"bad opcode {op}")
    assert not stack
    return acc, depth


class TestCompileProgram:
    @pytest.mark.parametrize("name", sorted(WIDE))
    def test_wide_trees(self, name):
        expr = WIDE[name]
        n = {"mixed64": 64, "union1000": 1000}.get(name, 40)
        leaves = _words(np.random.default_rng(14), (n, 2, 64), False)
        prog, slots = ck.compile_program(expr)
        got, depth = _run_program(prog, leaves)
        assert depth == slots <= ck.MAX_STACK
        want = np.asarray(jax_mesh._eval_expr(expr, jnp.asarray(leaves)))
        assert np.array_equal(got, want)

    def test_folds_need_no_stack(self):
        for op in ("and", "or", "andnot", "xor"):
            assert ck.compile_program(_fold(op, 1000))[1] == 0

    @pytest.mark.parametrize("seed", range(4))
    def test_random_trees(self, seed):
        rng = np.random.default_rng(100 + seed)
        leaves = _words(rng, (6, 2, 32), False)
        for _ in range(25):
            expr = _rand_tree(rng, 6, 5)
            prog, slots = ck.compile_program(expr)
            got, depth = _run_program(prog, leaves)
            assert depth == slots
            want = np.asarray(jax_mesh._eval_expr(expr,
                                                  jnp.asarray(leaves)))
            assert np.array_equal(got, want), expr

    def test_balanced_depth_is_logarithmic(self):
        expr = _balanced(0, 1024, ["and", "or", "xor", "andnot"])
        assert ck.compile_program(expr)[1] <= 10


class TestWrapperChecks:
    def test_rejects_uint32_and_int64(self):
        for dtype in (torch.int64, torch.float32):
            with pytest.raises(TypeError):
                ck.expr_count_rows(("leaf", 0), [torch.zeros((2, 8),
                                                             dtype=dtype)])

    def test_rejects_shape_mismatch(self):
        a = torch.zeros((2, 8), dtype=torch.int32)
        b = torch.zeros((3, 8), dtype=torch.int32)
        with pytest.raises(ValueError):
            ck.expr_count_rows(("and", ("leaf", 0), ("leaf", 1)), [a, b])

    def test_rejects_non_contiguous(self):
        rows = torch.zeros((2, 8, 4), dtype=torch.int32).transpose(0, 1)
        with pytest.raises(ValueError):
            ck.topn_block_count(None, rows, [])

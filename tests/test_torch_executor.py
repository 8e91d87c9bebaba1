"""The port's executor against the JAX package's on the same state.

A JAX ``Holder`` is filled from a seed; its state is exported with the
JAX package's own API (``frag.storage.all_positions()`` per fragment)
and carried into the port through ``carry.holder_from_state``. The JAX
``Executor`` runs its device leg on the virtual CPU mesh
(``mesh_min_slices=1``, as tests/test_device_differential.py runs it)
and the port's ``Executor(device="cpu")`` its kernel wrappers' plain
versions; every answer must be identical — the same exact counts and
the same TopN order.
"""

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder

from pilosa_tpu_torch import carry
from pilosa_tpu_torch.errors import PilosaError
from pilosa_tpu_torch.ops import cuda_kernels
from pilosa_tpu_torch.parallel import residency

N_SLICES = 8
N_ROWS = 6

# The port's device legs at every slice count (the JAX executor's
# use_mesh=True, mesh_min_slices=1).
PIN_DEVICE = {"mesh_min_slices": 1}


def export_state(holder) -> dict:
    """(index, frame, view, slice) → u64 positions, via the JAX API."""
    return {(frag.index, frag.frame, frag.view, frag.slice):
            frag.storage.all_positions()
            for frag in holder.iter_fragments()}


def _norm(results):
    out = []
    for r in results:
        if hasattr(r, "bits"):
            out.append([int(b) for b in r.bits()])
        elif isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        else:
            out.append(r)
    return out


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


def _fill(holder, rng):
    idx = holder.create_index("d")
    frame = idx.create_frame("f")
    for row in range(N_ROWS):
        dense = int(rng.integers(N_SLICES))
        cols = rng.choice(SLICE_WIDTH // 32, size=400, replace=False)
        frame.import_bits(np.full(len(cols), row, dtype=np.uint64),
                          (cols + dense * SLICE_WIDTH).astype(np.uint64))
        cols = rng.choice(N_SLICES * SLICE_WIDTH, size=80, replace=False)
        frame.import_bits(np.full(len(cols), row, dtype=np.uint64),
                          cols.astype(np.uint64))
    # Run-container rows (long column spans).
    runf = idx.create_frame("rf")
    for row in range(N_ROWS):
        start = int(rng.integers(0, (N_SLICES - 1) * SLICE_WIDTH))
        span = np.arange(start, start + 40000, dtype=np.uint64)
        runf.import_bits(np.full(len(span), row, dtype=np.uint64), span)
    # Absent fragments: frame g holds bits in slices 1 and 5 only.
    g = idx.create_frame("g")
    for s in (1, 5):
        cols = rng.choice(SLICE_WIDTH, size=300, replace=False)
        g.import_bits(np.full(len(cols), s % 3, dtype=np.uint64),
                      (cols + s * SLICE_WIDTH).astype(np.uint64))
    # Ties: rows 0-3 of frame t each hold 10 bits, all inside row 9, so
    # TopN against Bitmap(rowID=9, frame=t) ranks four rows at 10.
    t = idx.create_frame("t")
    base = np.arange(0, 640, 64, dtype=np.uint64)
    for row in range(4):
        t.import_bits(np.full(10, row, dtype=np.uint64), base + row)
    src = np.concatenate([base + r for r in range(4)])
    t.import_bits(np.full(len(src), 9, dtype=np.uint64), src)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX executor, port executor) over the same state."""
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    _fill(jh, np.random.default_rng(4242))
    th, tex = carry.holder_from_state(str(tmp_path_factory.mktemp("port")),
                                      export_state(jh), device="cpu",
                                      executor_options=PIN_DEVICE)
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1)
    yield jex, tex
    assert jex.device_fallbacks == 0
    jex.close()
    jh.close()
    th.close()


def _rand_tree(rng, depth, frame="f"):
    if depth == 0 or rng.random() < 0.35:
        return f"Bitmap(rowID={int(rng.integers(N_ROWS + 1))}, frame={frame})"
    op = rng.choice(["Intersect", "Union", "Difference"])
    k = int(rng.integers(2, 4))
    return (f"{op}(" + ", ".join(_rand_tree(rng, depth - 1, frame)
                                 for _ in range(k)) + ")")


def test_carry_round_trip(pair):
    jex, tex = pair
    for frag in jex.holder.iter_fragments():
        mine = tex.holder.fragment(frag.index, frag.frame, frag.view,
                                   frag.slice)
        assert np.array_equal(mine.positions(),
                              frag.storage.all_positions())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_count_trees(pair, seed):
    jex, tex = pair
    rng = np.random.default_rng(seed)
    for _ in range(12):
        q = f"Count({_rand_tree(rng, 2)})"
        assert tex.execute("d", q) == jex.execute("d", q), q


@pytest.mark.parametrize("seed", [4, 5])
def test_bitmap_calls(pair, seed):
    jex, tex = pair
    rng = np.random.default_rng(seed)
    for _ in range(6):
        q = _rand_tree(rng, 1)
        assert _norm(tex.execute("d", q)) == _norm(jex.execute("d", q)), q


@pytest.mark.parametrize("seed", [6, 7])
def test_topn_exact_forms(pair, seed):
    jex, tex = pair
    rng = np.random.default_rng(seed)
    for _ in range(8):
        ids = sorted(set(int(x) for x in rng.integers(N_ROWS + 1, size=4)))
        q = f"TopN({_rand_tree(rng, 1)}, frame=f, n=5, ids={ids})"
        assert _norm(tex.execute("d", q)) == _norm(jex.execute("d", q)), q


def test_topn_streaming_form(pair, monkeypatch):
    """The streaming form (candidate block above TOPN_BLOCK_BYTES) gives
    the resident form's answer."""
    jex, tex = pair
    from pilosa_tpu_torch.parallel import mesh as torch_mesh
    q = ("TopN(Union(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)),"
         f" frame=f, n=3, ids={list(range(N_ROWS))})")
    want = _norm(jex.execute("d", q))
    monkeypatch.setattr(torch_mesh, "TOPN_BLOCK_BYTES", 1 << 20)
    assert _norm(tex.execute("d", q)) == want


def test_run_container_frame(pair):
    jex, tex = pair
    for op in ("Intersect", "Union", "Difference"):
        q = (f"Count({op}(Bitmap(rowID=1, frame=rf),"
             f" Bitmap(rowID=2, frame=rf)))")
        assert tex.execute("d", q) == jex.execute("d", q), q
    q = f"TopN(Bitmap(rowID=0, frame=rf), frame=rf, ids={list(range(6))})"
    assert _norm(tex.execute("d", q)) == _norm(jex.execute("d", q))


def test_tie_order(pair):
    jex, tex = pair
    q = "TopN(Bitmap(rowID=9, frame=t), frame=t, n=2, ids=[3, 1, 0, 2, 9])"
    got = _norm(tex.execute("d", q))
    assert got == _norm(jex.execute("d", q))
    # count descending, then row id ascending among the tied rows
    assert got == [[(9, 40), (0, 10), (1, 10), (2, 10), (3, 10)]]


def test_absent_fragments_count_zero(pair):
    jex, tex = pair
    for q in ("Count(Bitmap(rowID=1, frame=g))",
              "Count(Union(Bitmap(rowID=2, frame=g), Bitmap(rowID=1,"
              " frame=g)))",
              "Count(Bitmap(rowID=77, frame=f))",
              "TopN(Bitmap(rowID=1, frame=g), frame=g, ids=[0, 1, 2, 8])"):
        assert _norm(tex.execute("d", q)) == _norm(jex.execute("d", q)), q


def test_multi_call_query(pair):
    jex, tex = pair
    q = ("Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2,"
         " frame=f))) TopN(Bitmap(rowID=3, frame=f), frame=f,"
         " ids=[0, 1, 2]) Count(Union(Bitmap(rowID=4, frame=rf),"
         " Bitmap(rowID=5, frame=f)))")
    assert _norm(tex.execute("d", q)) == _norm(jex.execute("d", q))


def test_wide_union_1000(tmp_path):
    """A 1000-child Union, one slice: the JAX host path (its resident
    slabs would pad to 8 slices) against the port's device leg."""
    rng = np.random.default_rng(9)
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    f = jh.create_index("w").create_frame("f")
    rows = rng.integers(0, 1200, size=20000).astype(np.uint64)
    cols = rng.integers(0, SLICE_WIDTH, size=20000).astype(np.uint64)
    f.import_bits(rows, cols)
    th, tex = carry.holder_from_state(str(tmp_path / "port"),
                                      export_state(jh), device="cpu",
                                      executor_options=PIN_DEVICE)
    jex = JaxExecutor(jh, host="local", use_mesh=False)
    union = "Union(" + ", ".join(f"Bitmap(rowID={i}, frame=f)"
                                 for i in range(1000)) + ")"
    for q in (f"Count({union})",
              f"Count(Difference(Bitmap(rowID=1100, frame=f), {union}))",
              f"TopN({union}, frame=f, ids=[1001, 1002, 5, 1150])"):
        assert _norm(tex.execute("w", q)) == _norm(jex.execute("w", q))
    jex.close()
    jh.close()
    th.close()


def test_setbit_ages_out_resident_slabs(tmp_path):
    rng = np.random.default_rng(10)
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    f = jh.create_index("s").create_frame("f")
    for row in (1, 2):
        cols = rng.choice(2 * SLICE_WIDTH, size=3000, replace=False)
        f.import_bits(np.full(3000, row, np.uint64), cols.astype(np.uint64))
    th, tex = carry.holder_from_state(str(tmp_path / "port"),
                                      export_state(jh), device="cpu",
                                      executor_options=PIN_DEVICE)
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1)
    q = ("Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2,"
         " frame=f))) TopN(Bitmap(rowID=1, frame=f), frame=f, ids=[1, 2])")
    before = tex.execute("s", q)
    assert _norm(before) == _norm(jex.execute("s", q))
    cache = residency.device_cache()
    hits = cache.hits
    assert _norm(tex.execute("s", q)) == _norm(before)  # warm: resident
    assert cache.hits > hits
    frag = jh.fragment("s", "f", "standard", 1)
    taken = set(frag.row(1).bits().tolist()) | \
        set(frag.row(2).bits().tolist())
    col = next(c for c in range(SLICE_WIDTH, 2 * SLICE_WIDTH)
               if c not in taken)
    w = f"SetBit(frame=f, rowID=1, columnID={col}) " \
        f"SetBit(frame=f, rowID=2, columnID={col})"
    assert tex.execute("s", w) == jex.execute("s", w)
    after = tex.execute("s", q)
    assert _norm(after) == _norm(jex.execute("s", q))
    assert after != before
    jex.close()
    jh.close()
    th.close()


@pytest.mark.parametrize("q", [
    "Count(Range(frame=f, rowID=1, start=\"2017-01-01T00:00\","
    " end=\"2017-02-01T00:00\"))",
    "Sum(frame=f, field=\"v\")",
    "SetFieldValue(frame=f, columnID=1, v=3)",
])
def test_later_slices_raise(pair, q):
    """Calls an earlier slice refused: the JAX package's answer now (0
    for a time Range over a frame without a time quantum) or its error
    text (no field ``v`` on frame ``f``)."""
    jex, tex = pair
    try:
        want = jex.execute("d", q)
    except Exception as e:  # noqa: BLE001 - the reference's error
        with pytest.raises(PilosaError) as got:
            tex.execute("d", q)
        assert str(got.value) == str(e) == "field not found: v"
        return
    assert tex.execute("d", q) == want == [0]


@pytest.mark.parametrize("q", [
    "Count(Bitmap(rowID=1, frame=nope))",
    "Count(Bitmap(frame=f))",
    "Count(Intersect())",
    "Count()",
    "TopN(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f), frame=f,"
    " ids=[1])",
    "SetBit(rowID=1, columnID=2)",
])
def test_errors_match(pair, q):
    jex, tex = pair
    with pytest.raises(Exception) as want:
        jex.execute("d", q)
    with pytest.raises(Exception) as got:
        tex.execute("d", q)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_empty_union_counts_zero(pair):
    jex, tex = pair
    q = "Count(Union())"
    assert tex.execute("d", q) == jex.execute("d", q) == [0]


@pytest.mark.parametrize("q", [
    # The sources of a TopN that holds an empty Union().
    "TopN(Union(), frame=f, ids=[0, 1, 2])",
    "TopN(Union(Bitmap(rowID=1, frame=g), Union()), frame=g, ids=[0, 1, 2])",
    "TopN(Intersect(Bitmap(rowID=1, frame=f), Union()), frame=f,"
    " ids=[0, 1, 2])",
    "TopN(Difference(Bitmap(rowID=1, frame=f), Union()), frame=f,"
    " ids=[0, 1, 2, 3])",
    "TopN(Difference(Union(), Bitmap(rowID=1, frame=f)), frame=f,"
    " ids=[0, 1, 2])",
    "TopN(Union(Union(), Union()), frame=f, ids=[0, 1])",
    # A source that folds to the empty set answers every form.
    "TopN(Union(), frame=f, n=2)",
    "TopN(Intersect(Union(), Bitmap(rowID=1, frame=f)), frame=f, ids=[1],"
    " threshold=3)",
    # An operand folded into the empty set is not evaluated.
    "TopN(Intersect(Bitmap(rowID=1, frame=nope), Union()), frame=f,"
    " ids=[0, 1])",
    "Count(Difference(Union(), Bitmap(frame=f)))",
    "Intersect(Union(), Intersect())",
    # ... but one that stays is, and raises as in the JAX package.
    "TopN(Union(Bitmap(rowID=1, frame=nope), Union()), frame=f, ids=[1])",
    "TopN(Difference(Bitmap(rowID=1, frame=nope), Union()), frame=f,"
    " ids=[1])",
    "TopN(Union(Intersect(), Union()), frame=f, ids=[1])",
    "TopN(Union(), frame=f, ids=[1], tanimotoThreshold=200)",
    # A query that writes is not folded; its answers stay the same.
    "SetBit(frame=t, rowID=9, columnID=0) TopN(Intersect(Bitmap(rowID=1,"
    " frame=f), Union()), frame=f, ids=[1])",
    "SetBit(frame=t, rowID=9, columnID=0) TopN(Union(Bitmap(rowID=1,"
    " frame=f), Union()), frame=f, ids=[1, 2])",
])
def test_empty_union_sources_match(pair, q):
    def outcome(ex):
        try:
            return _norm(ex.execute("d", q))
        except Exception as e:  # noqa: BLE001 - compared by name and text
            return (type(e).__name__, str(e))

    jex, tex = pair
    before = dict(cuda_kernels.LAUNCHES)
    assert outcome(tex) == outcome(jex)
    assert cuda_kernels.LAUNCHES == before


def test_no_kernel_launch_on_cpu(pair):
    _, tex = pair
    before = dict(cuda_kernels.LAUNCHES)
    tex.execute("d", "Count(Intersect(Bitmap(rowID=1, frame=f),"
                     " Bitmap(rowID=2, frame=f)))")
    assert cuda_kernels.LAUNCHES == before


def test_entry_point_runs_on_the_card_unless_asked(tmp_path):
    import torch
    from pilosa_tpu_torch.device import resolve_device
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    assert resolve_device("cpu") == torch.device("cpu")
    holder = Holder(str(tmp_path))
    holder.open()
    if torch.cuda.is_available():
        assert Executor(holder).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Executor(holder)
    holder.close()

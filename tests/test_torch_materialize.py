"""Bitmap-returning calls in the port against the JAX package: the
device materialize leg, the host wide fold and the bitmap-result cache.

The same seeded writes go into a JAX ``Holder`` and a port ``Holder``
through each package's own API: frame ``f`` (array and bitmap
containers), ``inv`` (inverse storage), ``tf`` (time quantum YMD,
timestamped bits) and ``v`` (a BSI field). Union/Intersect/Difference
of 8, 9 and 64 leaves, nested, over standard, inverse and time views,
and a field ``Range`` of every operator and both clamps, run through
the JAX executor on the virtual CPU mesh (``use_mesh=True,
mesh_min_slices=1``, its result cache off: it answers a second call of
one shape with the first's bits, ROADMAP fault 3.5) and through the
port's on ``device="cpu"``: identical bits. Spies show the port's
device leg taking a call of 8 or more leaves and a field Range, and not
a narrower call; the port's host leg (the device declined by its byte
bound) answers the same through ``Fragment.fold_rows``, which is held
to the JAX package's on the same fragment. The port's result cache
hits on a repeat, misses after a write to a leaf, and answers the
fault-3.5 pair right.
"""

import datetime as dt

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.frame import Field as JaxField
from pilosa_tpu.models.frame import FrameOptions as JaxFrameOptions
from pilosa_tpu.models.holder import Holder as JaxHolder

from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.frame import Field, FrameOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.parallel import mesh as torch_mesh
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.storage.fragment import Fragment

N_SLICES = 3
N_ROWS = 80
N_COLS = N_SLICES * SLICE_WIDTH
HOT_COLS = 12  # columns of frame inv that many rows hold


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


def _write_both(jh, th, rng):
    """The same data through each package's own API."""
    for h, F, FO in ((jh, JaxField, JaxFrameOptions),
                     (th, Field, FrameOptions)):
        idx = h.create_index("m")
        idx.create_frame("f")
        idx.create_frame("inv", FO(inverse_enabled=True))
        idx.create_frame("tf", FO(time_quantum="YMD"))
        idx.create_frame("v").create_field(F("amount", -100, 5000))
    writes = []
    window = SLICE_WIDTH + 65536 * 3  # one container of slice 1
    for row in range(N_ROWS):
        cols = rng.integers(0, N_COLS, size=200, dtype=np.uint64)
        if row % 5 == 0:  # dense rows share one container
            cols = np.concatenate([cols, window + rng.choice(
                65536, 50000, replace=False).astype(np.uint64)])
        writes.append(("f", np.full(len(cols), row, np.uint64), cols))
    inv_rows = rng.integers(0, 300, size=6000).astype(np.uint64)
    inv_cols = np.concatenate([
        rng.integers(0, HOT_COLS, size=3000),
        rng.integers(0, N_COLS, size=3000)]).astype(np.uint64)
    writes.append(("inv", inv_rows, inv_cols))
    t_rows = rng.integers(0, 10, size=4000).astype(np.uint64)
    t_cols = rng.integers(0, N_COLS, size=4000, dtype=np.uint64)
    days = rng.integers(0, 200, size=4000)
    stamps = [dt.datetime(2017, 1, 1) + dt.timedelta(days=int(d),
                                                     hours=int(d % 24))
              for d in days]
    vcols = rng.integers(0, N_COLS, size=6000, dtype=np.uint64)
    vvals = rng.integers(-100, 5001, size=6000)
    for h in (jh, th):
        for frame, rows, cols in writes:
            h.frame("m", frame).import_bits(rows, cols)
        h.frame("m", "tf").import_bits(t_rows, t_cols, timestamps=stamps)
        h.frame("m", "v").import_field_values("amount", vcols, vvals)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    th = Holder(str(tmp_path_factory.mktemp("port")))
    th.open()
    _write_both(jh, th, np.random.default_rng(93))
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1,
                      result_cache_bits=-1)
    tex = Executor(th, device="cpu", result_cache_bits=-1,
                   mesh_min_slices=1)
    yield jex, tex
    assert jex.device_fallbacks == 0
    jex.close()
    jh.close()
    th.close()


def _bits(results):
    return [[int(b) for b in r.bits()] for r in results]


def _bm(r, frame="f"):
    return f"Bitmap(rowID={r}, frame={frame})"


def _col(c):
    return f"Bitmap(columnID={c}, frame=inv)"


def _trange(r, a, b):
    return (f'Range(frame=tf, rowID={r}, start="2017-{a}T00:00",'
            f' end="2017-{b}T00:00")')


def _fold(op, leaves):
    return f"{op}({', '.join(leaves)})"


def _queries():
    """name → (PQL, leaves the device leg reads, or 0 for the host)."""
    rng = np.random.default_rng(17)
    rows = rng.permutation(N_ROWS).tolist()
    dense = list(range(0, N_ROWS, 5))
    q = {}
    for n in (8, 9, 64):
        q[f"union{n}"] = (_fold("Union", [_bm(r) for r in rows[:n]]), n)
        q[f"difference{n}"] = (_fold("Difference",
                                     [_bm(dense[0])]
                                     + [_bm(r) for r in rows[1:n]]), n)
    q["intersect8_dense"] = (_fold("Intersect",
                                   [_bm(r) for r in dense[:8]]), 8)
    q["intersect9_mixed"] = (_fold("Intersect",
                                   [_bm(r) for r in dense[:8]]
                                   + [_bm(rows[0])]), 9)
    q["nested9"] = (_fold("Union", [
        _fold("Intersect", [_bm(0), _bm(5)]),
        _fold("Difference", [_bm(rows[1]), _bm(rows[2]), _bm(rows[3])]),
        _bm(rows[4]), _fold("Union", [_bm(r) for r in rows[5:8]])]), 9)
    q["nested_difference"] = (_fold("Difference", [
        _fold("Union", [_bm(r) for r in dense[:6]]),
        _fold("Intersect", [_bm(dense[0]), _bm(dense[1])]),
        _bm(rows[9])]), 9)
    q["narrow7"] = (_fold("Union", [_bm(r) for r in rows[:7]]), 0)
    q["narrow_nested7"] = (_fold("Union", [
        _fold("Intersect", [_bm(0), _bm(5)]),
        _fold("Union", [_bm(r) for r in rows[:5]])]), 0)
    q["inverse8"] = (_fold("Union", [_col(c) for c in range(8)]), 8)
    q["inverse_intersect9"] = (_fold("Intersect",
                                     [_col(c) for c in range(2)]
                                     + [_col(c) for c in range(2, 9)]), 9)
    q["inverse_difference64"] = (_fold("Difference", [
        _col(c % HOT_COLS) if c < HOT_COLS else _col(c * 7919)
        for c in range(64)]), 64)
    q["time8"] = (_fold("Union", [_trange(r, "02-01", "05-15")
                                  for r in range(4)]), None)
    q["time_difference"] = (_fold("Difference", [
        _trange(1, "01-01", "07-01"), _trange(2, "03-05", "03-20"),
        _bm(rows[0])]), None)
    q["time_and_rows"] = (_fold("Intersect", [
        _fold("Union", [_bm(r) for r in dense[:7]]),
        _trange(3, "01-01", "06-01")]), None)
    q["field_and_rows"] = (_fold("Intersect", [
        _fold("Union", [_bm(r) for r in rows[:8]]),
        "Range(frame=v, amount > 100)"]), None)
    return q


def _spy(monkeypatch):
    calls = []
    for name in ("materialize_expr_sharded", "bsi_range_sharded"):
        real = getattr(torch_mesh, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(torch_mesh, name, spy)
    return calls


@pytest.mark.parametrize("name", sorted(_queries()))
def test_bitmap_calls(pair, monkeypatch, name):
    jex, tex = pair
    q, n_leaves = _queries()[name]
    calls = _spy(monkeypatch)
    got = _bits(tex.execute("m", q))
    assert got == _bits(jex.execute("m", q))
    if n_leaves == 0:
        assert calls == []
    else:
        assert calls == ["materialize_expr_sharded"]
    if n_leaves:
        leaves = []
        tex._compile_device_expr("m", _parse(q).calls[0], leaves)
        assert len(leaves) == n_leaves


@pytest.mark.parametrize("name", sorted(_queries()))
def test_bitmap_calls_host_leg(pair, monkeypatch, name):
    """The device declined by its byte bound: the host answers, a wide
    plain fold through Fragment.fold_rows."""
    jex, tex = pair
    host = Executor(tex.holder, device="cpu", result_cache_bits=-1,
                    materialize_device_bytes=0)
    q, n_leaves = _queries()[name]
    calls = _spy(monkeypatch)
    folds = []
    real = Fragment.fold_rows

    def fold_rows(frag, op, rids):
        folds.append(len(rids))
        return real(frag, op, rids)
    monkeypatch.setattr(Fragment, "fold_rows", fold_rows)
    assert _bits(host.execute("m", q)) == _bits(jex.execute("m", q))
    assert calls == []
    # A fold of 8 or more plain rows of one view is one pass a slice.
    plain = (n_leaves and name.startswith(("union", "difference",
                                           "intersect8", "inverse")))
    if plain:
        assert folds and set(folds) == {n_leaves}


def _parse(q):
    from pilosa_tpu_torch.pql.parser import parse
    return parse(q)


def _field_ranges():
    return {"eq": ("Range(frame=v, amount == 77)", True),
            "ne": ("Range(frame=v, amount != 77)", True),
            "lt": ("Range(frame=v, amount < 1000)", True),
            "le": ("Range(frame=v, amount <= -3)", True),
            "gt": ("Range(frame=v, amount > 4000)", True),
            "ge": ("Range(frame=v, amount >= 0)", True),
            "between": ("Range(frame=v, amount >< [-50, 2500])", True),
            "between_edges": ("Range(frame=v, amount >< [-100, 5000])",
                              False),
            "clamp_all": ("Range(frame=v, amount < 100000)", False),
            "clamp_none": ("Range(frame=v, amount > 100000)", False),
            "clamp_none_low": ("Range(frame=v, amount < -500)", False)}


@pytest.mark.parametrize("name", sorted(_field_ranges()))
def test_field_range(pair, monkeypatch, name):
    jex, tex = pair
    q, on_device = _field_ranges()[name]
    calls = _spy(monkeypatch)
    assert _bits(tex.execute("m", q)) == _bits(jex.execute("m", q))
    assert calls == (["bsi_range_sharded"] if on_device else [])


def test_count_takes_no_materialize(pair, monkeypatch):
    jex, tex = pair
    calls = _spy(monkeypatch)
    for q in ("Count(" + _queries()["union64"][0] + ")",
              "Count(Range(frame=v, amount > 4000))",
              "Count(Range(frame=v, amount > 100000))"):
        assert tex.execute("m", q) == jex.execute("m", q)
    assert calls == []


# -- Fragment.fold_rows against the JAX package's ---------------------------

def _row_lists():
    rng = np.random.default_rng(23)
    rows = rng.permutation(N_ROWS).tolist()
    return {"eight": rows[:8], "sixty_four": rows[:64],
            "dense": list(range(0, N_ROWS, 5)),
            "duplicates": rows[:6] + rows[:3],
            "first_repeated": rows[:5] + [rows[0]],
            "absent_rows": [rows[0], 10**6, rows[1], 10**6 + 1],
            "one": [rows[2]], "empty": []}


@pytest.mark.parametrize("op", ["or", "and", "andnot"])
@pytest.mark.parametrize("rows", sorted(_row_lists()))
def test_fold_rows(pair, op, rows):
    jex, tex = pair
    ids = _row_lists()[rows]
    for s in range(N_SLICES):
        mine = tex.holder.fragment("m", "f", "standard", s)
        ref = jex.holder.fragment("m", "f", "standard", s)
        got, want = mine.fold_rows(op, ids), ref.fold_rows(op, ids)
        assert got.dtype == want.dtype == np.uint64
        assert np.array_equal(got, want)


def test_fold_rows_refuses_an_unknown_op(pair):
    _, tex = pair
    with pytest.raises(ValueError, match="unknown fold op"):
        tex.holder.fragment("m", "f", "standard", 0).fold_rows("xor", [1])


# -- the bitmap-result cache --------------------------------------------------

def _cached(tex):
    return Executor(tex.holder, device="cpu", mesh_min_slices=1)


def test_result_cache_hit_after_repeat(pair, monkeypatch):
    jex, tex = pair
    ex = _cached(tex)
    q = _queries()["union9"][0]
    calls = _spy(monkeypatch)
    first = _bits(ex.execute("m", q))
    second = _bits(ex.execute("m", q))
    assert first == second == _bits(jex.execute("m", q))
    assert calls == ["materialize_expr_sharded"]
    assert (ex.result_cache_misses, ex.result_cache_hits) == (1, 1)
    # The hit is a copy-on-write hand-out: changing it leaves the cache.
    got = ex.execute("m", q)[0]
    col = int(got.bits()[0])
    got.clear_bit(col)
    assert _bits(ex.execute("m", q)) == first


def test_result_cache_misses_after_a_write_to_a_leaf(pair):
    jex, tex = pair
    ex = _cached(tex)
    rows = np.random.default_rng(17).permutation(N_ROWS).tolist()[:8]
    q = _fold("Union", [_bm(r) for r in rows])
    before = _bits(ex.execute("m", q))
    col = 2 * SLICE_WIDTH + 777_777
    assert col not in before[0]
    w = f"SetBit(frame=f, rowID={rows[3]}, columnID={col})"
    assert tex.execute("m", w) == jex.execute("m", w) == [True]
    after = _bits(ex.execute("m", q))
    assert col in after[0]
    assert after == _bits(jex.execute("m", q))
    assert ex.result_cache_hits == 0


def test_result_cache_keys_on_leaf_rows(pair):
    """The fault-3.5 pair: two Unions of one shape over one view."""
    jex, tex = pair
    ex = _cached(tex)
    a = _fold("Union", [_bm(1), _bm(2)])
    b = _fold("Union", [_bm(3), _bm(4)])
    got_a, got_b = _bits(ex.execute("m", a)), _bits(ex.execute("m", b))
    assert got_a == _bits(jex.execute("m", a))
    assert got_b == _bits(jex.execute("m", b))
    assert got_a != got_b
    assert len(ex._bitmap_results) == 2
    assert _bits(ex.execute("m", b)) == got_b
    assert ex.result_cache_hits == 1


def test_result_cache_bounds(pair):
    jex, tex = pair
    ex = Executor(tex.holder, device="cpu", result_cache_entries=2,
                  mesh_min_slices=1)
    qs = [_fold("Union", [_bm(r), _bm(r + 1)]) for r in range(1, 8, 2)]
    for q in qs:
        assert _bits(ex.execute("m", q)) == _bits(jex.execute("m", q))
    assert len(ex._bitmap_results) == 2
    small = Executor(tex.holder, device="cpu", result_cache_bits=10,
                     mesh_min_slices=1)
    assert _bits(small.execute("m", qs[0])) == _bits(jex.execute("m", qs[0]))
    assert len(small._bitmap_results) == 0

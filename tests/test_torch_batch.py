"""The fused multi-call batch of the port against the JAX package.

The same seeded writes go into a JAX ``Holder`` and a port ``Holder``
through each package's own API: rows with array and bitmap containers
in frame ``f``, TopN candidates with a ``cat`` row attribute in ``t``,
a BSI field ``amount`` in ``v`` and a filter row in ``seg``. Multi-call
bodies of Counts and exact-count TopNs — every mix the JAX
``_device_batch_run`` accepts, and runs cut by a call that does not
fuse, by the 16-call cap and by the byte budget — run through the JAX
executor on the virtual CPU mesh (``use_mesh=True,
mesh_min_slices=1``) and the port's on ``device="cpu"``: identical
answers. Spies on the port show one fused device call per run
(``count_exprs_sharded`` or ``fused_tree_sharded``), the run lengths, a
Count the planner proved empty answering 0 with no leaf, and a
filtered Sum as ONE batched count of depth+1 expressions.
``execute_partial`` gives the same prefix and error text in both.
"""

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.frame import Field as JaxField
from pilosa_tpu.models.holder import Holder as JaxHolder

from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.frame import Field
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import cuda_kernels
from pilosa_tpu_torch.parallel import mesh as torch_mesh
from pilosa_tpu_torch.parallel import residency

N_SLICES = 4
N_ROWS = 20
N_CAND = 40
SLAB = N_SLICES * SLICE_WIDTH // 8  # bytes of one leaf slab


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


def _write_both(jh, th, rng):
    """The same data through each package's own API."""
    n_cols = N_SLICES * SLICE_WIDTH
    for h, F in ((jh, JaxField), (th, Field)):
        idx = h.create_index("i")
        for name in ("f", "t", "seg"):
            idx.create_frame(name)
        idx.create_frame("v").create_field(F("amount", -50, 1000))
    writes = []
    for row in range(N_ROWS):
        cols = rng.integers(0, n_cols, size=300, dtype=np.uint64)
        if row % 4 == 0:  # half of one container: a bitmap container
            start = int(rng.integers(0, n_cols // 65536)) * 65536
            cols = np.concatenate([cols, start + rng.choice(
                65536, 32768, replace=False).astype(np.uint64)])
        writes.append(("f", np.full(len(cols), row, np.uint64), cols))
    for row in range(N_CAND):
        cols = rng.integers(0, n_cols, size=int(rng.integers(50, 3000)),
                            dtype=np.uint64)
        writes.append(("t", np.full(len(cols), row, np.uint64), cols))
    seg = rng.integers(0, n_cols, size=20000, dtype=np.uint64)
    writes.append(("seg", np.ones(len(seg), np.uint64), seg))
    vcols = rng.integers(0, n_cols, size=5000, dtype=np.uint64)
    vvals = rng.integers(-50, 1001, size=5000)
    for h in (jh, th):
        for frame, rows, cols in writes:
            h.frame("i", frame).import_bits(rows, cols)
        h.frame("i", "v").import_field_values("amount", vcols, vvals)
        store = h.frame("i", "t").row_attr_store
        for r in range(N_CAND):
            store.set_attrs(r, {"cat": r % 3})


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    th = Holder(str(tmp_path_factory.mktemp("port")))
    th.open()
    _write_both(jh, th, np.random.default_rng(81))
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1,
                      result_cache_bits=-1)
    tex = Executor(th, device="cpu", mesh_min_slices=1)
    yield jex, tex
    assert jex.device_fallbacks == 0
    jex.close()
    jh.close()
    th.close()


def _norm(results):
    out = []
    for r in results:
        if hasattr(r, "bits"):
            out.append([int(b) for b in r.bits()])
        elif hasattr(r, "count") and hasattr(r, "value"):
            out.append(("valcount", r.value, r.count))
        elif isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        else:
            out.append(r)
    return out


def _bm(r, frame="f"):
    return f"Bitmap(rowID={r}, frame={frame})"


def _ids(rng, n=12):
    return sorted(rng.choice(N_CAND, size=n, replace=False).tolist())


def _topn(src, ids, extra=""):
    return f"TopN({src}, frame=t, ids={ids}{extra})"


class _Spy:
    """Counts the port's fused device calls and batch-run lengths."""

    def __init__(self, monkeypatch, tex):
        self.fused = []
        self.runs = []
        for name in ("count_exprs_sharded", "fused_tree_sharded"):
            real = getattr(torch_mesh, name)

            def spy(*a, _real=real, _name=name):
                self.fused.append(_name)
                return _real(*a)
            monkeypatch.setattr(torch_mesh, name, spy)
        real_run = tex._device_batch_run

        def run(*a):
            out = real_run(*a)
            if out is not None:
                self.runs.append(out[1])
            return out
        monkeypatch.setattr(tex, "_device_batch_run", run)


def _bodies():
    rng = np.random.default_rng(5)
    ids_a, ids_b = _ids(rng), _ids(rng, 20)
    inter = f"Intersect({_bm(1)}, {_bm(2)})"
    return {
        "two_counts": f"Count({_bm(1)}) Count({inter})",
        "sixteen_counts": " ".join(
            f"Count({op}({_bm(r)}, {_bm((r + 5) % N_ROWS)}))"
            for r, op in zip(range(16), ["Union", "Intersect",
                                         "Difference"] * 6)),
        "count_topn": f"Count(Union({_bm(3)}, {_bm(4)})) "
                      + _topn(_bm(3), ids_a),
        "topn_count": _topn(inter, ids_b) + f" Count({_bm(7)})",
        "two_topns": _topn(_bm(5), ids_a) + " " + _topn(
            f"Difference({_bm(6)}, {_bm(8)})", ids_b),
        "four_counts_two_topns": " ".join([
            f"Count({_bm(1)})", _topn(_bm(2), ids_a),
            f"Count({inter})", f"Count(Union({_bm(9)}, {_bm(10)}))",
            _topn(f"Union({_bm(11)}, {_bm(1)})", ids_b),
            f"Count(Difference({_bm(12)}, {_bm(2)}))"]),
        "topn_attr_filter": _topn(_bm(4), ids_b,
                                  ', field="cat", filters=[0, 1]')
                            + f" Count({_bm(4)})",
        "topn_n_no_trim": _topn(_bm(12), ids_b, ", n=3") + " "
                          + _topn(_bm(12), ids_a, ", threshold=1"),
        "shared_leaves": " ".join(f"Count(Intersect({_bm(0)}, {_bm(r)}))"
                                  for r in range(1, 6)),
        "field_ranges": "Count(Range(frame=v, amount > 100)) "
                        "Count(Range(frame=v, amount >< [0, 500])) "
                        "Count(Intersect(Range(frame=v, amount < 10),"
                        f" {_bm(1, 'seg')}))",
        "sourced_by_range": _topn("Range(frame=v, amount >= 300)", ids_a)
                            + " Count(Range(frame=v, amount == 7))",
        "nested_trees": " ".join(
            f"Count(Union(Intersect({_bm(r)}, {_bm(r + 1)}),"
            f" Difference({_bm(r + 2)}, {_bm(r + 3)})))"
            for r in range(0, 12, 3)),
    }


@pytest.mark.parametrize("name", sorted(_bodies()))
def test_batch_mixes(pair, monkeypatch, name):
    jex, tex = pair
    q = _bodies()[name]
    spy = _Spy(monkeypatch, tex)
    fetches = torch_mesh.FETCHES["host"]
    assert _norm(tex.execute("i", q)) == _norm(jex.execute("i", q))
    # The whole body is one run, one fused device call, one host fetch.
    assert len(spy.runs) == 1
    assert torch_mesh.FETCHES["host"] - fetches == 1
    assert spy.fused == (["fused_tree_sharded"] if "TopN" in q
                         else ["count_exprs_sharded"])


def _cut_cases():
    rng = np.random.default_rng(6)
    ids = _ids(rng)
    counts = [f"Count({_bm(r)})" for r in range(N_ROWS)]
    return {
        # (body, port executor options, JAX instance attributes, runs)
        "bitmap_call": (" ".join(counts[:2] + [_bm(3)] + counts[3:5]),
                        {}, {}, [2, 2]),
        "threshold_topn": (" ".join(
            counts[:1] + [_topn(_bm(2), ids, ", threshold=2")]
            + counts[2:4]), {}, {}, [2]),
        "tanimoto_topn": (" ".join(
            counts[:2] + [_topn(_bm(2), ids, ", tanimotoThreshold=30")]
            + counts[2:4]), {}, {}, [2, 2]),
        "sourceless_topn": (" ".join(counts[:1] + ["TopN(frame=t, n=3)"]
                                     + counts[2:5]), {}, {}, [3]),
        "filters_leave_nothing": (" ".join(
            counts[:2] + [_topn(_bm(2), ids, ', field="cat", filters=[7]')]
            + counts[2:4]), {}, {}, [2, 2]),
        # The planner proves an empty Union empty: its Count answers 0
        # inside the run.
        "empty_union": (" ".join(["Count(Union())"] + counts[:3]), {}, {},
                        [4]),
        "cap": (" ".join(counts), {}, {}, [16, 4]),
        "cap_three": (" ".join(counts[:7]), {"batch_max_counts": 3},
                      {"_BATCH_MAX_COUNTS": 3}, [3, 3]),
        "budget": (" ".join(counts[:5]),
                   {"materialize_device_bytes": 3 * SLAB},
                   {"_MATERIALIZE_DEVICE_BYTES": 3 * SLAB}, [3, 2]),
        "budget_topn_blocks": (" ".join(
            [_topn(_bm(1), ids), _topn(_bm(1), ids), counts[2]]),
            {"materialize_device_bytes": (len(ids) + 2) * SLAB},
            {"_MATERIALIZE_DEVICE_BYTES": (len(ids) + 2) * SLAB}, [2]),
    }


@pytest.mark.parametrize("name", sorted(_cut_cases()))
def test_batch_runs_cut(pair, monkeypatch, name):
    jex, tex = pair
    q, opts, jattrs, runs = _cut_cases()[name]
    tex = Executor(tex.holder, device="cpu", mesh_min_slices=1, **opts)
    for k, v in jattrs.items():
        monkeypatch.setattr(jex, k, v)
    spy = _Spy(monkeypatch, tex)
    assert _norm(tex.execute("i", q)) == _norm(jex.execute("i", q))
    assert spy.runs == runs


def test_short_circuited_count_adds_no_leaf(pair, monkeypatch):
    jex, tex = pair
    empty = 10**6  # a row with no bit: the planner proves the tree empty
    q = (f"Count({_bm(1)}) Count(Intersect({_bm(15)}, {_bm(empty)})) "
         f"Count({_bm(2)})")
    asked = []
    real = tex._leaf_device_array

    def leaf_array(index, leaf, slices):
        asked.append(leaf)
        return real(index, leaf, slices)
    monkeypatch.setattr(tex, "_leaf_device_array", leaf_array)
    spy = _Spy(monkeypatch, tex)
    got = _norm(tex.execute("i", q))
    assert got == _norm(jex.execute("i", q))
    assert got[1] == 0
    assert spy.runs == [3] and spy.fused == ["count_exprs_sharded"]
    assert sorted(asked) == [("f", "standard", 1), ("f", "standard", 2)]


def test_short_circuited_run_launches_nothing(pair, monkeypatch):
    jex, tex = pair
    q = " ".join(f"Count(Intersect({_bm(r)}, {_bm(10**6 + r)}))"
                 for r in range(3))
    spy = _Spy(monkeypatch, tex)
    assert _norm(tex.execute("i", q)) == _norm(jex.execute("i", q)) \
        == [0, 0, 0]
    assert spy.runs == [3] and spy.fused == []


@pytest.mark.parametrize("body,n_done", [
    (f"Count({_bm(1)}) Count({_bm(2)}) Count(Bitmap(rowID=1, frame=nope))"
     f" Count({_bm(3)})", 2),
    (f"Count({_bm(1)}) SetBit(frame=f, rowID=3, columnID=5)"
     f" Count(Bitmap(rowID=1, frame=nope)) Count({_bm(3)})", 2),
    (f"Count({_bm(4)}) Count({_bm(5)}) Count({_bm(6)})"
     " SetBit(frame=nope, rowID=1, columnID=1)", 3),
    ("Count(Bitmap(rowID=1, frame=nope))", 0),
])
def test_execute_partial(pair, body, n_done):
    jex, tex = pair
    got, err = tex.execute_partial("i", body)
    want, jerr = jex.execute_partial("i", body)
    assert len(got) == n_done
    assert _norm(got) == _norm(want)
    assert str(err) == str(jerr) and err is not None


def test_execute_partial_without_error(pair):
    jex, tex = pair
    q = f"Count({_bm(1)}) Count({_bm(2)}) {_topn(_bm(3), [1, 2, 3])}"
    got, err = tex.execute_partial("i", q)
    want, jerr = jex.execute_partial("i", q)
    assert err is None and jerr is None
    assert _norm(got) == _norm(want)


def test_execute_partial_refuses_bulk_attrs(pair):
    _, tex = pair
    with pytest.raises(Exception, match="bulk attrs"):
        tex.execute_partial("i", "SetRowAttrs(frame=t, rowID=1, x=1)")


@pytest.mark.parametrize("q", [
    "Sum(frame=v, field=amount)",
    f"Sum({_bm(1, 'seg')}, frame=v, field=amount)",
    f"Sum(Intersect({_bm(1, 'seg')}, {_bm(2)}), frame=v, field=amount)",
])
def test_sum_is_one_batched_count(pair, monkeypatch, q):
    jex, tex = pair
    calls = []
    for name in ("expr_count_batch", "expr_count_rows"):
        real = getattr(cuda_kernels, name)

        def spy(exprs, leaves, _real=real, _name=name):
            calls.append((_name, len(exprs) if _name == "expr_count_batch"
                          else 1))
            return _real(exprs, leaves)
        monkeypatch.setattr(cuda_kernels, name, spy)
    fetches = torch_mesh.FETCHES["host"]
    assert _norm(tex.execute("i", q)) == _norm(jex.execute("i", q))
    depth = tex.holder.frame("i", "v").field("amount").bit_depth
    assert calls == [("expr_count_batch", depth + 1)]
    assert torch_mesh.FETCHES["host"] - fetches == 1


def test_multi_call_count_is_one_batched_count(pair, monkeypatch):
    jex, tex = pair
    q = " ".join(f"Count(Union({_bm(r)}, {_bm(r + 1)}))" for r in range(16))
    calls = []
    real = cuda_kernels.expr_count_batch

    def spy(exprs, leaves):
        calls.append(len(exprs))
        out = real(exprs, leaves)
        assert tuple(out.shape) == (len(exprs), N_SLICES)
        return out
    monkeypatch.setattr(cuda_kernels, "expr_count_batch", spy)
    assert _norm(tex.execute("i", q)) == _norm(jex.execute("i", q))
    assert calls == [16]

"""Every form of TopN in the port against the JAX package on one state.

A JAX ``Holder`` is filled from a seed, each frame by one import (so
both packages' count caches see the same rows in the same order); its
state goes into the port through ``carry.holder_from_state`` with the
frames' options (LRU and ranked caches, a large and a small cache
size), and the JAX ``Executor`` runs on the virtual CPU mesh
(``use_mesh=True, mesh_min_slices=1``) while the port's runs on
``device="cpu"``, where the kernel wrappers compute their plain
versions. Every answer must be identical: the same pairs, in the same
order, with the same exact counts, or the same error.

Each form runs at three sizes of the block gates, set alike on both
sides: the defaults (the resident device leg and the device top-k), a
``TOPN_BLOCK_BYTES`` of 8 candidate rows (the streaming device leg; the
sourceless refetch of more candidates on the host) and both gates at 0 (every candidate phase on the host, slice by
slice). Rank caches re-rank at most every 10 s; tests that write force
``recalculate()`` on both sides or hold both to the same staleness, so
no answer depends on wall time.
"""

import time

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.frame import FrameOptions as JaxFrameOptions
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.parallel import mesh as jax_mesh

from pilosa_tpu_torch import carry
from pilosa_tpu_torch.executor import Executor as TorchExecutor
from pilosa_tpu_torch.parallel import mesh as torch_mesh
from pilosa_tpu_torch.parallel import residency

N_SLICES = 3
N_ROWS = 70
WINDOW = 4096  # columns of each slice the rows and sources share
FRAMES = {
    "f": {},
    "fr": {"cache_type": "ranked"},
    "fs": {"cache_size": 25},
    "frs": {"cache_type": "ranked", "cache_size": 25},
}
SRC = "Bitmap(rowID=1, frame=src)"
SPARSE = "Bitmap(rowID=2, frame=src)"
# Rows N_ROWS..N_ROWS+3 of every TopN frame are near copies of this
# source row, so that Tanimoto forms answer pairs.
SIM = "Bitmap(rowID=3, frame=src)"
IDS = [0, 3, 5, 7, 11, 12, 30, 41, 66, 69, 70, 71, 72, 73, 500]
# The streaming leg's block budget: blocks of more than 8 candidates
# stream, in chunks of 8 rows.
STREAM_BLOCK_BYTES = 8 * N_SLICES * SLICE_WIDTH // 8


def export_state(holder) -> dict:
    return {(frag.index, frag.frame, frag.view, frag.slice):
            frag.storage.all_positions()
            for frag in holder.iter_fragments()}


def _norm(results):
    out = []
    for r in results:
        if isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        else:
            out.append(r)
    return out


def _outcome(ex, q):
    try:
        return _norm(ex.execute("d", q))
    except Exception as e:  # noqa: BLE001 - compared by name and text
        return (type(e).__name__, str(e))


def _frame_bits(rng, sim: dict, n_rows=N_ROWS):
    """(rows, cols) of one TopN frame: skewed row sizes inside the
    shared window, a few rows out of it, and four rows near the
    per-slice columns ``sim`` of source row 3 (equal, a subset, a
    superset, half of it and as many others)."""
    rows, cols = [], []
    for s, base in sim.items():
        extra = np.setdiff1d(rng.choice(WINDOW, size=80, replace=False),
                             base)
        near = [base, base[:70], np.union1d(base, extra[:20]),
                np.union1d(base[:40], extra[:40])]
        for i, c in enumerate(near):
            rows.append(np.full(len(c), n_rows + i, np.uint64))
            cols.append(c.astype(np.uint64) + np.uint64(s * SLICE_WIDTH))
    for r in range(n_rows):
        k = int(300 / (1 + (r * 37) % n_rows)) + int(rng.integers(1, 6))
        for s in range(N_SLICES):
            if (r + s) % 7 == 0:
                continue  # absent from this slice
            width = WINDOW if r % 5 else SLICE_WIDTH
            c = rng.choice(width, size=min(k, width), replace=False)
            rows.append(np.full(len(c), r, np.uint64))
            cols.append(c.astype(np.uint64) + np.uint64(s * SLICE_WIDTH))
    return np.concatenate(rows), np.concatenate(cols)


def _fill_jax(holder, rng):
    idx = holder.create_index("d")
    sim = {s: rng.choice(WINDOW, size=80, replace=False)
           for s in range(N_SLICES)}
    for name, opts in FRAMES.items():
        fr = idx.create_frame(name, JaxFrameOptions(**opts))
        fr.import_bits(*_frame_bits(rng, sim))
        for r in range(N_ROWS):
            fr.row_attr_store.set_attrs(r, {"cat": r % 3})
    src = idx.create_frame("src")
    rows, cols = [], []
    for s in range(N_SLICES):
        base = np.uint64(s * SLICE_WIDTH)
        dense = rng.choice(WINDOW, size=WINDOW // 3, replace=False)
        sparse = rng.choice(SLICE_WIDTH, size=40, replace=False)
        rows += [np.full(len(dense), 1, np.uint64),
                 np.full(len(sparse), 2, np.uint64),
                 np.full(len(sim[s]), 3, np.uint64)]
        cols += [dense.astype(np.uint64) + base,
                 sparse.astype(np.uint64) + base,
                 sim[s].astype(np.uint64) + base]
    src.import_bits(np.concatenate(rows), np.concatenate(cols))


def _make_pair(tmp_path_factory, seed):
    jh = JaxHolder(str(tmp_path_factory.mktemp("jax")))
    jh.open()
    _fill_jax(jh, np.random.default_rng(seed))
    row_attrs = {("d", name): {r: {"cat": r % 3} for r in range(N_ROWS)}
                 for name in FRAMES}
    th, tex = carry.holder_from_state(
        str(tmp_path_factory.mktemp("port")), export_state(jh),
        device="cpu", row_attrs=row_attrs,
        frame_options={("d", k): v for k, v in FRAMES.items()},
        executor_options={"mesh_min_slices": 1})
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1)
    return jh, jex, th, tex


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh, jex, th, tex = _make_pair(tmp_path_factory, 505)
    yield jex, tex
    assert jex.device_fallbacks == 0
    jex.close()
    jh.close()
    th.close()


@pytest.fixture(autouse=True)
def _fresh_device_cache():
    yield
    residency.device_cache().clear()


def _set_leg(monkeypatch, leg, *executors):
    """Set the block gates alike in both packages."""
    if leg == "resident":
        return
    gate = STREAM_BLOCK_BYTES if leg == "streaming" else 0
    monkeypatch.setattr(jax_mesh, "TOPN_BLOCK_BYTES", gate)
    monkeypatch.setattr(torch_mesh, "TOPN_BLOCK_BYTES", gate)
    if leg == "host":
        for ex in executors:
            monkeypatch.setattr(ex, "_TOPN_HOST_BLOCK_BYTES", 0)


FORMS = {
    "plain": "TopN(frame={F})",
    "n1": "TopN(frame={F}, n=1)",
    "n2": "TopN(frame={F}, n=2)",
    "n_above_rows": "TopN(frame={F}, n=1000)",
    "threshold2": "TopN(frame={F}, n=6, threshold=2)",
    "threshold5": "TopN(frame={F}, threshold=5)",
    "filters": 'TopN(frame={F}, n=8, field="cat", filters=[0, 2])',
    "ids": f"TopN(frame={{F}}, ids={IDS})",
    "ids_threshold": f"TopN(frame={{F}}, ids={IDS}, threshold=5)",
    "src": f"TopN({SRC}, frame={{F}}, n=6)",
    "src_all": f"TopN({SRC}, frame={{F}})",
    "src_filters": f'TopN({SRC}, frame={{F}}, n=5, field="cat",'
                   ' filters=[1])',
    "src_ids": f"TopN({SRC}, frame={{F}}, ids={IDS})",
    "src_ids_threshold": f"TopN({SRC}, frame={{F}}, ids={IDS},"
                         " threshold=3)",
    "src_threshold": f"TopN({SRC}, frame={{F}}, n=6, threshold=4)",
    "tanimoto1": f"TopN({SRC}, frame={{F}}, n=10, tanimotoThreshold=1)",
    "tanimoto50": f"TopN({SIM}, frame={{F}}, tanimotoThreshold=50)",
    "tanimoto50_n": f"TopN({SIM}, frame={{F}}, n=2, tanimotoThreshold=50)",
    "tanimoto100": f"TopN({SIM}, frame={{F}}, tanimotoThreshold=100)",
    "tanimoto101": f"TopN({SIM}, frame={{F}}, tanimotoThreshold=101)",
    "tanimoto_ids": f"TopN(Union({SIM}, {SPARSE}), frame={{F}}, ids={IDS},"
                    " tanimotoThreshold=30)",
    "sparse_src": f"TopN(Union({SPARSE}, Bitmap(rowID=9, frame=fr)),"
                  " frame={F}, n=4)",
    "folds_empty": f"TopN(Intersect({SRC}, Union()), frame={{F}}, n=5)",
}


@pytest.mark.parametrize("leg", ["resident", "streaming", "host"])
@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("form", list(FORMS))
def test_topn_form(pair, monkeypatch, form, frame, leg):
    jex, tex = pair
    _set_leg(monkeypatch, leg, jex, tex)
    q = FORMS[form].format(F=frame)
    want = _outcome(jex, q)
    assert _outcome(tex, q) == want, q
    if form == "tanimoto101":
        assert want == ("PilosaError",
                        "Tanimoto Threshold is from 1 to 100 only")
    elif form in ("plain", "src_all", "tanimoto1", "tanimoto50",
                  "tanimoto_ids"):
        assert want[0], q  # the form answers some pairs here


def test_forms_take_the_device_legs(pair, monkeypatch):
    """At the default gates the sourceless refetch is the device top-k,
    the filtered forms the device pruning and the sourced refetch the
    resident block count."""
    _, tex = pair
    calls = []
    for name in ("topn_topk_sharded", "topn_filtered_sharded",
                 "topn_exact_sharded"):
        fn = getattr(torch_mesh, name)
        monkeypatch.setattr(
            torch_mesh, name,
            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    for q, want in (("TopN(frame=fr, n=3)", "topn_topk_sharded"),
                    (FORMS["tanimoto_ids"].format(F="f"),
                     "topn_filtered_sharded"),
                    (FORMS["src"].format(F="fr"), "topn_exact_sharded"),
                    ("TopN(frame=f, n=3)", None)):  # the single pass
        calls.clear()
        tex.execute("d", q)
        assert (calls[0] if calls else None) == want, q


def _port_fragments(holder):
    return holder.iter_fragments()


def _recalculate(jh, th):
    for frag in list(jh.iter_fragments()) + _port_fragments(th):
        frag.recalculate_cache()


WRITE_FORMS = ["plain", "n2", "threshold5", "ids", "src", "src_ids",
               "tanimoto50", "filters"]


def _write_both(jex, tex, q):
    assert tex.execute("d", q) == jex.execute("d", q), q


def test_caches_follow_writes(tmp_path_factory, monkeypatch):
    """SetBit, ClearBit (a row down to zero too), a large and a small
    import: after each, every form on every frame gives the JAX
    package's answer."""
    jh, jex, th, tex = _make_pair(tmp_path_factory, 606)
    rng = np.random.default_rng(7)
    try:
        def check(tag):
            _recalculate(jh, th)
            for frame in FRAMES:
                for form in WRITE_FORMS:
                    q = FORMS[form].format(F=frame)
                    assert _outcome(tex, q) == _outcome(jex, q), (tag, q)

        for frame in FRAMES:
            writes = []
            for r in (60, 61, 2):
                for c in rng.choice(WINDOW, size=30, replace=False):
                    writes.append(f"SetBit(frame={frame}, rowID={r},"
                                  f" columnID={int(c)})")
            _write_both(jex, tex, " ".join(writes))
        check("setbit")
        for frame in FRAMES:
            frag = th.fragment("d", frame, "standard", 0)
            cols = frag.row(0).bits().tolist()
            _write_both(jex, tex, " ".join(
                f"ClearBit(frame={frame}, rowID=0, columnID={c})"
                for c in cols))
            assert frag.row_count(0) == 0
        check("clearbit")
        for frame in FRAMES:
            # One large import (a new slice's fragment) and one small
            # import into a large fragment.
            rows = rng.integers(0, N_ROWS + 5, size=2000).astype(np.uint64)
            cols = (rng.integers(0, WINDOW, size=2000)
                    + N_SLICES * SLICE_WIDTH).astype(np.uint64)
            small_rows = np.array([4, 4, 69], np.uint64)
            small_cols = np.array([7, 8, 9], np.uint64)
            for h in (jh, th):
                fr = h.frame("d", frame)
                fr.import_bits(rows, cols)
                fr.import_bits(small_rows, small_cols)
        check("import")
    finally:
        jex.close()
        jh.close()
        th.close()


def test_ranked_staleness_matches(tmp_path_factory):
    """Writes without a re-rank: both packages read their rank caches
    at the same staleness (re-ranking held off on both sides) and give
    the same answers — the per-slice path's cache counts, not fresh
    popcounts."""
    jh, jex, th, tex = _make_pair(tmp_path_factory, 707)
    try:
        far = time.monotonic() + 1e9
        for frag in list(jh.iter_fragments()) + _port_fragments(th):
            if hasattr(frag.cache, "_update_time"):
                frag.cache._update_time = far
        writes = " ".join(f"SetBit(frame=fr, rowID={r}, columnID={c})"
                          for r in (66, 67) for c in range(100, 160))
        _write_both(jex, tex, writes)
        for form in ("plain", "n2", "ids", "src", "src_ids"):
            q = FORMS[form].format(F="fr")
            assert _outcome(tex, q) == _outcome(jex, q), q
    finally:
        jex.close()
        jh.close()
        th.close()


@pytest.mark.parametrize("threshold,tanimoto", [
    (1, 0), (2, 0), (5, 0), (2**40, 0), (1, 1), (1, 50), (7, 99), (1, 100)])
def test_filtered_counts_match_jax(threshold, tanimoto):
    """``_filtered_counts`` on the same arrays as the JAX package's."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(threshold + tanimoto)
    words = 64
    leaves = rng.integers(0, 2**32, size=(2, 5, words), dtype=np.uint32)
    leaves[0, 1] = 0  # an empty source slice
    rows = rng.integers(0, 2**32, size=(5, 9, words), dtype=np.uint32)
    rows &= rng.integers(0, 2**32, size=rows.shape, dtype=np.uint32)
    rows[:, 0] = leaves[0] & leaves[1]  # rows equal to the source
    rows[:, 1] = 0
    expr = ("and", ("leaf", 0), ("leaf", 1))
    thr = min(threshold, 2**31 - 1)
    want = np.asarray(jax_mesh._filtered_counts(
        expr, jnp.asarray(rows), jnp.asarray(leaves), jnp.int32(thr),
        jnp.int32(tanimoto), None))
    got = torch_mesh._filtered_counts(
        expr, torch.from_numpy(rows.view(np.int32)),
        list(torch.from_numpy(leaves.view(np.int32))), thr, tanimoto)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch_mesh.topn_filtered_sharded(
        expr, torch.from_numpy(rows.view(np.int32)),
        list(torch.from_numpy(leaves.view(np.int32))), threshold,
        tanimoto) == want.sum(axis=0).tolist()


def test_topk_matches_jax_order():
    """The device top-k's order (count desc, index asc) and k clamp."""
    import torch
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 4, size=(3, 13, 8), dtype=np.uint32)
    t = torch.from_numpy(rows.view(np.int32))
    counts = torch_mesh.topn_exact_sharded(None, t, [])
    for k in (1, 5, 13, 40):
        got_counts, idx = torch_mesh.topn_topk_sharded(None, t, [], k)
        order = sorted(range(13), key=lambda i: (-counts[i], i))
        assert idx == order[:min(k, 13)]
        assert got_counts == [counts[i] for i in idx]


def test_executor_module_has_no_device_fallback():
    """No TopN leg catches a device error (no host fallback). The
    catch-alls of the class are ``execute_partial``'s, which hands the
    error back to its caller beside the results before it, and the
    cluster's, as in the JAX package: a failed leg re-maps onto another
    replica (which runs on its own card) and is counted, a failed
    pushdown hands the query to the fan-out, a broadcast re-raises the
    first error, a failed cache probe recomputes, a hedge race's
    failed side leaves the answer to the other replicas (the primary's
    error surfaces when both sides fail) and a resize double read's
    failed owner leaves its side to the next owner and its failed old
    side to the flipped target (the old side's error surfaces when both
    fail) — none of them computes on the host in place of the
    device. A pod coordinator's failed pod dispatch (a poisoned pod, a
    dead worker) answers through the pod's host fan-out, the JAX pod's
    semantics: there each process still runs its own legs."""
    import inspect
    allowed = {
        "execute_partial": ("return results, e",),
        "_map_reduce": ("FAILOVER_SLICES", "submit(nodes, group)"),
        "_topn_pushdown_gather": ("FAILOVER_SLICES",
                                  "submit(nodes, group)"),
        "_topn_distributed": ('TOPN_PUSHDOWN.labels("fallback")',),
        "_broadcast_call": ("raise errs[0]",),
        "_cluster_cache_validate": ("return False",),
        "_exec_remote_hedged": ("raise primary_err",),
        "_double_read_side": ("last = e",),
        "_exec_double_read": ("raise old_err",),
        "_count_pod_fn": ("_note_pod_fallback", "return NotImplemented"),
        "_topn_pod_fn": ("_note_pod_fallback", "return NotImplemented"),
        "_device_batch_run": ("_note_pod_fallback", "return None"),
    }
    for name, fn in inspect.getmembers(TorchExecutor, inspect.isfunction):
        src = inspect.getsource(fn)
        assert "except BaseException" not in src, name
        if name in allowed:
            for text in allowed[name]:
                assert text in src, (name, text)
        else:
            assert "except Exception" not in src, name

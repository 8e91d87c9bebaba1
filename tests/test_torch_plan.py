"""The port's planner against the JAX package's.

Both ``Planner``s plan the same queries over the same state (a JAX
holder filled from a seed, carried into the port) and must agree on
every rewritten call (``str``), every node's decisions, ``est_rows``,
``exact`` and cache marks — including the memo after writes that void a
proof. Then 46 edge queries (empty ``Intersect()``/``Union()``,
``n=0``, ``ids=[]``, repeated ids, Tanimoto 0 and 101, ``slices=[99]``,
64-bit ids, writes in multi-call queries, attribute filters on missing
fields, and proven-empty branches over a missing frame) run through
both executors and must give identical answers and error texts.
"""

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.plan.planner import Planner as JaxPlanner
from pilosa_tpu.pql.parser import parse as jax_parse

from pilosa_tpu_torch import carry
from pilosa_tpu_torch.ops import cuda_kernels
from pilosa_tpu_torch.plan.planner import EXACT_SLICES
from pilosa_tpu_torch.plan.planner import Planner as PortPlanner
from pilosa_tpu_torch.pql.parser import parse as port_parse

from test_torch_executor import _fill, _norm, export_state

N_SLICES = 8


@pytest.fixture
def pair(tmp_path):
    """(JAX executor, port executor) over the same state."""
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    _fill(jh, np.random.default_rng(4242))
    jh.index("d").create_frame("h")  # a frame with no view at all
    th, tex = carry.holder_from_state(str(tmp_path / "port"),
                                      export_state(jh), device="cpu")
    th.index("d").create_frame("h")
    jex = JaxExecutor(jh, host="local", use_mesh=True, mesh_min_slices=1)
    yield jex, tex
    jex.close()
    jh.close()
    th.close()


def _node_tuple(n):
    return (n.op, n.detail, n.est_rows, n.exact, tuple(n.decisions),
            n.short_circuit, n.cache_lookup, n.cache_store, n.key,
            tuple(sorted(n.frames)), n.placement,
            tuple(_node_tuple(c) for c in n.children))


def _plan_both(jp, tp, pql, slices):
    jcalls, jrec = jp.plan_query_cached("d", jax_parse(pql).calls, slices)
    tcalls, trec = tp.plan_query_cached("d", port_parse(pql).calls, slices)
    return ([str(c) for c in jcalls], [_node_tuple(n) for n in jrec.roots],
            jrec.decision_summary(), jrec.fingerprint), \
           ([str(c) for c in tcalls], [_node_tuple(n) for n in trec.roots],
            trec.decision_summary(), trec.fingerprint)


def _rand_tree(rng, depth):
    if depth == 0 or rng.random() < 0.35:
        frame = rng.choice(["f", "f", "g", "h", "t"])
        return f"Bitmap(rowID={int(rng.integers(8))}, frame={frame})"
    op = rng.choice(["Intersect", "Union", "Difference"])
    k = int(rng.integers(2, 4))
    return (f"{op}(" + ", ".join(_rand_tree(rng, depth - 1)
                                 for _ in range(k)) + ")")


PLAN_QUERIES = [
    'Count(Intersect(Bitmap(rowID=77, frame="f"), '
    'Bitmap(rowID=1, frame="nope")))',
    'Count(Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f"),'
    ' Bitmap(rowID=1, frame="g")))',
    'Count(Union(Bitmap(rowID=3, frame="f"), Bitmap(rowID=77, frame="f"),'
    ' Bitmap(rowID=1, frame="g")))',
    'Count(Difference(Bitmap(rowID=1, frame="f"), Bitmap(rowID=77, frame="f"),'
    ' Bitmap(rowID=2, frame="f")))',
    'Count(Difference(Bitmap(rowID=77, frame="f"), '
    'Bitmap(rowID=2, frame="f")))',
    'Count(Union())',
    'Count(Intersect(Bitmap(rowID=1, frame="f"), Union()))',
    'Count(Bitmap(rowID=1, frame="h"))',
    'Count(Intersect(Bitmap(rowID=1, frame="h"), Bitmap(rowID=1, frame="f")))',
    'Bitmap(columnID=3, frame="f")',
    'Count(Intersect(Bitmap(rowID=1, frame="f"), '
    'Bitmap(columnID=2, frame="f")))',
    'TopN(Intersect(Bitmap(rowID=9, frame="t"), Bitmap(rowID=77, frame="t")),'
    ' frame="t", n=2)',
    'TopN(Bitmap(rowID=9, frame="t"), frame="t", n=2)',
    'TopN(frame="f", n=3)',
    # CSE: one subtree twice within a batch, then across queries.
    'Union(Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f")),'
    ' Difference(Intersect(Bitmap(rowID=1, frame="f"),'
    ' Bitmap(rowID=2, frame="f")), Bitmap(rowID=3, frame="f")))',
    'Count(Union(Intersect(Bitmap(rowID=1, frame="f"),'
    ' Bitmap(rowID=2, frame="f")), Bitmap(rowID=4, frame="f")))',
    'Count(Union(Intersect(Bitmap(rowID=1, frame="f"),'
    ' Bitmap(rowID=2, frame="f")), Bitmap(rowID=4, frame="f")))',
]


def test_plans_equal_the_jax_planner(pair):
    jex, tex = pair
    jp, tp = JaxPlanner(jex.holder), PortPlanner(tex.holder)
    rng = np.random.default_rng(99)
    queries = PLAN_QUERIES + [f"Count({_rand_tree(rng, 3)})"
                              for _ in range(40)]
    for slices in (list(range(N_SLICES)), [0, 5], [99],
                   list(range(EXACT_SLICES + 6))):
        for q in queries + queries[:5]:  # the repeats hit the memo
            j, t = _plan_both(jp, tp, q, slices)
            assert j == t, (q, slices)
    assert jp.decision_totals == tp.decision_totals
    for outcome in ("short_circuit", "reordered", "planned"):
        assert tp.decision_totals.get(outcome, 0) > 0


def test_memo_follows_writes_that_void_a_proof(pair):
    jex, tex = pair
    jp, tp = JaxPlanner(jex.holder), PortPlanner(tex.holder)
    slices = list(range(N_SLICES))
    queries = ['Count(Intersect(Bitmap(rowID=77, frame="f"), '
               'Bitmap(rowID=1, frame="f")))',
               'Count(Intersect(Bitmap(rowID=5, frame="h"), '
               'Bitmap(rowID=1, frame="f")))']
    for q in queries:
        j, t = _plan_both(jp, tp, q, slices)
        assert j == t
        assert "short_circuit" in t[2]
    # A bit in row 77 (an existing fragment), and the first bit of the
    # frame that had no view: both proofs are void.
    for ex in (jex, tex):
        ex.execute("d", 'SetBit(frame="f", rowID=77, columnID=5)')
        ex.execute("d", 'SetBit(frame="h", rowID=5, columnID=3)')
    for q in queries:
        j, t = _plan_both(jp, tp, q, slices)
        assert j == t
        assert "short_circuit" not in t[2], q
    # ...and a clear restores the proof on the next plan.
    for ex in (jex, tex):
        ex.execute("d", 'ClearBit(frame="f", rowID=77, columnID=5)')
    j, t = _plan_both(jp, tp, queries[0], slices)
    assert j == t and "short_circuit" in t[2]


EDGE_QUERIES = [
    ('Count(Intersect())', None),
    ('Count(Union())', None),
    ('Count(Difference())', None),
    ('Intersect()', None),
    ('Union()', None),
    ('Difference()', None),
    ('TopN(frame="f", n=0)', None),
    ('TopN(frame="f", ids=[])', None),
    ('TopN(frame="f", ids=[1, 1, 2])', None),
    ('TopN(frame="t", n=2, ids=[0, 1, 2, 3, 3])', None),
    ('TopN(Bitmap(rowID=1, frame="f"), frame="f", tanimotoThreshold=0)',
     None),
    ('TopN(Bitmap(rowID=1, frame="f"), frame="f", tanimotoThreshold=101)',
     None),
    ('TopN(Bitmap(rowID=9, frame="t"), frame="t", n=4, '
     'tanimotoThreshold=100)', None),
    ('Count(Bitmap(rowID=1, frame="f"))', [99]),
    ('TopN(frame="f", n=2)', [99]),
    ('Bitmap(rowID=1, frame="f")', [99]),
    ('Bitmap(rowID=18446744073709551615, frame="f")', None),
    ('Count(Bitmap(rowID=9223372036854775807, frame="f"))', None),
    ('Bitmap(columnID=18446744073709551615, frame="f")', None),
    ('SetBit(frame="f", rowID=3, columnID=5) '
     'Count(Bitmap(rowID=3, frame="f"))', None),
    ('ClearBit(frame="f", rowID=3, columnID=5) '
     'Count(Bitmap(rowID=3, frame="f"))', None),
    ('SetBit(frame="f", rowID=4, columnID=7) '
     'TopN(Intersect(Bitmap(rowID=4, frame="f"), Union()), frame="f")', None),
    ('TopN(frame="t", n=2, field="missing", filters=[1])', None),
    ('TopN(Bitmap(rowID=9, frame="t"), frame="t", field="nope", '
     'filters=["x"], ids=[0, 1])', None),
    ('SetRowAttrs(frame="t", rowID=1, x=1) '
     'TopN(frame="t", n=4, field="x", filters=[1])', None),
    # A proven-empty operand beside a missing frame.
    ('Count(Intersect(Bitmap(rowID=77, frame="f"), '
     'Bitmap(rowID=1, frame="nope")))', None),
    ('Count(Intersect(Bitmap(rowID=77, frame="f"), '
     'Bitmap(rowID=1, frame="nope")))', list(range(EXACT_SLICES + 1))),
    ('Count(Intersect(Bitmap(rowID=1, frame="f"), '
     'Bitmap(rowID=1, frame="nope")))', None),
    ('Count(Union(Bitmap(rowID=77, frame="f"), '
     'Bitmap(rowID=1, frame="nope")))', None),
    ('Count(Difference(Bitmap(rowID=77, frame="f"), '
     'Bitmap(rowID=1, frame="nope")))', None),
    ('Count(Difference(Bitmap(rowID=1, frame="f"), '
     'Intersect(Bitmap(rowID=77, frame="f"), Bitmap(rowID=0, frame="nope"))))',
     None),
    ('TopN(Intersect(Bitmap(rowID=77, frame="f"), '
     'Bitmap(rowID=1, frame="nope")), frame="f", n=3)', None),
    ('TopN(Intersect(Bitmap(rowID=77, frame="t"), '
     'Bitmap(rowID=1, frame="nope")), frame="t", tanimotoThreshold=101)',
     None),
    ('Intersect(Bitmap(rowID=77, frame="f"), Bitmap(rowID=1, frame="nope"))',
     None),
    ('Count(Difference(Union(), Bitmap(rowID=1, frame="nope")))', None),
    ('Count(Bitmap(rowID=1))', None),
    ('Count(Bitmap(frame="f"))', None),
    ('Count(Bitmap(rowID=1, columnID=2, frame="f"))', None),
    ('Count(Union(Bitmap(rowID=1, frame="f"), Union()))', None),
    ('TopN(Union(), frame="f")', None),
    ('TopN(Intersect(Bitmap(rowID=1, frame="f"), Union()), frame="f", '
     'ids=[1, 2])', None),
    ('Count(Intersect(Bitmap(rowID=1, frame="g"), '
     'Bitmap(rowID=77, frame="g")))', None),
    ('TopN(frame="f", n=3, threshold=0)', None),
    ('TopN(frame="nope", n=3)', None),
    ('Count(Intersect(Bitmap(rowID=1, frame="f"), '
     'Bitmap(rowID=1, frame="f"))) Count(Bitmap(rowID=1, frame="h"))', None),
    ('Union(Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f")),'
     ' Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f")))',
     None),
]


def _run(ex, q, slices):
    try:
        return ("ok", _norm(ex.execute("d", q, slices)))
    except Exception as e:  # noqa: BLE001 - the error text is compared
        return ("error", type(e).__name__, str(e))


def test_edge_queries_answer_alike(pair):
    jex, tex = pair
    assert len(EDGE_QUERIES) == 46
    for q, slices in EDGE_QUERIES:
        j, t = _run(jex, q, slices), _run(tex, q, slices)
        assert j == t, q
    # The proven-empty operand beside a missing frame by itself: 0 at or
    # under EXACT_SLICES, no launch; the
    # same error as the JAX package above it.
    q = ('Count(Intersect(Bitmap(rowID=77, frame="f"), '
         'Bitmap(rowID=1, frame="nope")))')
    assert _run(tex, q, None) == ("ok", [0])
    wide = list(range(EXACT_SLICES + 1))
    assert _run(tex, q, wide) == _run(jex, q, wide)
    assert _run(tex, q, wide)[0] == "error"


def test_short_circuit_launches_nothing(pair, monkeypatch):
    """A proven-empty Count reaches no kernel wrapper; a Union with a
    proven-empty operand launches what the Union without it does."""
    _, tex = pair
    calls = []
    real = cuda_kernels.expr_count_rows
    monkeypatch.setattr(cuda_kernels, "expr_count_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert tex.execute("d", 'Count(Intersect(Bitmap(rowID=77, frame="f"), '
                            'Bitmap(rowID=1, frame="nope")))') == [0]
    assert calls == []
    with_empty = tex.execute("d", 'Count(Union(Bitmap(rowID=1, frame="f"), '
                                  'Bitmap(rowID=77, frame="f")))')
    n_with = len(calls)
    without = tex.execute("d", 'Count(Union(Bitmap(rowID=1, frame="f")))')
    assert with_empty == without and n_with == len(calls) - n_with == 1


def test_planner_off_runs_the_parsed_tree(pair):
    _, tex = pair
    tex.planner_enabled = False
    try:
        with pytest.raises(Exception, match="nope"):
            tex.execute("d", 'Count(Intersect(Bitmap(rowID=77, frame="f"), '
                             'Bitmap(rowID=1, frame="nope")))')
    finally:
        tex.planner_enabled = True


def test_explain_matches(pair):
    jex, tex = pair
    q = ('Count(Intersect(Bitmap(rowID=2, frame="f"), '
         'Bitmap(rowID=77, frame="f"), Bitmap(rowID=1, frame="g")))')
    jt, tt = jex.explain("d", q), tex.explain("d", q)
    jt.pop("node"), tt.pop("node")
    assert jt == tt
    assert tt["calls"][0]["decisions"] == ["short_circuit"]


def test_plan_route_matches(pair):
    """``?plan=1`` on the query route: the same plan tree from both
    handlers, and nothing executed."""
    import json

    from pilosa_tpu.server.handler import Handler as JaxHandler
    from pilosa_tpu_torch.server.handler import Handler
    from test_torch_server import call

    jex, tex = pair
    q = ('Count(Intersect(Bitmap(rowID=2, frame="f"), '
         'Bitmap(rowID=77, frame="f"), Bitmap(rowID=1, frame="g"))) '
         'TopN(Bitmap(rowID=9, frame="t"), frame="t", n=2)')
    got = [call(h, "POST", "/index/d/query?plan=1", q)
           for h in (JaxHandler(jex.holder, jex), Handler(tex.holder, tex))]
    assert got[0][0] == got[1][0] == 200
    assert json.loads(got[0][2]) == json.loads(got[1][2])
    assert json.loads(got[1][2])["results"] == []
    st, _, body = call(Handler(tex.holder, tex), "POST",
                       "/index/d/query?plan=1",
                       'SetBit(frame="f", rowID=1, columnID=2)')
    assert st == 400 and b"EXPLAIN" in body

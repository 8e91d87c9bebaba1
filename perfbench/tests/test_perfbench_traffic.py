"""The request generator and the data generator are deterministic by
seed and keep the mixes' proportions."""

import numpy as np
import pytest

from perfbench import datagen, traffic
from perfbench.tests.sizes import tiny

CELLS = [{"config": c, "traffic": t, "name": f"{c}.{t}"}
         for c, t in (("c4_segments", "dashboard"),
                      ("c4_segments", "wide_count"),
                      ("c4_segments", "intersect_batch"),
                      ("c4_segments", "intersect_count"),
                      ("c3_topn", "filtered_topn"))]


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_stream_is_deterministic_by_seed(cell):
    mix = traffic.load(cell["traffic"])
    rows = datagen.frame_rows(datagen.load(cell["config"]))
    a = traffic.Stream(mix, rows, 2**31 + 7, 3).take(40)
    b = traffic.Stream(mix, rows, 2**31 + 7, 3).take(40)
    c = traffic.Stream(mix, rows, 2**31 + 8, 3).take(40)
    assert a == b
    assert a != c
    assert traffic.Stream(mix, rows, 2**31 + 7, 3, warm=True).take(40) != a


@pytest.mark.parametrize("name", ["c4_segments", "c3_topn"])
def test_data_is_deterministic_by_seed(name):
    cfg = tiny(name)
    a, b = datagen.make(cfg, -5), datagen.make(cfg, -5)
    c = datagen.make(cfg, 6)
    for f in cfg["frames"]:
        assert np.array_equal(a[f][0], b[f][0])
        assert np.array_equal(a[f][1], b[f][1])
        assert not np.array_equal(a[f][1], c[f][1])
        # The same row sizes under every seed, in another order.
        sa = np.sort(np.bincount(a[f][0].astype(np.int64)))
        sc = np.sort(np.bincount(c[f][0].astype(np.int64)))
        assert np.array_equal(sa, sc)
        assert int(a[f][1].max()) < datagen.columns(cfg)


def test_wide_count_leaves_are_disjoint_and_sized():
    mix = traffic.load("wide_count")
    for _pql, (call,) in traffic.Stream(mix, {"f": 128}, 9, 0).take(200):
        assert call[0] == "Count" and call[1][0] == "Intersect"
        a, b = call[1][1]
        ra = {leaf[2] for leaf in a[1]}
        rb = {leaf[2] for leaf in b[1]}
        assert 8 <= len(ra) <= 32 and 8 <= len(rb) <= 32
        assert len(ra) == len(a[1]) and not ra & rb


def test_topn_decks_keep_the_proportions():
    mix = traffic.load("filtered_topn")
    calls = [c for _p, (c,) in traffic.Stream(
        mix, {"f": 100000, "src": 16}, 4, 1).take(400)]
    ns = [c[3] for c in calls]
    assert ns.count(100) == 300 and ns.count(1000) == 100
    two = [c for c in calls if c[1][0] == "Intersect"]
    assert len(two) == 200
    assert all(len({leaf[2] for leaf in c[1][1]}) == 2 for c in two)


def test_intersect_batch_draws_fresh_pairs():
    mix = traffic.load("intersect_batch")
    bodies = traffic.Stream(mix, {"f": 128}, 2**31 + 5, 1).take(200)
    for _p, tree in bodies:
        assert len(tree) == 16
        for call in tree:
            assert call[0] == "Count" and call[1][0] == "Intersect"
            a, b = call[1][1]
            assert a[0] == b[0] == "leaf" and a[2] != b[2]
    # No pool: nearly every body is new.
    assert len({p for p, _t in bodies}) == 200


def test_dashboard_bodies_come_from_the_pool():
    mix = traffic.load("dashboard")
    s = traffic.Stream(mix, {"f": 128}, 11, 2)
    bodies = s.take(300)
    assert all(len(tree) == 16 for _p, tree in bodies)
    distinct = {p for p, _t in bodies}
    assert 1 < len(distinct) <= 64
    # Zipf: the most popular dashboard is sent most.
    counts = sorted((sum(1 for p, _t in bodies if p == d) for d in distinct),
                    reverse=True)
    assert counts[0] > counts[-1]


def test_pql_matches_the_tree():
    call = ("TopN", ("Intersect", (("leaf", "src", 3), ("leaf", "src", 5))),
            "f", 100)
    assert traffic.pql(call) == ("TopN(Intersect(Bitmap(rowID=3, frame=src),"
                                  " Bitmap(rowID=5, frame=src)), frame=f,"
                                  " n=100)")
    assert traffic.leaves(call) == {("src", 3), ("src", 5)}


def test_a_new_call_is_a_new_file(tmp_path, monkeypatch):
    """A call kind the harness has never seen, from its own file under
    calls/: drawn, written, parsed and answered with no other edit."""
    calls = tmp_path / "calls"
    calls.mkdir()
    (calls / "CountBoth.py").write_text(
        "def draw(node, d):\n"
        "    return ('CountBoth', d.at('a').expr(node['arg']),"
        " d.at('b').expr(node['arg']))\n"
        "def pql(t, pql):\n"
        "    return f'Count({pql(t[1])}) Count({pql(t[2])})'\n"
        "def exprs(t):\n"
        "    return [t[1], t[2]]\n"
        "def parse(result):\n"
        "    return result\n"
        "def answer(ref, t, control=False):\n"
        "    return ref.count(t[1]) + ref.count(t[2])\n")
    monkeypatch.setattr(traffic, "HERE", str(tmp_path))
    monkeypatch.setattr(traffic, "_CALLS", {})
    mix = {"clients": 1, "warm_seconds": 1, "body": {"calls": [
        {"call": "CountBoth", "arg": {"rows": {"frame": "f", "k": 1}}}]}}
    pql, (call,) = traffic.Stream(mix, {"f": 8}, 3, 0).next()
    assert call[0] == "CountBoth" and pql.count("Count(") == 2
    assert traffic.leaves(call) == {call[1][1:], call[2][1:]}
    assert traffic.leaf_frames(mix) == ["f"]

"""The window's arithmetic works over every request, a stall inside the
window included, and the byte count of the count kernel's roofline."""

import importlib.util
import os

import pytest

from perfbench import peaks, stats

METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "metrics")


def _reader(name):
    sp = importlib.util.spec_from_file_location(
        "m_" + name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def _reqs(lat_ms, gap_ms=0.0, ok=None):
    """One client's closed loop from t0 = 0: each request sent when the
    last answered."""
    out, t = [], 0.0
    for i, ms in enumerate(lat_ms):
        out.append({"t_send": t, "t_recv": t + ms / 1e3,
                    "ok": True if ok is None else ok[i]})
        t += ms / 1e3 + gap_ms / 1e3
    return out


def test_a_stall_lowers_the_rate_and_shows_in_the_tail():
    steady = _reqs([10.0] * 100)
    stalled = _reqs([10.0] * 95 + [10.0, 2000.0, 10.0, 10.0, 10.0])
    assert stats.rate_per_s(steady, 0.0) == pytest.approx(100.0)
    # 100 answers over 0.99 + 2.0 s: the stall's time counts.
    assert stats.rate_per_s(stalled, 0.0) == pytest.approx(100 / 2.99)
    lat = stats.latencies_ms(stalled)
    assert stats.quantile(lat, 0.5) == pytest.approx(10.0)
    assert stats.quantile(lat, 0.99) == pytest.approx(10.0)
    assert max(lat) == pytest.approx(2000.0)
    # A stall in 6 % of the requests lands in the 95th percentile, which
    # a median of per-second chunks would hide.
    many = _reqs([10.0] * 94 + [500.0] * 6)
    assert stats.quantile(stats.latencies_ms(many), 0.95) == pytest.approx(500.0)


def test_failed_requests_read_above_every_answer():
    reqs = _reqs([5.0, 7.0, 6.0, 50.0], ok=[True, True, False, True])
    lat = stats.latencies_ms(reqs)
    assert sorted(lat)[-1] > 50.0
    assert stats.quantile(lat, 0.75) == 50.0
    assert stats.rate_per_s(reqs, 0.0) == pytest.approx(3 / 0.068)


def test_quantile_is_nearest_rank():
    assert stats.quantile(list(range(1, 101)), 0.95) == 95
    assert stats.quantile([3.0], 0.95) == 3.0


def test_count_bytes_per_query():
    # Count(Intersect(Union of 10 rows, Union of 20 rows)) at 256 slices:
    # 30 distinct leaf rows, each slice row of 2^20 bits read once.
    assert peaks.count_bytes(30, 256) == 30 * 256 * 131072
    assert peaks.SLICE_BYTES == 131072
    assert peaks.HBM_BYTES_PER_S == 3.35e12


def test_roofline_reader_counts_requests_inside_the_stretch():
    read = _reader("count_kernel_roofline")
    st = {"devicePrograms": 1}
    reqs = [
        {"ok": True, "stats": st, "t_send": 1.0, "t_recv": 1.1, "leaves": 40},
        {"ok": True, "stats": st, "t_send": 1.2, "t_recv": 1.3, "leaves": 20},
        # Straddles the stretch's end, and one that launched nothing.
        {"ok": True, "stats": st, "t_send": 1.9, "t_recv": 2.1, "leaves": 64},
        {"ok": True, "stats": {"devicePrograms": 0}, "t_send": 1.4,
         "t_recv": 1.5, "leaves": 64},
    ]
    need_s = 60 * 256 * 131072 / 3.35e12
    rec = {"reqs": reqs, "n_slices": 256, "kind": "NVIDIA H100 80GB HBM3",
           "trace": {"t_start": 0.9, "t_stop": 2.0,
                     "device_s": {"(anonymous namespace)::expr_count_kernel"
                                  "<false>(long long const*)": need_s * 2,
                                  "densify_kernel": 5.0}}}
    assert read(rec) == pytest.approx(50.0)
    rec["trace"]["device_s"] = {"densify_kernel": 5.0}
    assert read(rec) is None


def test_idle_share_reader():
    read = _reader("device_idle_share")
    assert read({"trace": {"busy_s": 0.5, "window_s": 2.0}}) == 75.0
    assert read({"trace": None}) is None

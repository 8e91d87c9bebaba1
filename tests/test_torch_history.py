"""The port's metric history (obs.history) and regression sentinel
(obs.sentinel) against the JAX package's.

Each test builds one metrics registry per package with the same
families, feeds both the same observations (made from a numpy seed) and
samples both at the same injected ``now`` sequence: the series keys and
every point must be identical, through the disk rings and a reopen too.
The sentinel's ``robust_z`` and its findings over those histories —
robust-z rules, the manifest envelope (a manifest written under
``tmp_path``) and the per-tenant burn rule — must be identical as well.
"""

import json

import numpy as np
import pytest

from pilosa_tpu.obs import history as jhist
from pilosa_tpu.obs import metrics as jmetrics
from pilosa_tpu.obs import sentinel as jsent

from pilosa_tpu_torch.obs import history as thist
from pilosa_tpu_torch.obs import metrics as tmetrics
from pilosa_tpu_torch.obs import sentinel as tsent

RES = ((1.0, 400), (5.0, 100), (30.0, 50))
T0 = 1_700_000_000.0


def _registry(mod):
    reg = mod.Registry()
    fams = {
        "lat": reg.histogram("pilosa_query_duration_seconds",
                             "query latency", labels=("call", "lane")),
        "n": reg.counter("pilosa_query_requests_total", "queries",
                         labels=("lane",)),
        "depth": reg.gauge("pilosa_admission_queue_depth_items",
                           "queued", labels=("lane",)),
        "burn": reg.gauge("pilosa_tenant_slo_burn_rate_ratio", "burn",
                          labels=("tenant", "window")),
    }
    return reg, fams


def _feed(fams, rng, tick: int, slow: bool) -> None:
    for lane in ("read", "write"):
        k = int(rng.integers(3, 9))
        fams["n"].labels(lane).inc(k)
        for v in rng.exponential(0.002, size=k):
            fams["lat"].labels("Count", lane).observe(
                float(v) * (40.0 if slow and lane == "read" else 1.0))
        fams["depth"].labels(lane).set(int(rng.integers(0, 5)))
    fams["burn"].labels("quiet", "5m").set(
        12.0 if slow else float(rng.random()))


def _drive(n_ticks: int, slow_from: int, seed: int, tmp_path=None):
    """Both histories after ``n_ticks`` samples one second apart; the
    read lane slows down from tick ``slow_from``."""
    out = []
    for mod, hmod in ((jmetrics, jhist), (tmetrics, thist)):
        reg, fams = _registry(mod)
        d = (str(tmp_path / hmod.__name__.split(".")[0])
             if tmp_path is not None else None)
        hist = hmod.MetricHistory(d, resolutions=RES, registry=reg)
        rng = np.random.default_rng(seed)
        counts = []
        for t in range(n_ticks):
            _feed(fams, rng, t, t >= slow_from)
            counts.append(hist.sample(now=T0 + t))
        out.append((hist, counts))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_same_samples_give_the_same_series(seed):
    (jh, jc), (th, tc) = _drive(90, 10**9, seed)
    assert jc == tc
    assert jh.keys() == th.keys()
    assert any(k.startswith("pilosa_query_duration_seconds:p99")
               for k in th.keys())
    for family in ("", "pilosa_query_duration_seconds",
                   "pilosa_query_requests_total"):
        for window, step in ((60.0, 0.0), (400.0, 5.0), (3600.0, 30.0)):
            assert (jh.series(family, None, window, step)
                    == th.series(family, None, window, step))
    flt = {"lane": "read"}
    assert (jh.series("pilosa_query_duration_seconds", flt, 60.0, 0.0)
            == th.series("pilosa_query_duration_seconds", flt, 60.0, 0.0))
    for key in th.keys():
        assert jh.latest(*jhist.split_key(key)) == th.latest(
            *thist.split_key(key))
    js, ts = jh.stats(), th.stats()
    assert js == ts


def test_disk_rings_reopen_alike(tmp_path):
    (jh, _), (th, _) = _drive(40, 10**9, 5, tmp_path)
    jh.close()
    th.close()
    jre = jhist.MetricHistory(str(tmp_path / "pilosa_tpu"),
                              resolutions=RES,
                              registry=_registry(jmetrics)[0])
    tre = thist.MetricHistory(str(tmp_path / "pilosa_tpu_torch"),
                              resolutions=RES,
                              registry=_registry(tmetrics)[0])
    assert jre.keys() == tre.keys() and tre.keys()
    assert (jre.series("", None, 60.0, 0.0)
            == tre.series("", None, 60.0, 0.0))
    # The same segment files on disk in both packages.
    for res in ("res0", "res1"):
        jd = tmp_path / "pilosa_tpu" / res
        td = tmp_path / "pilosa_tpu_torch" / res
        assert sorted(p.name for p in jd.iterdir()) == sorted(
            p.name for p in td.iterdir())
    jre.close()
    tre.close()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_robust_z_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        recent = rng.normal(5, 2, size=int(rng.integers(1, 12))).tolist()
        baseline = rng.normal(3, 1, size=int(rng.integers(1, 30))).tolist()
        if rng.random() < 0.2:
            baseline = [1.5] * len(baseline)  # MAD 0: the fallback scale
        assert jsent.robust_z(recent, baseline) == tsent.robust_z(
            recent, baseline)


def test_sentinel_findings_match(tmp_path):
    """The read lane slows down 40x for the last 20 of 120 ticks and
    the quiet tenant burns: both sentinels raise the same findings
    (robust-z on the latency quantiles, the manifest envelope, the
    tenant burn rule), and a second pass inside the re-trip window
    fires nothing new in either."""
    manifest = tmp_path / "manifest.json"
    # Committed latencies in ms, the manifest's unit.
    manifest.write_text(json.dumps({"metrics": {
        "latency_below_cap_p99": {"value": 0.5},
        "latency_below_cap_p50": {"value": 0.2}}}))
    (jh, _), (th, _) = _drive(120, 100, 21)
    now = T0 + 119
    found = []
    for mod, hist in ((jsent, jh), (tsent, th)):
        sent = mod.Sentinel(hist, window_s=15.0, baseline_s=100.0,
                            min_points=5, min_ratio=3.0,
                            manifest_path=str(manifest),
                            manifest_tolerance=2.0)
        first = sent.check(now=now)
        again = sent.check(now=now + 1)
        snap = sent.snapshot()
        snap.pop("manifest")
        found.append((first, again, snap))
    (jf, ja, js), (tf, ta, ts) = found
    assert tf == jf
    assert {f["rule"] for f in tf} == {"robust_z", "manifest",
                                       "tenant_burn"}
    assert ta == ja == []
    assert ts == js

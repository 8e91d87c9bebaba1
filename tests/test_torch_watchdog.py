"""The port's stall watchdog (obs.watchdog), flight recorder
(obs.blackbox) and the scrubber's ``stall_age`` against the JAX
package's.

- Each of the eight detectors trips on the same injected state in both
  packages, with the same cause and detail, and not below its threshold;
  a trip inside the re-trip window does not trip again; a trip
  force-keeps the in-flight traces and dumps the recorder with cause
  ``watchdog:<cause>``.
- The recorder keeps the same ring and dumps, prunes to ``max_dumps``
  and reports the same stats shape.
- ``Scrubber.stall_age`` is None between passes and the seconds since
  the last verified fragment during one, in both.
- A port server's SIGTERM leaves a ``sigterm`` dump and still closes
  the server (exit 0), and ``POST /debug/blackbox/dump`` writes one
  with the whole ring.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.obs import blackbox as jbb
from pilosa_tpu.obs import trace as jtrace
from pilosa_tpu.obs import watchdog as jwd
from pilosa_tpu.sched import context as jctx
from pilosa_tpu.sched import registry as jreg
from pilosa_tpu.storage import scrub as jscrub
from pilosa_tpu.storage import wal as jwal

from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.obs import blackbox as tbb
from pilosa_tpu_torch.obs import trace as ttrace
from pilosa_tpu_torch.obs import watchdog as twd
from pilosa_tpu_torch.sched import context as tctx
from pilosa_tpu_torch.sched import registry as treg
from pilosa_tpu_torch.storage import scrub as tscrub
from pilosa_tpu_torch.storage import wal as twal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {"jax": (jwd, jbb, jtrace, jctx, jreg, jwal),
        "port": (twd, tbb, ttrace, tctx, treg, twal)}


class _Admission:
    def __init__(self, queued, grant_age):
        self.state = (queued, grant_age)

    def stall_state(self):
        return self.state

    def snapshot(self):
        return {"inFlight": 0}


def _state(cause: str, over: bool) -> dict:
    """The injected state that trips ``cause`` (``over``) or sits just
    under its threshold (10 s everywhere)."""
    age = 12.5 if over else 7.5
    return {
        "wal_flusher": {"wal": {"oldestDirtyAgeS": age, "wals": [
            {"file": "/d/i/f/views/standard/fragments/0.wal",
             "pendingBytes": 130, "dirtyAgeS": age}]}},
        "stuck_query": {"late_s": age},
        "gossip_silence": {"gossip_age_fn": lambda: age},
        "admission_stall": {"admission": _Admission(3, age)},
        "resize_stall": {"resize_progress_fn": lambda: ("streaming", age)},
        "scrub_stall": {"scrub_progress_fn": lambda: age},
        "tier_stall": {"tier_progress_fn": lambda: age},
        "backup_stall": {"backup_progress_fn": lambda: age},
    }[cause]


def _trip(pkg: str, cause: str, over: bool, tmp_path, monkeypatch):
    wd_mod, bb_mod, tr_mod, ctx_mod, reg_mod, wal_mod = PKGS[pkg]
    st = _state(cause, over)
    monkeypatch.setattr(wal_mod, "flusher_health",
                        lambda: st.get("wal", {"oldestDirtyAgeS": 0.0}))
    registry = reg_mod.QueryRegistry()
    tracer = tr_mod.Tracer(enabled=False, max_traces=16)
    ctx = ctx_mod.QueryContext(pql="Count(Bitmap(rowID=1, frame=f))",
                               index="i", timeout_s=60.0, id="q1")
    if "late_s" in st:
        ctx.deadline = time.monotonic() - st["late_s"]
    ctx.state = "running"
    registry.register(ctx)
    ctx.trace = tracer.start(ctx, node="n")
    box = bb_mod.Blackbox(str(tmp_path / pkg / cause),
                          state_fn=lambda: {"probe": 1}, interval_s=60)
    kw = {k: v for k, v in st.items() if k not in ("wal", "late_s")}
    wd = wd_mod.Watchdog(registry=registry, tracer=tracer,
                         blackbox=box, wal_stall_s=10, deadline_grace_s=10,
                         gossip_silence_s=10, queue_stall_s=10,
                         resize_stall_s=10, scrub_stall_s=10,
                         tier_stall_s=10, backup_stall_s=10,
                         retrip_s=60, **kw)
    first = wd.check()
    again = wd.check()
    dumps = [os.path.basename(p).split("-", 2)[2] for p in box.dumps()]
    kept = ctx.trace.keep_reason
    snap = wd.snapshot()
    box.ring.close()
    return first, again, dumps, kept, snap["trips"], sorted(
        snap["thresholds"].items())


@pytest.mark.parametrize("cause", twd.CAUSES)
@pytest.mark.parametrize("over", [True, False])
def test_each_detector_trips_alike(cause, over, tmp_path, monkeypatch):
    assert twd.CAUSES == jwd.CAUSES
    got = {pkg: _trip(pkg, cause, over, tmp_path, monkeypatch)
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    first, again, dumps, kept, trips, _ = got["port"]
    if over:
        assert [c for c, _ in first] == [cause]
        assert again == []
        assert dumps == [f"watchdog_{cause}.json"]
        assert kept == "watchdog" and trips == 1
    else:
        assert first == again == [] and dumps == [] and trips == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_blackbox_ring_and_dumps_alike(seed, tmp_path):
    rng = np.random.default_rng(seed)
    states = [{"k": int(v)} for v in rng.integers(1000, size=12)]
    out = {}
    for name, mod in (("jax", jbb), ("port", tbb)):
        it = iter(states)
        box = mod.Blackbox(str(tmp_path / name), state_fn=lambda: next(it),
                           interval_s=60, segment_bytes=512,
                           max_segments=2, max_dumps=2, node="n1")
        for _ in range(9):
            box.snapshot("periodic")
        paths = [box.dump(c) for c in ("api", "watchdog:stuck_query",
                                       "sigterm")]
        docs = [json.load(open(p)) for p in box.dumps()]
        stats = box.stats()
        stats.pop("dir")
        box.ring.close()
        out[name] = (
            [os.path.basename(p).split("-", 2)[2] for p in paths],
            # Dumps of one millisecond sort by cause: compare as sets.
            sorted((d["cause"], d["node"], [r["k"] for r in d["ring"]],
                    d["current"]["k"], d["current"]["trigger"])
                   for d in docs),
            sorted(n.split("-", 2)[2] for n in stats.pop("dumps")),
            stats["ring"]["segmentBytes"], stats["ring"]["maxSegments"])
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 2  # pruned to max_dumps


def test_scrubber_stall_age_alike(tmp_path):
    ages = {}
    for name, holder_mod, scrub_mod in (("jax", JHolder, jscrub),
                                        ("port", THolder, tscrub)):
        h = holder_mod(str(tmp_path / name))
        h.open()
        try:
            idx = h.create_index("i")
            frame = idx.create_frame("f")
            frame.import_bits(np.array([1, 2], dtype=np.uint64),
                              np.array([3, 4], dtype=np.uint64))
            sc = scrub_mod.Scrubber(h, interval_s=3600, pace_s=0.3)
            seen = []
            real = scrub_mod.Scrubber._pass_locked

            def watch():
                time.sleep(0.15)
                seen.append(sc.stall_age())

            before = sc.stall_age()
            t = threading.Thread(target=watch)
            t.start()
            real(sc)
            t.join()
            ages[name] = (before, seen[0] is not None and seen[0] >= 0.1,
                          sc.stall_age())
        finally:
            h.close()
    assert ages["port"] == ages["jax"] == (None, True, None)


def test_sigterm_and_api_dumps(tmp_path):
    data = tmp_path / "d"
    env = dict(os.environ, PYTHONPATH=REPO,
               PILOSA_BLACKBOX_INTERVAL="200ms")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "--device", "cpu", "-d", str(data), "-b", "127.0.0.1:0"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        host = line.split("http://", 1)[1].split()[0]
        time.sleep(0.6)
        req = urllib.request.Request(f"http://{host}/debug/blackbox/dump",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            path = json.loads(r.read())["dumped"]
        doc = json.load(open(path))
        assert doc["cause"] == "api" and doc["ring"]
        assert {"admission", "wal", "generations", "queries",
                "integrity", "threads"} <= set(doc["current"])
        with urllib.request.urlopen(f"http://{host}/debug/blackbox",
                                    timeout=10) as r:
            bb = json.loads(r.read())
        assert bb["enabled"] and bb["recent"] and "watchdog" in bb
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    names = os.listdir(data / "blackbox")
    assert any(n.endswith("-sigterm.json") for n in names), names
    assert "shutting down" in err

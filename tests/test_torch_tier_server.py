"""Tiered storage through the server: a port server and a JAX server,
each with ``[tier]`` enabled over a copy of one seeded data directory,
on the CPU.

- Count, TopN and Sum over fragments pushed to the blob tier give the
  hot answers, the same in both packages, as do ``/debug/tier`` and the
  flight recorder's tier block;
- a blob fetch that fails (the ``tier.fetch`` failpoint) answers the
  same status and body in both, strict and with ``?partial=1``, and the
  next pass heals it in both;
- the scrubber's blob leg and ``check --deep`` over the stubs give the
  same verdicts, clean and over a rotted object.
"""

import argparse
import io
import json
import os
import shutil
import urllib.error
import urllib.request

import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.cli import commands as jcmds
from pilosa_tpu.fault import failpoints as jfp

from pilosa_tpu_torch.cli import commands as tcmds
from pilosa_tpu_torch.fault import failpoints as tfp


def _call(host, method, path, body=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _q(host, pql, qs=""):
    st, hs, body = _call(host, "POST", f"/index/it/query{qs}", pql.encode())
    return st, hs.get("X-Pilosa-Partial"), json.loads(body)


SLICES = 3
QUERIES = (
    'Count(Intersect(Bitmap(frame="f", rowID=1), Bitmap(frame="f",'
    ' rowID=2)))',
    'Count(Union(Bitmap(frame="f", rowID=0), Bitmap(frame="f",'
    ' rowID=3)))',
    'Count(Bitmap(frame="f", rowID=4))',
    'TopN(frame="f", n=4)',
    'TopN(Bitmap(frame="f", rowID=1), frame="f", n=3)',
    'TopN(frame="f", ids=[0, 2, 4])',
    'Sum(frame="b", field="v")',
    'Sum(Bitmap(frame="f", rowID=2), frame="b", field="v")',
    'Bitmap(frame="f", rowID=3)',
)


def _seed(path):
    """A one-node data directory: frame f (5 rows over 3 slices) and
    the BSI frame b, written through a port server."""
    from pilosa_tpu_torch.server.server import Server
    import numpy as np
    s = Server(str(path), host="127.0.0.1:0", device="cpu", warmup=False)
    s.open()
    try:
        _call(s.host, "POST", "/index/it", b"{}")
        _call(s.host, "POST", "/index/it/frame/f", b"{}")
        _call(s.host, "POST", "/index/it/frame/b",
              b'{"options": {"fields": [{"name": "v", "min": 0,'
              b' "max": 1000}]}}')
        rng = np.random.default_rng(41)
        body = []
        for r in range(5):
            cols = np.unique(rng.integers(0, SLICES * SLICE_WIDTH,
                                          size=60 + 40 * r))
            body += [f'SetBit(frame="f", rowID={r}, columnID={c})'
                     for c in cols.tolist()]
        cols = np.unique(rng.integers(0, SLICES * SLICE_WIDTH, size=40))
        body += [f'SetFieldValue(frame="b", columnID={c}, v={int(v)})'
                 for c, v in zip(cols.tolist(),
                                 rng.integers(0, 1000, size=len(cols)))]
        st, _h, _b = _call(s.host, "POST", "/index/it/query",
                           "\n".join(body).encode())
        assert st == 200
    finally:
        s.close()


@pytest.fixture
def tiered_pair(tmp_path, monkeypatch):
    """(JAX server, port server), each with the tier manager enabled —
    its loop idle (passes run on demand) — over a copy of one seeded
    directory; scrub passes on demand only."""
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    from pilosa_tpu.server.server import Server as JServer
    from pilosa_tpu.utils.config import ScrubConfig as JScrub
    from pilosa_tpu.utils.config import TierConfig as JTier
    from pilosa_tpu_torch.server.server import Server as TServer
    from pilosa_tpu_torch.utils.config import ScrubConfig as TScrub
    from pilosa_tpu_torch.utils.config import TierConfig as TTier
    _seed(tmp_path / "seed")
    shutil.copytree(tmp_path / "seed", tmp_path / "j")
    shutil.copytree(tmp_path / "seed", tmp_path / "t")
    tier = dict(enabled=True, resident_budget=1 << 30, idle=0.001,
                blob_idle=0.001, interval=999.0, blob="dir", pace=0.0)
    js = JServer(str(tmp_path / "j"), host="127.0.0.1:0",
                 anti_entropy_interval=0, polling_interval=0,
                 scrub_config=JScrub(interval=999.0, pace=0.0,
                                     repair=False),
                 tier_config=JTier(**tier))
    ts = TServer(str(tmp_path / "t"), host="127.0.0.1:0", device="cpu",
                 warmup=False, anti_entropy_interval=0,
                 polling_interval=0,
                 scrub_config=TScrub(interval=999.0, pace=0.0,
                                     repair=False),
                 tier_config=TTier(**tier))
    js.open()
    ts.open()
    try:
        yield js, ts
    finally:
        jfp.disarm_all()
        tfp.disarm_all()
        ts.close()
        js.close()


def _to_blob(s):
    """One pass through /debug/tier: every fragment idles past both
    ages, so the pass demotes it and pushes it to the blob store. The
    route shows the state from before its pass; the state after it
    comes from a second call."""
    st, _h, body = _call(s.host, "GET", "/debug/tier?pass=1")
    assert st == 200
    out = json.loads(_call(s.host, "GET", "/debug/tier?entries=1")[2])
    out["pass"] = json.loads(body)["pass"]
    assert out["tiers"]["hot"]["fragments"] == 0
    assert out["tiers"]["cold"]["fragments"] == 0
    return out


def _stable(state):
    """/debug/tier with the fields that name a directory or a moment
    taken out."""
    out = {k: v for k, v in state.items()
           if k not in ("store", "stallAgeS", "residentBytes")}
    if "entries" in out:
        out["entries"] = sorted(
            ({k: v for k, v in e.items() if k != "idleS"}
             for e in out["entries"]),
            key=lambda e: (e["frame"], e["view"], e["slice"]))
    for b in out.get("blocked", ()):
        b.pop("since", None)
        b.pop("reason", None)
    return out


def test_reads_over_blob_fragments_equal_the_hot_answers(tiered_pair):
    hot = [[_q(s.host, q) for q in QUERIES] for s in tiered_pair]
    assert hot[0] == hot[1] and all(a[0] == 200 for a in hot[1])
    states = [_stable(_to_blob(s)) for s in tiered_pair]
    assert states[0] == states[1]
    assert states[1]["tiers"]["blob"]["fragments"] >= SLICES
    assert states[1]["pass"]["pushed"] == states[1]["pass"]["demoted"]
    stubs = [sorted(p for p in os.listdir(os.path.join(
        s.holder.path, "it/f/views/standard/fragments"))) for s in
        tiered_pair]
    assert stubs[0] == stubs[1] == [f"{i}.blob" for i in range(SLICES)]
    cold = [[_q(s.host, q) for q in QUERIES] for s in tiered_pair]
    assert cold == hot
    after = [_stable(json.loads(_call(s.host, "GET", "/debug/tier")[2]))
             for s in tiered_pair]
    assert after[0] == after[1] and after[1]["blobFetches"] >= SLICES
    assert after[1]["tiers"]["blob"]["fragments"] == 0
    # Again from blob after a second push, now each query alone.
    for s in tiered_pair:
        _to_blob(s)
    again = [[_q(s.host, q) for q in reversed(QUERIES)]
             for s in tiered_pair]
    assert again[0] == again[1] == [list(reversed(hot[1]))][0]


def test_a_failed_fetch_degrades_alike_and_heals(tiered_pair):
    count = 'Count(Bitmap(frame="f", rowID=4))'
    want = [_q(s.host, count) for s in tiered_pair]
    for s in tiered_pair:
        _to_blob(s)
    seen = []
    for s, fp in zip(tiered_pair, (jfp, tfp)):
        fp.arm("tier.fetch", "partition(fetch)")
        try:
            first = _q(s.host, count)
            blocked = s.tier.slice_blocked("it", 0)
            again = _q(s.host, count)
            partial = _q(s.host, count, "?partial=1")
            state = _stable(json.loads(_call(s.host, "GET",
                                             "/debug/tier")[2]))
            # How many fetches a failing read attempts is the executor's
            # schedule, not an answer: the JAX leg runs its slices one
            # by one and tries each, the port's device leg builds one
            # slab over them and stops at the first fragment that fails.
            state["blocked"] = bool(state["blocked"])
            state["fetchFailures"] = state["fetchFailures"] > 0
        finally:
            fp.disarm_all()
        s.tier.pass_once()
        healed = (s.tier.slice_blocked("it", 0), _q(s.host, count))
        seen.append((first, blocked, again, partial, state, healed))
    assert seen[0] == seen[1]
    first, blocked, again, partial, state, healed = seen[1]
    assert first[0] >= 500 and again[0] >= 400 and blocked
    assert partial[0] == 200 and partial[1] is not None
    assert state["fetchFailures"] is True and state["blocked"] is True
    assert healed == (False, want[1])


def test_debug_tier_surface_equals_jax(tiered_pair, tmp_path):
    outs = []
    for s in tiered_pair:
        base = json.loads(_call(s.host, "GET", "/debug/tier")[2])
        _to_blob(s)
        listed = json.loads(_call(s.host, "GET",
                                  "/debug/tier?entries=1&tier=blob")[2])
        none = json.loads(_call(s.host, "GET",
                                "/debug/tier?entries=1&tier=hot")[2])
        bb = s._blackbox_state()["tier"]
        outs.append((sorted(base), base["enabled"], sorted(base["tiers"]),
                     sorted(base["store"]),
                     sorted(listed["entries"][0]),
                     {e["tier"] for e in listed["entries"]},
                     none["entries"], sorted(bb),
                     s.watchdog is None
                     or s.watchdog.tier_progress_fn == s.tier.stall_age))
    assert outs[0] == outs[1]
    assert outs[1][1] is True and outs[1][5] == {"blob"} and outs[1][8]
    from pilosa_tpu.server.handler import Handler as JHandler
    from pilosa_tpu_torch.server.handler import Handler as THandler
    stubs = []
    for s, cls in zip(tiered_pair, (JHandler, THandler)):
        h = cls(s.holder, s.executor, host="local")
        env = {"REQUEST_METHOD": "GET", "PATH_INFO": "/debug/tier",
               "QUERY_STRING": "", "CONTENT_LENGTH": "0",
               "wsgi.input": io.BytesIO(b"")}
        stubs.append(json.loads(b"".join(h(env, lambda *a: None))))
    assert stubs == [{"enabled": False}] * 2


def test_scrub_covers_the_blob_tier_alike(tiered_pair):
    outs = []
    for s in tiered_pair:
        _to_blob(s)
        clean = s.scrubber.pass_once()
        root = os.path.join(s.tier.cold_dir, "blob")
        for dirpath, _d, files in os.walk(root):
            for name in files:
                if name.startswith("blk-") and "/0" in dirpath[-3:]:
                    p = os.path.join(dirpath, name)
                    raw = bytearray(open(p, "rb").read())
                    raw[0] ^= 0xFF
                    open(p, "wb").write(bytes(raw))
        rotted = s.scrubber.pass_once()
        outs.append(({k: clean[k] for k in ("fragments", "corrupt")},
                     {k: rotted[k] for k in ("fragments", "corrupt")},
                     s.tier.slice_blocked("it", 0),
                     s.holder.quarantine.slice_blocked("it", 0)))
    assert outs[0] == outs[1]
    assert outs[1][0]["corrupt"] == 0 and outs[1][1]["corrupt"] >= 1
    assert outs[1][2:] == (True, False)


def _check_deep(cmds, path):
    out = io.StringIO()
    rc = cmds.cmd_check(argparse.Namespace(paths=[str(path)], deep=True,
                                           archive=""), out, out)
    return rc, out.getvalue().replace(str(path), "<dir>")


def test_check_deep_over_stubs_equals_jax(tiered_pair, tmp_path):
    for s in tiered_pair:
        _to_blob(s)
    # Every fragment is a stub now: the live directories hold no data
    # file a server could be writing.
    dirs = [s.holder.path for s in tiered_pair]
    clean = [_check_deep(c, d) for c, d in zip((jcmds, tcmds), dirs)]
    assert clean[0] == clean[1]
    assert clean[1][0] == 0
    assert clean[1][1].count("ok (blob tier,") >= SLICES
    for d in dirs:
        root = os.path.join(d, "_tier", "blob", "it", "f", "standard", "1")
        name = next(n for n in sorted(os.listdir(root))
                    if n.startswith("blk-0-"))
        raw = bytearray(open(os.path.join(root, name), "rb").read())
        raw[-1] ^= 0x01
        open(os.path.join(root, name), "wb").write(bytes(raw))
    rotted = [_check_deep(c, d) for c, d in zip((jcmds, tcmds), dirs)]
    assert rotted[0] == rotted[1]
    assert rotted[1][0] == 1 and "CORRUPT (blob it/f/standard/1)" in \
        rotted[1][1]

"""The port's replay (obs.replay and the ``replay`` verb) over the port's
own capture.

A JAX server and a port server (capture on, ``mode = "full"``) take the
same request stream, made from a numpy seed. The port's ``shadow`` of
the port's capture, with the JAX server as the baseline and the port
server as the candidate, compares every captured read and finds no
mismatch; the ``replay --records F --shadow A B`` verb agrees (rc 0).
One extra SetBit on the candidate alone diverges it: the shadow then
reports mismatches with their dumps, and the verb returns rc 1. A plain
replay re-issues the stream with the JAX replay's summary shape, and
``load_records`` reads the same files as the JAX package's.
"""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.obs import replay as jreplay
from pilosa_tpu.server.server import Server as JaxServer

from pilosa_tpu_torch.cli import commands as port_cli
from pilosa_tpu_torch.obs import replay as treplay
from pilosa_tpu_torch.server.server import Server as PortServer
from pilosa_tpu_torch.utils.config import CaptureConfig

N_SLICES = 3


def _post(host, path, body, headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _stream(rng):
    n_cols = N_SLICES * SLICE_WIDTH
    out = []
    for i in range(60):
        op = "ClearBit" if i % 6 == 5 else "SetBit"
        out.append(f'{op}(frame="f", rowID={int(rng.integers(8))},'
                   f' columnID={int(rng.integers(n_cols))})')
    for _ in range(25):
        a, b, c = rng.integers(8, size=3)
        out.append(f'Count(Intersect(Bitmap(rowID={a}, frame="f"),'
                   f' Union(Bitmap(rowID={b}, frame="f"),'
                   f' Bitmap(rowID={c}, frame="f"))))')
    out += ['TopN(frame="f", n=4)', 'Bitmap(rowID=1, frame="f")',
            'Count(Bitmap(rowID=1, frame="nope"))']
    return out


@pytest.fixture
def pair(tmp_path):
    js = JaxServer(str(tmp_path / "jax"), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    ps = PortServer(str(tmp_path / "port"), host="127.0.0.1:0",
                    device="cpu", warmup=False,
                    capture_config=CaptureConfig(mode="full"))
    js.open()
    try:
        ps.open()
        try:
            for host in (js.host, ps.host):
                for path in ("/index/i", "/index/i/frame/f"):
                    assert _post(host, path, b"{}") == 200
            for pql in _stream(np.random.default_rng(404)):
                got = {_post(h, "/index/i/query", pql.encode())
                       for h in (js.host, ps.host)}
                assert len(got) == 1, pql
            yield js, ps
        finally:
            ps.close()
    finally:
        js.close()


def test_port_shadow_of_port_capture(pair, tmp_path):
    js, ps = pair
    records = treplay.fetch_records(ps.host, limit=100000)
    assert records == jreplay.fetch_records(ps.host, limit=100000)
    reads = [r for r in records if r["lane"] == "read"
             and r["status"] == 200]
    writes = [r for r in records if r["lane"] != "read"]
    assert len(records) == len(_stream(np.random.default_rng(404)))
    # Every read the port captured, against the JAX baseline.
    out = treplay.shadow(records, js.host, ps.host, senders=4)
    assert out["mismatches"] == 0, out["dumps"][:2]
    assert out["reads_compared"] == len(reads)
    assert out["writes_replayed"] == len(writes)
    # The JAX shadow of the same records agrees.
    jout = jreplay.shadow(records, js.host, ps.host, senders=4)
    assert {k: jout[k] for k in ("reads_compared", "mismatches")} == {
        k: out[k] for k in ("reads_compared", "mismatches")}
    # The verb, from a records file: rc 0.
    path = tmp_path / "records.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    so, se = io.StringIO(), io.StringIO()
    rc = port_cli.main(["replay", "--records", str(path), "--shadow",
                        js.host, ps.host, "--out",
                        str(tmp_path / "sum.json")], stdout=so, stderr=se)
    assert rc == 0, se.getvalue()
    summary = json.loads(so.getvalue())
    assert summary["mismatches"] == 0
    assert summary["reads_compared"] == len(reads)
    assert json.loads((tmp_path / "sum.json").read_text()) == summary

    # Diverge the candidate: one bit only the port server holds.
    assert _post(ps.host, "/index/i/query",
                 b'SetBit(frame="f", rowID=1, columnID=5)') == 200
    assert _post(ps.host, "/index/i/query",
                 b'SetBit(frame="f", rowID=2, columnID=6)') == 200
    out = treplay.shadow(records, js.host, ps.host, senders=4)
    assert out["mismatches"] > 0
    dump = out["dumps"][0]
    assert dump["baselineDigest"] != dump["candidateDigest"]
    assert "baselineResults" in dump and "candidateResults" in dump
    so, se = io.StringIO(), io.StringIO()
    rc = port_cli.main(["replay", "--records", str(path), "--shadow",
                        js.host, ps.host], stdout=so, stderr=se)
    assert rc == 1
    assert json.loads(so.getvalue())["mismatches"] == out["mismatches"]


def test_plain_replay_and_loading(pair, tmp_path):
    js, ps = pair
    records = treplay.fetch_records(ps.host, limit=100000)
    n_failed = sum(1 for r in records if r["status"] != 200)
    out = treplay.replay(records, js.host, rate=200.0, senders=4)
    jout = jreplay.replay(records, js.host, rate=200.0, senders=4)
    assert set(out) == set(jout)
    for got in (out, jout):
        assert got["offered"] == len(records)
        assert got["completed"] == len(records) - n_failed
        assert got["errors"] == n_failed == 1
    # The verb's live-export form (--host) against the port node.
    so, se = io.StringIO(), io.StringIO()
    assert port_cli.main(["replay", "--host", ps.host, "--rate", "x200",
                          "--senders", "2"], stdout=so, stderr=se) == 0
    got = json.loads(so.getvalue())
    assert got["offered"] == len(records) and got["errors"] == 1
    # load_records: JSONL and a saved /debug/capture/records answer.
    jsonl = tmp_path / "r.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in records[:5]))
    doc = tmp_path / "r.json"
    doc.write_text(json.dumps({"records": records[:5]}))
    for p in (jsonl, doc):
        assert (treplay.load_records(str(p))
                == jreplay.load_records(str(p)) == records[:5])
    assert treplay.schedule(records, 3.0) == jreplay.schedule(records, 3.0)
    # An empty records file: rc 1 with the JAX verb's message.
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    se = io.StringIO()
    assert port_cli.main(["replay", "--records", str(empty)],
                         stdout=io.StringIO(), stderr=se) == 1
    assert "no capture records to replay" in se.getvalue()

"""The port's workload capture (obs.capture) against the JAX package's.

- The same request stream (made from a numpy seed) sent to a JAX server
  and a port server, each with ``[capture] mode = "full"``: the two
  capture streams agree record for record on ``kind``, ``pql``,
  ``index``, ``tenant``, ``lane``, ``status``, ``opts`` and the result
  ``digest`` — writes, reads over every call family the stream sends,
  a query that fails (400, no digest), protobuf import acks — and every
  200 answer carries the same ``X-Pilosa-Result-Digest`` header.
- ``result_digest`` and ``redact_pql`` agree on seeded inputs; the
  sampled mode takes the same records; a torn ring tail is skipped on
  reopen in both, and the cursor stays monotonic.
- ``?since=`` pages and ``?scope=cluster`` merges alike.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.obs import capture as jcap
from pilosa_tpu.proto import internal_pb2 as jax_pb
from pilosa_tpu.server.server import Server as JaxServer
from pilosa_tpu.utils.config import CaptureConfig as JCaptureConfig

from pilosa_tpu_torch.obs import capture as tcap
from pilosa_tpu_torch.server.server import Server as PortServer
from pilosa_tpu_torch.utils.config import CaptureConfig as TCaptureConfig

N_SLICES = 3
PB = {"Content-Type": "application/x-protobuf",
      "Accept": "application/x-protobuf"}
COMPARED = ("kind", "pql", "index", "tenant", "lane", "status", "opts",
            "digest", "bits", "slice", "frame")


def _request(host, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _stream(rng):
    """(path suffix, body, headers) requests; the first ones build the
    schema (not captured: schema DDL is not query traffic)."""
    n_cols = N_SLICES * SLICE_WIDTH
    out = []
    for i in range(40):
        frame = ("f", "g")[i % 2]
        op = "ClearBit" if i % 5 == 4 else "SetBit"
        out.append(("/index/i/query",
                    f'{op}(frame="{frame}", rowID={int(rng.integers(12))},'
                    f' columnID={int(rng.integers(n_cols))})'.encode(), {}))
        if i % 10 == 0:
            cols = rng.integers(n_cols, size=200)
            s = int(cols[0]) // SLICE_WIDTH
            cols = s * SLICE_WIDTH + cols % SLICE_WIDTH
            out.append(("/import", jax_pb.ImportRequest(
                Index="i", Frame=frame, Slice=s,
                RowIDs=rng.integers(12, size=200).tolist(),
                ColumnIDs=cols.tolist()).SerializeToString(), PB))
    for _ in range(12):
        a, b = rng.integers(12, size=2)
        out.append(("/index/i/query",
                    f'Count(Union(Bitmap(rowID={a}, frame="f"),'
                    f' Bitmap(rowID={b}, frame="g")))'.encode(), {}))
    out.append(("/index/i/query", b'TopN(frame="f", n=5)', {}))
    out.append(("/index/i/query",
                b'TopN(Bitmap(rowID=1, frame="g"), frame="f", n=4)', {}))
    out.append(("/index/i/query", b'Bitmap(rowID=2, frame="f")', {}))
    out.append(("/index/i/query", b'Count(Bitmap(rowID=1, frame="nope"))',
                {}))  # 400 in both: a record, no digest
    out.append(("/index/i/query?timeout=30s",
                b'Count(Bitmap(rowID=3, frame="g"))', {}))
    out.append(("/index/i/query?partial=1",
                b'Count(Bitmap(rowID=4, frame="f"))',
                {"X-Pilosa-Tenant": "acme"}))
    out.append(("/index/i/query", b'SetRowAttrs(frame="f", rowID=1, x=2)',
                {"X-Pilosa-Tenant": "acme"}))
    return out


@pytest.fixture
def servers(tmp_path):
    js = JaxServer(str(tmp_path / "jax"), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0,
                   capture_config=JCaptureConfig(mode="full"))
    ps = PortServer(str(tmp_path / "port"), host="127.0.0.1:0",
                    device="cpu", warmup=False,
                    capture_config=TCaptureConfig(mode="full"))
    js.open()
    try:
        ps.open()
        try:
            yield js, ps
        finally:
            ps.close()
    finally:
        js.close()


def test_same_stream_same_records(servers):
    js, ps = servers
    for host in (js.host, ps.host):
        for path in ("/index/i", "/index/i/frame/f", "/index/i/frame/g"):
            assert _request(host, "POST", path, b"{}")[0] == 200
    steps = _stream(np.random.default_rng(808))
    for path, body, headers in steps:
        got = [_request(h, "POST", path, body, headers)
               for h in (js.host, ps.host)]
        (js_st, js_body, js_h), (ps_st, ps_body, ps_h) = got
        assert js_st == ps_st, (path, body, js_body, ps_body)
        assert (js_h.get(jcap.DIGEST_HEADER)
                == ps_h.get(tcap.DIGEST_HEADER)), (path, body)
        if js_st == 200 and path != "/import":
            assert len(ps_h[tcap.DIGEST_HEADER]) == 16
    jrecs = json.loads(_request(js.host, "GET",
                                "/debug/capture/records?limit=1000")[1])
    trecs = json.loads(_request(ps.host, "GET",
                                "/debug/capture/records?limit=1000")[1])
    assert len(trecs["records"]) == len(steps)
    assert [{k: r.get(k) for k in COMPARED} for r in trecs["records"]] \
        == [{k: r.get(k) for k in COMPARED} for r in jrecs["records"]]
    assert [r["seq"] for r in trecs["records"]] == list(
        range(1, len(steps) + 1))
    assert trecs["next"] == len(steps)
    assert all(r["node"] == ps.host for r in trecs["records"])
    failed = [r for r in trecs["records"] if r["status"] != 200]
    assert len(failed) == 1 and failed[0]["digest"] == ""
    # Paging with ?since= gives the same pages.
    for since, limit in ((0, 7), (10, 5), (len(steps), 3)):
        q = f"/debug/capture/records?since={since}&limit={limit}"
        j = json.loads(_request(js.host, "GET", q)[1])
        t = json.loads(_request(ps.host, "GET", q)[1])
        assert ([r["seq"] for r in t["records"]]
                == [r["seq"] for r in j["records"]])
        assert t["next"] == j["next"]
    # The status blocks agree but for the ring's byte counts and node.
    js_st = json.loads(_request(js.host, "GET", "/debug/capture")[1])
    ps_st = json.loads(_request(ps.host, "GET", "/debug/capture")[1])
    for blk in (js_st, ps_st):
        blk.pop("node")
        blk["ring"] = sorted(blk["ring"])
    assert ps_st == js_st
    # A one-node ?scope=cluster merge is the local stream.
    merged = json.loads(_request(
        ps.host, "GET", "/debug/capture/records?scope=cluster&limit=1000"
    )[1])
    assert merged["nodes"] == [ps.host] and merged["missing"] == []
    assert merged["records"] == trecs["records"]


def _results(rng, n):
    out = []
    for _ in range(n):
        kind = rng.integers(5)
        if kind == 0:
            out.append(int(rng.integers(1 << 40)))
        elif kind == 1:
            pairs = [{"id": int(i), "count": int(c)} for i, c in zip(
                rng.integers(50, size=6), rng.integers(4, size=6))]
            out.append(pairs)
        elif kind == 2:
            out.append({"attrs": {"b": 1, "a": "x"},
                        "bits": sorted(rng.integers(1 << 20, size=5)
                                       .tolist())})
        elif kind == 3:
            out.append(bool(rng.integers(2)))
        else:
            out.append({"value": int(rng.integers(-9, 9)),
                        "count": int(rng.integers(9))})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_digest_and_redaction_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        res = _results(rng, int(rng.integers(0, 4)))
        assert tcap.result_digest(res) == jcap.result_digest(res)
        assert tcap.normalize_result(res) == jcap.normalize_result(res)
    for _ in range(40):
        pql = (f'Count(Bitmap(rowID={int(rng.integers(1000))},'
               f' frame="f{int(rng.integers(9))}")) '
               f'SetRowAttrs(frame=g, rowID={int(rng.integers(99))},'
               f' name="a\\"b{int(rng.integers(9))}", x=1.{seed})')
        assert tcap.redact_pql(pql) == jcap.redact_pql(pql)


def test_sampled_mode_takes_the_same_records(tmp_path):
    rng = np.random.default_rng(9)
    lanes = [str(x) for x in rng.choice(["read", "write", "admin"],
                                        size=200, p=[0.8, 0.15, 0.05])]
    picks = []
    for mod, name in ((jcap, "j"), (tcap, "t")):
        s = mod.CaptureStore(str(tmp_path / name), mode="sampled",
                             sample_n=7, redact_tenants={"secret"})
        picks.append(([s.should_capture(lane) for lane in lanes],
                      s.redacts("secret"), s.redacts("open")))
        s.close()
    assert picks[0] == picks[1]
    assert sum(picks[1][0]) < len(lanes)


def test_torn_ring_tail_skipped_on_reopen(tmp_path):
    exports = []
    for mod, name in ((jcap, "j"), (tcap, "t")):
        d = str(tmp_path / name)
        s = mod.CaptureStore(d, mode="full", node="n1")
        for i in range(8):
            s.add("query", f"Count(Bitmap(rowID={i}))", "i", "i", "read",
                  f"q{i}", 200, 0.001, digest=f"{i:016x}",
                  wall=1000.0 + i, mono=50.0 + i)
        s.close()
        segs = sorted(f for f in os.listdir(d) if f.endswith(".jsonl"))
        tail = os.path.join(d, segs[-1])
        with open(tail, "rb") as f:
            raw = f.read()
        with open(tail, "wb") as f:
            f.write(raw[:-7])  # tear the last frame mid-line
        s = mod.CaptureStore(d, mode="full", node="n1")
        recs = s.export()
        cid = s.add("query", "Count()", "i", "i", "read", "q8", 200,
                    0.001, wall=2000.0, mono=99.0)
        exports.append((recs, cid, s.export(since=cid - 1)))
        s.close()
    assert exports[0] == exports[1]
    recs, cid, after = exports[1]
    assert len(recs) == 7 and cid == 8
    assert [r["seq"] for r in after] == [8]
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "t"))


def test_merge_and_offsets_match():
    rng = np.random.default_rng(5)
    streams = []
    for node in ("a:1", "b:2", "c:3"):
        ts = np.sort(rng.uniform(0, 10, size=6))
        streams.append([{"seq": i + 1, "t": float(t), "mono": float(t) + 5,
                         "node": node} for i, t in enumerate(ts)])
    assert tcap.merge_streams(streams) == jcap.merge_streams(streams)
    merged = tcap.merge_streams(streams)
    assert tcap.arrival_offsets(merged) == jcap.arrival_offsets(merged)
    assert (tcap.arrival_offsets(streams[0])
            == jcap.arrival_offsets(streams[0]))


def test_capture_survives_a_restart(tmp_path):
    d = str(tmp_path / "p")
    for round_ in range(2):
        ps = PortServer(d, host="127.0.0.1:0", device="cpu", warmup=False,
                        capture_config=TCaptureConfig(mode="full"))
        ps.open()
        try:
            if round_ == 0:
                for path in ("/index/i", "/index/i/frame/f"):
                    assert _request(ps.host, "POST", path, b"{}")[0] == 200
            assert _request(ps.host, "POST", "/index/i/query",
                            b'SetBit(frame="f", rowID=1, columnID=2)'
                            )[0] == 200
            recs = json.loads(_request(ps.host, "GET",
                                       "/debug/capture/records")[1])
        finally:
            ps.close()
    assert [r["seq"] for r in recs["records"]] == [1, 2]
    shutil.rmtree(d)

"""The HTTP front's pipelined query batch lane: the port's server against
the JAX package's, over a raw socket.

A JAX ``Holder`` writes a small data directory and closes it; the
directory is copied. A ``pilosa_tpu`` ``Server`` serves the original, a
``pilosa_tpu_torch`` ``Server(device="cpu")`` the copy. Each pipelined
run — a SetBit burst, one with a failing call in the middle, a read run
of Counts and TopNs with a failing Count, multi-call bodies — goes to
both on one keep-alive connection in one write, and the response bytes
must be identical. The port must run each batched run as ONE
``execute_partial`` call, answer each request as it would alone (a
repeated SetBit false, the request after a failing one run on its own)
and keep every acked SetBit across a reopen.
"""

import shutil
import socket

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.server.server import Server as JaxServer

from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.server.server import Server as PortServer

N_SLICES = 3


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    jax_dir, port_dir = root / "jax", root / "port"
    jh = JaxHolder(str(jax_dir))
    jh.open()
    rng = np.random.default_rng(31)
    idx = jh.create_index("d")
    for name in ("f", "t"):
        fr = idx.create_frame(name)
        for row in range(12):
            cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=500,
                                dtype=np.uint64)
            fr.import_bits(np.full(len(cols), row, np.uint64), cols)
    jh.close()
    shutil.copytree(jax_dir, port_dir)
    js = JaxServer(str(jax_dir), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    js.open()
    ps = PortServer(str(port_dir), host="127.0.0.1:0", device="cpu")
    ps.open()
    calls = []
    real = ps.executor.execute_partial

    def counted(*a, **kw):
        calls.append(len(a[1].calls))
        return real(*a, **kw)
    ps.executor.execute_partial = counted
    yield js, ps, calls, port_dir
    ps.close()
    js.close()
    residency.device_cache().clear()


def _request(body: str, index: str = "d") -> bytes:
    b = body.encode()
    return (f"POST /index/{index}/query HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(b)}\r\n\r\n").encode() + b


def _responses(host: str, reqs: list[bytes]) -> list[bytes]:
    """Send ``reqs`` pipelined in one write on one connection; the raw
    bytes of each response, in order."""
    h, port = host.split(":")
    out: list[bytes] = []
    buf = b""
    with socket.create_connection((h, int(port)), timeout=60) as s:
        s.sendall(b"".join(reqs))
        while len(out) < len(reqs):
            end = buf.find(b"\r\n\r\n")
            if end >= 0:
                head = buf[:end].decode("latin-1").lower()
                length = int(head.split("content-length:")[1]
                             .split("\r\n")[0])
                if len(buf) >= end + 4 + length:
                    out.append(buf[:end + 4 + length])
                    buf = buf[end + 4 + length:]
                    continue
            chunk = s.recv(1 << 16)
            assert chunk, "connection closed early"
            buf += chunk
    return out


def _both(servers, bodies):
    js, ps, calls, _ = servers
    reqs = [_request(b) for b in bodies]
    del calls[:]
    want = _responses(js.host, reqs)
    got = _responses(ps.host, reqs)
    assert got == want
    return got


def _status(resp: bytes) -> int:
    return int(resp.split(b" ", 2)[1])


def _body(resp: bytes) -> bytes:
    return resp.split(b"\r\n\r\n", 1)[1]


def test_setbit_burst(servers):
    rng = np.random.default_rng(1)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=40).tolist()
    bodies = [f"SetBit(frame=f, rowID={20 + i % 3}, columnID={c})"
              for i, c in enumerate(cols)]
    bodies += bodies[:5]  # again: each answers false
    got = _both(servers, bodies)
    assert [_body(r) for r in got[-5:]] == [b'{"results": [false]}\n'] * 5
    assert all(_status(r) == 200 for r in got)
    assert servers[2] == [len(bodies)]  # one executor call


def test_failing_write_mid_run(servers):
    bodies = [f"SetBit(frame=f, rowID=30, columnID={c})"
              for c in range(5)]
    bodies += ["SetBit(frame=nope, rowID=1, columnID=1)"]
    bodies += [f"SetBit(frame=f, rowID=30, columnID={c})"
               for c in range(3, 8)]
    bodies += ["Count(Bitmap(rowID=30, frame=f))"]
    got = _both(servers, bodies)
    assert [_status(r) for r in got] == [200] * 5 + [400] + [200] * 6
    assert _body(got[-1]) == b'{"results": [8]}\n'
    assert _body(got[6]) == b'{"results": [false]}\n'
    # One combined call; the requests after the failing one run alone.
    assert servers[2] == [len(bodies)]


def test_read_run_with_a_failing_count(servers):
    ids = list(range(12))
    bodies = ["Count(Bitmap(rowID=1, frame=f))",
              f"TopN(Bitmap(rowID=2, frame=f), frame=t, ids={ids})",
              "Count(Intersect(Bitmap(rowID=1, frame=f),"
              " Bitmap(rowID=2, frame=t)))",
              "Count(Bitmap(rowID=1, frame=nope))",
              "Count(Union(Bitmap(rowID=3, frame=f),"
              " Bitmap(rowID=4, frame=f)))",
              "TopN(frame=t, n=3)"]
    got = _both(servers, bodies)
    assert [_status(r) for r in got] == [200, 200, 200, 400, 200, 200]
    assert servers[2] == [len(bodies)]


def test_multi_call_bodies(servers):
    bodies = ["SetBit(frame=f, rowID=40, columnID=1)"
              " SetBit(frame=f, rowID=40, columnID=2)",
              "Count(Bitmap(rowID=40, frame=f))"
              " Count(Bitmap(rowID=1, frame=f))",
              "ClearBit(frame=f, rowID=40, columnID=1)",
              "Count(Bitmap(rowID=40, frame=f))"
              " Bitmap(rowID=40, frame=f)"]
    got = _both(servers, bodies)
    assert _body(got[3]) == b'{"results": [1, {"attrs": {}, "bits": [2]}]}\n'
    assert servers[2] == [7]


def test_write_to_a_new_slice_then_count(servers):
    """A pipelined SetBit into a slice past the index's last one, then
    a Count of its row: the port answers as the JAX server does with
    each request sent alone (the JAX server's one pipelined run misses
    the new slice, ROADMAP fault 3.6 of the reference). The port's run
    ends after each slice-adding write."""
    js, ps, calls, _ = servers
    bodies = [f"SetBit(frame=f, rowID=50, columnID={7 * SLICE_WIDTH + 3})",
              "Count(Bitmap(rowID=50, frame=f))",
              "SetBit(frame=f, rowID=50, columnID=1)",
              "Count(Bitmap(rowID=50, frame=f))",
              f"SetBit(frame=f, rowID=51, columnID={9 * SLICE_WIDTH})"
              f" Count(Bitmap(rowID=51, frame=f))",
              "Count(Bitmap(rowID=51, frame=f))"]
    reqs = [_request(b) for b in bodies]
    del calls[:]
    want = [_responses(js.host, [r])[0] for r in reqs]  # one by one
    got = _responses(ps.host, reqs)
    # A request sent alone carries the JAX server's per-query headers:
    # the status and body are what it answers.
    assert [(_status(r), _body(r)) for r in got] == \
        [(_status(r), _body(r)) for r in want]
    # Within one request the slice list is taken once, as in the
    # reference: its Count misses the bit its SetBit put in a new slice.
    assert [_body(r) for r in got] == [
        b'{"results": [true]}\n', b'{"results": [1]}\n',
        b'{"results": [true]}\n', b'{"results": [2]}\n',
        b'{"results": [true, 0]}\n', b'{"results": [1]}\n']
    assert calls == [1, 5, 1]


def test_write_to_a_new_inverse_slice_then_read(servers):
    """The inverse view's slices follow row ids: a pipelined SetBit of a
    row past the last inverse slice, then a column's Bitmap (which reads
    the inverse slice list), answers as sent alone."""
    js, ps, calls, _ = servers
    opts = b'{"options": {"inverseEnabled": true}}'
    frame = (b"POST /index/d/frame/inv HTTP/1.1\r\nContent-Length: "
             + str(len(opts)).encode() + b"\r\n\r\n" + opts)
    for host in (js.host, ps.host):
        assert _status(_responses(host, [frame])[0]) == 200
    row = 4 * SLICE_WIDTH + 2
    bodies = ["SetBit(frame=inv, rowID=1, columnID=7)",
              f"SetBit(frame=inv, rowID={row}, columnID=7)",
              "Bitmap(columnID=7, frame=inv)",
              "Count(Bitmap(rowID=1, frame=inv))"]
    reqs = [_request(b) for b in bodies]
    del calls[:]
    want = [_responses(js.host, [r])[0] for r in reqs]
    got = _responses(ps.host, reqs)
    assert [(_status(r), _body(r)) for r in got] == \
        [(_status(r), _body(r)) for r in want]
    assert str(row).encode() in _body(got[2])
    assert calls == [2, 2]


def test_unparsable_request_goes_one_by_one(servers):
    js, ps, calls, _ = servers
    bodies = ["Count(Bitmap(rowID=1, frame=f))", "Count(Bitmap(",
              "Count(Bitmap(rowID=2, frame=f))"]
    reqs = [_request(b) for b in bodies]
    del calls[:]
    want = _responses(js.host, reqs)
    got = _responses(ps.host, reqs)
    assert [(_status(r), _body(r)) for r in got] == \
        [(_status(r), _body(r)) for r in want]
    assert [_status(r) for r in got] == [200, 400, 200]
    assert calls == []  # the batcher declined: per-request dispatch


def test_acked_pipelined_setbits_survive_a_reopen(tmp_path):
    srv = PortServer(str(tmp_path / "d"), host="127.0.0.1:0", device="cpu")
    srv.open()
    try:
        _responses(srv.host, [
            b"POST /index/d HTTP/1.1\r\nContent-Length: 2\r\n\r\n{}",
            b"POST /index/d/frame/f HTTP/1.1\r\nContent-Length: 2\r\n\r\n{}"])
        cols = np.random.default_rng(2).integers(
            0, N_SLICES * SLICE_WIDTH, size=300).tolist()
        got = _responses(srv.host, [
            _request(f"SetBit(frame=f, rowID={i % 4}, columnID={c})")
            for i, c in enumerate(cols)])
        assert all(_status(r) == 200 for r in got)
    finally:
        srv.close()
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        for i, c in enumerate(cols):
            frag = h.fragment("d", "f", "standard", c // SLICE_WIDTH)
            assert c in frag.row(i % 4).bits().tolist()
    finally:
        h.close()

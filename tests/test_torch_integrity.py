"""Storage integrity and disk-full degradation: the port against the JAX
package on the CPU.

The cases of ``tests/test_scrub.py`` (footer, corrupt failpoint,
fragment quarantine, scrubber, serving gates, repair, the 507 import
retry), each run through both packages on the same seeded bytes:

- ``scrub_file`` gives equal verdicts on a clean file, a flipped body,
  header or footer byte, a torn WAL tail and a vintage file;
- a seeded ``corrupt`` failpoint flips the same bits in both;
- both fragments quarantine the same corrupted file with the same
  reason and leave the same ``.corrupt`` bytes; verify-on-read trips on
  the same read; the same armed ``enospc``/``torn``/``corrupt``
  failpoints at ``wal.append``, ``snapshot.write`` and ``storage.read``
  leave the same file bytes and raise the same errors;
- ``Scrubber.pass_once`` summarises copies of one directory alike;
- a port ``Repairer`` restores a quarantined fragment to its replica's
  exact bits (two in-process port servers, replicas 2);
- a JAX server and a port server over copies of one directory answer the
  same 503 for a quarantined one-node slice, the same 507 with
  ``Retry-After`` while write-unready, the same 409 on the fragment
  routes, and the same ``/debug/integrity`` entries (times aside).
"""

import io
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import pilosa_tpu.fault.diskfull as jdf
import pilosa_tpu.fault.failpoints as jfp
import pilosa_tpu.storage.fragment as jfrag
import pilosa_tpu.storage.integrity as jint
import pilosa_tpu.storage.roaring as jroar
import pilosa_tpu.storage.scrub as jscrub

import pilosa_tpu_torch.fault.diskfull as tdf
import pilosa_tpu_torch.fault.failpoints as tfp
import pilosa_tpu_torch.storage.fragment as tfrag
import pilosa_tpu_torch.storage.integrity as tint
import pilosa_tpu_torch.storage.roaring as troar
import pilosa_tpu_torch.storage.scrub as tscrub

from pilosa_tpu_torch import SLICE_WIDTH

PKGS = (("jax", jfp, jfrag, jint, jroar, jscrub, jdf),
        ("torch", tfp, tfrag, tint, troar, tscrub, tdf))


@pytest.fixture(autouse=True)
def _clean_global_state():
    yield
    for _n, fp, *_rest, df in PKGS:
        fp.disarm_all()
        # A test's seeded registry (monkeypatched in as the default) may
        # still be the armed one.
        fp.ACTIVE = None
        df.default().reset()


def _bitmap_bytes(roar, n=5000, seed=3, footer=True):
    rng = np.random.default_rng(seed)
    b = roar.Bitmap()
    b.add_many(rng.choice(1 << 22, size=n, replace=False)
               .astype(np.uint64))
    if not footer:
        return b.marshal()
    buf = io.BytesIO()
    b.write_to(buf, footer=True)
    return buf.getvalue()


def _with_ops(roar, data: bytes, n_ops: int = 3) -> bytes:
    return data + b"".join(roar.Op(roar.OP_ADD, 100 + i).marshal()
                           for i in range(n_ops))


def _variants(roar):
    """name → file bytes, built with ``roar`` (each package's own
    writer; the bytes are compared across packages too)."""
    clean = _bitmap_bytes(roar)
    body_len = roar.Bitmap.unmarshal(clean).footer.body_len
    body = bytearray(clean)
    body[body_len - 33] ^= 0x08
    header = bytearray(clean)
    header[9] ^= 0x01
    footer = bytearray(clean)
    footer[-6] ^= 0x40
    wal = _with_ops(roar, clean)
    wal_bad = bytearray(wal)
    wal_bad[-20] ^= 0x04
    return {"clean": clean, "body": bytes(body), "header": bytes(header),
            "footer": bytes(footer), "torn_wal": wal + b"\x00\x01\x02",
            "bad_wal": bytes(wal_bad),
            "vintage": _with_ops(roar, _bitmap_bytes(roar, footer=False)),
            "torn_footer": clean[:len(roar.Bitmap.unmarshal(clean)
                                      .marshal()) + 7]}


# -- verdicts -----------------------------------------------------------------

def test_variant_bytes_equal_across_packages():
    assert _variants(jroar) == _variants(troar)


@pytest.mark.parametrize("name", ["clean", "body", "header", "footer",
                                  "torn_wal", "bad_wal", "vintage",
                                  "torn_footer"])
def test_scrub_file_verdicts_equal(tmp_path, name):
    data = _variants(troar)[name]
    p = tmp_path / "f"
    p.write_bytes(data)
    want = jscrub.scrub_file(str(p))
    got = tscrub.scrub_file(str(p))
    assert got == want
    assert got["corrupt"] == (name in ("body", "header", "footer",
                                       "bad_wal"))
    assert tscrub.scrub_buffer(data) == jscrub.scrub_buffer(data)


def test_unreadable_file_verdict(tmp_path):
    p = str(tmp_path / "absent")
    assert tscrub.scrub_file(p) == jscrub.scrub_file(p)


# -- the corrupt failpoint ----------------------------------------------------

@pytest.mark.parametrize("spec", ["corrupt", "corrupt(3)", "corrupt(5)*1"])
def test_seeded_corrupt_flips_the_same_bits(tmp_path, monkeypatch, spec):
    out = []
    for name, fp, *_ in PKGS:
        monkeypatch.setattr(fp, "_default", fp.Failpoints(seed=11))
        p = tmp_path / name
        p.write_bytes(bytes(4096))
        fp.arm("storage.read", spec)
        fp.default().hit("storage.read", path=str(p))
        fp.default().hit("storage.read", path=str(p))
        out.append(p.read_bytes())
        fp.disarm_all()
    assert out[0] == out[1]
    assert out[1] != bytes(4096)


def test_corrupt_missing_path_and_writer(tmp_path, monkeypatch):
    """No file yet is a no-op that still consumes the trigger; a
    snapshot writer (write-only, by name) gets the same flips."""
    out = []
    for name, fp, *_ in PKGS:
        monkeypatch.setattr(fp, "_default", fp.Failpoints(seed=3))
        fp.arm("storage.read", "corrupt(4)*1")
        fp.default().hit("storage.read", path=str(tmp_path / "nope"))
        assert fp.ACTIVE is None
        p = tmp_path / name
        fp.arm("snapshot.write", "corrupt(4)")
        with open(p, "wb") as f:
            f.write(bytes(1024))
            fp.default().hit("snapshot.write", writer=f)
        fp.disarm_all()
        out.append(p.read_bytes())
    assert out[0] == out[1] != bytes(1024)


# -- fragment quarantine ------------------------------------------------------

def _make_fragment(frag_mod, int_mod, path, n_bits=800, q=None):
    q = q if q is not None else int_mod.QuarantineRegistry()
    f = frag_mod.Fragment(str(path), "i", "f", "standard", 0, quarantine=q)
    f.open()
    for i in range(n_bits):
        f.set_bit(3, (i * 7919) % SLICE_WIDTH)
    f.snapshot(sync=True)
    return f, q


def test_open_quarantines_the_same_file(tmp_path):
    f, _ = _make_fragment(tfrag, tint, tmp_path / "seed")
    f.close()
    raw = bytearray((tmp_path / "seed").read_bytes())
    raw[len(raw) // 2] ^= 0x10
    outs = []
    for name, _fp, frag_mod, int_mod, *_ in PKGS:
        p = tmp_path / name
        p.write_bytes(bytes(raw))
        q = int_mod.QuarantineRegistry()
        g = frag_mod.Fragment(str(p), "i", "f", "standard", 0, quarantine=q)
        g.open()
        try:
            assert g.quarantined and q.slice_blocked("i", 0)
            assert g.set_bit(9, 42)  # writes keep applying
            entry = {k: v for k, v in q.entries()[0].items()
                     if k not in ("since", "path")}
            outs.append((g.quarantine_reason, entry,
                         (tmp_path / (name + ".corrupt")).read_bytes(),
                         g.row_count(3), g.row_count(9)))
        finally:
            g.close()
        # The sentinel re-quarantines a restart before the repair.
        g2 = frag_mod.Fragment(str(p), "i", "f", "standard", 0,
                               quarantine=int_mod.QuarantineRegistry())
        g2.open()
        try:
            assert g2.quarantined
            assert g2.quarantine_reason.startswith("pending repair")
            g2.clear_quarantine()
            assert not os.path.exists(str(p) + ".corrupt")
        finally:
            g2.close()
    assert outs[0] == outs[1]
    assert outs[1][2] == bytes(raw)


def test_verify_on_read_trips_on_the_same_read(tmp_path):
    f, _ = _make_fragment(tfrag, tint, tmp_path / "seed")
    f.close()
    seed = (tmp_path / "seed").read_bytes()
    outs = []
    for name, _fp, frag_mod, int_mod, *_ in PKGS:
        p = tmp_path / name
        p.write_bytes(seed)
        q = int_mod.QuarantineRegistry()
        g = frag_mod.Fragment(str(p), "i", "f", "standard", 0, quarantine=q)
        g.open()  # clean: footer and body pass, the latch is armed
        try:
            assert g._verify_pending
            off = int(g.storage.footer.offsets[0]) + 2
            with open(p, "r+b") as raw:
                raw.seek(off)
                b = raw.read(1)[0]
                raw.seek(off)
                raw.write(bytes([b ^ 0x20]))
            with pytest.raises(int_mod.CorruptionError) as ei:
                g.row(3)
            assert g.quarantined and q.slice_blocked("i", 0)
            g.row(3)  # the latch fired once
            outs.append((str(ei.value), g.quarantine_reason))
        finally:
            g.close()
    assert outs[0] == outs[1]


def test_reset_for_repair_alike(tmp_path):
    outs = []
    for name, _fp, frag_mod, int_mod, *_ in PKGS:
        g, q = _make_fragment(frag_mod, int_mod, tmp_path / name)
        before = (tmp_path / name).read_bytes()
        g._set_quarantined("test", site="scrub")
        g.reset_for_repair()
        try:
            assert g.quarantined and g.row_count(3) == 0
            outs.append(((tmp_path / (name + ".corrupt")).read_bytes()
                         == before, (tmp_path / name).read_bytes()))
        finally:
            g.close()
    assert outs[0] == outs[1]


# -- failpoints at the storage sites ------------------------------------------

# The wal.append modes stay armed until the explicit barrier has failed:
# the background flusher may take the leader flush first.
CASES = [
    ("wal.append", "enospc"),
    ("wal.append", "torn(7)"),
    ("wal.append", "error"),
    ("snapshot.write", "enospc*1"),
    ("snapshot.write", "torn(5)*1"),
    ("snapshot.write", "corrupt(2)*1"),
    ("storage.read", "corrupt(3)*1"),
    ("storage.read", "error*1"),
]


def _drive(frag_mod, int_mod, fp, df, path, site, spec):
    """Build a fragment, reopen it (a fresh WAL over the snapshot), arm
    ``site`` with ``spec``, then run the one operation that reaches it;
    returns the error it raised, the disk-full latch, the file's bytes
    and the state a reopen finds."""
    g, q = _make_fragment(frag_mod, int_mod, path, n_bits=300)
    g.close()
    g = frag_mod.Fragment(str(path), "i", "f", "standard", 0, quarantine=q)
    g.open()
    fp.arm(site, spec)
    err = None
    try:
        if site == "wal.append":
            g.set_bit(4, 11)
            try:
                g.wal_barrier()
            except Exception as e:  # noqa: BLE001 - compared below
                err = (type(e).__name__, str(e), str(e.__cause__))
            ready = df.default().snapshot()
            fp.disarm_all()
            g.set_bit(4, 12)
            g.wal_barrier()  # lands, and clears the latch
            ready["writeReady"] = (ready["writeReady"],
                                   df.default().snapshot()["writeReady"])
        elif site == "snapshot.write":
            g.set_bit(4, 13)
            g.wal_barrier()
            try:
                g.snapshot(sync=True)
            except Exception as e:  # noqa: BLE001 - compared below
                err = (type(e).__name__, str(e))
            ready = df.default().snapshot()
        else:
            try:
                err = g.verify_on_disk()
            except Exception as e:  # noqa: BLE001 - compared below
                err = (type(e).__name__, str(e))
            ready = df.default().snapshot()
        data = path.read_bytes()
    finally:
        fp.disarm_all()
        g.close()
    g2 = frag_mod.Fragment(str(path), "i", "f", "standard", 0,
                           quarantine=int_mod.QuarantineRegistry())
    g2.open()
    try:
        state = (g2.quarantine_reason, g2.row_count(3), g2.row_count(4))
    finally:
        g2.close()
    return (err, ready["writeReady"], sorted(ready["events"]), data, state,
            [(e["reason"], e["slice"]) for e in q.entries()])


@pytest.mark.parametrize("site,spec", CASES)
def test_storage_failpoints_alike(tmp_path, monkeypatch, site, spec):
    outs = []
    for name, fp, frag_mod, int_mod, _r, _s, df in PKGS:
        monkeypatch.setattr(fp, "_default", fp.Failpoints(seed=5))
        df.default().reset()
        outs.append(_drive(frag_mod, int_mod, fp, df, tmp_path / name,
                           site, spec))
    assert outs[0] == outs[1]


def test_failed_flush_after_a_snapshot_swap_keeps_the_wal(tmp_path):
    """A leader flush that fails after a snapshot swapped the data file
    truncates back to the durable prefix. The JAX package's WAL keeps
    its first file's base offset across the swap, so the truncate
    EXTENDS the file with zeros and the next open finds every record
    failing its checksum (it quarantines); the port's does not."""
    outs = []
    for name, fp, frag_mod, int_mod, _r, scrub_mod, df in PKGS:
        path = tmp_path / name
        g, q = _make_fragment(frag_mod, int_mod, path, n_bits=300)
        size = path.stat().st_size
        fp.arm("wal.append", "enospc")
        g.set_bit(4, 11)
        with pytest.raises(Exception):
            g.wal_barrier()
        fp.disarm_all()
        g.set_bit(4, 12)
        g.wal_barrier()
        outs.append((path.stat().st_size - size,
                     scrub_mod.scrub_file(str(path))["corrupt"]))
        g.close()
    assert outs[0] == (300 * 13 + 26, True)   # the JAX package's fault
    assert outs[1] == (26, False)


# -- the scrubber -------------------------------------------------------------

def test_scrubber_pass_alike(tmp_path):
    from pilosa_tpu.models.holder import Holder as JHolder
    from pilosa_tpu_torch.models.holder import Holder as THolder
    seed_dir = tmp_path / "seed"
    h = THolder(str(seed_dir))
    h.open()
    idx = h.create_index("i")
    fr = idx.create_frame("f")
    rng = np.random.default_rng(7)
    cols = rng.choice(3 * SLICE_WIDTH, size=3000, replace=False)
    for col in cols.tolist():
        fr.set_bit("standard", int(col) % 5, int(col))
    for s in range(3):
        h.fragment("i", "f", "standard", s).snapshot(sync=True)
    h.close()
    bad = seed_dir / "i" / "f" / "views" / "standard" / "fragments" / "1"
    outs = []
    for name, holder_cls, scrub_mod in (("jax", JHolder, jscrub),
                                        ("torch", THolder, tscrub)):
        d = tmp_path / name
        shutil.copytree(seed_dir, d)
        hh = holder_cls(str(d))
        hh.open()
        try:
            hits = []
            s = scrub_mod.Scrubber(hh, interval_s=999, pace_s=0,
                                   on_corrupt=hits.append)
            first = s.pass_once()
            rot = d / bad.relative_to(seed_dir)
            raw = bytearray(rot.read_bytes())
            raw[40] ^= 0x02
            rot.write_bytes(bytes(raw))
            second = s.pass_once()
            third = s.pass_once()  # the quarantined copy is skipped
            st = s.state()
            outs.append(([{k: v for k, v in x.items() if k != "seconds"}
                          for x in (first, second, third)],
                         [(f.frame, f.slice) for f in hits],
                         {k: st[k] for k in ("passes", "fragmentsScrubbed",
                                             "blocksVerified",
                                             "corruptionsFound")},
                         [(e["slice"], e["reason"])
                          for e in hh.quarantine.entries()]))
        finally:
            hh.close()
    assert outs[0] == outs[1]
    assert outs[1][0][1]["corrupt"] == 1


# -- servers over copies of one directory -------------------------------------

def _post(host, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST", headers=headers or {})
    return urllib.request.urlopen(req, timeout=30)


def _call(host, method, path, body=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture
def solo_pair(tmp_path, monkeypatch):
    """A JAX server and a port server, each over a copy of one seeded
    one-node data directory; scrub passes on demand only, no repair."""
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    from pilosa_tpu.server.server import Server as JServer
    from pilosa_tpu.utils.config import ScrubConfig as JScrub
    from pilosa_tpu_torch.server.server import Server as TServer
    from pilosa_tpu_torch.utils.config import ScrubConfig as TScrub
    seed = TServer(str(tmp_path / "seed"), host="127.0.0.1:0",
                   device="cpu", warmup=False)
    seed.open()
    _post(seed.host, "/index/it", b"{}")
    _post(seed.host, "/index/it/frame/f", b"{}")
    for col in (3, 9, 2 * SLICE_WIDTH + 5):
        _post(seed.host, "/index/it/query",
              f'SetBit(frame="f", rowID=1, columnID={col})'.encode())
    seed.close()
    shutil.copytree(tmp_path / "seed", tmp_path / "j")
    shutil.copytree(tmp_path / "seed", tmp_path / "t")
    js = JServer(str(tmp_path / "j"), host="127.0.0.1:0",
                 anti_entropy_interval=0, polling_interval=0,
                 scrub_config=JScrub(interval=999.0, pace=0.0,
                                     repair=False))
    ts = TServer(str(tmp_path / "t"), host="127.0.0.1:0", device="cpu",
                 warmup=False, anti_entropy_interval=0,
                 polling_interval=0,
                 scrub_config=TScrub(interval=999.0, pace=0.0,
                                     repair=False))
    js.open()
    ts.open()
    yield js, ts
    ts.close()
    js.close()


COUNT = b'Count(Bitmap(frame="f", rowID=1))'


def test_quarantined_one_node_slice_answers_503(solo_pair):
    outs = []
    for s in solo_pair:
        assert json.loads(_call(s.host, "POST", "/index/it/query",
                                COUNT)[2])["results"] == [3]
        frag = s.holder.fragment("it", "f", "standard", 0)
        frag._set_quarantined("test corruption", site="scrub")
        st, _h, body = _call(s.host, "POST", "/index/it/query", COUNT)
        # A query over the other slices only still answers.
        other = _call(s.host, "POST", "/index/it/query?slices=2", COUNT)
        # Writes keep applying to the quarantined copy.
        w = _call(s.host, "POST", "/index/it/query",
                  b'SetBit(frame="f", rowID=7, columnID=1)')
        outs.append((st, json.loads(body), other[0],
                     json.loads(other[2]), w[0], frag.row_count(7)))
    assert outs[0] == outs[1]
    assert outs[1][0] == 503


def test_fragment_routes_refuse_a_quarantined_copy(solo_pair):
    outs = []
    for s in solo_pair:
        frag = s.holder.fragment("it", "f", "standard", 0)
        frag._set_quarantined("test corruption", site="scrub")
        got = []
        for path in ("/fragment/blocks?index=it&frame=f&view=standard"
                     "&slice=0",
                     "/fragment/data?index=it&frame=f&view=standard"
                     "&slice=0"):
            st, _h, body = _call(s.host, "GET", path)
            got.append((st, body))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][0][0] == 409


def _strip_times(entries):
    return [{k: v for k, v in e.items() if k not in ("since", "path")}
            for e in entries]


def test_debug_integrity_alike(solo_pair):
    outs = []
    for s in solo_pair:
        first = json.loads(_call(s.host, "GET", "/debug/integrity")[2])
        st, _h, scrub = _call(s.host, "POST", "/debug/integrity/scrub?sync=1")
        frag = s.holder.fragment("it", "f", "standard", 0)
        frag._set_quarantined("test corruption", site="scrub")
        second = json.loads(_call(s.host, "GET", "/debug/integrity")[2])
        trig = json.loads(_call(s.host, "POST",
                                "/debug/integrity/scrub")[2])
        outs.append((sorted(first), first["quarantined"],
                     first["coverage"], st,
                     {k: v for k, v in json.loads(scrub).items()
                      if k != "seconds"},
                     sorted(second), _strip_times(second["quarantined"]),
                     trig, sorted(first["scrub"])))
    assert outs[0] == outs[1]


def test_write_unready_answers_507(solo_pair):
    outs = []
    for s, fp, df in zip(solo_pair, (jfp, tfp), (jdf, tdf)):
        df.default().reset()
        fp.arm("wal.append", "enospc")
        try:
            first = _call(s.host, "POST", "/index/it/query",
                          b'SetBit(frame="f", rowID=2, columnID=7)')
            st = df.default().snapshot()
            # Unready: the next write answers 507 before it executes;
            # a read keeps serving.
            df.default()._last_probe = time.monotonic()
            second = _call(s.host, "POST", "/index/it/query",
                           b'SetBit(frame="f", rowID=2, columnID=8)')
            read = _call(s.host, "POST", "/index/it/query", COUNT)
            imp = _call(s.host, "GET", "/debug/tenants")
        finally:
            fp.disarm_all()
        # Space frees: the probe clears the latch and the write lands.
        df.default()._last_probe = 0.0
        third = _call(s.host, "POST", "/index/it/query",
                      b'SetBit(frame="f", rowID=2, columnID=8)')
        outs.append((first[0], json.loads(first[2])["error"][:40],
                     first[1].get("Retry-After"), st["writeReady"],
                     st["site"], second[0], second[2],
                     second[1].get("Retry-After"), read[0],
                     json.loads(imp[2])["writeReady"]["writeReady"],
                     third[0], json.loads(third[2]),
                     df.default().snapshot()["recoveries"]))
        df.default().reset()
    assert outs[0] == outs[1]
    assert outs[1][0] == 507 and outs[1][5] == 507 and outs[1][10] == 200


def test_import_retries_507(monkeypatch):
    """A peer's 507 during an import is as transient as a 429: the
    client waits it out by Retry-After."""
    import pilosa_tpu.cluster.client as jclient
    import pilosa_tpu_torch.cluster.client as tclient
    outs = []
    for mod in (jclient, tclient):
        c = mod.Client("peer:1")
        script = [(507, b"full", [("Retry-After", "0.01")]),
                  (507, b"full", [("Retry-After", "0.01")]),
                  (200, b"", [])]
        calls, sleeps = [], []

        def fake_do(method, path, body=None, headers=None, host=None,
                    idempotent=None, deadline_s=None, headers_out=None,
                    _script=script, _calls=calls):
            status, raw, hs = _script[len(_calls)]
            _calls.append(path)
            if headers_out is not None:
                headers_out.extend(hs)
            return status, raw

        monkeypatch.setattr(c, "_do", fake_do)
        monkeypatch.setattr(time, "sleep", sleeps.append)
        status, _ = c._do_429("POST", "/import", b"x", {}, None)
        monkeypatch.undo()
        outs.append((status, len(calls), len(sleeps)))
    assert outs[0] == outs[1] == (200, 3, 2)


# -- repair from a replica ----------------------------------------------------

def test_repairer_restores_replica_bits(tmp_path):
    from pilosa_tpu_torch.cluster.client import Client
    from pilosa_tpu_torch.cluster.topology import Cluster, Node
    from pilosa_tpu_torch.server.repair import Repairer
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.utils.config import ScrubConfig
    import socket

    ports = []
    for _ in range(2):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            ports.append(sk.getsockname()[1])
    hosts = [f"127.0.0.1:{p}" for p in ports]
    servers = []
    try:
        for i, h in enumerate(hosts):
            s = Server(str(tmp_path / f"n{i}"), host=h, device="cpu",
                       warmup=False, anti_entropy_interval=0,
                       polling_interval=0,
                       cluster=Cluster(nodes=[Node(x) for x in hosts],
                                       replica_n=2),
                       cluster_type="http",
                       scrub_config=ScrubConfig(interval=999.0, pace=0.0,
                                                repair=False))
            s.open()
            servers.append(s)
        s1, s2 = servers
        _post(s1.host, "/index/rp", b"{}")
        _post(s1.host, "/index/rp/frame/f", b"{}")
        rng = np.random.default_rng(11)
        rows = rng.integers(0, 6, 1500).astype(np.uint64)
        cols = rng.choice(2 * SLICE_WIDTH, size=1500,
                          replace=False).astype(np.uint64)
        Client(s1.host).import_arrays("rp", "f", rows, cols)
        frag = s1.holder.fragment("rp", "f", "standard", 0)
        want = frag.storage.all_positions().copy()
        frag.snapshot(sync=True)
        raw = bytearray(open(frag.path, "rb").read())
        raw[len(raw) // 3] ^= 0x40
        open(frag.path, "wb").write(bytes(raw))
        assert frag.verify_on_disk()["corrupt"] and frag.quarantined
        # A write while quarantined reaches both owners.
        _post(s1.host, "/index/rp/query",
              b'SetBit(frame="f", rowID=50, columnID=123)')
        for row in range(6):
            got = json.loads(_post(
                s1.host, "/index/rp/query",
                f'Count(Bitmap(frame="f", rowID={row}))'.encode()
            ).read())["results"][0]
            assert got == int((rows == row).sum())
        rep = Repairer(s1.holder, s1.cluster, s1.host,
                       client_factory=s1._client_factory, fault=s1.fault)
        assert rep.repair_fragment(frag) == "repaired"
        assert not frag.quarantined
        assert not os.path.exists(frag.path + ".corrupt")
        assert not frag.verify_on_disk()["corrupt"]
        f2 = s2.holder.fragment("rp", "f", "standard", 0)
        assert np.array_equal(frag.storage.all_positions(),
                              f2.storage.all_positions())
        assert set(want.tolist()) | {50 * SLICE_WIDTH + 123} == set(
            frag.storage.all_positions().tolist())
        assert dict(frag.blocks()) == dict(f2.blocks())
        # No replica left: the fragment stays quarantined.
        frag._set_quarantined("test", site="scrub")
        s1.cluster.nodes = [Node(s1.host)]
        assert Repairer(s1.holder, s1.cluster, s1.host,
                        client_factory=s1._client_factory
                        ).repair_fragment(frag) == "no_replica"
        assert frag.quarantined
        s1.cluster.nodes = [Node(h) for h in hosts]
        frag.clear_quarantine()
    finally:
        for s in servers:
            s.close()


# -- configuration ------------------------------------------------------------

def test_env_keys_match_the_jax_loader():
    from pilosa_tpu.utils import config as jcfg
    from pilosa_tpu_torch.utils import config as tcfg
    env = {"PILOSA_SCRUB_ENABLED": "0", "PILOSA_SCRUB_INTERVAL": "12s",
           "PILOSA_SCRUB_PACE": "0.25s", "PILOSA_SCRUB_REPAIR": "off",
           "PILOSA_SCRUB_REPAIR_RESCAN": "500ms",
           "PILOSA_TRACE_TAIL": "false", "PILOSA_TRACE_HEAD_N": "7",
           "PILOSA_TRACE_SLOW_FLOOR": "250ms",
           "PILOSA_TRACE_DISK_SEGMENT_BYTES": "65536",
           "PILOSA_TRACE_DISK_SEGMENTS": "3",
           "PILOSA_TRACE_ENABLED": "1", "PILOSA_TRACE_MAX_TRACES": "9",
           "PILOSA_TRACE_MAX_SPANS": "99"}
    for e in ({}, env):
        want = jcfg.load("", env=e)
        got = tcfg.load("", env=e)
        assert vars(got.scrub) == vars(want.scrub)
        assert vars(got.trace) == vars(want.trace)


def test_barrier_flushes_a_wal_whose_background_flush_failed(tmp_path,
                                                             monkeypatch):
    """The background flusher's leader write hits ENOSPC and drops the
    WAL from its dirty set. The next commit barrier must still put the
    pending record in the OS before an ack (a retried SetBit that
    answers false appends nothing new). The JAX package's barrier skips
    that WAL, so the record stays in userspace; the port's flushes it."""
    import pilosa_tpu.storage.wal as jwal
    import pilosa_tpu_torch.storage.wal as twal
    outs = []
    for (name, fp, frag_mod, int_mod, *_r), wal_mod in zip(PKGS,
                                                          (jwal, twal)):
        g, _q = _make_fragment(frag_mod, int_mod, tmp_path / name,
                               n_bits=50)
        try:
            fp.arm("wal.append", "enospc*1")
            g.set_bit(6, 77)
            deadline = time.time() + 10
            while g._wal._registered and time.time() < deadline:
                time.sleep(0.005)  # the flusher's failed leader write
            assert not g._wal._registered
            wal_mod.barrier_all()
            outs.append(g._wal.pending_bytes())
        finally:
            fp.disarm_all()
            g.close()
    assert outs == [13, 0]


def test_scrub_verify_survives_a_pinned_map(tmp_path, monkeypatch):
    """A view into the scrubbed map that outlives ``scrub_buffer`` (a
    stack sampler holding the returned frame, as the continuous profiler
    does for a moment) leaves the port's ``verify_on_disk`` verdict
    standing; the JAX package's close raises BufferError there, and its
    scrubber skips the fragment as unverifiable (found, not copied)."""
    pinned = []
    got = {}
    for name, _fp, frag_mod, int_mod, *_ in PKGS:
        f, _ = _make_fragment(frag_mod, int_mod, tmp_path / name)
        scrub_mod = jscrub if frag_mod is jfrag else tscrub
        real = scrub_mod.scrub_buffer

        def pinning(buf, real=real):
            pinned.append(np.frombuffer(buf, dtype=np.uint8))
            return real(buf)

        monkeypatch.setattr(scrub_mod, "scrub_buffer", pinning)
        try:
            got[name] = f.verify_on_disk()
        except BufferError as e:
            got[name] = e
        finally:
            pinned.clear()
            monkeypatch.setattr(scrub_mod, "scrub_buffer", real)
            f.close()
    assert isinstance(got["jax"], BufferError)
    assert got["torch"]["corrupt"] is False
    assert got["torch"]["coverage"] == "full" and got["torch"]["blocks"] > 0

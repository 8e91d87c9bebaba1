"""One data directory, both packages: a directory that the JAX package
wrote and closed is served by the port's ``Server`` with the same
options, attributes and answers, and the other way round.

The options live in the protobuf ``.meta`` files and the attributes in
the sqlite stores; both packages must read and write the same bytes
(the port writes no ``.meta.json``). The reference answers come from a
JAX ``Handler`` over a copy of the same directory.
"""

import io
import json
import os
import shutil
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.models.frame import Field as JaxField
from pilosa_tpu.models.frame import FrameOptions as JaxFrameOptions
from pilosa_tpu.models.holder import Holder as JaxHolder
from pilosa_tpu.models.index import IndexOptions as JaxIndexOptions
from pilosa_tpu.server.handler import Handler as JaxHandler

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.models.frame import Field, FrameOptions
from pilosa_tpu_torch.models.index import IndexOptions
from pilosa_tpu_torch.parallel import residency
from pilosa_tpu_torch.server.server import Server

READS = [
    "Bitmap(r=1, frame=f)", "Bitmap(rowID=2, frame=g)",
    "Count(Intersect(Bitmap(r=1, frame=f), Bitmap(rowID=2, frame=g)))",
    "Count(Union(Bitmap(r=1, frame=f), Bitmap(r=4, frame=f)))",
    "TopN(Bitmap(rowID=2, frame=g), frame=f, ids=[0,1,2,3,4,5])",
    "TopN(Bitmap(rowID=2, frame=g), frame=f, ids=[0,1,2,3,4,5],"
    " field=\"tier\", filters=[\"gold\"])",
    # Every TopN form over the count caches: f is a ranked frame, g an
    # LRU one; both reopen from the .cache sidecars.
    "TopN(frame=f, n=3)", "TopN(frame=g, n=4)", "TopN(frame=g)",
    "TopN(frame=f, ids=[0,2,4,9])", "TopN(frame=g, n=3, threshold=2)",
    "TopN(Bitmap(rowID=2, frame=g), frame=f, n=2)",
    "TopN(Bitmap(r=1, frame=f), frame=g, n=3, threshold=2)",
    "TopN(Bitmap(r=1, frame=f), frame=g, tanimotoThreshold=1)",
    "TopN(frame=f, n=5, field=\"tier\", filters=[\"gold\", \"tin\"])",
]


def _wsgi(app, method, path, body=b""):
    path, _, qs = path.partition("?")
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])

    chunks = app(environ, start_response)
    return out["status"], b"".join(chunks)


def _http(srv, method, path, body=b""):
    req = urllib.request.Request(f"http://{srv.host}{path}", data=body,
                                 method=method)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


def _write_with_jax(path, rng):
    h = JaxHolder(path)
    h.open()
    idx = h.create_index("i", JaxIndexOptions(column_label="col",
                                              time_quantum="YM"))
    f = idx.create_frame("f", JaxFrameOptions(
        row_label="r", inverse_enabled=True, cache_type="ranked",
        cache_size=5000))
    g = idx.create_frame("g")
    idx.create_frame("h", JaxFrameOptions(fields=[JaxField("n", -3, 900)]))
    for frame in (f, g):
        rows = rng.integers(0, 6, size=3000).astype(np.uint64)
        cols = rng.integers(0, 3 * SLICE_WIDTH, size=3000, dtype=np.uint64)
        frame.import_bits(rows, cols & np.uint64(~0xFFFF0 & (2**64 - 1)))
    f.set_bit("standard", 1, 2 * SLICE_WIDTH + 5)
    for rid, tier in ((0, "gold"), (1, "gold"), (3, "tin"), (4, "gold")):
        f.row_attr_store.set_attrs(rid, {"tier": tier, "w": rid * 1.5,
                                         "on": rid % 2 == 0, "n": -rid})
    g.row_attr_store.set_attrs(2, {"label": "two"})
    idx.column_attr_store.set_bulk_attrs({5: {"city": "Oslo"},
                                          2 * SLICE_WIDTH + 5: {"n": 9}})
    h.close()


def _write_with_port(path, rng):
    srv = Server(path, host="127.0.0.1:0", device="cpu")
    srv.open()
    h = srv.holder
    idx = h.create_index("i", IndexOptions(column_label="col",
                                           time_quantum="YM"))
    f = idx.create_frame("f", FrameOptions(row_label="r", cache_type="ranked",
                                           cache_size=5000))
    g = idx.create_frame("g")
    idx.create_frame("h", FrameOptions(fields=[Field("n", -3, 900)]))
    idx.create_frame("inv", FrameOptions(inverse_enabled=True))
    for frame in (f, g):
        rows = rng.integers(0, 6, size=3000).astype(np.uint64)
        cols = rng.integers(0, 3 * SLICE_WIDTH, size=3000, dtype=np.uint64)
        frame.import_bits(rows, cols & np.uint64(~0xFFFF0 & (2**64 - 1)))
    _http(srv, "POST", "/index/i/query",
          f"SetBit(frame=f, r=1, col={2 * SLICE_WIDTH + 5})"
          " SetRowAttrs(frame=f, r=0, tier=\"gold\", on=true)"
          " SetRowAttrs(frame=f, r=1, tier=\"gold\", w=1.5, n=-1)"
          " SetRowAttrs(frame=f, r=3, tier=\"tin\")"
          " SetRowAttrs(frame=f, r=4, tier=\"gold\")"
          " SetRowAttrs(frame=g, rowID=2, label=\"two\")"
          " SetColumnAttrs(id=5, city=\"Oslo\")"
          f" SetColumnAttrs(col={2 * SLICE_WIDTH + 5}, n=9)".encode())
    srv.close()
    residency.device_cache().clear()


def _meta_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            if name.startswith(".meta"):
                with open(os.path.join(d, name), "rb") as f:
                    out[os.path.relpath(os.path.join(d, name), root)] = \
                        f.read()
    return out


def _jax_answers(path):
    """The JAX package's answers over ``path`` (opened and closed)."""
    h = JaxHolder(path)
    h.open()
    app = JaxHandler(h, JaxExecutor(h, host="local"))
    out = _answers(lambda m, p, b=b"": _wsgi(app, m, p, b))
    h.close()
    return out


def _answers(send):
    out = {}
    for path in ("/schema", "/slices/max", "/slices/max?inverse=true",
                 "/index/i/frame/f/views", "/index/i/frame/g/views"):
        out[path] = send("GET", path)
    for path in ("/index/i/attr/diff", "/index/i/frame/f/attr/diff",
                 "/index/i/frame/g/attr/diff"):
        out[path] = send("POST", path, b'{"blocks": []}')
    for q in READS:
        out[q] = send("POST", "/index/i/query", q.encode())
        out[q + " columnAttrs"] = send(
            "POST", "/index/i/query?columnAttrs=true", q.encode())
    return {k: (s, json.loads(b)) for k, (s, b) in out.items()}


def _port_answers(path):
    srv = Server(path, host="127.0.0.1:0", device="cpu")
    srv.open()
    try:
        out = _answers(lambda m, p, b=b"": _http(srv, m, p, b))
        f = srv.holder.frame("i", "f")
        opts = (srv.holder.index("i").options, f.options,
                srv.holder.frame("i", "h").options)
    finally:
        srv.close()
        residency.device_cache().clear()
    return out, opts


def test_jax_directory_served_by_the_port(tmp_path):
    jax_dir, copy = str(tmp_path / "jax"), str(tmp_path / "copy")
    _write_with_jax(jax_dir, np.random.default_rng(21))
    metas = _meta_files(jax_dir)
    shutil.copytree(jax_dir, copy)
    got, (iopts, fopts, hopts) = _port_answers(jax_dir)
    assert got == _jax_answers(copy)
    assert got[READS[5]][1]["results"][0]  # the filter keeps some rows
    assert got[READS[0]][1]["results"][0]["attrs"] == {
        "tier": "gold", "w": 1.5, "on": False, "n": -1}
    assert iopts == IndexOptions(column_label="col", time_quantum="YM")
    assert fopts == FrameOptions(row_label="r", inverse_enabled=True,
                                 cache_type="ranked", cache_size=5000,
                                 time_quantum="YM")
    assert hopts.fields == [Field("n", -3, 900)]
    assert got["/schema"][1]["indexes"][0]["frames"][0]["views"] == [
        {"name": "inverse"}, {"name": "standard"}]
    # The port rewrote every .meta on open, byte for byte the same.
    assert _meta_files(jax_dir) == metas
    assert not any(n.endswith(".json") for n in metas)


def test_port_directory_served_by_jax(tmp_path):
    port_dir, copy = str(tmp_path / "port"), str(tmp_path / "copy")
    _write_with_port(port_dir, np.random.default_rng(22))
    assert not [n for n in _meta_files(port_dir) if n.endswith(".json")]
    shutil.copytree(port_dir, copy)
    want = _jax_answers(copy)
    got, _ = _port_answers(port_dir)
    assert got == want
    assert want["Bitmap(r=1, frame=f)"][1]["results"][0]["attrs"] == {
        "tier": "gold", "w": 1.5, "n": -1}
    h = JaxHolder(copy)
    h.open()
    f = h.frame("i", "f")
    assert (f.options.row_label, f.options.cache_type,
            f.options.cache_size, f.options.time_quantum) == (
        "r", "ranked", 5000, "YM")
    assert h.frame("i", "inv").options.inverse_enabled
    assert [x.to_json() for x in h.frame("i", "h").fields()] == [
        {"name": "n", "min": -3, "max": 900}]
    assert h.index("i").column_attr_store.attrs(5) == {"city": "Oslo"}
    h.close()


@pytest.mark.parametrize("write_first", ["jax", "port"])
def test_attribute_store_bytes_match(tmp_path, write_first):
    """The same attribute writes leave the same sqlite rows."""
    import sqlite3
    from pilosa_tpu.storage.attrs import AttrStore as JaxAttrStore

    from pilosa_tpu_torch.storage.attrs import AttrStore
    writes = [(1, {"a": 1, "b": "x"}), (2**64 - 1, {"f": -0.0, "t": True}),
              (1, {"a": None, "c": -2**63}), (250, {"s": "é🙂"})]
    rows = {}
    for name, cls in (("jax", JaxAttrStore), ("port", AttrStore)):
        store = cls(str(tmp_path / name))
        store.open()
        for id, m in writes:
            store.set_attrs(id, m)
        assert store.attrs(1) == {"b": "x", "c": -2**63}
        store.close()
        db = sqlite3.connect(str(tmp_path / name))
        rows[name] = db.execute(
            "SELECT id, value FROM attrs ORDER BY id").fetchall()
        db.close()
    assert rows["jax"] == rows["port"]
    # Each package reads the other's store, anti-entropy blocks too.
    reader, writer = ((AttrStore, JaxAttrStore) if write_first == "jax"
                      else (JaxAttrStore, AttrStore))
    path = str(tmp_path / write_first)
    a, b = reader(path), writer(path)
    a.open()
    b.open()
    assert a.attrs(2**64 - 1) == {"f": -0.0, "t": True}
    assert a.attrs(250) == b.attrs(250) == {"s": "é🙂"}
    assert a.blocks() == b.blocks() and len(a.blocks()) == 3
    assert a.block_data(0) == b.block_data(0)
    a.close()
    b.close()


def test_carry_with_attributes(tmp_path):
    """``carry.holder_from_state`` takes the JAX package's attribute
    stores beside its fragments: Bitmap attributes, ``columnAttrs`` and
    an attribute-filtered TopN answer as the JAX package does."""
    from pilosa_tpu_torch import carry
    from pilosa_tpu_torch.server.handler import Handler

    jax_dir = str(tmp_path / "jax")
    _write_with_jax(jax_dir, np.random.default_rng(23))
    jh = JaxHolder(jax_dir)
    jh.open()
    state = {(fr.index, fr.frame, fr.view, fr.slice):
             fr.storage.all_positions() for fr in jh.iter_fragments()
             if fr.view == "standard"}
    idx = jh.index("i")
    row_attrs = {("i", name): {rid: m for block, _ in
                               frame.row_attr_store.blocks()
                               for rid, m in frame.row_attr_store
                               .block_data(block).items()}
                 for name, frame in idx.frames.items()}
    column_attrs = {"i": {cid: m for block, _ in
                          idx.column_attr_store.blocks()
                          for cid, m in idx.column_attr_store
                          .block_data(block).items()}}
    want = _answers(lambda m, p, b=b"": _wsgi(
        JaxHandler(jh, JaxExecutor(jh, host="local")), m, p, b))
    jh.close()
    holder, ex = carry.holder_from_state(
        str(tmp_path / "port"), state, device="cpu", row_attrs=row_attrs,
        column_attrs=column_attrs)
    # Options are not part of the carried state: use the JAX ones.
    holder.index("i").options = IndexOptions(column_label="col",
                                             time_quantum="YM")
    holder.frame("i", "f").options.row_label = "r"
    got = _answers(lambda m, p, b=b"": _wsgi(Handler(holder, ex), m, p, b))
    holder.close()
    residency.device_cache().clear()
    for q in READS:
        assert got[q] == want[q], q
        assert got[q + " columnAttrs"] == want[q + " columnAttrs"], q
    for path in ("/index/i/attr/diff", "/index/i/frame/f/attr/diff",
                 "/index/i/frame/g/attr/diff"):
        assert got[path] == want[path], path


def _cache_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            if name.endswith(".cache"):
                with open(os.path.join(d, name), "rb") as f:
                    out[os.path.relpath(os.path.join(d, name), root)] = \
                        f.read()
    return out


def test_topn_reads_answer_pairs(tmp_path):
    """The TopN reads of this file's directories are not empty."""
    path = str(tmp_path / "jax")
    _write_with_jax(path, np.random.default_rng(24))
    got = _jax_answers(path)
    for q in READS:
        if q.startswith("TopN(frame=") or "n=2)" in q:
            assert got[q][1]["results"][0], q


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_sidecars_match(tmp_path, writer):
    """Each package's ``.cache`` sidecars are the protobuf ``Cache`` of
    the sorted cached row ids, byte for byte as upb encodes them; the
    other package opens them to the same caches and closes them to the
    same bytes."""
    from pilosa_tpu.proto import internal_pb2

    from pilosa_tpu_torch.models.holder import Holder

    path = str(tmp_path / writer)
    (_write_with_jax if writer == "jax" else _write_with_port)(
        path, np.random.default_rng(25))
    files = _cache_files(path)
    assert len(files) >= 6  # frames f and g over three slices
    for blob in files.values():
        ids = list(internal_pb2.Cache.FromString(blob).IDs)
        assert ids == sorted(ids) and ids
        assert internal_pb2.Cache(IDs=ids).SerializeToString() == blob
    caches = {}
    for name, cls in (("jax", JaxHolder), ("port", Holder)):
        h = cls(path)
        h.open()
        caches[name] = {
            (fr.frame, fr.slice): (type(fr.cache).__name__,
                                   fr.cache.max_entries,
                                   fr.cache.top_arrays()[0].tolist(),
                                   fr.cache.top_arrays()[1].tolist())
            for fr in h.iter_fragments() if fr.view == "standard"}
        h.close()
        assert _cache_files(path) == files
    assert caches["jax"] == caches["port"]
    assert caches["port"][("f", 0)][:2] == ("RankCache", 5000)
    assert caches["port"][("g", 0)][:2] == ("LRUCache", 50000)


@pytest.mark.parametrize("damage", ["truncate", "garbage", "remove"])
def test_damaged_cache_sidecar_rebuilds(tmp_path, damage):
    """A torn, corrupt or missing sidecar is advisory: the fragment
    opens, its cache is rebuilt from storage, and every TopN answer
    equals the JAX package's over the same damaged directory."""
    path, copy = str(tmp_path / "data"), str(tmp_path / "copy")
    _write_with_port(path, np.random.default_rng(26))
    want = _jax_answers(shutil.copytree(path, str(tmp_path / "intact")))
    for name in _cache_files(path):
        full = os.path.join(path, name)
        if damage == "remove":
            os.remove(full)
            continue
        with open(full, "rb") as f:
            blob = f.read()
        with open(full, "wb") as f:
            f.write(blob[:len(blob) // 2] if damage == "truncate"
                    else b"\xff" * 11)
    shutil.copytree(path, copy)
    got, _ = _port_answers(path)
    for q in READS:
        assert got[q] == want[q], q
    assert _jax_answers(copy) == got


def test_carry_frame_options(tmp_path):
    """``carry.holder_from_state`` takes each frame's options: a ranked
    frame carries across as a ranked frame of the same size and answers
    every TopN form as the JAX package does."""
    from pilosa_tpu_torch import carry
    from pilosa_tpu_torch.server.handler import Handler

    jax_dir = str(tmp_path / "jax")
    _write_with_jax(jax_dir, np.random.default_rng(27))
    jh = JaxHolder(jax_dir)
    jh.open()
    state = {(fr.index, fr.frame, fr.view, fr.slice):
             fr.storage.all_positions() for fr in jh.iter_fragments()
             if fr.view == "standard"}
    opts = {("i", name): {"cache_type": fr.options.cache_type,
                          "cache_size": fr.options.cache_size,
                          "row_label": fr.options.row_label}
            for name, fr in jh.index("i").frames.items()}
    want = _answers(lambda m, p, b=b"": _wsgi(
        JaxHandler(jh, JaxExecutor(jh, host="local")), m, p, b))
    jh.close()
    holder, ex = carry.holder_from_state(
        str(tmp_path / "port"), state, device="cpu", frame_options=opts)
    holder.index("i").options = IndexOptions(column_label="col",
                                             time_quantum="YM")
    frag = holder.fragment("i", "f", "standard", 0)
    assert (holder.frame("i", "f").options.cache_type,
            type(frag.cache).__name__, frag.cache.max_entries) == (
        "ranked", "RankCache", 5000)
    got = _answers(lambda m, p, b=b"": _wsgi(Handler(holder, ex), m, p, b))
    holder.close()
    residency.device_cache().clear()
    for q in READS:
        if q.startswith("TopN") and "filters" not in q:
            assert got[q] == want[q], q


VIEW_READS = [
    "Count(Range(frame=v, amt > 100))", "Range(frame=v, amt >< [-9, 40])",
    "Sum(frame=v, field=amt)", "Min(frame=v, field=amt)",
    "Max(Bitmap(frame=tv, rowID=1), frame=v, field=amt)",
    "Count(Range(frame=tv, rowID=1, start=\"2017-01-01T00:00\","
    " end=\"2017-03-05T07:00\"))",
    "Range(frame=tv, rowID=2, start=\"2017-02-03T04:00\","
    " end=\"2018-01-01T00:00\")",
    "Bitmap(col=7, frame=tv)", "Count(Bitmap(col=7, frame=tv))",
    f"Bitmap(col={SLICE_WIDTH + 3}, frame=tv)",
    "Count(Range(frame=inh, rowID=4, start=\"2017-01-01T00:00\","
    " end=\"2017-02-01T00:00\"))",
]


def _write_views(path, rng, jax):
    """Field, time and inverse views through one package's own API:
    index ``w`` (column label ``col``, time quantum YM), frame ``v``
    with field ``amt``, frame ``tv`` (YMDH, inverse) and frame ``inh``,
    which takes the index's time quantum."""
    if jax:
        h = JaxHolder(path)
        IO, FO, F = JaxIndexOptions, JaxFrameOptions, JaxField
    else:
        from pilosa_tpu_torch.models.holder import Holder
        h = Holder(path)
        IO, FO, F = IndexOptions, FrameOptions, Field
    h.open()
    idx = h.create_index("w", IO(column_label="col", time_quantum="YM"))
    v = idx.create_frame("v", FO(fields=[F("amt", -10, 3000)]))
    cols = rng.integers(0, 3 * SLICE_WIDTH, size=500, dtype=np.uint64)
    v.import_field_values("amt", cols, rng.integers(-10, 3001, size=500))
    v.set_field_value("amt", 5, 42)
    tv = idx.create_frame("tv", FO(time_quantum="YMDH",
                                   inverse_enabled=True))
    import datetime as dt
    stamps = [dt.datetime(2017, 1 + int(m), 1 + int(d), int(hh))
              for m, d, hh in zip(rng.integers(12, size=300),
                                  rng.integers(28, size=300),
                                  rng.integers(24, size=300))]
    tv.import_bits(rng.integers(0, 5, size=300).astype(np.uint64),
                   rng.integers(0, 2 * SLICE_WIDTH, size=300,
                                dtype=np.uint64), stamps)
    tv.import_bits(np.array([1, 2, SLICE_WIDTH + 9], np.uint64),
                   np.array([7, 7, SLICE_WIDTH + 3], np.uint64))
    tv.set_bit("standard", 3, 7, dt.datetime(2017, 2, 3, 4))
    tv.set_bit("inverse", 7, 4)
    inh = idx.create_frame("inh")
    inh.set_bit("standard", 4, 9, dt.datetime(2017, 1, 9, 9))
    h.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_views_and_fields_open_in_both(tmp_path, writer):
    """Each package opens the other's field views, time views, inverse
    views and the ``.meta`` holding fields and time quanta: the same
    views, the same bits and the same answers over HTTP."""
    from pilosa_tpu_torch.models.holder import Holder

    path, copy = str(tmp_path / "data"), str(tmp_path / "copy")
    _write_views(path, np.random.default_rng(28), writer == "jax")
    metas = _meta_files(path)
    shutil.copytree(path, copy)
    frags = {}
    for name, cls in (("jax", JaxHolder), ("port", Holder)):
        h = cls(path)
        h.open()
        frags[name] = {
            (fr.frame, fr.view, fr.slice):
            (fr.positions() if name == "port"
             else fr.storage.all_positions()).tolist()
            for fr in h.iter_fragments()}
        if name == "port":
            idx = h.index("w")
            assert idx.options == IndexOptions(column_label="col",
                                               time_quantum="YM")
            assert h.frame("w", "v").field("amt") == Field("amt", -10, 3000)
            assert h.frame("w", "v").field_value("amt", 5) == (42, True)
            assert h.frame("w", "inh").time_quantum() == "YM"
            assert idx.max_inverse_slice() == 1
        h.close()
        assert _meta_files(path) == metas
    assert frags["port"] == frags["jax"]
    views = {k[1] for k in frags["port"]}
    assert {"field_amt", "inverse", "inverse_2017", "standard_2017020304",
            "standard_201701"} <= views
    jh = JaxHolder(copy)
    jh.open()
    app = JaxHandler(jh, JaxExecutor(jh, host="local"))
    want = {q: _wsgi(app, "POST", "/index/w/query", q.encode())
            for q in VIEW_READS}
    want["/schema"] = _wsgi(app, "GET", "/schema")
    jh.close()
    srv = Server(path, host="127.0.0.1:0", device="cpu")
    srv.open()
    try:
        for q in VIEW_READS:
            got = _http(srv, "POST", "/index/w/query", q.encode())
            assert (got[0], json.loads(got[1])) == \
                (want[q][0], json.loads(want[q][1])), q
        got = _http(srv, "GET", "/schema")
        assert json.loads(got[1]) == json.loads(want["/schema"][1])
    finally:
        srv.close()
        residency.device_cache().clear()

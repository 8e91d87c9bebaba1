"""The port's protobuf codec against the JAX package's generated
``internal_pb2`` (upb).

Every message of ``pilosa_tpu_torch/proto/internal.py`` is built from the
same seeded numpy data on both sides: the port's bytes must equal
``SerializeToString()``, and each side must decode the other's bytes to
equal fields. ``MaxSlicesResponse``'s map has no defined order on the
wire, so it is compared after decoding.
"""

import struct
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pilosa_tpu.proto import internal_pb2 as jpb

from pilosa_tpu_torch.proto import internal as tpb

MESSAGES = ["Attr", "AttrMap", "Bitmap", "Pair", "QueryRequest",
            "QueryResponse", "QueryResult", "ColumnAttrSet",
            "ImportRequest", "ImportResponse", "IndexMeta", "FrameMeta",
            "FieldMeta", "MaxSlicesResponse", "Cache",
            # the cluster's messages
            "Bit", "BlockDataRequest", "BlockDataResponse",
            "CreateSliceMessage", "DeleteIndexMessage",
            "CreateIndexMessage", "CreateFrameMessage",
            "DeleteFrameMessage", "Frame", "Index", "NodeStatus",
            "ClusterStatus"]

_U64_EDGES = [0, 1, 127, 128, 16383, 16384, 2**32 - 1, 2**63 - 1, 2**63,
              2**64 - 1]


# -- building one message on both sides -------------------------------------

def _u64s(rng, n):
    """u64 values across every varint length, edges included."""
    bits = rng.integers(0, 65, size=n)
    v = [int(rng.integers(0, 2**63, dtype=np.uint64)) * 2 + 1 >> (64 - int(b))
         if b else 0 for b in bits]
    return v + _U64_EDGES[: int(rng.integers(0, len(_U64_EDGES)))]


def _i64s(rng, n):
    return [int(x) for x in rng.integers(-2**63, 2**63 - 1, size=n,
                                         dtype=np.int64)] + [-1, 0, -2**63]


def _string(rng):
    alphabet = ["a", "Z", "_", "9", "é", "🙂", " "]
    return "".join(rng.choice(alphabet, size=int(rng.integers(0, 6))))


def _attr(rng):
    kind = int(rng.integers(0, 5))
    spec = {"Key": _string(rng), "Type": kind}
    if kind == 1:
        spec["StringValue"] = _string(rng)
    elif kind == 2:
        spec["IntValue"] = int(rng.integers(-2**63, 2**63 - 1,
                                            dtype=np.int64))
    elif kind == 3:
        spec["BoolValue"] = bool(rng.integers(0, 2))
    elif kind == 4:
        spec["FloatValue"] = float(rng.choice(
            [0.0, -0.0, 1.5, -2.25e300, float("inf"), float("nan"),
             float(rng.standard_normal())]))
    return ("Attr", spec)


def _attrs(rng):
    return [_attr(rng) for _ in range(int(rng.integers(0, 4)))]


def _spec(name, rng):
    """(message name, field dict) of one random message."""
    if name == "Attr":
        return _attr(rng)
    if name == "AttrMap":
        return (name, {"Attrs": _attrs(rng)})
    if name == "Bitmap":
        return (name, {"Bits": _u64s(rng, int(rng.integers(0, 40))),
                       "Attrs": _attrs(rng)})
    if name == "Pair":
        return (name, {"Key": _u64s(rng, 1)[0], "Count": _u64s(rng, 1)[0]})
    if name == "QueryRequest":
        return (name, {"Query": _string(rng),
                       "Slices": _u64s(rng, int(rng.integers(0, 5))),
                       "ColumnAttrs": bool(rng.integers(0, 2)),
                       "Quantum": _string(rng),
                       "Remote": bool(rng.integers(0, 2))})
    if name == "QueryResult":
        spec = {"N": _u64s(rng, 1)[0],
                "Pairs": [_spec("Pair", rng)
                          for _ in range(int(rng.integers(0, 3)))],
                "Changed": bool(rng.integers(0, 2))}
        if rng.integers(0, 2):
            spec["Bitmap"] = _spec("Bitmap", rng)
        return (name, spec)
    if name == "QueryResponse":
        return (name, {"Err": _string(rng),
                       "Results": [_spec("QueryResult", rng)
                                   for _ in range(int(rng.integers(0, 4)))],
                       "ColumnAttrSets": [_spec("ColumnAttrSet", rng)
                                          for _ in range(
                                              int(rng.integers(0, 3)))]})
    if name == "ColumnAttrSet":
        return (name, {"ID": _u64s(rng, 1)[0], "Attrs": _attrs(rng)})
    if name == "ImportRequest":
        n = int(rng.integers(0, 30))
        return (name, {"Index": _string(rng), "Frame": _string(rng),
                       "Slice": _u64s(rng, 1)[0],
                       "RowIDs": _u64s(rng, n), "ColumnIDs": _u64s(rng, n),
                       "Timestamps": _i64s(rng, int(rng.integers(0, 4)))
                       if rng.integers(0, 2) else []})
    if name == "ImportResponse":
        return (name, {"Err": _string(rng)})
    if name == "IndexMeta":
        return (name, {"ColumnLabel": _string(rng),
                       "TimeQuantum": _string(rng)})
    if name == "FieldMeta":
        return (name, {"Name": _string(rng),
                       "Min": _i64s(rng, 1)[0], "Max": _i64s(rng, 1)[0]})
    if name == "FrameMeta":
        return (name, {"RowLabel": _string(rng),
                       "InverseEnabled": bool(rng.integers(0, 2)),
                       "CacheType": _string(rng),
                       "CacheSize": int(rng.integers(0, 2**32)),
                       "TimeQuantum": _string(rng),
                       "Fields": [_spec("FieldMeta", rng)
                                  for _ in range(int(rng.integers(0, 3)))]})
    if name == "MaxSlicesResponse":
        return (name, {"MaxSlices": {_string(rng) + str(i): _u64s(rng, 1)[0]
                                     for i in range(int(rng.integers(0, 5)))}})
    if name == "Cache":
        return (name, {"IDs": _u64s(rng, int(rng.integers(0, 60)))})
    if name == "Bit":
        return (name, {"RowID": _u64s(rng, 1)[0],
                       "ColumnID": _u64s(rng, 1)[0],
                       "Timestamp": _i64s(rng, 1)[0]})
    if name == "BlockDataRequest":
        return (name, {"Index": _string(rng), "Frame": _string(rng),
                       "View": _string(rng), "Slice": _u64s(rng, 1)[0],
                       "Block": _u64s(rng, 1)[0]})
    if name == "BlockDataResponse":
        n = int(rng.integers(0, 30))
        return (name, {"RowIDs": _u64s(rng, n), "ColumnIDs": _u64s(rng, n)})
    if name == "CreateSliceMessage":
        return (name, {"Index": _string(rng), "Slice": _u64s(rng, 1)[0],
                       "IsInverse": bool(rng.integers(0, 2))})
    if name in ("DeleteIndexMessage",):
        return (name, {"Index": _string(rng)})
    if name == "CreateIndexMessage":
        spec = {"Index": _string(rng)}
        if rng.integers(0, 2):
            spec["Meta"] = _spec("IndexMeta", rng)
        return (name, spec)
    if name == "CreateFrameMessage":
        spec = {"Index": _string(rng), "Frame": _string(rng)}
        if rng.integers(0, 2):
            spec["Meta"] = _spec("FrameMeta", rng)
        return (name, spec)
    if name == "DeleteFrameMessage":
        return (name, {"Index": _string(rng), "Frame": _string(rng)})
    if name == "Frame":
        spec = {"Name": _string(rng)}
        if rng.integers(0, 2):
            spec["Meta"] = _spec("FrameMeta", rng)
        return (name, spec)
    if name == "Index":
        spec = {"Name": _string(rng), "MaxSlice": _u64s(rng, 1)[0],
                "Frames": [_spec("Frame", rng)
                           for _ in range(int(rng.integers(0, 3)))],
                "Slices": _u64s(rng, int(rng.integers(0, 8)))}
        if rng.integers(0, 2):
            spec["Meta"] = _spec("IndexMeta", rng)
        return (name, spec)
    if name == "NodeStatus":
        return (name, {"Host": _string(rng), "State": _string(rng),
                       "Indexes": [_spec("Index", rng)
                                   for _ in range(int(rng.integers(0, 3)))]})
    if name == "ClusterStatus":
        return (name, {"Nodes": [_spec("NodeStatus", rng)
                                 for _ in range(int(rng.integers(0, 3)))]})
    raise KeyError(name)


def build(mod, spec):
    name, fields = spec
    kwargs = {}
    for k, v in fields.items():
        if isinstance(v, tuple):
            kwargs[k] = build(mod, v)
        elif isinstance(v, list) and v and isinstance(v[0], tuple):
            kwargs[k] = [build(mod, x) for x in v]
        else:
            kwargs[k] = v
    return getattr(mod, name)(**kwargs)


def canon(msg, cls):
    """Field dict of a decoded message of either package, walked by the
    port's field table (doubles by their bits, so NaN and -0.0 count)."""
    out = {}
    for _num, name, kind, sub in cls.FIELDS:
        v = getattr(msg, name)
        if kind == "message":
            present = (msg.HasField(name) if hasattr(msg, "HasField")
                       else v is not None)
            out[name] = canon(v, sub) if present else None
        elif kind == "repeated_message":
            out[name] = [canon(x, sub) for x in v]
        elif kind.startswith("packed"):
            out[name] = [int(x) for x in v]
        elif kind == "map_string_uint64":
            out[name] = {k: int(x) for k, x in dict(v).items()}
        elif kind == "double":
            out[name] = struct.pack("<d", v)
        else:
            out[name] = v
    return out


def check_both_ways(spec, byte_equal=True):
    cls = getattr(tpb, spec[0])
    want = build(jpb, spec).SerializeToString()
    got = build(tpb, spec).SerializeToString()
    if byte_equal:
        assert got == want
    mine = cls.FromString(want)
    theirs = getattr(jpb, spec[0]).FromString(got)
    assert canon(mine, cls) == canon(theirs, cls) == canon(
        build(tpb, spec), cls)
    return got


# -- every message -------------------------------------------------------------

@pytest.mark.parametrize("name", MESSAGES)
@pytest.mark.parametrize("seed", range(6))
def test_message_matches_upb(name, seed):
    rng = np.random.default_rng(1000 * seed + MESSAGES.index(name))
    check_both_ways(_spec(name, rng), byte_equal=name != "MaxSlicesResponse")


def test_cache_sidecar_of_a_full_rank_cache():
    """A ``.cache`` sidecar of 50,000 sorted row ids (the default cache
    size) is upb's bytes, and decodes back to the ids."""
    ids = np.unique(np.random.default_rng(3).integers(
        0, 2**40, size=50_000, dtype=np.uint64))
    blob = tpb.Cache(IDs=ids).SerializeToString()
    assert blob == jpb.Cache(IDs=ids.tolist()).SerializeToString()
    assert np.array_equal(tpb.Cache.FromString(blob).IDs, ids)


def test_max_slices_map_decodes_either_order():
    spec = ("MaxSlicesResponse", {"MaxSlices": {"b": 3, "a": 0, "c": 2**64 - 1}})
    check_both_ways(spec, byte_equal=False)
    assert tpb.MaxSlicesResponse.FromString(
        build(jpb, spec).SerializeToString()).MaxSlices == {
            "a": 0, "b": 3, "c": 2**64 - 1}


# -- edge cases ------------------------------------------------------------

@pytest.mark.parametrize("v", [0, 2**63, 2**64 - 1])
def test_uint64_edges(v):
    check_both_ways(("Bitmap", {"Bits": [v, 0, v]}))
    check_both_ways(("Pair", {"Key": v, "Count": v}))
    check_both_ways(("ImportRequest", {"Slice": v, "RowIDs": [v],
                                       "ColumnIDs": [v]}))


@pytest.mark.parametrize("v", [-1, -2**63, -12345678901234, 2**63 - 1])
def test_negative_int64(v):
    got = check_both_ways(("ImportRequest", {"Timestamps": [v, 0, v]}))
    assert tpb.ImportRequest.FromString(got).Timestamps.tolist() == [v, 0, v]
    got = check_both_ways(("Attr", {"Type": 2, "IntValue": v}))
    if v < 0:
        assert len(got) == 2 + 1 + 10  # Type, then a 10-byte IntValue


@pytest.mark.parametrize("v", [float("nan"), -0.0, 0.0, float("-inf")])
def test_doubles(v):
    got = check_both_ways(("Attr", {"Type": 4, "FloatValue": v}))
    back = tpb.Attr.FromString(got).FloatValue
    assert struct.pack("<d", back) == struct.pack("<d", v)


def test_empty_and_absent_submessages():
    empty = check_both_ways(("QueryResult", {"Bitmap": ("Bitmap", {})}))
    assert empty == b"\x0a\x00"
    assert check_both_ways(("QueryResult", {})) == b""
    assert tpb.QueryResult.FromString(b"").Bitmap is None
    assert tpb.QueryResult.FromString(b"\x0a\x00").Bitmap == tpb.Bitmap()
    resp = check_both_ways(("QueryResponse", {
        "Results": [("QueryResult", {}), ("QueryResult", {"N": 0})]}))
    assert resp == b"\x12\x00\x12\x00"


def test_unpacked_repeated_input():
    # RowIDs (field 4) as three unpacked varints, then one packed run:
    # both forms accumulate, as upb does.
    body = (b"\x20\x01" + b"\x20\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01"
            + b"\x20\x00" + b"\x22\x03\x05\xac\x02"
            + b"\x30\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01")
    mine = tpb.ImportRequest.FromString(body)
    theirs = jpb.ImportRequest.FromString(body)
    assert canon(mine, tpb.ImportRequest) == canon(theirs, tpb.ImportRequest)
    assert mine.RowIDs.tolist() == [1, 2**64 - 1, 0, 5, 300]
    assert mine.Timestamps.tolist() == [-1]


@pytest.mark.parametrize("unknown", [
    b"\x78\x05",                               # field 15, varint
    b"\x79" + b"\x01" * 8,                     # field 15, fixed64
    b"\x7a\x03abc",                            # field 15, bytes
    b"\x7d" + b"\x02" * 4,                     # field 15, fixed32
    b"\x2a\x02\x08\x07",                       # QueryResult.ValCount
    b"\x10\x05",                               # Bitmap field 2 as varint
])
def test_unknown_fields_are_skipped(unknown):
    base = build(jpb, ("QueryResult", {"N": 7, "Pairs": [
        ("Pair", {"Key": 1, "Count": 2})]})).SerializeToString()
    for body in (unknown + base, base + unknown):
        assert canon(tpb.QueryResult.FromString(body), tpb.QueryResult) == \
            canon(jpb.QueryResult.FromString(body), tpb.QueryResult)


@pytest.mark.parametrize("body", [b"\x22\x05\x01\x02", b"\x22\x01\x80",
                                  b"\x08", b"\x0a\x05ab",
                                  b"\x22\x0b" + b"\xff" * 10 + b"\x01"])
def test_malformed_bytes_raise(body):
    with pytest.raises(Exception):
        jpb.ImportRequest.FromString(body)
    with pytest.raises(tpb.DecodeError):
        tpb.ImportRequest.FromString(body)


def test_packed_million_values_decode_fast():
    """A loose guard against a per-value loop: 1 M packed u64 of mixed
    lengths decode in well under a few seconds on the CPU."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 2**63, size=1_000_000, dtype=np.uint64) >> \
        rng.integers(0, 64, size=1_000_000).astype(np.uint64)
    body = jpb.ImportRequest(RowIDs=vals.tolist()).SerializeToString()
    t0 = time.perf_counter()
    got = tpb.ImportRequest.FromString(body)
    elapsed = time.perf_counter() - t0
    assert np.array_equal(got.RowIDs, vals)
    assert tpb.ImportRequest(RowIDs=vals).SerializeToString() == body
    assert elapsed < 3.0, elapsed


@settings(max_examples=60, deadline=None, database=None)
@given(rows=st.lists(st.integers(0, 2**64 - 1), max_size=20),
       ts=st.lists(st.integers(-2**63, 2**63 - 1), max_size=5),
       index=st.text(max_size=8), slice=st.integers(0, 2**64 - 1))
def test_import_request_hypothesis(rows, ts, index, slice):
    check_both_ways(("ImportRequest", {"Index": index, "Slice": slice,
                                       "RowIDs": rows,
                                       "ColumnIDs": rows[::-1],
                                       "Timestamps": ts}))


@settings(max_examples=60, deadline=None, database=None)
@given(key=st.text(max_size=6), i=st.integers(-2**63, 2**63 - 1),
       f=st.floats(allow_nan=True), s=st.text(max_size=6),
       b=st.booleans(), t=st.integers(0, 2**64 - 1))
def test_attr_hypothesis(key, i, f, s, b, t):
    check_both_ways(("Attr", {"Key": key, "Type": t, "StringValue": s,
                              "IntValue": i, "BoolValue": b,
                              "FloatValue": f}))


# -- the cluster's broadcast envelope and the node-to-node decode -------------

@pytest.mark.parametrize("seed", range(4))
def test_broadcast_envelopes_equal_jax(seed):
    """``marshal_message`` gives the JAX package's 1-byte tag + body, and
    each side unmarshals the other's envelope to equal fields."""
    from pilosa_tpu.cluster import broadcast as jb

    from pilosa_tpu_torch.cluster import broadcast as tb
    rng = np.random.default_rng(seed)
    for name in ("CreateSliceMessage", "CreateIndexMessage",
                 "DeleteIndexMessage", "CreateFrameMessage",
                 "DeleteFrameMessage"):
        spec = _spec(name, rng)
        want = jb.marshal_message(build(jpb, spec))
        got = tb.marshal_message(build(tpb, spec))
        assert got == want
        cls = getattr(tpb, name)
        assert canon(tb.unmarshal_message(want), cls) == canon(
            jb.unmarshal_message(got), cls)
    qid = _string(rng) + "q"
    assert tb.marshal_message(tb.CancelQueryMessage(qid)) == \
        jb.marshal_message(jb.CancelQueryMessage(qid))
    assert tb.unmarshal_message(jb.marshal_message(
        jb.CancelQueryMessage(qid))).id == qid


def test_query_results_decode_like_jax():
    """A peer's QueryResponse decodes per call name as the JAX codec
    decodes it: Bitmap bits and attributes, TopN pairs, counts, changed
    flags, ValCounts and attribute writes."""
    from pilosa_tpu.server import codec as jcodec

    from pilosa_tpu_torch.server import codec as tcodec
    rng = np.random.default_rng(2)
    W = 1 << 20
    bits = np.unique(rng.integers(0, 5 * W, size=300, dtype=np.uint64))
    results = [
        jpb.QueryResult(Bitmap=jpb.Bitmap(Bits=bits.tolist())),
        jpb.QueryResult(Pairs=[jpb.Pair(Key=5, Count=9),
                               jpb.Pair(Key=2**40, Count=1)]),
        jpb.QueryResult(N=2**40 + 7),
        jpb.QueryResult(Changed=True),
        jpb.QueryResult(ValCount=jpb.ValCount(Val=-12, Count=3)),
        jpb.QueryResult(),
        jpb.QueryResult(),
    ]
    results[0].Bitmap.Attrs.append(jpb.Attr(Key="k", Type=1,
                                            StringValue="v"))
    raw = jpb.QueryResponse(Results=results).SerializeToString()
    names = ["Bitmap", "TopN", "Count", "SetBit", "Sum", "SetRowAttrs",
             "Union"]
    got = tcodec.decode_query_results(tpb.QueryResponse.FromString(raw),
                                      names)
    want = jcodec.decode_query_results(jpb.QueryResponse.FromString(raw),
                                       names)
    assert got[0].bits().tolist() == want[0].bits().tolist()
    assert got[0].attrs == want[0].attrs == {"k": "v"}
    assert [(p.id, p.count) for p in got[1]] == \
        [(p.id, p.count) for p in want[1]]
    assert got[2:4] == want[2:4]
    assert (got[4].value, got[4].count) == (want[4].value, want[4].count)
    assert got[5] is None and want[5] is None
    assert got[6].count() == want[6].count() == 0
    req = tcodec.encode_query_request("Count(Bitmap(rowID=1))", [3, 2**33],
                                      column_attrs=True, remote=True)
    assert req == jcodec.encode_query_request(
        "Count(Bitmap(rowID=1))", [3, 2**33], column_attrs=True,
        remote=True)

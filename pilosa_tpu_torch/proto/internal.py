"""The port's protobuf wire codec for the messages of the JAX package's
``proto/internal.proto`` that the server speaks and writes (``.meta``
files, the fragments' ``.cache`` sidecars, and the cluster's node-to-node
messages: block sync, broadcasts and node status).

The card machine has no protobuf library, so the port encodes and
decodes the wire itself. Each message class has the field names of the
generated ``internal_pb2`` classes, ``SerializeToString()`` and
``FromString()``, and gives the same bytes:

- fields are emitted in field-number order;
- proto3 scalars at their default (0, "", False, a double whose bits are
  all zero) are left out; a set submessage is always emitted, an empty
  one as a zero-length field;
- repeated scalars are packed on encode; decode accepts both the packed
  and the unpacked form;
- ``int64`` is the 10-byte two's-complement varint, ``double`` fixed64
  little-endian, ``uint32`` keeps the low 32 bits of a decoded varint;
- map entries carry both key and value, keys in sorted order;
- unknown fields, and known fields of another wire type, are skipped.

Repeated ``uint64``/``int64`` fields decode to numpy arrays in a few
vectorised passes (``decode_varints``): the terminating bytes
(``b < 0x80``) give each value's span, and each value is put together
from its 7-bit groups with shifts and a segmented sum, with no Python
loop over the values. Encode is vectorised the same way
(``encode_varints``).
"""

from __future__ import annotations

import struct

import numpy as np

_MASK64 = (1 << 64) - 1
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_DOUBLE = struct.Struct("<d")


class DecodeError(Exception):
    """Bytes that are not a valid encoding of the message."""


# -- varints -----------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def encode_varints(values) -> bytes:
    """Varints of a u64 (or two's-complement i64) vector, vectorised:
    one pass per 7-bit group, at most ten."""
    v = np.ascontiguousarray(values)
    if v.dtype != np.uint64:
        v = v.astype(np.int64, copy=False).view(np.uint64) \
            if v.dtype.kind == "i" else v.astype(np.uint64)
    if not len(v):
        return b""
    n = np.ones(len(v), np.int64)
    for k in range(1, 10):
        n += v >= np.uint64(1 << (7 * k))
    ends = np.cumsum(n)
    starts = ends - n
    out = np.empty(int(ends[-1]), np.uint8)
    for k in range(10):
        m = n > k
        if not m.any():
            break
        group = (v[m] >> np.uint64(7 * k)) & np.uint64(0x7F)
        out[starts[m] + k] = group.astype(np.uint8) | np.where(
            n[m] > k + 1, 0x80, 0).astype(np.uint8)
    return out.tobytes()


def decode_varints(data, signed: bool = False) -> np.ndarray:
    """Packed varints → u64 (or i64) array. The terminating bytes mark
    each value's end; every byte's 7 bits shift by 7 × its place in its
    value, and a segmented sum (the groups never overlap, so the sum is
    their OR) gives the values. Groups past bit 63 are dropped, as
    protobuf decoders do."""
    b = np.frombuffer(data, np.uint8)
    dtype = np.int64 if signed else np.uint64
    if not len(b):
        return np.zeros(0, dtype)
    term = b < 0x80
    if not term[-1]:
        raise DecodeError("truncated packed varint")
    ends = np.flatnonzero(term)
    if len(ends) == len(b):  # every value one byte
        return b.astype(np.uint64).view(dtype)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    if int(lens.max()) > 10:
        raise DecodeError("varint longer than 10 bytes")
    place = np.arange(len(b), dtype=np.int64) - np.repeat(starts, lens)
    groups = (b & 0x7F).astype(np.uint64) << (place * 7).astype(np.uint64)
    return np.add.reduceat(groups, starts).view(dtype)


def _skip(buf, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        return _read_varint(buf, pos)[1]
    if wt == _WT_I64:
        pos += 8
    elif wt == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wt == _WT_I32:
        pos += 4
    else:
        raise DecodeError(f"unsupported wire type {wt}")
    if pos > len(buf):
        raise DecodeError("truncated field")
    return pos


def _tag(num: int, wt: int) -> bytes:
    return _varint(num << 3 | wt)


# -- messages ----------------------------------------------------------------

# Field kinds: singular scalars, a singular submessage, repeated
# submessages, packed repeated u64/i64, and map<string, uint64>.
_SCALAR_DEFAULTS = {"string": "", "bool": False, "uint32": 0, "uint64": 0,
                    "int64": 0, "double": 0.0}
_SCALAR_WT = {"string": _WT_LEN, "bool": _WT_VARINT, "uint32": _WT_VARINT,
              "uint64": _WT_VARINT, "int64": _WT_VARINT, "double": _WT_I64}


class Message:
    """Base of the wire messages. ``FIELDS`` lists
    ``(number, name, kind, message class or None)`` in field-number
    order."""

    FIELDS: tuple = ()

    def __init__(self, **kwargs):
        for _, name, kind, _sub in self.FIELDS:
            setattr(self, name, _default(kind))
        names = {f[1] for f in self.FIELDS}
        for k, v in kwargs.items():
            if k not in names:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        for _, name, kind, _sub in self.FIELDS:
            a, b = getattr(self, name), getattr(other, name)
            if kind in ("packed_uint64", "packed_int64"):
                if not np.array_equal(_as_array(a, kind),
                                      _as_array(b, kind)):
                    return False
            elif kind == "double":
                if _DOUBLE.pack(a) != _DOUBLE.pack(b):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self):
        parts = []
        for _, name, kind, _sub in self.FIELDS:
            v = getattr(self, name)
            if kind in ("packed_uint64", "packed_int64"):
                v = _as_array(v, kind).tolist()
            if v or kind == "message" and v is not None:
                parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encode

    def SerializeToString(self) -> bytes:
        out: list[bytes] = []
        for num, name, kind, _sub in self.FIELDS:
            v = getattr(self, name)
            if kind == "string":
                if v:
                    b = v.encode()
                    out += (_tag(num, _WT_LEN), _varint(len(b)), b)
            elif kind in ("uint64", "uint32", "bool"):
                v = int(v)
                if v:
                    limit = 1 << (32 if kind == "uint32" else 64)
                    if not 0 <= v < limit:
                        raise ValueError(f"{name}: {v} out of range for"
                                         f" {kind}")
                    out += (_tag(num, _WT_VARINT), _varint(v))
            elif kind == "int64":
                v = int(v)
                if v:
                    if not -(1 << 63) <= v < 1 << 63:
                        raise ValueError(f"{name}: {v} out of range for"
                                         " int64")
                    out += (_tag(num, _WT_VARINT), _varint(v & _MASK64))
            elif kind == "double":
                b = _DOUBLE.pack(v)
                if b != b"\0" * 8:
                    out += (_tag(num, _WT_I64), b)
            elif kind == "message":
                if v is not None:
                    b = v.SerializeToString()
                    out += (_tag(num, _WT_LEN), _varint(len(b)), b)
            elif kind == "repeated_message":
                for m in v:
                    b = m.SerializeToString()
                    out += (_tag(num, _WT_LEN), _varint(len(b)), b)
            elif kind in ("packed_uint64", "packed_int64"):
                if len(v):
                    b = encode_varints(_as_array(v, kind))
                    out += (_tag(num, _WT_LEN), _varint(len(b)), b)
            elif kind == "map_string_uint64":
                for k in sorted(v):
                    kb = k.encode()
                    entry = (b"\x0a" + _varint(len(kb)) + kb + b"\x10"
                             + _varint(int(v[k]) & _MASK64))
                    out += (_tag(num, _WT_LEN), _varint(len(entry)), entry)
        return b"".join(out)

    # -- decode

    @classmethod
    def FromString(cls, data) -> "Message":
        buf = memoryview(bytes(data) if not isinstance(data, bytes)
                         else data)
        by_num = cls._by_num()
        msg = cls()
        chunks: dict[str, list] = {}
        pos, end = 0, len(buf)
        while pos < end:
            key, pos = _read_varint(buf, pos)
            num, wt = key >> 3, key & 7
            spec = by_num.get(num)
            if spec is None:
                pos = _skip(buf, pos, wt)
                continue
            name, kind, sub = spec
            if kind in _SCALAR_WT:
                if wt != _SCALAR_WT[kind]:
                    pos = _skip(buf, pos, wt)
                    continue
                v, pos = _read_scalar(buf, pos, kind)
                setattr(msg, name, v)
            elif kind in ("packed_uint64", "packed_int64"):
                signed = kind == "packed_int64"
                if wt == _WT_LEN:
                    n, pos = _read_varint(buf, pos)
                    if pos + n > end:
                        raise DecodeError("truncated packed field")
                    chunks.setdefault(name, []).append(
                        decode_varints(buf[pos:pos + n], signed))
                    pos += n
                elif wt == _WT_VARINT:
                    v, pos = _read_varint(buf, pos)
                    chunks.setdefault(name, []).append(
                        np.array([v], np.uint64).view(
                            np.int64 if signed else np.uint64))
                else:
                    pos = _skip(buf, pos, wt)
            else:  # length-delimited: messages and map entries
                if wt != _WT_LEN:
                    pos = _skip(buf, pos, wt)
                    continue
                n, pos = _read_varint(buf, pos)
                if pos + n > end:
                    raise DecodeError("truncated submessage")
                body = buf[pos:pos + n]
                pos += n
                if kind == "repeated_message":
                    getattr(msg, name).append(sub.FromString(body))
                elif kind == "message":
                    # A repeated singular message merges: decode the
                    # concatenation, as protobuf does.
                    chunks.setdefault(name, []).append(bytes(body))
                else:
                    k, v = _MapEntry.FromString(body).pair()
                    getattr(msg, name)[k] = v
        for name, parts in chunks.items():
            if isinstance(parts[0], bytes):
                setattr(msg, name, _field_class(cls, name).FromString(
                    b"".join(parts)))
            else:
                setattr(msg, name, parts[0] if len(parts) == 1
                        else np.concatenate(parts))
        return msg

    @classmethod
    def _by_num(cls) -> dict:
        table = cls.__dict__.get("_BY_NUM")
        if table is None:
            table = {num: (name, kind, sub)
                     for num, name, kind, sub in cls.FIELDS}
            cls._BY_NUM = table
        return table


def _field_class(cls, name: str):
    for _, n, _kind, sub in cls.FIELDS:
        if n == name:
            return sub
    raise KeyError(name)


def _default(kind: str):
    if kind in _SCALAR_DEFAULTS:
        return _SCALAR_DEFAULTS[kind]
    if kind == "message":
        return None
    if kind == "repeated_message":
        return []
    if kind == "packed_uint64":
        return np.zeros(0, np.uint64)
    if kind == "packed_int64":
        return np.zeros(0, np.int64)
    return {}


def _as_array(v, kind: str) -> np.ndarray:
    dtype = np.int64 if kind == "packed_int64" else np.uint64
    return np.asarray(v, dtype=dtype)


def _read_scalar(buf, pos: int, kind: str):
    if kind == "double":
        if pos + 8 > len(buf):
            raise DecodeError("truncated double")
        return _DOUBLE.unpack_from(buf, pos)[0], pos + 8
    if kind == "string":
        n, pos = _read_varint(buf, pos)
        if pos + n > len(buf):
            raise DecodeError("truncated string")
        try:
            return str(buf[pos:pos + n], "utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid UTF-8 in string field: {e}")
    v, pos = _read_varint(buf, pos)
    if kind == "bool":
        return v != 0, pos
    if kind == "uint32":
        return v & 0xFFFFFFFF, pos
    if kind == "int64":
        return (v - (1 << 64) if v >> 63 else v), pos
    return v, pos


class _MapEntry(Message):
    FIELDS = ((1, "key", "string", None), (2, "value", "uint64", None))

    def pair(self) -> tuple[str, int]:
        return self.key, self.value


# -- public API types (internal.proto) ---------------------------------------

class Attr(Message):
    FIELDS = ((1, "Key", "string", None), (2, "Type", "uint64", None),
              (3, "StringValue", "string", None),
              (4, "IntValue", "int64", None),
              (5, "BoolValue", "bool", None),
              (6, "FloatValue", "double", None))


class AttrMap(Message):
    FIELDS = ((1, "Attrs", "repeated_message", Attr),)


class Bitmap(Message):
    FIELDS = ((1, "Bits", "packed_uint64", None),
              (2, "Attrs", "repeated_message", Attr))


class Pair(Message):
    FIELDS = ((1, "Key", "uint64", None), (2, "Count", "uint64", None))


class ColumnAttrSet(Message):
    FIELDS = ((1, "ID", "uint64", None),
              (2, "Attrs", "repeated_message", Attr))


class QueryRequest(Message):
    FIELDS = ((1, "Query", "string", None),
              (2, "Slices", "packed_uint64", None),
              (3, "ColumnAttrs", "bool", None),
              (4, "Quantum", "string", None),
              (5, "Remote", "bool", None))


class ValCount(Message):
    FIELDS = ((1, "Val", "int64", None), (2, "Count", "int64", None))


class QueryResult(Message):
    FIELDS = ((1, "Bitmap", "message", Bitmap),
              (2, "N", "uint64", None),
              (3, "Pairs", "repeated_message", Pair),
              (4, "Changed", "bool", None),
              (5, "ValCount", "message", ValCount))


class QueryResponse(Message):
    FIELDS = ((1, "Err", "string", None),
              (2, "Results", "repeated_message", QueryResult),
              (3, "ColumnAttrSets", "repeated_message", ColumnAttrSet))


class ImportRequest(Message):
    FIELDS = ((1, "Index", "string", None), (2, "Frame", "string", None),
              (3, "Slice", "uint64", None),
              (4, "RowIDs", "packed_uint64", None),
              (5, "ColumnIDs", "packed_uint64", None),
              (6, "Timestamps", "packed_int64", None))


class ImportValueRequest(Message):
    FIELDS = ((1, "Index", "string", None), (2, "Frame", "string", None),
              (3, "Field", "string", None), (4, "Slice", "uint64", None),
              (5, "ColumnIDs", "packed_uint64", None),
              (6, "Values", "packed_int64", None))


# -- private types (internal.proto) ------------------------------------------

class ImportResponse(Message):
    FIELDS = ((1, "Err", "string", None),)


class IndexMeta(Message):
    FIELDS = ((1, "ColumnLabel", "string", None),
              (2, "TimeQuantum", "string", None))


class FieldMeta(Message):
    FIELDS = ((1, "Name", "string", None), (2, "Min", "int64", None),
              (3, "Max", "int64", None))


class FrameMeta(Message):
    FIELDS = ((1, "RowLabel", "string", None),
              (2, "InverseEnabled", "bool", None),
              (3, "CacheType", "string", None),
              (4, "CacheSize", "uint32", None),
              (5, "TimeQuantum", "string", None),
              (6, "Fields", "repeated_message", FieldMeta))


class Cache(Message):
    """A fragment's ``.cache`` sidecar: the count cache's row ids."""
    FIELDS = ((1, "IDs", "packed_uint64", None),)


class MaxSlicesResponse(Message):
    FIELDS = ((1, "MaxSlices", "map_string_uint64", None),)


# -- cluster types (internal.proto) ------------------------------------------

class Bit(Message):
    FIELDS = ((1, "RowID", "uint64", None), (2, "ColumnID", "uint64", None),
              (3, "Timestamp", "int64", None))


class BlockDataRequest(Message):
    FIELDS = ((1, "Index", "string", None), (2, "Frame", "string", None),
              (3, "Block", "uint64", None), (4, "Slice", "uint64", None),
              (5, "View", "string", None))


class BlockDataResponse(Message):
    FIELDS = ((1, "RowIDs", "packed_uint64", None),
              (2, "ColumnIDs", "packed_uint64", None))


class CreateSliceMessage(Message):
    FIELDS = ((1, "Index", "string", None), (2, "Slice", "uint64", None),
              (3, "IsInverse", "bool", None))


class DeleteIndexMessage(Message):
    FIELDS = ((1, "Index", "string", None),)


class CreateIndexMessage(Message):
    FIELDS = ((1, "Index", "string", None),
              (2, "Meta", "message", IndexMeta))


class CreateFrameMessage(Message):
    FIELDS = ((1, "Index", "string", None), (2, "Frame", "string", None),
              (3, "Meta", "message", FrameMeta))


class DeleteFrameMessage(Message):
    FIELDS = ((1, "Index", "string", None), (2, "Frame", "string", None))


class Frame(Message):
    FIELDS = ((1, "Name", "string", None),
              (2, "Meta", "message", FrameMeta))


class Index(Message):
    FIELDS = ((1, "Name", "string", None),
              (2, "Meta", "message", IndexMeta),
              (3, "MaxSlice", "uint64", None),
              (4, "Frames", "repeated_message", Frame),
              (5, "Slices", "packed_uint64", None))


class NodeStatus(Message):
    FIELDS = ((1, "Host", "string", None), (2, "State", "string", None),
              (3, "Indexes", "repeated_message", Index))


class ClusterStatus(Message):
    FIELDS = ((1, "Nodes", "repeated_message", NodeStatus),)

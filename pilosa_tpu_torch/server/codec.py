"""Wire codecs of the HTTP handler.

Trimmed copy of the JAX package's ``server/codec.py`` on the port's wire
codec (``proto/internal.py``): runtime results (storage.Bitmap,
cache.Pair, attribute dicts, counts, changed flags) to the protobuf
``QueryResponse`` and to the reference's JSON shapes
(handler.go:1307-1397, bitmap.go:220-233, cache.go:292-293). ValCount
comes with the BSI slice; the node-to-node decoders with the cluster
slice.
"""

from __future__ import annotations

import base64

from ..proto import internal as pb
from ..storage.attrs import encode_attr_list
from ..storage.bitmap import Bitmap


def encode_bitmap(bm: Bitmap) -> pb.Bitmap:
    return pb.Bitmap(Bits=bm.bits(), Attrs=encode_attr_list(bm.attrs))


def encode_query_result(result) -> pb.QueryResult:
    # A Bitmap result is always present on the wire, even an empty one;
    # N=0 and Changed=false are left out (proto3 defaults).
    out = pb.QueryResult()
    if isinstance(result, Bitmap):
        out.Bitmap = encode_bitmap(result)
    elif isinstance(result, list):
        out.Pairs = [pb.Pair(Key=p.id, Count=p.count) for p in result]
    elif isinstance(result, bool):
        out.Changed = result
    elif isinstance(result, int):
        out.N = result
    return out


def encode_query_response(results: list, column_attr_sets=None,
                          err: str = "") -> pb.QueryResponse:
    return pb.QueryResponse(
        Err=err, Results=[encode_query_result(r) for r in results],
        ColumnAttrSets=[pb.ColumnAttrSet(ID=id,
                                         Attrs=encode_attr_list(attrs))
                        for id, attrs in column_attr_sets or []])


# -- JSON shapes --------------------------------------------------------------

def result_to_json(result):
    if isinstance(result, Bitmap):
        return result.to_json()
    if isinstance(result, list):  # pairs
        return [{"id": p.id, "count": p.count} for p in result]
    return result  # int, bool, or None


def query_response_json(results: list, column_attr_sets=None,
                        err: str = "") -> dict:
    out = {}
    if results:
        out["results"] = [result_to_json(r) for r in results]
    if column_attr_sets:
        out["columnAttrs"] = [
            {"id": id, **({"attrs": attrs} if attrs else {})}
            for id, attrs in column_attr_sets]
    if err:
        out["error"] = err
    return out


def blocks_from_json(objs: list[dict]) -> list[tuple[int, bytes]]:
    """Attribute blocks of an ``attr/diff`` request: checksum bytes
    base64 like Go's []byte (fragment.go:1270-1273)."""
    return [(o["id"], base64.b64decode(o["checksum"])) for o in objs]

"""Wire codecs of the HTTP handler.

Trimmed copy of the JAX package's ``server/codec.py`` on the port's wire
codec (``proto/internal.py``): runtime results (storage.Bitmap,
cache.Pair, attribute dicts, counts, changed flags) to the protobuf
``QueryResponse`` and to the reference's JSON shapes
(handler.go:1307-1397, bitmap.go:220-233, cache.go:292-293) and the
``ValCount`` of Sum/Min/Max (``{"value": v, "count": n}``), and the
node-to-node side: the QueryRequest a coordinator sends, the per-call
decode of a peer's QueryResponse (executor.go:1058-1080) and the
anti-entropy block JSON.
"""

from __future__ import annotations

import base64
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..proto import internal as pb
from ..storage import roaring
from ..storage.attrs import decode_attr_list, encode_attr_list
from ..storage.bitmap import Bitmap
from ..storage.bsi import ValCount
from ..storage.cache import Pair
from ..utils.arrays import group_by_key


def encode_bitmap(bm: Bitmap) -> pb.Bitmap:
    return pb.Bitmap(Bits=bm.bits(), Attrs=encode_attr_list(bm.attrs))


def decode_bitmap(msg: pb.Bitmap) -> Bitmap:
    """The segmented result bitmap from the wire bit list, one roaring
    build per slice."""
    bm = Bitmap()
    cols = np.asarray(msg.Bits, dtype=np.uint64)
    if len(cols):
        for slice, group in group_by_key(cols // np.uint64(SLICE_WIDTH),
                                         cols):
            bm.add_segment(roaring.Bitmap.from_sorted(group), int(slice),
                           writable=True)
    bm.attrs = decode_attr_list(msg.Attrs)
    return bm


def encode_query_request(query: str, slices: Optional[list[int]] = None,
                         column_attrs: bool = False, remote: bool = False
                         ) -> bytes:
    return pb.QueryRequest(Query=query, Slices=slices or [],
                           ColumnAttrs=column_attrs,
                           Remote=remote).SerializeToString()


def decode_query_results(resp: pb.QueryResponse, call_names: list[str]
                         ) -> list:
    """Per-call results by call name (executor.go:1058-1080)."""
    out = []
    for name, res in zip(call_names, resp.Results):
        if name == "TopN":
            out.append([Pair(int(m.Key), int(m.Count)) for m in res.Pairs])
        elif name == "Count":
            out.append(int(res.N))
        elif name in ("SetBit", "ClearBit", "SetFieldValue"):
            out.append(bool(res.Changed))
        elif name in ("Sum", "Min", "Max"):
            vc = res.ValCount or pb.ValCount()
            out.append(ValCount(int(vc.Val), int(vc.Count)))
        elif name in ("SetRowAttrs", "SetColumnAttrs"):
            out.append(None)
        else:
            out.append(decode_bitmap(res.Bitmap or pb.Bitmap()))
    return out


def encode_query_result(result) -> pb.QueryResult:
    # A Bitmap result is always present on the wire, even an empty one;
    # N=0 and Changed=false are left out (proto3 defaults).
    out = pb.QueryResult()
    if isinstance(result, Bitmap):
        out.Bitmap = encode_bitmap(result)
    elif isinstance(result, ValCount):
        out.ValCount = pb.ValCount(Val=result.value, Count=result.count)
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
    if isinstance(result, (Bitmap, ValCount)):
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


def blocks_to_json(blocks: list[tuple[int, bytes]]) -> list[dict]:
    """FragmentBlock JSON: checksum bytes base64 like Go's []byte
    (fragment.go:1270-1273)."""
    return [{"id": bid, "checksum": base64.b64encode(chk).decode()}
            for bid, chk in blocks]


def blocks_from_json(objs: list[dict]) -> list[tuple[int, bytes]]:
    """Attribute blocks of an ``attr/diff`` request: checksum bytes
    base64 like Go's []byte (fragment.go:1270-1273)."""
    return [(o["id"], base64.b64decode(o["checksum"])) for o in objs]

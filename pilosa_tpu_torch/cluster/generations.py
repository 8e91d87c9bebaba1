"""Per-slice fragment generation tokens.

Trimmed copy of the JAX package's ``cluster/generations.py``: only
``frag_key`` and ``slice_tokens``, the keys of the planner's per-slice
subresult cache (plan.planner.SubresultCache). A token is a fragment's
``DeviceRowCache`` ``(uid, generation)`` pair: every write bumps the
generation and every reopen draws a new uid, so a key built from the
tokens stops matching the moment any fragment it names changes. The
cluster map, its wire encoding and the staleness bound wait for the
multi-node slice.
"""

from __future__ import annotations


def frag_key(frame: str, view: str) -> str:
    return f"{frame}/{view}"


def slice_tokens(holder, index: str, slice: int) -> dict:
    """This node's current ``{frame/view: (uid, gen)}`` dict for one
    slice — every open fragment of every frame/view at that slice.
    Empty dict = no fragments there (a valid, comparable state)."""
    idx = holder.index(index)
    if idx is None:
        return {}
    out: dict[str, tuple[int, int]] = {}
    for fname in sorted(idx.frames):
        frame = idx.frames[fname]
        for vname in sorted(frame.views):
            frag = frame.views[vname].fragments.get(slice)
            if frag is not None:
                dev = frag.device
                out[frag_key(fname, vname)] = (dev.uid, dev.generation)
    return out

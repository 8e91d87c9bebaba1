"""Mutation-generation tokens: cluster-wide cache-validity facts.

Copy of the JAX package's ``cluster/generations.py``. A token is a
fragment's ``(uid, generation)`` pair (its DeviceRowCache's): every write
bumps the generation and every reopen draws a new uid, so a key built
from the tokens stops matching the moment any fragment it names changes.
uids are process-local counters, so every consumer keys by ``(peer,
uid, gen)``, never by the bare pair.

- **Tokens** per slice: ``{"<frame>/<view>": (uid, gen)}`` — the keys of
  the planner's per-slice subresult cache (plan.planner.SubresultCache).
- **Wire**: a serving node piggybacks its tokens for the served slices
  on internal query responses and import acks as the
  ``X-Pilosa-Generations`` header, and answers the ``GET /generations``
  probe, in the JAX package's JSON encoding.
- **GenerationMap**: the coordinator's per-peer map, each entry stamped
  with a monotonic receive time; the coordinator's cluster result cache
  snapshots the freshest entry of each slice and validates it with a
  probe. (The JAX package's staleness-bounded reads serve its remote
  bitmap-result keys, which the port does not keep.)

Invalidation is by mismatch, not callbacks: a write to any replica bumps
that replica's generations, the next exchange with it carries the new
tokens, and every artifact keyed by the old tokens stops matching.
"""

from __future__ import annotations

import json
import threading
import time

from ..obs import metrics as obs_metrics

# Internal response header carrying the serving node's tokens for the
# slices it served (query legs and import acks).
GENERATIONS_HEADER = "X-Pilosa-Generations"

# Caps on one wire payload: fragment entries AND encoded bytes (the
# byte budget is the binding one — http.client rejects header LINES
# over 64 KiB, same rationale as the trace/cost 48 KiB budgets). Past
# either, whole slices are dropped (never a partial slice — a consumer
# either sees a slice's complete token dict or nothing) and the
# payload is marked truncated.
MAX_WIRE_FRAGMENTS = 4096
MAX_WIRE_BYTES = 48 << 10


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


def local_tokens(holder, index: str, slices) -> dict:
    """``{slice: {frame/view: (uid, gen)}}`` for the given slices."""
    return {int(s): slice_tokens(holder, index, int(s)) for s in slices}


def encode_wire(index: str, tokens: dict,
                max_fragments: int = MAX_WIRE_FRAGMENTS,
                max_bytes: int = MAX_WIRE_BYTES) -> str:
    """Compact JSON for the header / probe body. ``tokens`` is the
    local_tokens shape. Slices are included whole, in ascending order,
    until the fragment cap OR the byte budget (whichever binds —
    header lines over 64 KiB would fail the very response carrying
    them); the rest are dropped and ``x`` marks the truncation
    (consumers treat absent slices as unknown, never as empty)."""
    t: dict = {}
    n = 0
    # Envelope + truncation marker overhead, counted up front so the
    # budget bounds the FINAL encoded size.
    size = len(json.dumps({"i": index, "t": {}, "x": 1},
                          separators=(",", ":")))
    truncated = False
    for s in sorted(tokens):
        m = tokens[s]
        chunk = json.dumps(
            {str(s): {k: [v[0], v[1]] for k, v in m.items()}},
            separators=(",", ":"))
        cost = len(chunk) - 1  # minus braces, plus the joining comma
        if size + cost > max_bytes:
            # Byte budget binds even for the FIRST slice: an
            # over-64KiB header line would fail the whole response.
            truncated = True
            break
        if t and n + len(m) > max_fragments:
            truncated = True
            break
        n += len(m)
        size += cost
        t[str(s)] = {k: [v[0], v[1]] for k, v in m.items()}
    out = {"i": index, "t": t}
    if truncated:
        out["x"] = 1
    return json.dumps(out, separators=(",", ":"))


def decode_wire(payload: str):
    """(index, {slice: {frag_key: (uid, gen)}}) or None on garbage —
    a malformed header must never fail the query that carried it."""
    try:
        data = json.loads(payload)
        index = data["i"]
        tokens = {}
        for s, m in (data.get("t") or {}).items():
            tokens[int(s)] = {str(k): (int(v[0]), int(v[1]))
                              for k, v in m.items()}
    except (ValueError, KeyError, TypeError, IndexError):
        return None
    if not isinstance(index, str):
        return None
    return index, tokens


def decode_tokens(raw: dict) -> dict:
    """The /generations probe's ``tokens`` object → the local_tokens
    shape (lenient: bad entries dropped, not raised)."""
    out: dict = {}
    for s, m in (raw or {}).items():
        try:
            out[int(s)] = {str(k): (int(v[0]), int(v[1]))
                           for k, v in m.items()}
        except (ValueError, TypeError, KeyError, IndexError):
            continue
    return out


class GenerationMap:
    """Coordinator-side per-peer generation knowledge.

    ``apply(peer, index, tokens)`` records a peer's tokens (from a
    response header or a probe) with a monotonic timestamp; ``newest``
    reads the freshest entry of a slice. Thread-safe; bounded per peer
    (oldest slices evicted beyond ``max_slices_per_peer``).
    """

    def __init__(self, max_slices_per_peer: int = 65536):
        self.max_slices_per_peer = max_slices_per_peer
        self._mu = threading.Lock()
        # peer -> (index, slice) -> (tokens dict, monotonic ts)
        self._peers: dict[str, dict[tuple, tuple]] = {}

    def apply(self, peer: str, index: str, tokens: dict) -> int:
        """Record ``{slice: {frag_key: (uid, gen)}}`` for a peer;
        returns the number of slice entries applied."""
        if not peer or not tokens:
            return 0
        now = time.monotonic()
        with self._mu:
            m = self._peers.setdefault(peer, {})
            for s, toks in tokens.items():
                m[(index, int(s))] = (dict(toks), now)
            if len(m) > self.max_slices_per_peer:
                # Rare; evict oldest entries wholesale.
                drop = sorted(m.items(), key=lambda kv: kv[1][1])
                for k, _ in drop[:len(m) - self.max_slices_per_peer]:
                    del m[k]
        obs_metrics.GENERATION_UPDATES.labels(peer).inc(len(tokens))
        return len(tokens)

    def apply_wire(self, peer: str, payload: str) -> int:
        """Record a piggybacked GENERATIONS_HEADER payload."""
        decoded = decode_wire(payload)
        if decoded is None:
            return 0
        index, tokens = decoded
        return self.apply(peer, index, tokens)

    def tokens(self, peer: str, index: str, slice: int):
        """The freshest-known token dict of (peer, index, slice), or
        None (the resize double read's newest-token check)."""
        with self._mu:
            m = self._peers.get(peer)
            ent = m.get((index, slice)) if m else None
        return ent[0] if ent is not None else None

    def newest(self, index: str, slice: int):
        """(peer, tokens, ts) with the newest knowledge of (index,
        slice) across peers, or None."""
        best = None
        with self._mu:
            for peer, m in self._peers.items():
                ent = m.get((index, slice))
                if ent is None:
                    continue
                toks, ts = ent
                if best is None or ts > best[2]:
                    best = (peer, toks, ts)
        return best

    def snapshot(self) -> dict:
        """Peers and slice entries held (the flight recorder's
        ``generations`` block)."""
        with self._mu:
            return {"peers": len(self._peers),
                    "entries": sum(len(m) for m in self._peers.values())}

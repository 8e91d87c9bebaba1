"""The one request generator: reads a traffic mix's parameter file and
yields PQL bodies, each with the tree the reference evaluates.

A mix (``perfbench/traffic/<mix>.json``) holds:

- ``clients``: closed-loop clients, each on its own keep-alive
  connection;
- ``warm_seconds``: how long every client sends its warm-up stream
  before the window (counted in set-up);
- ``body``: a template, ``{"calls": [<call>, ...], "repeat": k}``; a
  request's body is the calls drawn ``repeat`` times, in order;
- ``pool`` (optional): ``{"size": m, "pick": "zipf", "s": 1.0}`` draws
  ``m`` bodies once, shared by every client, and each request picks one
  of them (a dashboard that users reload). They are drawn in rank space
  by a fixed generator, so every seed serves the same dashboards over
  other row ids.

Template nodes:

- ``{"call": <Name>, ...}``: a PQL call, drawn, written, parsed and
  answered by ``perfbench/calls/<Name>.py`` (see ``calls/Count.py``);
  a new call is a new file there;
- ``{"op": "Union" | "Intersect" | "Difference" | "Xor", "args": [...]}``;
- ``{"rows": {"frame": F, "k": k | [lo, hi], "pick": "zipf" | "uniform",
  "s": 1.0, "distinct": group}}``: k ``Bitmap`` leaves of frame F, in
  place, k drawn uniformly from [lo, hi]; rows that share a ``distinct``
  group within one request are all different;
- ``{"choose": [[weight, node], ...]}`` with whole weights: each client
  deals the options from a shuffled deck that holds each option
  ``weight`` times, so every run sends the same proportions.

Row popularity: ``zipf`` picks popularity rank r with weight 1 / r**s.
Rank r is the same size stratum of the frame under every seed (a fixed
permutation), held by the row id the seed gives that stratum
(``row_order``): every seed sends the same work over other rows, in
another order.

Trees: ``("leaf", frame, row)`` and ``(op, (children))`` for the
operators above; a call's tree starts with its name, and the rest is
its module's. A body is a tuple of calls. This module imports numpy and
the standard library only: the client processes import it, and the
call modules with it.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OPS = ("Union", "Intersect", "Difference", "Xor")


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


_CALLS: dict = {}


def call_kind(name: str):
    """The module ``perfbench/calls/<name>.py``, loaded once."""
    mod = _CALLS.get(name)
    if mod is None:
        path = os.path.join(HERE, "calls", name + ".py")
        if not os.path.isfile(path):
            raise ValueError(f"unknown call {name!r}: no {path}")
        sp = importlib.util.spec_from_file_location(
            "perfbench_call_" + name, path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        _CALLS[name] = mod
    return mod


def seed_seq(seed: int, *tags) -> np.random.SeedSequence:
    """A SeedSequence for (seed, tags); any whole seed, negative too."""
    words = [int(seed) % (1 << 64)]
    for t in tags:
        words.append(t if isinstance(t, int)
                     else int.from_bytes(str(t).encode()[:8], "little"))
    return np.random.SeedSequence(words)


def rng_for(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(seed_seq(seed, *tags))


def row_order(seed: int, frame: str, n_rows: int) -> np.ndarray:
    """The row id that holds each size stratum of a frame (datagen), by
    the seed."""
    return rng_for(seed, "rows", frame).permutation(n_rows)


class Stream:
    """The request stream of one client (``client`` >= 0) or of the
    warm-up (``warm`` True): deterministic in (mix, frame sizes, seed,
    client, warm)."""

    def __init__(self, mix: dict, frame_rows: dict, seed: int,
                 client: int, warm: bool = False):
        self.mix = mix
        self.frame_rows = frame_rows
        self.seed = seed
        # Popularity rank r -> row id: the row of size stratum
        # strata[r], wherever the seed places that stratum.
        self._pop = {}
        for frame, n in sorted(frame_rows.items()):
            strata = rng_for(0, "popularity", frame).permutation(n)
            self._pop[frame] = row_order(seed, frame, n)[strata]
        self._rng = rng_for(seed, "warm" if warm else "window", client)
        self._decks: dict = {}
        self._pool = None
        pool = mix.get("pool")
        if pool:
            prng = rng_for(0, "pool")
            self._pool = [self._body(prng, self._decks)
                          for _ in range(int(pool["size"]))]
            self._pool_p = _weights(len(self._pool), pool.get("pick", "zipf"),
                                    float(pool.get("s", 1.0)))
            self._decks = {}

    def next(self) -> tuple[str, tuple]:
        """(PQL body, tree) of the next request."""
        if self._pool is not None:
            i = int(self._rng.choice(len(self._pool), p=self._pool_p))
            return self._pool[i]
        return self._body(self._rng, self._decks)

    def take(self, n: int) -> list:
        return [self.next() for _ in range(n)]

    def popularity(self, frame: str) -> np.ndarray:
        """Row id of each popularity rank of ``frame``."""
        return self._pop[frame]

    # -- drawing --------------------------------------------------------------

    def _body(self, rng, decks) -> tuple[str, tuple]:
        tmpl = self.mix["body"]
        calls = []
        for _ in range(int(tmpl.get("repeat", 1))):
            for i, c in enumerate(tmpl["calls"]):
                calls.append(Draw(self, rng, decks, ("c", i), {}).call(c))
        return " ".join(pql(c) for c in calls), tuple(calls)


class Draw:
    """What a call module's ``draw(node, d)`` draws with: the stream's
    generator, the decks of its ``choose`` nodes (by their path in the
    template) and the rows taken in this call (by ``distinct`` group)."""

    def __init__(self, stream: Stream, rng, decks: dict, path: tuple,
                 used: dict):
        self.stream = stream
        self.rng = rng
        self._decks = decks
        self.path = path
        self._used = used

    def at(self, *tags) -> "Draw":
        """The same draw one step down the template (its own decks)."""
        return Draw(self.stream, self.rng, self._decks, self.path + tags,
                    self._used)

    def resolve(self, node):
        """``node`` with its ``choose`` nodes dealt."""
        path = self.path
        while isinstance(node, dict) and "choose" in node:
            node = self._deal(node, path)
            path = path + ("x",)
        return node

    def call(self, node) -> tuple:
        node = self.resolve(node)
        return call_kind(node["call"]).draw(node, self)

    def expr(self, node) -> tuple:
        """One bitmap expression."""
        out = self.nodes(node)
        if len(out) != 1:
            raise ValueError("a call's argument must be one expression")
        return out[0]

    def nodes(self, node) -> list:
        """The trees a template node stands for (``rows`` may stand for
        several leaves)."""
        node = self.resolve(node)
        if "rows" in node:
            return self._rows(node["rows"])
        if "call" in node:
            return [self.call(node)]
        op = node["op"]
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        kids = []
        for i, a in enumerate(node["args"]):
            kids.extend(self.at(i).nodes(a))
        return [(op, tuple(kids))]

    def _deal(self, node, path):
        """The next option of a ``choose`` node's deck."""
        deck = self._decks.get(path)
        if not deck:
            deck = []
            for i, (w, _opt) in enumerate(node["choose"]):
                deck.extend([i] * int(w))
            self.rng.shuffle(deck)
            self._decks[path] = deck
        return node["choose"][deck.pop()][1]

    def _rows(self, spec) -> list:
        frame = spec["frame"]
        pop = self.stream.popularity(frame)
        n_rows = len(pop)
        k = spec["k"]
        k = (int(self.rng.integers(k[0], k[1] + 1)) if isinstance(k, list)
             else int(k))
        p = _weights(n_rows, spec.get("pick", "uniform"),
                     float(spec.get("s", 1.0)))
        group = spec.get("distinct")
        taken = (self._used.setdefault((frame, group), set()) if group
                 else set())
        if taken:
            p = p.copy()
            p[[r for r in range(n_rows) if pop[r] in taken]] = 0
            p /= p.sum()
        ranks = self.rng.choice(n_rows, size=k, replace=False, p=p)
        rows = [int(pop[r]) for r in ranks]
        taken.update(rows)
        return [("leaf", frame, r) for r in rows]


def _weights(n: int, pick: str, s: float) -> np.ndarray:
    if pick == "uniform":
        return np.full(n, 1.0 / n)
    if pick == "zipf":
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
        return w / w.sum()
    raise ValueError(f"unknown pick {pick!r}")


def pql(t) -> str:
    """The PQL of a tree."""
    kind = t[0]
    if kind == "leaf":
        return f"Bitmap(rowID={t[2]}, frame={t[1]})"
    if kind in OPS:
        return f"{kind}({', '.join(pql(c) for c in t[1])})"
    return call_kind(kind).pql(t, pql)


def leaf_frames(mix: dict) -> list:
    """The frames whose rows a mix sends as ``Bitmap`` leaves."""
    out: set = set()

    def walk(node):
        if isinstance(node, dict):
            if "rows" in node:
                out.add(node["rows"]["frame"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(mix["body"])
    return sorted(out)


def leaves(t) -> set:
    """The distinct (frame, row) leaves of a tree."""
    if t[0] == "leaf":
        return {(t[1], t[2])}
    kids = t[1] if t[0] in OPS else call_kind(t[0]).exprs(t)
    out: set = set()
    for c in kids:
        out |= leaves(c)
    return out

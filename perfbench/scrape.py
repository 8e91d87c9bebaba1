"""The program's ``/metrics`` text, read as sums over label sets."""

from __future__ import annotations

import re

_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*?\})?\s+([^\s#]+)")


def parse(text: str) -> dict:
    """{sample name: value summed over its label sets}; exemplars and
    comments are skipped."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            continue
        try:
            v = float(m.group(3))
        except ValueError:
            continue
        out[m.group(1)] = out.get(m.group(1), 0.0) + v
    return out


def delta(rec: dict, name: str):
    """After minus before of one sample over the window; None when the
    traced run did not scrape or the program has no such sample."""
    sc = rec.get("scrape")
    if not sc or name not in sc["after"]:
        return None
    return sc["after"][name] - sc["before"].get(name, 0.0)

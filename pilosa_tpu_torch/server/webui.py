"""Embedded browser console, served from a static asset set.

Reference: webui/index.html + webui/assets/{main.js,style.css},
compiled into the binary via statik and served at ``/`` and
``/assets/{file}`` (handler.go:15,43-44,84,132-145). Same shape here:
``server/assets/`` ships with the package (its own copy of the JAX
package's assets, byte for byte; the Python
analogue of statik embedding — package data instead of a generated Go
file), and the handler mounts ``GET /`` → index.html plus
``GET /assets/{file}``.

Feature parity with the reference console (webui/assets/main.js):
a PQL REPL targeting ``POST /index/{index}/query`` with an index
dropdown from ``/schema``, per-query wall-time + result history +
ArrowUp/ArrowDown keyboard recall, a cluster-status view over
``/status``, the server version from ``/version`` — plus a schema
browser (indexes → frames → options) the reference links out for.
"""

from __future__ import annotations

import os

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".js": "application/javascript; charset=utf-8",
    ".svg": "image/svg+xml",
    ".png": "image/png",
}


_cache: dict[str, tuple[bytes, str] | None] = {}


def asset(name: str) -> tuple[bytes, str] | None:
    """(bytes, content type) for one asset, or None when unknown;
    read once and served from memory after (the statik-embedding
    behavior this module mirrors).

    Names are single path segments only — the route pattern forbids
    ``/`` and this re-checks, so traversal cannot escape the dir."""
    if name in _cache:
        return _cache[name]
    if not name or "/" in name or "\\" in name or name.startswith("."):
        return None  # don't cache hostile names unboundedly
    path = os.path.join(_ASSET_DIR, name)
    if not os.path.isfile(path):
        return None
    ext = os.path.splitext(name)[1]
    ctype = _CONTENT_TYPES.get(ext, "application/octet-stream")
    with open(path, "rb") as f:
        got = (f.read(), ctype)
    _cache[name] = got
    return got


def page_bytes() -> bytes:
    """The console page (GET /)."""
    got = asset("index.html")
    if got is None:  # packaging error — fail loud, not blank
        raise FileNotFoundError("webui assets missing: index.html")
    return got[0]

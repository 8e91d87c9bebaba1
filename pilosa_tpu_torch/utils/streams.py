"""Small stream helpers shared by storage and the HTTP layer."""

from __future__ import annotations


class CappedReader:
    """File-like reader limited to the first n bytes.

    Two users with the same need: fragment backup streams exactly the
    size captured under lock even if the WAL grows after (tar headers
    carry a fixed size), and the WSGI request body has no EOF of its own
    (reading past Content-Length blocks on the live socket).
    """

    def __init__(self, f, n: int):
        self.f = f
        self.remaining = n

    def read(self, size: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        if size < 0 or size > self.remaining:
            size = self.remaining
        out = self.f.read(size)
        self.remaining -= len(out)
        return out

"""Injected logger threaded through Server/Holder/Fragment/Syncer/Gossip.

Reference: the Go build passes a ``LogOutput io.Writer`` down the same
chain — server/server.go:123-131 opens ``--log-path`` (stderr when
empty), holder.go:360 and fragment.go:329 expose ``logger()`` accessors,
and fragment.go:1012-1020 wraps snapshots in a duration ``track()``.
Here the equivalent is one small thread-safe Logger object with Go
``log.Printf`` semantics; components receive it as a constructor
argument and default to the silent NOP so library use stays quiet.
"""

from __future__ import annotations

import sys
import threading
import time


class Logger:
    """Thread-safe line logger. ``printf`` mirrors Go's log.Printf:
    a %-format string plus args, one timestamped line per call."""

    def __init__(self, stream=None):
        self._stream = stream          # None → silent (the NOP)
        self._owns_stream = False
        self._mu = threading.Lock()

    @classmethod
    def open(cls, path: str) -> "Logger":
        """A logger for ``--log-path``: append to ``path``, or stderr
        when the path is empty (server/server.go:123-131)."""
        if not path:
            return cls(sys.stderr)
        lg = cls(open(path, "a", encoding="utf-8"))
        lg._owns_stream = True
        return lg

    def printf(self, fmt: str, *args) -> None:
        if self._stream is None:
            return
        msg = (fmt % args) if args else fmt
        line = time.strftime("%Y/%m/%d %H:%M:%S ") + msg + "\n"
        with self._mu:
            stream = self._stream  # close() may have nulled it post-check
            if stream is None:
                return
            try:
                stream.write(line)
                stream.flush()
            except (OSError, ValueError):
                pass  # a full disk / closed stream must not kill serving

    def track(self, fmt: str, *args):
        """Context manager logging "<msg> took <dur>" on exit — the
        reference's snapshot timer (fragment.go:1012-1020)."""
        return _Track(self, (fmt % args) if args else fmt)

    def close(self) -> None:
        if self._owns_stream and self._stream is not None:
            with self._mu:
                try:
                    self._stream.close()
                except OSError:
                    pass
                self._stream = None


class _Track:
    def __init__(self, logger: Logger, msg: str):
        self.logger = logger
        self.msg = msg

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.logger.printf("%s took %.6fs", self.msg,
                           time.monotonic() - self._start)
        return False


NOP = Logger(None)

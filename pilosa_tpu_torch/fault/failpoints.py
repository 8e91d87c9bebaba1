"""Failpoints: named, deterministic fault-injection sites.

Copy of the JAX package's ``fault/failpoints.py``: production code
carries named injection points; a disarmed site costs one
module-attribute read and a None check, and an armed site injects a
scripted fault deterministically, so every chaos failure replays from
its logged seed.

The port arms the sites its own modules carry:

==================  =========================================================
``rpc.send``        cluster/client._do, before a request reaches the wire
``rpc.recv``        cluster/client._do, after the response is read
``wal.append``      storage/wal's leader flush and storage/roaring's plain
                    op writers, around every op-log write (torn-write
                    capable: writes a prefix, then fails — crash
                    mid-append)
``snapshot.write``  storage/fragment, inside the snapshot tmp-file write
``gossip.deliver``  cluster/gossip, before a received broadcast envelope
                    is handed to the server (an error drops it: the
                    envelope is lost in transit)
``mesh.dispatch``   parallel/mesh._dispatch, before each kernel launch
                    (an injected delay holds the query inside its
                    device dispatch, the watchdog's stuck_query case)
``ring.write``      obs/diskring segment appends (the tail sampler's,
                    blackbox's, history's and capture's rings;
                    torn-write capable)
``resize.stream``   server/syncer FragmentStreamer block pushes during
                    an elastic resize (torn-write capable: a PREFIX of
                    the block's positions lands on the target, then the
                    stream fails — the idempotent block re-diff must
                    converge); partition mode scopes by target host
``storage.read``    storage/fragment, before the data file is read back
                    (open) and before the scrubber re-reads it —
                    corrupt-capable: flips real bits in the on-disk
                    snapshot, so detection → quarantine → repair is
                    deterministically injectable
``tier.fault``      storage/fragment, before a cold fragment's container
                    blocks are faulted in (tier) — corrupt-capable: flips
                    real bits inside the block about to be verified, so
                    the per-block crc check at fault time catches it
``tier.fetch``      tier/manager blob-tier transfers (push and fetch) —
                    error, delay and corrupt make a failed cold fetch and
                    a torn promotion injectable; partition mode scopes by
                    direction (``push`` / ``fetch``)
==================  =========================================================

Arming an unknown site raises: a site without an injection point would
inject nothing, and a chaos test that silently injects nothing proves
nothing.

Spec grammar (one string per site), the JAX package's::

    off                        disarm
    error                      raise FailpointError every hit
    error(0.25)                ... with probability 0.25 (seeded RNG)
    enospc                     raise FailpointError carrying
                               errno.ENOSPC — a full disk at this
                               site (fault.diskfull degradation path)
    enospc(0.25)               ... with probability 0.25
    delay(50ms)                sleep 50 ms, then proceed
    delay(50ms,0.5)            ... with probability 0.5
    torn(7)                    write the first 7 bytes of the record,
                               then raise (wal.append / sites passing
                               ``data`` + ``writer``)
    corrupt                    flip ONE real bit of the site's file
                               (``writer`` at snapshot.write, ``path``
                               at storage.read) at a seeded-random
                               offset, then PROCEED — silent on-disk
                               corruption, exactly the fault the
                               integrity footer exists to catch
    corrupt(3)                 ... flip 3 bits
    partition(hostB)           raise only when the site's ``host``
                               contains "hostB" (one-way partition)
    <mode>*3                   trigger at most 3 times, then auto-disarm

Arming: ``PILOSA_FAULT_<SITE>`` environment variables (dots as
underscores: ``PILOSA_FAULT_RPC_SEND=error``) or ``POST
/debug/failpoints``. The RNG seeds from ``PILOSA_FAULT_SEED`` (logged at
first arm) so probabilistic schedules replay exactly.
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
import time
from typing import Optional

from ..obs import metrics as obs_metrics
from ..utils.config import parse_duration

# The nop-path flag every injection site checks inline:
#     if failpoints.ACTIVE is not None: failpoints.ACTIVE.hit("rpc.send")
# None whenever no failpoint is armed anywhere — the disarmed cost is
# one module-attribute read, no call, no allocation.
ACTIVE: Optional["Failpoints"] = None

SITES = ("rpc.send", "rpc.recv", "wal.append", "snapshot.write",
         "gossip.deliver", "mesh.dispatch", "ring.write",
         "resize.stream", "storage.read", "tier.fault", "tier.fetch")


def env_key(site: str) -> str:
    """The ONE site→env-variable mapping (dots as underscores):
    utils.config's load() and arm_from_env both use it, so the env
    contract cannot drift between the two arming paths."""
    return "PILOSA_FAULT_" + site.replace(".", "_").upper()

_LOG = logging.getLogger("pilosa_tpu_torch.fault")

_SPEC_RE = re.compile(
    r"^(?P<mode>[a-z]+)"
    r"(?:\((?P<args>[^)]*)\))?"
    r"(?:\*(?P<count>\d+))?$")

_MODES = ("error", "delay", "torn", "partition", "enospc", "corrupt")


class FailpointError(OSError):
    """An injected fault. Subclasses OSError deliberately: transport
    layers (http.client wrappers, the gossip loops, the device-dispatch
    fallback) already treat OSError as 'the operation failed', so an
    injection exercises exactly the recovery path a real fault would."""


class Failpoint:
    __slots__ = ("site", "mode", "arg", "pct", "remaining", "spec",
                 "hits")

    def __init__(self, site: str, mode: str, arg, pct: float,
                 remaining: Optional[int], spec: str):
        self.site = site
        self.mode = mode
        self.arg = arg
        self.pct = pct
        self.remaining = remaining  # None = unlimited triggers
        self.spec = spec
        self.hits = 0


def parse_spec(site: str, spec: str) -> Optional[Failpoint]:
    """Spec string → Failpoint; None for "off"/empty; ValueError on
    anything malformed (an unparseable injection must fail loudly —
    a chaos test that silently injects nothing proves nothing)."""
    spec = spec.strip()
    if not spec or spec == "off":
        return None
    m = _SPEC_RE.match(spec)
    if m is None or m.group("mode") not in _MODES:
        raise ValueError(f"failpoint {site}: invalid spec {spec!r}")
    mode = m.group("mode")
    raw_args = [a.strip() for a in (m.group("args") or "").split(",")
                if a.strip()]
    count = int(m.group("count")) if m.group("count") else None
    pct = 1.0
    arg = None
    if mode in ("error", "enospc"):
        if len(raw_args) > 1:
            raise ValueError(f"failpoint {site}: {mode} takes at most"
                             f" one argument")
        if raw_args:
            pct = float(raw_args[0])
    elif mode == "delay":
        if not raw_args or len(raw_args) > 2:
            raise ValueError(f"failpoint {site}: delay(duration[,p])")
        arg = parse_duration(raw_args[0])
        if len(raw_args) == 2:
            pct = float(raw_args[1])
    elif mode == "torn":
        if not raw_args or len(raw_args) > 2:
            raise ValueError(f"failpoint {site}: torn(bytes[,p])")
        arg = int(raw_args[0])
        if len(raw_args) == 2:
            pct = float(raw_args[1])
    elif mode == "corrupt":
        if len(raw_args) > 2:
            raise ValueError(f"failpoint {site}: corrupt([bits][,p])")
        arg = int(raw_args[0]) if raw_args else 1
        if arg < 1:
            raise ValueError(f"failpoint {site}: corrupt needs >=1 bit")
        if len(raw_args) == 2:
            pct = float(raw_args[1])
    elif mode == "partition":
        if not raw_args or len(raw_args) > 2:
            raise ValueError(f"failpoint {site}: partition(host[,p])")
        arg = raw_args[0]
        if len(raw_args) == 2:
            pct = float(raw_args[1])
    if not 0.0 <= pct <= 1.0:
        raise ValueError(f"failpoint {site}: probability {pct} outside"
                         f" [0, 1]")
    return Failpoint(site, mode, arg, pct, count, spec)


class Failpoints:
    """The armed-failpoint registry. One process-global instance
    (``default()``) serves every injection site; tests may build their
    own for isolation of the parsing/trigger logic."""

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            env = os.environ.get("PILOSA_FAULT_SEED", "")
            seed = int(env) if env else random.SystemRandom().randrange(
                1 << 31)
        self.seed = seed
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self._points: dict[str, Failpoint] = {}
        self._seed_logged = False

    # -- arming --------------------------------------------------------------

    def arm(self, site: str, spec: str) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown failpoint site {site!r} (sites: "
                + ", ".join(SITES) + ")")
        fp = parse_spec(site, spec)
        with self._mu:
            if fp is None:
                self._points.pop(site, None)
            else:
                self._points[site] = fp
                if not self._seed_logged:
                    self._seed_logged = True
                    # The replay contract: every chaos failure report
                    # carries the seed that reproduces its schedule.
                    _LOG.warning(
                        "failpoints armed (PILOSA_FAULT_SEED=%d to"
                        " replay this schedule)", self.seed)
        self._sync_active()

    def disarm(self, site: str) -> None:
        with self._mu:
            self._points.pop(site, None)
        self._sync_active()

    def disarm_all(self) -> None:
        with self._mu:
            self._points.clear()
        self._sync_active()

    def _sync_active(self) -> None:
        """Publish to the process-global ACTIVE hook — DEFAULT registry
        only. A private registry (unit tests isolating trigger logic)
        must neither hijack the production injection sites nor clear a
        schedule the default registry armed."""
        global ACTIVE
        with _default_mu:
            is_default = _default is self
        if not is_default:
            return
        with self._mu:
            armed = bool(self._points)
        ACTIVE = self if armed else None

    # -- the injection hook --------------------------------------------------

    def hit(self, site: str, host: Optional[str] = None,
            writer=None, data: Optional[bytes] = None,
            path: Optional[str] = None,
            span: Optional[tuple] = None) -> None:
        """Evaluate ``site``. Raises FailpointError when the armed mode
        says so; returns silently otherwise. ``host`` scopes partition
        mode; ``writer``+``data`` let torn mode emit a prefix of the
        record before failing; ``writer`` (an open file) or ``path``
        give corrupt mode the bytes to flip. ``span`` (offset, length)
        confines corrupt flips to the byte range the caller is about to
        verify, so detection is deterministic rather than a draw
        against the whole file."""
        with self._mu:
            fp = self._points.get(site)
            if fp is None:
                return
            if fp.mode == "partition" and (
                    host is None or fp.arg not in host):
                return
            if fp.pct < 1.0 and self._rng.random() >= fp.pct:
                return
            fp.hits += 1
            if fp.remaining is not None:
                fp.remaining -= 1
                if fp.remaining <= 0:
                    self._points.pop(site, None)
            mode, arg = fp.mode, fp.arg
        self._sync_active()
        obs_metrics.FAILPOINT_TRIGGERS.labels(site).inc()
        # A query that hit an armed failpoint is chaos evidence: flag
        # its context (the trace's keep decision reads the flags).
        from ..sched import context as sched_context
        ctx = sched_context.current()
        if ctx is not None:
            ctx.note_flag("failpoint")
        if mode == "delay":
            time.sleep(arg)
            return
        if mode == "torn":
            if writer is not None and data:
                writer.write(data[:max(0, min(int(arg), len(data)))])
            raise FailpointError(
                f"failpoint {site}: torn write after {arg} bytes")
        if mode == "corrupt":
            self._corrupt(site, writer=writer, path=path,
                          bits=int(arg or 1), span=span)
            return
        if mode == "enospc":
            # The two-arg OSError form sets .errno, so the catching
            # site's `err.errno == errno.ENOSPC` test sees exactly
            # what a real full disk raises.
            import errno as errno_mod
            raise FailpointError(
                errno_mod.ENOSPC,
                f"failpoint {site}: injected ENOSPC"
                " (no space left on device)")
        # error / partition
        raise FailpointError(f"failpoint {site}: injected"
                             + (f" (partition {arg})"
                                if mode == "partition" else ""))

    def _corrupt(self, site: str, writer, path: Optional[str],
                 bits: int, span: Optional[tuple] = None) -> None:
        """Flip ``bits`` real bits at seeded-random offsets of the
        site's file — silent on-disk corruption, the fault the
        storage-integrity footer (storage.integrity) exists to catch.
        Proceeds (never raises): the point is that NOTHING fails at
        the write, exactly like real bit rot. A site with no file (the
        rpc sites) proceeds untouched."""
        opened = None
        fd = None
        if writer is not None and hasattr(writer, "fileno"):
            # Snapshot writers are opened "wb" (write-only), so flips
            # reopen the file read-write by name; a nameless writer
            # (BytesIO-backed test double) falls through to its fd.
            try:
                writer.flush()
            except (OSError, ValueError):
                pass
            name = getattr(writer, "name", None)
            if isinstance(name, str) and path is None:
                path = name
            else:
                try:
                    fd = writer.fileno()
                except (OSError, ValueError):
                    fd = None
        if fd is None:
            if path is None:
                return
            try:
                opened = open(path, "r+b")
            except OSError:
                return  # nothing on disk yet: nothing to rot
            fd = opened.fileno()
        try:
            size = os.fstat(fd).st_size
            if size <= 0:
                return
            base, extent = 0, size
            if span is not None:
                base = max(0, min(int(span[0]), size - 1))
                extent = max(1, min(int(span[1]), size - base))
            with self._mu:  # seeded draws stay on the replay schedule
                flips = [(base + self._rng.randrange(extent),
                          self._rng.randrange(8))
                         for _ in range(bits)]
            for off, bit in flips:
                b = os.pread(fd, 1, off)
                if not b:
                    continue
                os.pwrite(fd, bytes([b[0] ^ (1 << bit)]), off)
                _LOG.warning(
                    "failpoint %s: corrupt flipped bit %d of byte %d"
                    " (file size %d)", site, bit, off, size)
        finally:
            if opened is not None:
                opened.close()

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            points = {
                site: {"spec": fp.spec, "hits": fp.hits,
                       "remaining": fp.remaining}
                for site, fp in self._points.items()}
        return {"seed": self.seed, "sites": list(SITES),
                "armed": points}


_default: Optional[Failpoints] = None
_default_mu = threading.Lock()


def default() -> Failpoints:
    global _default
    with _default_mu:
        if _default is None:
            _default = Failpoints()
        return _default


def seed_default(seed: int) -> None:
    """Fix the default registry's RNG seed (the [fault] seed knob).
    Rebuilds the registry, so call before arming anything."""
    global _default, ACTIVE
    with _default_mu:
        _default = Failpoints(seed=seed)
    ACTIVE = None  # the old registry's schedule (if any) is gone


def arm(site: str, spec: str) -> None:
    default().arm(site, spec)


def disarm_all() -> None:
    if _default is not None:
        _default.disarm_all()


def arm_from_env(env=None) -> list[str]:
    """Arm failpoints from ``PILOSA_FAULT_<SITE>`` variables (dots as
    underscores); returns the sites armed. Reserved PILOSA_FAULT_*
    names (SEED) are not sites, so they are never read here."""
    env = os.environ if env is None else env
    armed = []
    for site in SITES:
        val = env.get(env_key(site))
        if val is None:
            continue
        arm(site, val)
        if val.strip() not in ("", "off"):
            armed.append(site)
    return armed


class injected:
    """Context manager for tests: arm on enter, disarm on exit.

    >>> with injected("rpc.send", "error"):
    ...     ...
    """

    def __init__(self, site: str, spec: str):
        self.site = site
        self.spec = spec

    def __enter__(self):
        arm(self.site, self.spec)
        return default()

    def __exit__(self, exc_type, exc, tb):
        default().disarm(self.site)
        return False

"""Sentinel errors and name/label validation.

Reference: pilosa.go:25-122 (sentinel errors, name/label regexes, time format).
"""

import re


class PilosaError(Exception):
    """Base class for all framework errors."""


class IndexExistsError(PilosaError):
    pass


class IndexNotFoundError(PilosaError):
    pass


class FrameExistsError(PilosaError):
    pass


class FrameNotFoundError(PilosaError):
    pass


class InverseNotEnabledError(PilosaError):
    pass


class FragmentNotFoundError(PilosaError):
    pass


class QueryRequiredError(PilosaError):
    pass


class SliceUnavailableError(PilosaError):
    """Raised when a slice cannot be mapped to any available node
    (reference: executor.go:1239)."""


class QueryDeadlineError(PilosaError):
    """Raised when a query's deadline budget is exhausted — by the
    executor's fan-out loops, the device dispatch layer, or the
    cluster client's socket/retry machinery (sched.context). Maps to
    HTTP 504; never triggers replica re-mapping (the query is dead,
    not the node)."""


class QueryCancelledError(PilosaError):
    """Raised when a query is cancelled through the lifecycle API
    (DELETE /debug/queries/{id}, propagated cluster-wide). Maps to
    HTTP 409; never triggers replica re-mapping."""


class QueryKilledError(QueryCancelledError):
    """A query killed by the per-tenant slow-query cost policy
    (sched.tenants): its ledger crossed a configured ceiling at a
    stage boundary. Subclasses QueryCancelledError so every
    cancellation-aware layer (executor legs, admission waits, mesh
    dispatch) treats it as a cancel; the HTTP layer maps it to a
    DISTINCT status (402 + ``X-Pilosa-Killed-By: cost-policy``) so
    clients can tell a budget kill from an operator cancel."""


# Name/label rules (reference: pilosa.go:50-53).
_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,64}$")
_LABEL_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]{0,64}$")

# TimeFormat is the canonical PQL timestamp layout
# (reference: pilosa.go:106, Go layout "2006-01-02T15:04").
TIME_FORMAT = "%Y-%m-%dT%H:%M"


def validate_name(name: str) -> None:
    """Validate an index/frame/view name (reference: pilosa.go:109-114)."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise PilosaError(f"invalid name: {name!r}")


def validate_label(label: str) -> None:
    """Validate a row/column label (reference: pilosa.go:116-122)."""
    if not isinstance(label, str) or not _LABEL_RE.match(label):
        raise PilosaError(f"invalid label: {label!r}")

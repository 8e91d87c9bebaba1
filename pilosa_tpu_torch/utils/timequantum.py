"""Time quantum engine: time-view naming and range covers.

Reference: time.go. A frame with a time quantum writes each timestamped bit
to one extra view per quantum unit (Y/M/D/H, e.g. ``standard_2017``,
``standard_201701``); a Range query unions the *minimal* set of views
covering [start, end), computed by walking up from fine to coarse units and
back down (time.go:95-167 — semantics preserved exactly, including the
GTE-boundary rules of nextYearGTE/nextMonthGTE/nextDayGTE).
"""

from __future__ import annotations

import datetime as dt

from ..errors import PilosaError

VALID_QUANTUMS = frozenset(
    ["Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""])


def parse_time_quantum(v: str) -> str:
    q = v.upper()
    if q not in VALID_QUANTUMS:
        raise PilosaError(f"invalid time quantum: {v!r}")
    return q


_UNIT_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def view_by_time_unit(name: str, t: dt.datetime, unit: str) -> str:
    fmt = _UNIT_FMT.get(unit)
    if fmt is None:
        return ""
    return f"{name}_{t.strftime(fmt)}"


def views_by_time(name: str, t: dt.datetime, quantum: str) -> list[str]:
    """All per-unit view names a timestamped bit lands in (time.go:81-92)."""
    out = []
    for unit in quantum:
        v = view_by_time_unit(name, t, unit)
        if v:
            out.append(v)
    return out


def _add_months(t: dt.datetime, n: int) -> dt.datetime:
    # Matches Go's AddDate normalization: overflowing days roll forward
    # (Jan 30 + 1mo = "Feb 30" → Mar 1/2). The GTE probes call this from
    # mid-month dates, so the overflow case is reachable.
    month0 = t.month - 1 + n
    year = t.year + month0 // 12
    month = month0 % 12 + 1
    base = dt.datetime(year, month, 1, t.hour, t.minute, t.second,
                       t.microsecond)
    return base + dt.timedelta(days=t.day - 1)


def _add_years(t: dt.datetime, n: int) -> dt.datetime:
    # Feb 29 + 1y = "Feb 29 non-leap" → Mar 1, per Go AddDate normalization.
    return _add_months(t, 12 * n)


def _next_year_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _add_years(t, 1)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _add_months(t, 1)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = t + dt.timedelta(days=1)
    return ((nxt.year, nxt.month, nxt.day)
            == (end.year, end.month, end.day)) or end > nxt


def views_by_time_range(name: str, start: dt.datetime, end: dt.datetime,
                        quantum: str) -> list[str]:
    """Minimal view cover of [start, end) (time.go:95-167)."""
    t = start
    has_y, has_m = "Y" in quantum, "M" in quantum
    has_d, has_h = "D" in quantum, "H" in quantum
    results: list[str] = []

    # Walk up from the smallest units to the largest.
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_day_gte(t, end):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += dt.timedelta(hours=1)
                    continue
            if has_d:
                if not _next_month_gte(t, end):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += dt.timedelta(days=1)
                    continue
            if has_m:
                if not _next_year_gte(t, end):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_months(t, 1)
                    continue
            break

    # Walk back down from the largest units to the smallest.
    while t < end:
        if has_y and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_years(t, 1)
        elif has_m and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_months(t, 1)
        elif has_d and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t += dt.timedelta(days=1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t += dt.timedelta(hours=1)
        else:
            break

    return results

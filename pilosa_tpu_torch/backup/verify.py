"""Restore verification: replay a captured workload, compare digests.

The acceptance test for a restore is not "the files are back" — it is
"the cluster gives the same answers". This module replays the read
records of a captured workload (obs.capture / obs.replay, the
shadow-diff machinery) against the restored cluster and compares each
response's result digest against the digest recorded at capture time
on the ORIGINAL cluster. Zero mismatches = the restore provably
serves the same answers the source did.

Only reads are replayed (writes would mutate the restored state), and
only records that captured a digest participate — a record without
one can't be checked, so it is counted but never scored.
"""

from __future__ import annotations

from typing import Optional

from ..obs import replay as replay_mod
from ..utils import logger as logger_mod

# Queries that read; everything else (SetBit/ClearBit/SetFieldValue…)
# would mutate the restored cluster mid-verification.
READ_CALLS = ("Bitmap", "Union", "Intersect", "Difference", "Count",
              "TopN", "Range", "Sum", "Min", "Max")


def is_read(rec: dict) -> bool:
    pql = (rec.get("pql") or "").lstrip()
    return pql.startswith(READ_CALLS)


def verify_restore(host: str, records: list[dict],
                   limit: Optional[int] = None,
                   logger=None) -> dict:
    """Replay each comparable read record against ``host``; returns
    ``{"compared", "matches", "mismatches", "skipped", "errors",
    "mismatchSamples"}``. ``mismatches == 0`` over a non-empty
    ``compared`` set is the restore-verified verdict."""
    logger = logger or logger_mod.NOP
    compared = matches = skipped = errors = 0
    samples: list[dict] = []
    for rec in records:
        if limit is not None and compared >= limit:
            break
        if not is_read(rec) or not rec.get("digest"):
            skipped += 1
            continue
        out = replay_mod._issue(host, rec)
        if out["status"] != rec.get("status", 200) \
                or not out["digest"]:
            errors += 1
            continue
        compared += 1
        if out["digest"] == rec["digest"]:
            matches += 1
        elif len(samples) < 8:
            samples.append({"pql": rec.get("pql"),
                            "index": rec.get("index"),
                            "want": rec["digest"],
                            "got": out["digest"]})
    mismatches = compared - matches
    logger.printf("restore verify: %d compared, %d mismatches,"
                  " %d skipped, %d errors", compared, mismatches,
                  skipped, errors)
    return {"compared": compared, "matches": matches,
            "mismatches": mismatches, "skipped": skipped,
            "errors": errors, "mismatchSamples": samples}

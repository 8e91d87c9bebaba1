#!/bin/bash
# Whole-script A/B of chip_smoke.py on one card: each tree named on the
# command line runs the script in turn (e.g. parent, change), from its
# own unpacked copy with HOME and TMPDIR inside it, every output line
# stamped with the wall clock; then each run's seconds by phase (from
# the stamp of one phase line to the next) and in total are printed.
#
#   git archive <parent> | tar -x -C archive_check/parent
#   git archive $(git write-tree) | tar -x -C archive_check/change
#   bash chip_smoke_ab.sh OUTDIR parent=archive_check/parent \
#       change=archive_check/change
#
# OUTDIR gets <label>.out for each run.
set -u
out=$(realpath -m "$1")
shift
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in "$@"; do
  label=${spec%%=*}
  dir=$(realpath "${spec#*=}")
  (
    cd "$dir" && mkdir -p h t
    HOME=$PWD/h TMPDIR=$PWD/t timeout 1250 python3 -u chip_smoke.py \
        2>/dev/null \
      | while IFS= read -r line; do
          printf '%s %s\n' "$(date +%s.%N)" "$line"
        done > "$out/$label.out"
    echo "$label rc=${PIPESTATUS[0]}"
  )
done
for spec in "$@"; do
  python3 - "$out/${spec%%=*}.out" "${spec%%=*}" <<'PY'
import json
import sys

stamped = [ln.rstrip("\n").split(" ", 1) for ln in open(sys.argv[1])]
t0 = prev = float(stamped[0][0])
phases = []
for ts, line in stamped:
    if line.startswith('{"phase"'):
        phases.append((json.loads(line)["phase"], round(float(ts) - prev, 1)))
        prev = float(ts)
print(sys.argv[2], "total", round(float(stamped[-1][0]) - t0, 1), phases)
PY
done

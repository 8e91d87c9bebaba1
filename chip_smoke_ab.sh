#!/bin/bash
# Whole-script A/B of chip_smoke.py on one card: each tree named on the
# command line runs the script in turn (e.g. parent, change), from its
# own unpacked copy with HOME and TMPDIR inside it, every output line
# stamped with the wall clock; then each run's total seconds and, for
# each phase, the seconds from the script's start to its line (from the
# script's standard error: phases 11-15 run beside phases 2-10, so a
# phase's end is read from its own process's clock) are printed.
#
#   git archive <parent> | tar -x -C archive_check/parent
#   git archive $(git write-tree) | tar -x -C archive_check/change
#   bash chip_smoke_ab.sh OUTDIR parent=archive_check/parent \
#       change=archive_check/change
#
# OUTDIR gets <label>.out and <label>.err for each run.
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
        2>"$out/$label.err" \
      | while IFS= read -r line; do
          printf '%s %s\n' "$(date +%s.%N)" "$line"
        done > "$out/$label.out"
    echo "$label rc=${PIPESTATUS[0]}"
  )
done
for spec in "$@"; do
  python3 - "$out/${spec%%=*}" "${spec%%=*}" <<'PY'
import re
import sys

stamps = [float(ln.split(" ", 1)[0]) for ln in open(sys.argv[1] + ".out")]
ends = [(m.group(1), float(m.group(2))) for m in
        (re.match(r"chip_smoke: (\S+) line at ([0-9.]+) s", ln)
         for ln in open(sys.argv[1] + ".err")) if m]
print(sys.argv[2], "total", round(stamps[-1] - stamps[0], 1),
      sorted(ends, key=lambda e: e[1]))
PY
done

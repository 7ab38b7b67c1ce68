#!/bin/bash
# Run chip_smoke.py in each of several checkouts, one after the other on
# the same card, to compare their phases' spans within one machine. Each
# output line is stamped with the seconds since that run began; the log
# goes to OUT/NAME.log (its exit code as the last line) and the run's
# build/chip_smoke.json to OUT/NAME.json. An older checkout whose phases
# carry no ``at_s`` is timed the same way.
#
#   bash smoke_pair.sh OUT NAME=DIR [NAME=DIR ...] [-- chip_smoke.py args]
#
# e.g. parent, change, change, parent, each a full run:
#   bash smoke_pair.sh chiprun_out p1=build/parent c1=build/final \
#       c2=build/final p2=build/parent
set -o pipefail
out=$(mkdir -p "$1" && cd "$1" && pwd)
shift
runs=()
while [ $# -gt 0 ] && [ "$1" != "--" ]; do runs+=("$1"); shift; done
[ "$1" = "--" ] && shift
stamp='import sys, time
t0 = time.time()
for line in sys.stdin:
    sys.stdout.write("%.3f %s" % (time.time() - t0, line))
    sys.stdout.flush()'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for run in "${runs[@]}"; do
    name=${run%%=*}
    dir=${run#*=}
    (
        cd "$dir" || exit 1
        timeout -k 10 1200 python3 -u chip_smoke.py "$@" 2>&1 \
            | python3 -u -c "$stamp" > "$out/$name.log"
        echo "rc=${PIPESTATUS[0]}" >> "$out/$name.log"
        cp build/chip_smoke.json "$out/$name.json" 2>/dev/null
    )
    tail -n 2 "$out/$name.log" | cut -c1-300
done

#!/bin/sh
# The runs that set a cell's bounds: two sets of the same seeds, one
# after the other in one call, then traced runs on further seeds.
#   sh hicbench/sets.sh <workload> <seconds> "<seeds>" "<traced seeds>" [dir]
# One line a run: set, seed, exit code, the result's last line; each
# run's output in <dir> (default build/hicbench/sets).
set -u
w=$1; secs=$2; seeds=$3; traced=$4; out=${5:-build/hicbench/sets}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for set in 1 2; do
  for s in $seeds; do
    python3 hicbench/run.py --workload "$w" --seed "$s" --seconds "$secs" \
      --trace 0 > $out/$w.$set.$s.out 2> $out/$w.$set.$s.err
    echo "set=$set seed=$s rc=$? $(tail -n 1 $out/$w.$set.$s.out)"
  done
done
for s in $traced; do
  t0=$(date +%s)
  python3 hicbench/run.py --workload "$w" --seed "$s" --seconds "$secs" \
    --trace 1 > $out/$w.trace.$s.out 2> $out/$w.trace.$s.err
  echo "trace seed=$s rc=$? wall=$(( $(date +%s) - t0 )) $(tail -n 1 $out/$w.trace.$s.out)"
done

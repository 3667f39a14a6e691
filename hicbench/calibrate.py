"""Readings for the limits of a cell's check, on the chip at the cell's
own size: for each seed, one unit of the program and the plain
reference on the same inputs, the numbers the check compares; with
``--control``, the control too (the reference at the precision below
the configuration's, put in the program's place).

    python3 hicbench/calibrate.py --workload xtropicalis.cluster \\
        --seeds 11,12,13 [--control]

One JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control', action='store_true')
    args = ap.parse_args(argv)
    import torch

    from hicbench import genome as gen
    from hicbench import harness
    from hicbench.stages import STAGES
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    wl = next(w for w in bench['workloads'] if w['name'] == args.workload)
    cfg = harness.load('configs', wl['config'])
    mix = harness.load('traffic', wl['traffic'])
    dev = torch.device('cuda')
    warm = False
    for seed in [int(s) for s in args.seeds.split(',')]:
        stage = STAGES[mix['stage']](cfg, mix, gen.make(cfg, seed), dev,
                                     seed)
        if not warm:
            stage.warmup()
            warm = True
        t0 = time.perf_counter()
        out = stage.unit(0)
        t1 = time.perf_counter()
        ref = stage.reference()
        t2 = time.perf_counter()
        line = {'seed': seed, 'unit_s': t1 - t0, 'reference_s': t2 - t1,
                'program': stage.compare(out, ref)}
        if args.control:
            line['control'] = stage.compare(stage.control([out]), ref)
            line['control_s'] = time.perf_counter() - t2
        print(json.dumps(line), flush=True)
        del out, ref, stage
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Readings for the limits of a cell's check, on the chip at the cell's
own size: for each seed, one unit of the program and the plain
reference on the same inputs, the numbers the check compares; with
``--control``, the control too (the reference at the precision below
the configuration's, put in the program's place); with ``--faults``,
one more unit for each fault that ``tests/test_hicbench_run.py`` and
``tests/test_hicbench_cluster_sets.py`` plant in this cell's timed path
(not on the card's route alone).

    python3 hicbench/calibrate.py --workload xtropicalis.cluster \\
        --seeds 11,12,13 [--control] [--faults]

One JSON line a seed: {"seed", "program": {...}, "control": {...},
"faults": {fault: {...}}}.
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
    ap.add_argument('--faults', action='store_true')
    args = ap.parse_args(argv)
    import torch

    from hicbench import genome as gen
    from hicbench import harness
    from hicbench import stages
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    wl = next(w for w in bench['workloads'] if w['name'] == args.workload)
    cfg = harness.load('configs', wl['config'])
    mix = harness.load('traffic', wl['traffic'])
    dev = torch.device('cuda')
    warm = False
    for seed in [int(s) for s in args.seeds.split(',')]:
        stage = stages.load(mix['stage']).Stage(cfg, mix, gen.make(cfg, seed),
                                                dev, seed)
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
        if args.faults:
            line['faults'] = {what: stage.compare(broken(stage), ref)
                              for what, broken in faults(args.workload)}
        print(json.dumps(line), flush=True)
        del out, ref, stage
        torch.cuda.empty_cache()
    return 0


def faults(workload):
    """(what, run) of each fault the tests plant in ``workload``'s timed
    path off the card's route: ``run(stage)`` is one unit with it."""
    sys.path.insert(0, os.path.join(ROOT, 'hicbench', 'tests'))
    import test_hicbench_cluster_sets as s
    import test_hicbench_run as t

    def planted(module, attr, make):
        def run(stage):
            orig = getattr(module, attr)
            setattr(module, attr, make(orig))
            try:
                return stage.unit(0)
            finally:
                setattr(module, attr, orig)
        return run
    return [(what, planted(module, attr, make))
            for w, what, module, attr, make, device in t.faults() + s.faults()
            if w == workload and device == 'cpu']


if __name__ == '__main__':
    sys.exit(main())

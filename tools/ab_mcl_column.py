#!/usr/bin/env python3
"""The dense MCL column kernel of two checkouts, in turns on one card.

    python3 tools/ab_mcl_column.py A_DIR B_DIR [--shapes 6x8000,1x19999]
        [--reps 10]

For each shape BxN (B matrices of n fragments), in the order ABBA, each
checkout runs in a process of its own that imports only that checkout
and this directory's kernelkit.py: it builds its `mcl_column` kernel,
makes one later MCL iteration of a seeded block matrix (the iterate
after two iterations and its expansion, both made with the plain
version, so that both checkouts time the same input), checks its
kernel against the plain version and
times the kernel with the statistic (old given) and without it, with
CUDA events. Each turn prints one JSON line; the last line holds every
turn's ms by shape and checkout beside the bound. Exits non-zero when a
turn fails or a kernel disagrees with its plain version.
"""

import argparse
import json
import os
import subprocess
import sys

ORDER = 'ABBA'
TOOLS = os.path.dirname(os.path.abspath(__file__))

TURN = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[5])
import kernelkit as kit
from haphic_tpu_torch.cluster import mcl as tmcl
from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels import mcl_column as kmc
B, n, reps = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
pruning, dev = 1e-4, torch.device('cuda')
kbuild.build(['mcl_column'])
infl = torch.as_tensor(np.linspace(1.1, 1.6, B, dtype=np.float32),
                       device=dev)
m = kit.mcl_column_iterate(0, B, n, infl, pruning, 2, dev)
e = tmcl._matpower(m, 2)
got, stat = kmc.mcl_column(e, infl, pruning, old=m)
want, want_stat = kmc.mcl_column_plain(e, infl, pruning, old=m)
cmp = kit.mcl_column_compare(got, want, kmc._inflate(e, infl.view(-1, 1, 1)),
                             pruning)
del got, want
ms = kit.time_ms(lambda: kmc.mcl_column(e, infl, pruning, old=m), reps)
ms_no_old = kit.time_ms(lambda: kmc.mcl_column(e, infl, pruning), reps)
print(json.dumps(dict(B=B, n=n, ms=ms, ms_no_old=ms_no_old,
                      bound_ms=kit.mcl_column_bound_ms(B, n, True)[0],
                      bound_ms_no_old=kit.mcl_column_bound_ms(B, n, False)[0],
                      stat_max_abs_err=float((stat - want_stat).abs().max()),
                      nvidia_smi=kit.nvidia_smi(), **cmp)))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('a_dir')
    ap.add_argument('b_dir')
    ap.add_argument('--shapes', default='6x8000,1x19999')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    dirs = {'A': os.path.abspath(args.a_dir), 'B': os.path.abspath(args.b_dir)}
    summary, ok = {}, True
    for shape in args.shapes.split(','):
        B, n = shape.split('x')
        for turn, tree in enumerate(ORDER):
            proc = subprocess.run(
                [sys.executable, '-c', TURN, dirs[tree], B, n,
                 str(args.reps), TOOLS], capture_output=True, text=True,
                cwd=dirs[tree])
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                print(json.dumps({'shape': shape, 'turn': turn,
                                  'tree': tree, 'failed': proc.returncode}),
                      flush=True)
                ok = False
                continue
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(line, shape=shape, turn=turn, tree=tree)),
                  flush=True)
            ok = ok and line['outside_tol'] == 0 and \
                line['kept_differ'] == 0 and line['argmax_differ'] == 0 \
                and line['stat_max_abs_err'] <= 1e-7
            row = summary.setdefault(shape, {
                'bound_ms': line['bound_ms'],
                'bound_ms_no_old': line['bound_ms_no_old'],
                'nvidia_smi': line['nvidia_smi']})
            row.setdefault(tree, []).append(
                {'ms': line['ms'], 'ms_no_old': line['ms_no_old']})
    print(json.dumps({'order': ORDER, 'by_shape': summary}), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())

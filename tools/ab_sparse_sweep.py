#!/usr/bin/env python3
"""A whole sparse MCL sweep on the card, with the convergence statistic's
kernel and with its plain version, or of two checkouts, in turns.

    python3 tools/ab_sparse_sweep.py [--order ABBAABBA]
    python3 tools/ab_sparse_sweep.py A_DIR B_DIR [--order ABBA]

Runs chip_smoke.py's `sparse_pipeline` phase once (the 480 Mb /
6,000,000-pair simulated genome, n = 24,000, the pipeline on the card)
to take the arguments the pipeline gave run_mcl_sparse, then runs that
sweep again in the given order: A with col_allclose's kernel, as the
pipeline runs it, B with its plain version (kernelkit.py's
col_allclose_plain_stat in the engine's place).
Every sweep step is timed between two syncs with the card. Each sweep
prints one JSON line: the statistic, its turn, sweep_s, the steps' ms
(sum, p50, p99, max, and the count and sum by K), the kernel's launches,
the iterations per inflation and the K of each shrink.

With two checkouts, B's chip_smoke.py runs the pipeline once in a
process of its own and keeps the sweep's arguments; then each turn is a
process that imports one checkout's package only and runs that sweep
with the checkout's statistic kernel (A and B as the order says), so
that the parent's and the change's steps by K and the statistic's
launches stand side by side; each turn also times the statistic of the
sweep's first step as the sweep takes it, once over all of the step's
columns (tools/ab_rescore.py's measure: ms by CUDA events, device us and
kernels by torch.profiler, and a hash of its result). Exits non-zero
when CUDA is unavailable, when a turn fails, or when two sweeps differ
in iterations or shrinks.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

import kernelkit as kit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep(torch, sp, kca, call, plain: bool) -> dict:
    """run_mcl_sparse on the pipeline's arguments, every step timed."""
    steps = []
    step = sp._sweep_step

    def timed(idx, *rest, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(idx, *rest, **kw)
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, int(idx.shape[2])))
        return out

    sp._sweep_step = timed
    kca.col_allclose.launches = 0
    try:
        with mock.patch.object(sp, 'col_allclose',
                               kit.col_allclose_plain_stat) if plain \
                else contextlib.nullcontext():
            res = sp.run_mcl_sparse(*call['args'], **call['kw'])
    finally:
        sp._sweep_step = step
    ms = np.array([t for t, _ in steps])
    by_K = {}
    for t, K in steps:
        c, s = by_K.get(K, (0, 0.0))
        by_K[K] = (c + 1, s + t)
    return {'statistic': 'plain' if plain else 'kernel',
            'sweep_s': res.sweep_s, 'steps': len(steps),
            'step_ms_sum': float(ms.sum()),
            'step_ms_p50': float(np.percentile(ms, 50)),
            'step_ms_p99': float(np.percentile(ms, 99)),
            'step_ms_max': float(ms.max()),
            'steps_by_K': {str(K): {'steps': c, 'ms': s}
                           for K, (c, s) in sorted(by_K.items())},
            'launches': kca.col_allclose.launches,
            'n_iters': res.n_iters.tolist(), 'k_steps': res.k_steps}


RECORD = r'''
import os, pickle, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from haphic_tpu_torch import cli
from haphic_tpu_torch.cluster import sparse_mcl as sp
from haphic_tpu_torch.cluster.sweep import SPARSE_MIN_N
from haphic_tpu_torch.kernels import build as kbuild
cs.WORK = sys.argv[2]
cs.phase_env(torch, kbuild)
call = []
with cs._first_call(sp, 'run_mcl_sparse', call):
    cs.phase_sparse_pipeline(torch, cli, sp, SPARSE_MIN_N)
call[0].pop('result')
with open(os.path.join(sys.argv[2], 'call.pkl'), 'wb') as f:
    pickle.dump(call[0], f)
'''

TURN = r'''
import json, os, pickle, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[3])
import ab_rescore
import ab_sparse_sweep as ab
import kernelkit as kit
from haphic_tpu_torch.cluster import sparse_mcl as sp
from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels import col_allclose as kca
from haphic_tpu_torch.kernels import sparse_column as kcol
kbuild.build()
with open(os.path.join(sys.argv[2], 'call.pkl'), 'rb') as f:
    call = pickle.load(f)
first, step = [], sp._sweep_step


def recording(*args, **kw):
    if not first:       # the host loop updates `active` in place
        first.append(args[:3] + (args[3].copy(),) + args[4:])
    return step(*args, **kw)


sp._sweep_step = recording
try:
    out = ab.sweep(torch, sp, kca, call, False)
finally:
    sp._sweep_step = step
# the statistic of the sweep's first step, once over all of the columns,
# as the sweep takes it
si, sv, f, active, n, K, chunk, pruning, expansion = first[0]
sel = torch.as_tensor(np.flatnonzero(active), device=si.device)
A_i, A_v, fa = si[sel], sv[sel], f[sel]
new = kit.step_columns(kcol.sparse_column, A_i, A_v, fa, n, K, chunk,
                       pruning, expansion)
flag = torch.zeros(1, dtype=torch.int32, device=si.device)


def stat():
    return kca.col_allclose(A_i, A_v, *new, n, bad=flag)


out['statistic_a_step'] = dict(
    ab_rescore.measure(torch, stat, 20), K=int(K), columns=int(A_i.shape[1]),
    B=int(A_i.shape[0]), sha=ab_rescore.digest(torch, stat()),
    flag=int(flag))
print(json.dumps(out), flush=True)
'''


def child(code: str, tree: str, *argv: str) -> list:
    out = subprocess.run([sys.executable, '-c', code, tree] + list(argv),
                         cwd=tree, stdout=subprocess.PIPE, text=True)
    if out.returncode != 0:
        raise SystemExit('ab_sparse_sweep: {} exited {}'.format(
            tree, out.returncode))
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{')]


def two_checkouts(trees: dict, order: str) -> int:
    """The sweep of B's pipeline run by each checkout in turns."""
    work = os.path.join(trees['B'], 'build', 'ab_sparse_sweep')
    os.makedirs(work, exist_ok=True)
    child(RECORD, trees['B'], work)
    first = None
    for turn, label in enumerate(order):
        (rec,) = child(TURN, trees[label], work,
                       os.path.dirname(os.path.abspath(__file__)))
        rec = dict(checkout=label, dir=trees[label], turn=turn, **rec)
        print(json.dumps(rec), flush=True)
        first = first or rec
        if (rec['n_iters'], rec['k_steps']) != (first['n_iters'],
                                                 first['k_steps']):
            sys.stderr.write('ab_sparse_sweep: turn {} differs from turn 0 '
                             'in iterations or shrinks\n'.format(turn))
            return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('trees', nargs='*', metavar='DIR',
                    help='A_DIR B_DIR: two checkouts in turns')
    ap.add_argument('--order', default=None,
                    help='one tree: A the kernel, B the plain statistic '
                    '(default ABBAABBA); two trees: A and B (default ABBA)')
    args = ap.parse_args(argv)
    if len(args.trees) not in (0, 2):
        ap.error('give no checkout or two')
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('ab_sparse_sweep: CUDA is not available\n')
        return 1
    if args.trees:
        return two_checkouts(
            dict(zip('AB', (os.path.abspath(t) for t in args.trees))),
            args.order or 'ABBA')
    args.order = args.order or 'ABBAABBA'
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from haphic_tpu_torch import cli
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.cluster.sweep import SPARSE_MIN_N
    from haphic_tpu_torch.kernels import build as kbuild
    from haphic_tpu_torch.kernels import col_allclose as kca
    cs.WORK = os.path.join(REPO, 'build', 'ab_sparse_sweep')
    os.makedirs(cs.WORK, exist_ok=True)
    cs.phase_env(torch, kbuild)
    call = []
    with cs._first_call(sp, 'run_mcl_sparse', call):
        cs.phase_sparse_pipeline(torch, cli, sp, SPARSE_MIN_N)
    call[0].pop('result')
    first = None
    for turn, which in enumerate(args.order):
        rec = dict(turn=turn, **sweep(torch, sp, kca, call[0], which == 'B'))
        print(json.dumps(rec), flush=True)
        first = first or rec
        if (rec['n_iters'], rec['k_steps']) != (first['n_iters'],
                                                 first['k_steps']):
            sys.stderr.write('ab_sparse_sweep: turn {} differs from turn 0 '
                             'in iterations or shrinks\n'.format(turn))
            return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())

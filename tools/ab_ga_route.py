#!/usr/bin/env python3
"""The GA of two checkouts on the pipelines' own groups, in turns on one
card, on both of its routes.

    python3 tools/ab_ga_route.py A_DIR B_DIR [--order ABBA]

First B's chip_smoke.py runs its dense and its sparse pipeline (the
160 Mb / 2,000,000-pair genome, and the 24-chromosome one the sparse
MCL engine clusters) and keeps the arguments of each one's
`optimize_tours` call. Then, in the order ABBA (or ``--order``), each
checkout runs that call on the card again in a process of its own that
imports only that checkout: once on the delta route (the default) and
once with HAPHIC_GA_NO_DELTA=1 (every generation scored in full by the
score kernel). Each turn prints one JSON line: per pipeline and route,
the GA's seconds and peak card memory, the launches of the GA's kernels
(the rescoring kernel's where the checkout has it), and a hash of the
results (orders, orientations, scores), so that the two checkouts'
outputs can be compared; then the same call once more under
torch.profiler: its wall, device busy ms, idle share, device operations
and host syncs (cudaStreamSynchronize, cudaEventSynchronize,
cudaMemcpy: the calls that wait for the card). Each turn then times one rescoring call
(`rescore`, the checkout's rescore_population kernel) in each mode at
the dense pipeline's largest GA batch, on that batch's own records and
a seeded population (tools/ab_rescore.py's measure: ms by CUDA events,
device us and kernels a call by torch.profiler, host us a call, and a
hash of the outputs), so that the two kernels are timed side by side in
ABBA turns. Last, B's process prints one line that times, at the
dense pipeline's largest GA batch, the batch's score as one kernel
launch against one launch per group, and the (G, P, R) contribution
sum three ways (one f32 sum, one f32 sum per group, one f64 sum rounded
once), with the rows of groups 2-4 whose sum changes when those groups
are summed alone. Exits non-zero when a run fails.
"""

import json
import os
import subprocess
import sys

ORDER = 'ABBA'
PIPELINES = ('dense', 'sparse')

RECORD = r'''
import os, pickle, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from haphic_tpu_torch import cli
from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.order import optimize as topt
cs.WORK = sys.argv[2]
cs.phase_env(torch, kbuild)
for name, sim, engine in (('dense', cs.SIM, 'dense'),
                          ('sparse', cs.SPARSE_SIM, 'sparse')):
    keep = []
    with cs._first_call(topt, 'optimize_tours', keep):
        cs._drive_pipeline(torch, cli, sim, name + '_sim', name + '_out',
                           engine)
    kw = dict(keep[0]['kw'])
    if kw.get('mesh', 0) is None:
        kw.pop('mesh')
    with open(os.path.join(sys.argv[2], name + '.pkl'), 'wb') as f:
        pickle.dump((keep[0]['args'], kw), f)
'''

TURN = r'''
import hashlib, json, os, pickle, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[4])
import ab_rescore as ab
from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels import delta as kdelta
from haphic_tpu_torch.kernels import score as kscore
from haphic_tpu_torch.order import optimize as topt
try:                        # a checkout from before the rescoring kernel
    from haphic_tpu_torch.kernels import rescore as krs
except ImportError:
    krs = None
kbuild.build()


def profiled(fn):
    """Wall ms of fn under torch.profiler, the device's busy ms (the
    union of its kernels and copies), the idle share of the wall, the
    device operations and the host syncs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, syncs = [], 0
    for e in prof.events():
        if getattr(e.device_type, 'name', '') == 'CUDA':
            dev.append((e.time_range.start, e.time_range.end))
        elif e.name in ('cudaStreamSynchronize', 'cudaEventSynchronize',
                        'cudaMemcpy'):
            syncs += 1
    dev.sort()
    busy, end = 0.0, None
    for s, e in dev:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {'wall_ms': wall_us / 1e3, 'device_busy_ms': busy / 1e3,
            'idle_share': 1.0 - busy / wall_us, 'device_ops': len(dev),
            'host_syncs': syncs}


calls = {}
for name in sys.argv[3].split(','):
    with open(os.path.join(sys.argv[2], name + '.pkl'), 'rb') as f:
        calls[name] = pickle.load(f)
args, kw = calls['dense']
# warm-up: the CUDA context, the kernels' first loads
topt.optimize_tours([p for p in args[0] if p.k > 1][:1],
                    **dict(kw, ngen=10, hot_starts=None))
out = {}
for name, (args, kw) in calls.items():
    for route, flag in (('delta', ''), ('full', '1')):
        os.environ['HAPHIC_GA_NO_DELTA'] = flag
        kscore.score_population.launches = 0
        kdelta.delta_generation.launches = 0
        if krs is not None:
            krs.rescore.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = topt.optimize_tours(*args, **kw)
        torch.cuda.synchronize()
        secs = time.time() - t0
        h = hashlib.sha256()
        for r in res:
            for x in (r.order, r.ori, np.float32(r.score)):
                h.update(np.ascontiguousarray(x).tobytes())
        out[name + '_' + route] = {
            'ga_s': secs, 'score_launches': kscore.score_population.launches,
            'delta_launches': kdelta.delta_generation.launches,
            'rescore_launches': None if krs is None else krs.rescore.launches,
            'max_memory_allocated': torch.cuda.max_memory_allocated(),
            'results_sha256': h.hexdigest(),
            'profiled': profiled(lambda: topt.optimize_tours(*args, **kw))}
os.environ.pop('HAPHIC_GA_NO_DELTA')
if krs is not None:
    # one rescoring call in each mode at the dense run's largest batch
    args, kw = calls['dense']
    problems, npop = args[0], kw['npop']
    (k_pad, Rp, c_eff), idxs = max(
        topt._batches(problems, npop, topt.CHUNK),
        key=lambda b: len(b[1]) * b[0][1])
    rec, order, ori, _ = topt._make_batch(
        [problems[g] for g in idxs], [None] * len(idxs), k_pad, Rp, c_eff,
        npop, kw['seed'], 'cuda')
    rargs = (order, ori, rec.lengths, rec.pa, rec.pb, rec.la, rec.lb, rec.d,
             rec.w)
    out['rescore'] = {'G': len(idxs), 'P': npop, 'k_pad': k_pad,
                      'R_pad': Rp}
    for mode, caches in (('scores', False), ('caches', True)):
        fn = lambda: krs.rescore(*rargs, caches=caches)
        out['rescore'][mode] = dict(ab.measure(torch, fn, 50),
                                    sha=ab.digest(torch, fn()))
print(json.dumps(out), flush=True)
'''

PARTS = r'''
import json, os, pickle, sys
import torch
sys.path.insert(0, sys.argv[1])
from haphic_tpu_torch.kernels import score as kscore
from haphic_tpu_torch.order import optimize as topt
with open(os.path.join(sys.argv[2], 'dense.pkl'), 'rb') as f:
    args, kw = pickle.load(f)
problems, npop = args[0], kw['npop']
(k_pad, Rp, c_eff), idxs = max(topt._batches(problems, npop, topt.CHUNK),
                               key=lambda b: len(b[1]) * b[0][1])
rec, order, ori, _ = topt._make_batch(
    [problems[g] for g in idxs], [None] * len(idxs), k_pad, Rp, c_eff,
    npop, kw['seed'], 'cuda')
G = len(idxs)


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def batched():
    return kscore.score_population(order, ori, rec.lengths, rec.pa, rec.pb,
                                   rec.d, rec.w)


one, per = batched(), rec.score(order, ori)
contrib = rec.caches(order, ori)[-2]
sums = {'f32_batched': lambda c: c.sum(dim=2),
        'f32_per_group': topt._group_sums,
        'f64_rounded_once': lambda c: c.double().sum(dim=2).float()}
g0, g1 = min(2, G - 1), min(5, G)
line = {'G': G, 'P': npop, 'k_pad': k_pad, 'R_pad': Rp,
        'score_ms': {'one_launch': ms(batched),
                     'launch_per_group': ms(lambda: rec.score(order, ori))},
        'score_rows_differing': int((one != per).sum()),
        'sum_ms': {k: ms(lambda f=f: f(contrib)) for k, f in sums.items()},
        'sum_rows_changed_alone': {
            k: int((f(contrib)[g0:g1] != f(contrib[g0:g1].contiguous()))
                   .sum()) for k, f in sums.items()},
        'rows_compared': (g1 - g0) * npop}
print(json.dumps(line), flush=True)
'''


def child(code: str, tree: str, *argv: str) -> list:
    out = subprocess.run([sys.executable, '-c', code, tree] + list(argv),
                         cwd=tree, stdout=subprocess.PIPE, text=True)
    if out.returncode != 0:
        raise SystemExit('ab_ga_route: {} exited {}'.format(
            tree, out.returncode))
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{')]


def main(argv) -> int:
    order = ORDER
    if len(argv) == 4 and argv[2] == '--order':
        order, argv = argv[3], argv[:2]
    if len(argv) != 2 or set(order) - set('AB'):
        sys.stderr.write(__doc__)
        return 2
    trees = dict(zip('AB', (os.path.abspath(t) for t in argv)))
    work = os.path.join(trees['B'], 'build', 'ab_ga_route')
    os.makedirs(work, exist_ok=True)
    lines = child(RECORD, trees['B'], work)
    print(json.dumps({'record': [ln for ln in lines
                                 if ln.get('phase') != 'env']}), flush=True)
    for turn, label in enumerate(order):
        (line,) = child(TURN, trees[label], work, ','.join(PIPELINES),
                        os.path.dirname(os.path.abspath(__file__)))
        print(json.dumps({'checkout': label, 'dir': trees[label],
                          'turn': turn, **line}), flush=True)
    (line,) = child(PARTS, trees['B'], work)
    print(json.dumps({'checkout': 'B', 'dense_batch': line}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

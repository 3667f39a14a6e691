#!/usr/bin/env python3
"""A whole sparse MCL sweep on the card, with the convergence statistic's
kernel and with its plain version, in turns.

    python3 tools/ab_sparse_sweep.py [--order ABBAABBA]

Runs chip_smoke.py's `sparse_pipeline` phase once (the 480 Mb /
6,000,000-pair simulated genome, n = 24,000, the pipeline on the card)
to take the arguments the pipeline gave run_mcl_sparse, then runs that
sweep again in the given order: A with col_allclose's kernel, as the
pipeline runs it, B with its plain version (col_allclose.plain_stat).
Every sweep step is timed between two syncs with the card. Each sweep
prints one JSON line: the statistic, its turn, sweep_s, the steps' ms
(sum, p50, p99, max, and the count and sum by K), the kernel's launches,
the iterations per inflation and the K of each shrink. Exits non-zero
when CUDA is unavailable or when two sweeps differ in iterations or
shrinks.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

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
        with kca.plain_stat(sp) if plain else contextlib.nullcontext():
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--order', default='ABBAABBA',
                    help='A: the kernel, B: the plain statistic')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('ab_sparse_sweep: CUDA is not available\n')
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from haphic_tpu_torch import cli
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.cluster.sweep import SPARSE_MIN_N
    from haphic_tpu_torch.kernels import build as kbuild
    from haphic_tpu_torch.kernels import col_allclose as kca
    from haphic_tpu_torch.kernels import delta as kdelta
    from haphic_tpu_torch.kernels import score as kscore
    cs.WORK = os.path.join(REPO, 'build', 'ab_sparse_sweep')
    os.makedirs(cs.WORK, exist_ok=True)
    cs.phase_env(torch, kbuild)
    call = []
    with cs._first_call(sp, 'run_mcl_sparse', call):
        cs.phase_sparse_pipeline(torch, cli, kscore, kdelta, sp,
                                 SPARSE_MIN_N)
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

"""The sparse column kernel's cycles by phase, from its timing build.

    python3 tools/sparse_column_phases.py [--seed 0] [--reps 3]
        [--iterate build/chip_smoke/sparse_step.pt]

Builds csrc/sparse_column.cu with -DSC_PHASE_CLOCKS (its own library
beside the main one), runs one sweep step's column work through it, at
the sparse smoke run's shape (B = 4, n + 1 = 24,001, K = 128) on a
seeded column-stochastic iterate, or with ``--iterate`` on the smoke
run's own first step as chip_smoke.py saves it, and prints one JSON
line: each phase's clock64() cycles, summed over the columns, a
column's mean and its share; the column work's ms (CUDA events)
through the timing build and through the main build; and the step's
column shapes (kernelkit.column_stats).
"""

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import kernelkit as kit  # noqa: E402


def _phases_fn():
    """The timing build of csrc/sparse_column.cu (-DSC_PHASE_CLOCKS),
    its own library beside the main one: (launch, read the cycles, the
    phase names)."""
    from haphic_tpu_torch.kernels import build as kbuild
    from haphic_tpu_torch.kernels import sparse_column as kcol
    path = kbuild.library_path('sparse_column').replace(
        'libsparse_column-', 'libsparse_column_phases-')
    if not os.path.exists(path):
        nvcc = kbuild.nvcc_path()
        if nvcc is None:
            raise RuntimeError('nvcc not found (set CUDA_HOME)')
        os.makedirs(kbuild.BUILD_DIR, exist_ok=True)
        tmp = '{}.{}.tmp'.format(path, os.getpid())
        subprocess.run([nvcc] + kbuild.NVCC_FLAGS + [
            '-DSC_PHASE_CLOCKS', '-o', tmp,
            os.path.join(kbuild.CSRC, 'sparse_column.cu')], check=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    read = lib.sparse_column_phase_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    names = lib.sparse_column_phase_names
    names.argtypes, names.restype = [], ctypes.c_char_p
    return kcol._bind(lib), read, names().decode().split(',')


def phases(A_i, A_v, infl, n: int, K: int, chunk: int, pruning: float,
           expansion: int, reps: int) -> dict:
    """One sweep step's column work (kernelkit.step_columns) through the
    timing build: each phase's clock64() cycles, summed over the columns,
    a column's mean and its share; the column work's ms through the
    timing build and through the main build."""
    from haphic_tpu_torch.kernels import sparse_column as kcol
    launch, read, names = _phases_fn()

    def timed(*args):
        kcol._check(*args[:5], args[5], args[6], args[8])
        return kcol._launch(launch, *args)
    buf = (ctypes.c_uint64 * (len(names) + 1))()
    run = functools.partial(kit.step_columns, timed, A_i, A_v, infl, n, K,
                            chunk, pruning, expansion)
    run()
    torch.cuda.synchronize()
    for attempt in range(2):      # zero, then the counts of one step
        if attempt:
            run()
            torch.cuda.synchronize()
        err = read(ctypes.addressof(buf))
        if err != 0:
            raise RuntimeError('reading the phase cycles: CUDA error '
                               '{}'.format(err))
    cycles = list(buf)[:len(names)]
    cols, total = buf[len(names)], sum(cycles)
    return {'columns_timed': cols, 'cycles_per_column': total / max(cols, 1),
            'phases': {k: {'cycles_per_column': c / max(cols, 1),
                           'share': c / max(total, 1)}
                       for k, c in zip(names, cycles)},
            'timing_build_ms': kit.time_ms(run, reps),
            'ms': kit.time_ms(functools.partial(
                kit.step_columns, kcol.sparse_column, A_i, A_v, infl, n, K,
                chunk, pruning, expansion), reps)}


def main(argv=None) -> int:
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.kernels import build as kbuild
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--iterate', help='a sweep step saved by chip_smoke.py '
                    '(build/chip_smoke/sparse_step.pt) in place of the '
                    'seeded iterate')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write('sparse_column_phases: CUDA is not available\n')
        return 1
    dev = torch.device('cuda')
    if args.iterate:
        st = torch.load(args.iterate, map_location=dev)
        idx, val, infl = st['idx'], st['val'], st['infl']
        active = st['active'].cpu().numpy()
        n, K, chunk = st['n'], st['K'], st['chunk']
        pruning, expansion = st['pruning'], st['expansion']
    else:
        # the sparse smoke run's first step: n = 24,000 fragments, the
        # first inflation batch of 4, the default K
        n, B, K = 24000, 4, sp.DEFAULT_K
        idx, val = (torch.as_tensor(x, device=dev)
                    for x in kit.sparse_column_iterate(args.seed, B, n, K))
        infl = torch.as_tensor(np.linspace(1.2, 2.0, B, dtype=np.float32),
                               device=dev)
        active = np.ones(B, dtype=bool)
        chunk = sp._auto_chunk(B, K, n)
        pruning, expansion = 1e-4, 2
    # the column work alone: the active inflations' columns
    sel = torch.as_tensor(np.flatnonzero(active), device=dev)
    A_i, A_v, fa = idx[sel], val[sel], infl[sel]
    kbuild.build(['sparse_column'])
    print(json.dumps(dict(
        kernel='sparse_column', nvidia_smi=kit.nvidia_smi(),
        device=torch.cuda.get_device_name(0),
        iterate=args.iterate or 'seeded {}'.format(args.seed),
        B=A_i.shape[0], n_plus_1=n + 1, K=K, chunk=chunk,
        **phases(A_i, A_v, fa, n, K, chunk, pruning, expansion, args.reps),
        columns=kit.column_stats(A_i, A_v, n, K, chunk))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

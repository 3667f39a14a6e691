#!/usr/bin/env python3
"""Smoke run of haphic_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env       nvidia-smi name and power limit, torch/CUDA versions, and
             the build of every CUDA kernel (one nvcc per source, all
             started together).
2. pipeline  `haphic_tpu_torch.cli.main(["pipeline", ...])` on the card
             on a simulated genome of 8 chromosomes x 1000 contigs x
             20 kb (160 Mb) with 2,000,000 Hi-C pairs (bench.py's
             make_sim generator and sim flags), --ngen 500 instead of
             5000 (a cut, for time). The dense MCL sweep and the GA run
             on the card; the kernel launch counts are set to 0 just
             before and read just after. The scaffolds must recover
             the 8 simulated chromosomes as a partition.
3. kernel    every kernel against its plain torch version on the card,
             at a small shape and at the shapes the pipeline gave it
             (max relative error <= 1e-5: the sums run in another
             order), with CUDA-event times and the least time the card
             could take for the same work.
4. kernels   one line listing every kernel (the line before the last).

The last line is {"ok": true, "device": {...}}. The script exits
non-zero, printing no result, when CUDA is unavailable, when the
package is missing, or when any phase fails.
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, 'build', 'chip_smoke')

SIM = dict(nchrs=8, ctgs_per_chr=1000, ctg_len=20000, n_pairs=2_000_000,
           seed=17)
NGEN = 500
SIM_FLAGS = ['--Nx', '100', '--RE_site_cutoff', '0',
             '--density_lower', '0', '--density_upper', '1',
             '--rank_sum_upper', '1', '--flank', '0',
             '--min_group_len', '0', '--min_RE_sites', '0',
             '--min_links', '1']
REL_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 (non-tensor)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12

KERNELS = [{
    'name': 'score_population',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/score_population.cu',
    'replaces': 'haphic_tpu/order/optimize.py:470',
}]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError('chip_smoke: {}'.format(what))


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def make_sim(outdir, nchrs, ctgs_per_chr, ctg_len, n_pairs, seed):
    """Simulated assembly + pairs file: bench.py's make_sim generator
    (same draws in the same order), written with plain string joins."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    cpc, L = ctgs_per_chr, ctg_len
    n = nchrs * cpc
    names = ['chr{}_ctg{}'.format(c + 1, i + 1)
             for c in range(nchrs) for i in range(cpc)]
    fa = os.path.join(outdir, 'asm.fa')
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    with open(fa, 'wb') as f:
        for name in names:
            seq = bases[rng.integers(0, 4, L)].tobytes()
            f.write(b'>' + name.encode() + b'\n')
            f.write(b'\n'.join(seq[s:s + 70] for s in range(0, L, 70)))
            f.write(b'\n')
    chrom = rng.integers(0, nchrs, n_pairs)
    i1 = rng.integers(0, cpc, n_pairs)
    off = np.rint(rng.normal(0, 1.2, n_pairs)).astype(np.int64)
    i2 = np.clip(i1 + off, 0, cpc - 1)
    noise = rng.random(n_pairs) < 0.02
    a = np.where(noise, rng.integers(0, n, n_pairs), chrom * cpc + i1)
    b = np.where(noise, rng.integers(0, n, n_pairs), chrom * cpc + i2)
    pa = rng.integers(1, L + 1, n_pairs)
    pb = rng.integers(1, L + 1, n_pairs)
    pairs = os.path.join(outdir, 'hic.pairs')
    with open(pairs, 'w') as f:
        f.write('## pairs format v1.0\n')
        f.writelines('r{}\t{}\t{}\t{}\t{}\t+\t+\n'.format(
            r, names[x], p, names[y], q) for r, (x, p, y, q) in enumerate(
                zip(a.tolist(), pa.tolist(), b.tolist(), pb.tolist())))
    return fa, pairs


def check_partition(agp: str, nchrs: int) -> dict:
    """The scaffolds recover the simulated chromosomes as a partition:
    every scaffold holds contigs of one chromosome, and each chromosome
    lies in exactly one scaffold."""
    scaffolds = {}
    with open(agp) as f:
        for line in f:
            cols = line.rstrip('\n').split('\t')
            if len(cols) >= 9 and cols[4] == 'W':
                scaffolds.setdefault(cols[0], []).append(cols[5])
    chrom_of_scaffold = {}
    for s, ctgs in scaffolds.items():
        chroms = {c.split('_')[0] for c in ctgs}
        check(len(chroms) == 1, 'scaffold {} mixes {}'.format(s, chroms))
        chrom_of_scaffold[s] = chroms.pop()
    per_chrom = {}
    for s, c in chrom_of_scaffold.items():
        per_chrom.setdefault(c, []).append(s)
    check(len(per_chrom) == nchrs,
          'chromosomes found: {}'.format(sorted(per_chrom)))
    split = {c: v for c, v in per_chrom.items() if len(v) != 1}
    check(not split, 'chromosomes split over scaffolds: {}'.format(split))
    return {'scaffolds': len(scaffolds),
            'contigs_placed': sum(len(v) for v in scaffolds.values())}


class MetricsLog(logging.Handler):
    """Collects the `metrics` dicts the port attaches to log records."""

    def __init__(self):
        super().__init__()
        self.metrics = {}

    def emit(self, record):
        m = getattr(record, 'metrics', None)
        if m:
            for k, v in m.items():
                self.metrics.setdefault(k, []).append(v)


def phase_env(torch, kbuild):
    t0 = time.time()
    paths = kbuild.build()
    secs = time.time() - t0
    for name in paths:
        sys.stderr.write(kbuild.BUILD_LOG.get(name, ''))
    emit({'phase': 'env', 'nvidia_smi': nvidia_smi(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'device': torch.cuda.get_device_name(0),
          'kernel_build_s': secs,
          'libraries': {n: os.path.relpath(p, REPO)
                        for n, p in paths.items()}})


def phase_pipeline(torch, cli, kscore):
    t0 = time.time()
    fa, pairs = make_sim(os.path.join(WORK, 'sim'), **SIM)
    sim_s = time.time() - t0
    out = os.path.join(WORK, 'out')
    log = MetricsLog()
    logging.getLogger('haphic_tpu_torch').addHandler(log)
    torch.cuda.reset_peak_memory_stats()
    kscore.score_population.launches = 0
    t0 = time.time()
    rc = cli.main(['pipeline', fa, pairs, str(SIM['nchrs']), '--outdir',
                   out, '--ngen', str(NGEN)] + SIM_FLAGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {'score_population': kscore.score_population.launches}
    logging.getLogger('haphic_tpu_torch').removeHandler(log)
    check(rc == 0, 'pipeline exit code {}'.format(rc))
    m = log.metrics
    mcl = m['mcl_route'][-1]
    check(mcl == 'cuda', 'the MCL sweep ran on {}, not the card'.format(mcl))
    check(m['ga_route'][-1] == 'cuda',
          'the GA ran on {}, not the card'.format(m['ga_route'][-1]))
    for name, n in launches.items():
        check(n > 0, 'kernel {} was not launched on the main path'.format(
            name))
    agp = os.path.join(out, '04.build', 'scaffolds.agp')
    check(os.path.exists(agp), 'no {}'.format(agp))
    part = check_partition(agp, SIM['nchrs'])
    batches = m['ga_batch']
    emit({'phase': 'pipeline', 'sim': SIM, 'sim_s': sim_s,
          'cut': {'ngen': [5000, NGEN]}, 'n': m['n'][-1],
          'mcl_route': mcl, 'mcl_batches': m['batches'][-1],
          'mcl_iters_per_inflation': m['n_iters'][-1],
          'records_per_group': m['records'][-1],
          'ga_work': m['ga_work'][-1], 'ga_route': m['ga_route'][-1],
          'ga_batches': batches, 'stage_s': m['stage_secs'][-1],
          'cluster_s': m['cluster_secs'][-1], 'ga_s': m['ga_secs'][-1],
          'wall_s': wall,
          'max_memory_allocated': torch.cuda.max_memory_allocated(),
          'launches': launches, **part})
    big = max(batches, key=lambda b: b['G'] * b['R_pad'])
    return launches, big


def _score_inputs(torch, G, P, k, R, seed):
    rng = np.random.default_rng(seed)
    kk = max(2, k - 3)                      # real contigs; rest k padding
    lengths = np.zeros((G, k), np.int64)
    lengths[:, :kk] = rng.integers(5000, 40000, (G, kk))
    pa = rng.integers(0, kk - 1, (G, R)).astype(np.int32)
    pb = np.minimum(pa + rng.integers(1, 5, (G, R)), kk - 1).astype(
        np.int32)
    d = rng.integers(1, 40000, (G, 4, R)).astype(np.float32)
    w = rng.integers(1, 4, (G, R)).astype(np.float32)
    order = np.argsort(rng.random((G, P, k)), axis=2).astype(np.int32)
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)
    return [torch.as_tensor(x, device='cuda')
            for x in (order, ori, lengths, pa, pb, d, w)]


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(torch, kscore, big, launches):
    rows = []
    shapes = [('small', 2, 6, 32, 1000),
              ('main_path', big['G'], big['P'], big['k_pad'],
               big['R_pad'])]
    for seed, (label, G, P, k, R) in enumerate(shapes):
        args = _score_inputs(torch, G, P, k, R, seed)
        got = kscore.score_population(*args)
        want = kscore.score_population_plain(*args)
        torch.cuda.synchronize()
        check(got.shape == (G, P) and bool(torch.isfinite(got).all()),
              'score kernel output at {} shape'.format(label))
        abs_err = float((got - want).abs().max())
        rel_err = float(((got - want).abs() / want.abs()).max())
        check(rel_err <= REL_TOL, 'score kernel disagrees at {} shape: '
              'max relative error {}'.format(label, rel_err))
        ms = _time_ms(torch, lambda: kscore.score_population(*args), 20)
        plain_ms = _time_ms(
            torch, lambda: kscore.score_population_plain(*args), 3)
        # each input read once (order, ori, lengths; pa, pb, d[4], w per
        # record), the scores written once
        nbytes = G * P * k * 8 + G * k * 8 + G * R * 28 + G * P * 4
        ops = 25 * G * P * R
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / FP32_FLOPS * 1e3
        row = {'shape': label, 'G': G, 'P': P, 'k': k, 'R': R,
               'max_abs_err': abs_err, 'max_rel_err': rel_err, 'ms': ms,
               'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
               'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
        emit({'phase': 'kernel', 'name': 'score_population',
              'main_path_launches': launches['score_population'], **row})
        rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: CUDA is not available\n')
        return 1
    sys.path.insert(0, REPO)
    from haphic_tpu_torch import cli
    from haphic_tpu_torch.kernels import build as kbuild
    from haphic_tpu_torch.kernels import score as kscore

    phase_env(torch, kbuild)
    launches, big = phase_pipeline(torch, cli, kscore)
    rows = phase_kernel(torch, kscore, big, launches)
    main_row = rows[-1]
    kernels = []
    for k in KERNELS:
        kernels.append(dict(k, launches=launches[k['name']],
                            max_abs_err=main_row['max_abs_err'],
                            ms=main_row['ms'],
                            plain_ms=main_row['plain_ms'],
                            bound_ms=main_row['bound_ms'],
                            bound_by=main_row['bound_by'],
                            library_ms=None))
    print(nvidia_smi(), flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Trace the device GA's kernels on the card.

    python -m haphic_tpu_torch.kernels.trace_ga [--G 7] [--P 100]
        [--k 1024] [--R 196608] [--gens 10] [--out DIR]

Builds one GA batch of G groups at the given shape (random records that
link near contigs, sorted by contig as build_problem sorts them, and a
random population), warms up, then:

1. times ``--gens`` delta generations (``optimize._dgen``) with the host
   clock around a synchronised run;
2. runs the same number of generations under ``torch.profiler`` and
   reports the device time by operation (the top 15), the number of
   kernels and host syncs per generation, and the device's idle share
   of the profiled window (the gaps between device activity);
3. repeats both with the plain torch version of the per-record work
   (``delta_generation_plain``) in place of the kernel
   (``delta_generation``);
4. scores the population ``--gens`` times with ``score_population``
   under the profiler: CUDA-event ms per call and the device time of
   each of its kernels (table, partial sums, reduction).

Each result is one JSON line naming the card (`nvidia-smi` name and
power limit). With ``--out`` the Chrome traces are written there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_batch(G: int, P: int, k: int, R: int, seed: int, device):
    """(_Records, GA state) of one batch: contigs of 5-40 kb, records
    between contigs at most 4 slots apart in the true order, sorted by
    (a, b), and a population of random tours."""
    from haphic_tpu_torch.order import optimize as opt
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5000, 40000, (G, k)).astype(np.int64)
    pa = rng.integers(0, k - 1, (G, R))
    pb = np.minimum(pa + rng.integers(1, 5, (G, R)), k - 1)
    key = np.sort(pa * k + pb, axis=1)
    pa, pb = (key // k).astype(np.int32), (key % k).astype(np.int32)
    d = rng.integers(1, 40000, (G, 4, R)).astype(np.float32)
    w = rng.integers(1, 4, (G, R)).astype(np.float32)
    order = np.argsort(rng.random((G, P, k)), axis=2).astype(np.int32)
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)

    def put(x):
        return torch.as_tensor(x, device=device)
    rec = opt._Records(put(lengths), put(pa), put(pb), put(d), put(w))
    o, r = put(order), put(ori)
    return rec, (o, r) + rec.caches(o, r)


def _device_intervals(prof):
    out = []
    for e in prof.events():
        if getattr(e.device_type, 'name', '') == 'CUDA':
            out.append((e.time_range.start, e.time_range.end))
    return sorted(out)


def _busy_and_gaps(iv):
    """Union length of the device intervals (us) and the gaps between
    them."""
    busy, gaps = 0.0, []
    cur_s, cur_e = None, None
    for s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def trace(label: str, step, state, gens: int, out_dir=None) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(gens):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / gens

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gens):
            state = step(state)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, 'trace_ga_{}.json'.format(label)))
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    iv = _device_intervals(prof)
    busy_us, gaps = _busy_and_gaps(iv)
    syncs = sum(ev.count for ev in prof.key_averages()
                if ev.key in ('cudaStreamSynchronize',
                              'cudaDeviceSynchronize', 'cudaMemcpyAsync',
                              'cudaEventSynchronize'))
    span_us = (iv[-1][1] - iv[0][0]) if iv else 0.0
    return {
        'path': label, 'wall_ms_per_gen': wall_ms,
        'profiled_wall_ms_per_gen': prof_wall_us / 1e3 / gens,
        'device_busy_ms_per_gen': busy_us / 1e3 / gens,
        'device_span_ms_per_gen': span_us / 1e3 / gens,
        'idle_share_of_wall': 1.0 - busy_us / prof_wall_us,
        'gaps_per_gen': len(gaps) / gens,
        'gap_ms_per_gen': sum(gaps) / 1e3 / gens,
        'gaps_over_100us': sum(1 for g in gaps if g > 100),
        'device_ops_per_gen': len(iv) / gens,
        'host_syncs_per_gen': syncs / gens,
        'top_device_ms_per_gen': [
            {'op': key[:80], 'ms': us / 1e3 / gens, 'calls_per_gen':
             n / gens} for us, key, n in rows[:15]],
    }


def trace_score(rec, order, ori, calls: int) -> dict:
    """CUDA-event ms per score_population call and device ms per call
    of each kernel it launches."""
    from torch.profiler import ProfilerActivity, profile
    rec.score(order, ori)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        rec.score(order, ori)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rec.score(order, ori)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            kernels[ev.key[:60]] = dev_us / 1e3 / calls
    return {'path': 'score_population',
            'ms_per_call': start.elapsed_time(end) / calls,
            'device_ms_per_call': kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--G', type=int, default=7)
    ap.add_argument('--P', type=int, default=100)
    ap.add_argument('--k', type=int, default=1024)
    ap.add_argument('--R', type=int, default=196608)
    ap.add_argument('--gens', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write('trace_ga: CUDA is not available\n')
        return 1
    from haphic_tpu_torch.order import optimize as opt
    rec, state = make_batch(args.G, args.P, args.k, args.R, args.seed,
                            'cuda')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(args.seed)
    card = _nvidia_smi()
    shape = {'G': args.G, 'P': args.P, 'k': args.k, 'R': args.R}
    from haphic_tpu_torch.kernels import delta as kdelta
    paths = [('kernel', lambda s: opt._dgen(gen, rec, s)),
             ('plain', lambda s: opt._dgen(
                 gen, rec, s, kdelta.delta_generation_plain))]
    for label, step in paths:
        torch.cuda.reset_peak_memory_stats()
        row = trace(label, step, state, args.gens, args.out)
        row['max_memory_allocated'] = torch.cuda.max_memory_allocated()
        print(json.dumps(dict(row, nvidia_smi=card, shape=shape)),
              flush=True)
    row = trace_score(rec, state[0], state[1], args.gens)
    print(json.dumps(dict(row, nvidia_smi=card, shape=shape)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

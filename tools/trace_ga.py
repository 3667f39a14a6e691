#!/usr/bin/env python3
"""Trace the device GA's kernels on the card.

    python3 tools/trace_ga.py [--G 7] [--P 100]
        [--k 1024] [--R 196608] [--gens 10] [--out DIR]
        [--pipeline OUTDIR --fasta ASM.FA]

Builds one GA batch of G groups at the given shape (random records that
link near contigs, sorted by contig as build_problem sorts them, and a
random population). With ``--pipeline``, also the largest GA batch of a
finished ``haphic pipeline`` run (its groups, split CLM files and fast
sort tours, read back from OUTDIR, hot-started as the pipeline starts
its GA), evolved WARM_GENS (100) generations by the GA's own windows
first.
On each batch, from the same starting state:

1. times ``--gens`` delta generations (``optimize._dgen``: the seven
   draws, then one launch of the kernel's draws mode) with the host
   clock around a synchronised run;
2. runs the same number of generations under ``torch.profiler`` and
   reports the device time by operation (the top 15), the number of
   device operations and host syncs per generation, and the device's
   idle share of the profiled window (the gaps between device
   activity);
3. runs ``--gens`` more and reports, per generation, the share of
   (individual, record) pairs the moves touch and the rows that accept;
4. repeats all three with ``_dgen`` given a step: the kernel's move
   mode (``delta_generation`` on the moves ``_moves_from_draws`` makes,
   path ``move_mode``) and the plain version
   (``delta_generation_plain``, path ``plain``).

On each batch it also times one kernel launch alone (kernel_breakdown:
a generation in draws mode; in move mode the delta pass, a generation,
every row's commit, no move). It scores
the random population ``--gens`` times with
``score_population`` under the profiler: CUDA-event ms per call and the
device time of each of its kernels (table, partial sums, reduction).

With ``--pipeline`` it then traces one whole window of the GA
(``optimize._evolve_delta_impl``, WINDOW_GENS generations: 20 cycles
of three rescoring calls, crossover, mutation, selection and 24 delta
generations) on that batch (``trace_window``): its host-clock time and
peak card memory; its device busy ms, device operations, host syncs and
idle share under the profiler; and the same split by phase, in a third
run with the card synchronised around each step of the cycle, with each
phase's device operations and host syncs a call (``delta_generations``:
a delta generation's).

Each result is one JSON line naming the card (`nvidia-smi` name and
power limit). With ``--out`` the Chrome traces are written there.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import kernelkit as kit  # noqa: E402

# generations the pipeline's batch evolves before it is traced
WARM_GENS = 100
# generations of the traced window: the GA's default log_every
WINDOW_GENS = 500


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


def pipeline_batch(out_dir: str, fasta: str, npop: int, seed: int, device):
    """(_Records, GA state, shape) of the largest GA batch of a finished
    pipeline run in ``out_dir``: each group's problem and hot start as
    sort_stage makes them (optimize.group_problem on
    01.cluster/HT_links.pkl, 02.reassign/final_groups and split_clms,
    and its fast sort tour 03.sort/*.tour.sav), started as
    optimize_tours starts it, then WARM_GENS generations of the GA's
    delta windows (mutation probability 0.2, the pipeline's default)."""
    from haphic_tpu_torch.io.artifacts import (load_ht_pickle,
                                               parse_clm_file,
                                               parse_group_file,
                                               parse_tour_file)
    from haphic_tpu_torch.io.fasta import read_fasta
    from haphic_tpu_torch.order import optimize as opt
    from haphic_tpu_torch.order.fast_sort import make_group_data
    asm = read_fasta(fasta, keep_seqs=False)
    ht = load_ht_pickle(os.path.join(out_dir, '01.cluster', 'HT_links.pkl'),
                        asm.name2id)
    problems, hots = [], []
    for path in sorted(glob.glob(os.path.join(
            out_dir, '02.reassign', 'final_groups', '*.txt'))):
        name = os.path.basename(path)[:-len('.txt')]
        if name == 'final_clusters':
            continue
        members = [asm.name2id[c] for c, _, _ in parse_group_file(path)]
        if len(members) < 2:
            continue
        gd = make_group_data(members, asm.lengths, ht)
        clm = parse_clm_file(os.path.join(out_dir, '02.reassign',
                                          'split_clms', name + '.clm'),
                             asm.name2id)
        tour = parse_tour_file(os.path.join(out_dir, '03.sort',
                                            name + '.tour.sav'))
        problem, hot = opt.group_problem(gd.ctg_ids, asm.lengths, clm, tour,
                                         asm.name2id)
        problems.append(problem)
        hots.append(hot)
    (k_pad, Rp, c_eff), idxs = max(
        opt._batches(problems, npop, opt.CHUNK),
        key=lambda b: len(b[1]) * b[0][1])
    rec, order, ori, gen = opt._make_batch(
        [problems[i] for i in idxs], [hots[i] for i in idxs], k_pad, Rp,
        c_eff, npop, seed, device)
    order, ori, _ = opt._evolve_delta_impl(gen, rec, order, ori, 0.2,
                                           WARM_GENS)
    shape = {'G': len(idxs), 'P': npop, 'k': k_pad, 'R': Rp}
    return rec, (order, ori) + rec.caches(order, ori), shape


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


def _moves_stats(rec, state, gen, step, gens: int) -> dict:
    """Per generation, the share of (individual, record) pairs the moves
    touch and the rows that accept, over ``gens`` generations drawn and
    stepped as _dgen draws and steps them (``step`` None: the draws
    mode)."""
    from haphic_tpu_torch.kernels import delta as kdelta
    from haphic_tpu_torch.order import optimize as opt
    G, P, k = state[0].shape
    R = state[4].shape[2]
    touched, accepted = [], []
    for _ in range(gens):
        draws = opt._move_draws(opt._Draws(gen, G), (G, P), k,
                                state[0].device)
        move = opt._moves_from_draws(*draws, k, 1.1, opt._DELTA_LOCAL_FRAC)
        touched.append(kdelta.touched_records(state[4], state[7],
                                              move).sum())
        if step is None:
            _, acc = kdelta.delta_generation_from_draws(
                state, draws, rec.la, rec.lb, rec.d, rec.w, 1.1,
                opt._DELTA_LOCAL_FRAC, opt._DELTA_MIN_GAIN,
                opt._DELTA_SPAN_GAIN)
        else:
            _, acc = step(state, move, rec.la, rec.lb, rec.d, rec.w,
                          opt._DELTA_MIN_GAIN, opt._DELTA_SPAN_GAIN)
        accepted.append(acc.sum())
    touched = [int(x) / float(G * P * max(R, 1)) for x in touched]
    accepted = [int(x) for x in accepted]
    return {'touched_share_per_gen': float(np.mean(touched)),
            'touched_share_by_gen': touched,
            'accepted_rows_per_gen': float(np.mean(accepted)),
            'accepted_rows_by_gen': accepted}


def trace(label: str, rec, state, gen, step, gens: int,
          out_dir=None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from haphic_tpu_torch.order import optimize as opt

    draws = opt._Draws(gen, state[0].shape[0])

    def one(s):
        return opt._dgen(draws, rec, s, step)
    for _ in range(3):
        state = one(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(gens):
        state = one(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / gens

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gens):
            state = one(state)
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
        **_moves_stats(rec, state, gen, step, gens),
    }


class _WindowMarks:
    """While installed, each step of ``optimize._evolve_delta_impl``'s
    cycle runs inside a profiler range named 'window:<phase>', with the
    card synchronised on entering and before leaving, so that all the
    device work a step launches lies inside its range: the three
    rescoring calls (parents, offspring, the selected population),
    crossover, mutation, selection with re-seeding, and the delta
    generations. A step called from inside another marked step (the
    rescoring's caches call) stays in the outer step's range."""

    def __init__(self, opt, sync):
        self.opt, self.sync = opt, sync
        self.depth = 0
        self.scored = 0
        self.saved = []

    def _wrap(self, fn, label):
        def run(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            name = label() if callable(label) else label
            self.depth += 1
            self.sync()
            try:
                with torch.profiler.record_function('window:' + name):
                    out = fn(*args, **kw)
                    self.sync()
            finally:
                self.depth -= 1
            return out
        return run

    def _scores_label(self):
        self.scored += 1
        return ('rescore_parents', 'rescore_offspring')[
            (self.scored - 1) % 2]

    def __enter__(self):
        opt, rec = self.opt, self.opt._Records
        for owner, name, label in (
                (rec, 'cache_scores', self._scores_label),
                (rec, 'caches', 'rescore_selected'),
                (opt, '_ox_crossover', 'crossover'),
                (opt, '_mutate', 'mutation'),
                (opt, '_select', 'select_reseed'),
                (opt, '_reseed', 'select_reseed'),
                (opt, '_dgen', 'delta_generations')):
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


_SYNC_CALLS = ('cudaStreamSynchronize', 'cudaEventSynchronize', 'cudaMemcpy')


def _window_profile(prof, wall_us: float) -> dict:
    """Device busy ms, device operations, host syncs and the idle share
    of one profiled window, then the same per marked phase (the device
    operations that start inside the phase's ranges). The card
    synchronisations of the marks themselves (cudaDeviceSynchronize)
    are not counted as host syncs."""
    ranges, dev, syncs = {}, [], []
    for e in prof.events():
        if e.name.startswith('window:'):
            if getattr(e.device_type, 'name', '') != 'CUDA':
                ranges.setdefault(e.name[7:], []).append(
                    (e.time_range.start, e.time_range.end))
        elif getattr(e.device_type, 'name', '') == 'CUDA':
            dev.append((e.time_range.start, e.time_range.end))
        elif e.name in _SYNC_CALLS:
            syncs.append(e.time_range.start)
    dev.sort()
    busy_us, _ = _busy_and_gaps(dev)
    out = {'wall_ms': wall_us / 1e3, 'device_busy_ms': busy_us / 1e3,
           'idle_share': 1.0 - busy_us / wall_us, 'device_ops': len(dev),
           'host_syncs': len(syncs)}
    if not ranges:
        return out
    phases, owned = {}, 0
    for name, rs in sorted(ranges.items()):
        rs.sort()
        mine = [iv for iv in dev if any(s <= iv[0] <= e for s, e in rs)]
        owned += len(mine)
        busy, _ = _busy_and_gaps(mine)
        pwall = sum(e - s for s, e in rs)
        n_syncs = sum(1 for t in syncs if any(s <= t <= e for s, e in rs))
        phases[name] = {
            'calls': len(rs), 'wall_ms': pwall / 1e3,
            'device_ms': busy / 1e3, 'device_ops': len(mine),
            'idle_share': 1.0 - busy / pwall if pwall > 0 else None,
            'host_syncs': n_syncs,
            'device_ops_per_call': len(mine) / len(rs),
            'host_syncs_per_call': n_syncs / len(rs)}
    out['phases'] = phases
    out['unmarked_device_ops'] = len(dev) - owned
    return out


def trace_window(rec, order, ori, seed: int, ngen: int,
                 mutprob: float = 0.2) -> dict:
    """One whole ``_evolve_delta_impl`` window of ``ngen`` generations
    from (order, ori), three times from the same start and draws: timed
    by the host clock, under the profiler (its device busy share, device
    operations and host syncs), and under the profiler with each step
    of the cycle marked (``_WindowMarks``), split by phase."""
    from torch.profiler import ProfilerActivity, profile

    from haphic_tpu_torch.order import optimize as opt
    G = order.shape[0]

    def sync():
        if order.is_cuda:
            torch.cuda.synchronize()

    def window():
        gen = torch.Generator(device=order.device)
        gen.manual_seed(seed)
        return opt._evolve_delta_impl(opt._Draws(gen, G), rec, order.clone(),
                                      ori.clone(), mutprob, ngen)

    def run():
        sync()
        t0 = time.perf_counter()
        res = window()
        sync()
        return res, (time.perf_counter() - t0) * 1e6
    run()                                             # warm-up
    if order.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    res, wall_us = run()
    peak = torch.cuda.max_memory_allocated() if order.is_cuda else None
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        res_p, prof_us = run()
    plain = _window_profile(prof, prof_us)
    with _WindowMarks(opt, sync), profile(activities=acts) as prof:
        res_m, marked_us = run()
    marked = _window_profile(prof, marked_us)
    same = all(torch.equal(a, b) for r in (res_p, res_m)
               for a, b in zip(res, r))
    return {'path': 'window', 'shape': dict(zip('GPk', order.shape),
                                            R=rec.pa.shape[1]),
            'ngen': ngen, 'wall_ms': wall_us / 1e3,
            'max_memory_allocated': peak, 'profiled': plain,
            'marked': marked, 'runs_equal': same}


def kernel_breakdown(rec, state, gen, reps: int) -> dict:
    """CUDA-event ms of one delta_generation launch on one set of draws
    drawn as _dgen draws them, applied again and again to one copy of
    the state (the moves permute slots inside their own range, so each
    repetition touches the same records): in draws mode, as the GA
    launches it (draws_generation_ms); in move mode on the moves the
    draws make, with every row rejected (the delta pass alone), with
    the acceptance the kernel makes on the first run (a generation),
    with every row accepted (every row's commit), and with no move (the
    launch and the cluster's fixed cost). Also the pairs the moves touch
    and the pairs whose contribution they may change."""
    from haphic_tpu_torch.kernels import delta as kdelta
    from haphic_tpu_torch.order import optimize as opt
    G, P, k = state[0].shape
    draws = opt._move_draws(opt._Draws(gen, G), (G, P), k, state[0].device)
    move = tuple(torch.empty((G, P), dtype=dt, device=state[0].device)
                 for dt in (torch.bool,) + (torch.int32,) * 4)
    st = tuple(x.clone() for x in state)

    def from_draws(s, moves_out=None):
        return kdelta.delta_generation_from_draws(
            s, draws, rec.la, rec.lb, rec.d, rec.w, 1.1,
            opt._DELTA_LOCAL_FRAC, opt._DELTA_MIN_GAIN,
            opt._DELTA_SPAN_GAIN, moves_out=moves_out)

    def run(mv, accept=None):
        return kdelta.delta_generation(st, mv, rec.la, rec.lb, rec.d, rec.w,
                                       opt._DELTA_MIN_GAIN,
                                       opt._DELTA_SPAN_GAIN, accept=accept)
    own = from_draws(tuple(x.clone() for x in state), move)[1]
    draws_ms = kit.time_ms(lambda: from_draws(st), reps)
    st = tuple(x.clone() for x in state)
    still = (torch.zeros_like(move[0]),) + tuple(move[1:])
    out = {'path': 'delta_generation_breakdown',
           'touched_pairs': int(kdelta.touched_records(
               state[4], state[7], move).sum()),
           'changed_pairs': int(kdelta.changed_records(
               state[4], state[7], move).sum()),
           'pairs': G * P * state[4].shape[2],
           'accepted_rows': int(own.sum()),
           'draws_generation_ms': draws_ms,
           'reject_all_ms': kit.time_ms(
               lambda: run(move, torch.zeros_like(own)), reps),
           'generation_ms': kit.time_ms(lambda: run(move, own), reps),
           'accept_all_ms': kit.time_ms(
               lambda: run(move, torch.ones_like(own)), reps),
           'no_move_ms': kit.time_ms(
               lambda: run(still, torch.zeros_like(own)), reps)}
    del st
    return out


def trace_score(rec, order, ori, calls: int) -> dict:
    """CUDA-event ms per score_population call and device ms per call
    of each kernel it launches."""
    from torch.profiler import ProfilerActivity, profile
    ms = kit.time_ms(lambda: rec.score(order, ori), calls)
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
            'ms_per_call': ms,
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
    ap.add_argument('--pipeline', default=None,
                    help='output directory of a finished pipeline run')
    ap.add_argument('--fasta', default=None,
                    help="that run's assembly FASTA")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write('trace_ga: CUDA is not available\n')
        return 1
    if args.pipeline and not args.fasta:
        ap.error('--pipeline needs --fasta')
    from haphic_tpu_torch.kernels import delta as kdelta
    card = kit.nvidia_smi()
    shape = {'G': args.G, 'P': args.P, 'k': args.k, 'R': args.R}
    batches = [('random', lambda: make_batch(
        args.G, args.P, args.k, args.R, args.seed, 'cuda') + (shape,))]
    if args.pipeline:
        batches.append(('pipeline', lambda: pipeline_batch(
            args.pipeline, args.fasta, args.P, args.seed, 'cuda')))
    for population, build in batches:
        # one batch on the card at a time: peak memory is the step's own
        rec, state, bshape = build()
        for label, step in (('kernel', None),
                            ('move_mode', kdelta.delta_generation),
                            ('plain', kdelta.delta_generation_plain)):
            gen = torch.Generator(device='cuda')
            gen.manual_seed(args.seed)
            st = tuple(x.clone() for x in state)
            torch.cuda.reset_peak_memory_stats()
            row = trace('{}_{}'.format(population, label), rec, st, gen,
                        step, args.gens, args.out)
            row['max_memory_allocated'] = torch.cuda.max_memory_allocated()
            print(json.dumps(dict(row, population=population,
                                  nvidia_smi=card, shape=bshape)),
                  flush=True)
            del st
            torch.cuda.empty_cache()
        gen = torch.Generator(device='cuda')
        gen.manual_seed(args.seed)
        row = kernel_breakdown(rec, state, gen, 20)
        print(json.dumps(dict(row, population=population, nvidia_smi=card,
                              shape=bshape)), flush=True)
        if population == 'random':
            row = trace_score(rec, state[0], state[1], args.gens)
            print(json.dumps(dict(row, nvidia_smi=card, shape=bshape)),
                  flush=True)
        else:
            row = trace_window(rec, state[0], state[1], args.seed,
                               WINDOW_GENS)
            print(json.dumps(dict(row, nvidia_smi=card)), flush=True)
        del rec, state
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())

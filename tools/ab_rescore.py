#!/usr/bin/env python3
"""The GA cycle's rescoring kernel (rescore_population) of two checkouts,
timed in turns on one card at the dense pipeline's largest GA batch's
shape, and the share of the second's kernel that builds its tables.

    python3 tools/ab_rescore.py A_DIR B_DIR [--order ABBA] [--reps 50]
        [--prologue] [--sass OUT_DIR]

The inputs are seeded: G = 7 groups, P = 100 tours, k = 1024 contigs,
R = 196,608 records of which the last 1000 are padding, the real ones
sorted by (a, b) as the GA's problem building leaves them (about 190 a
contig, so that a warp's records mostly share a and have distinct b).

Each turn is a process of its own that imports one checkout's package
only and prints one JSON line: for each mode (scores, caches) the ms a
call by CUDA events over --reps calls, the device kernels of a call by
torch.profiler (name, device us, the gap before it), the device us a
call, the wrapper's host us a call (the calls enqueued without a sync),
and a hash of the outputs.

--prologue runs one more process on B (its kernel builds each tile's
tables in every CTA's prologue) and prints one JSON line per mode:
  - a sweep of R at k = 1024, P = 100 and as many groups as give one
    CTA an SM at most, each CTA taking all the chunks (the plan's m
    replaced): R = 512 (a CTA is mostly its table build) and R = 1, 2,
    3 and 4 chunks, the ms by CUDA events and the device ms of a call,
    so that the build's cost (the intercept) and a chunk's (the slope)
    can be read;
  - at the dense batch's shape, the kernel with each number m of chunks
    a CTA (the plan's m replaced: the grid has ceil(nchunks / m) chunk
    groups), its ms, device ms and output hash (equal for every m: the
    sum order does not depend on m), beside the m the plan picks.

--sass writes each library's SASS (cuobjdump -sass) to OUT_DIR and
prints, per rescoring kernel, its instruction count and its loops (the
spans of backward branches) with the count of instructions,
shared-memory loads, conversions (I2F, F2F), MUFU and FP64 adds in
each. Exits non-zero when a turn fails.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import kernelkit as kit

TOOLS = os.path.dirname(os.path.abspath(__file__))
SHAPE = dict(G=7, P=100, k=1024, R=196608, pad=1000, seed=5)


def inputs(torch, G, P, k, R, pad, seed, device='cuda'):
    """rescore's nine arguments at this shape, from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1000, 500000, (G, k)).astype(np.int64)
    real = R - pad
    pa = np.sort(rng.integers(0, k, (G, real)), axis=1)
    pb = rng.integers(0, k - 1, (G, real))
    pb += pb >= pa                      # never a record of one contig
    for g in range(G):                  # (a, b) order within each group
        o = np.lexsort((pb[g], pa[g]))
        pa[g], pb[g] = pa[g][o], pb[g][o]
    d = rng.integers(-5000, 100000, (G, 4, R)).astype(np.float32)
    w = rng.random((G, R)).astype(np.float32)
    pa = np.concatenate([pa, np.zeros((G, pad), np.int64)], axis=1)
    pb = np.concatenate([pb, np.zeros((G, pad), np.int64)], axis=1)
    d[..., real:] = 0
    w[:, real:] = 0
    order = np.argsort(rng.random((G, P, k)), axis=2)
    ori = rng.integers(0, 2, (G, P, k))
    la = np.take_along_axis(lengths, pa, 1)
    lb = np.take_along_axis(lengths, pb, 1)
    i32 = [torch.as_tensor(x.astype(np.int32), device=device)
           for x in (order, ori)]
    rec = [torch.as_tensor(x.astype(np.int32), device=device)
           for x in (pa, pb, la, lb)]
    return i32 + [torch.as_tensor(lengths, device=device)] + rec + [
        torch.as_tensor(d, device=device), torch.as_tensor(w, device=device)]


def measure(torch, fn, reps):
    """fn's ms a call by CUDA events, its device kernels by the profiler
    and its host us a call; fn is called with no argument."""
    import time
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    calls = 5
    ev = kit.kernel_events(fn, calls)
    per = len(ev) // calls
    first, prev = [], None
    for name, start, end in ev[-per:] if per else []:
        first.append({'name': name[:80], 'us': end - start,
                      'gap_before_us': None if prev is None
                      else start - prev})
        prev = end
    dev_us = sum(end - start for _, start, end in ev) / calls
    return {'ms': ms, 'device_us': dev_us, 'kernels_a_call': len(ev) / calls,
            'host_us': host_us, 'last_call': first}


def digest(torch, out) -> str:
    """A hash of the outputs' bits, from two exact integer sums of each
    taken on the card (plain and position-weighted)."""
    import hashlib
    h = hashlib.sha256()
    for x in out if isinstance(out, tuple) else (out,):
        v = x.contiguous().view(torch.int32).flatten().long()
        wgt = torch.arange(v.numel(), device=v.device) % 65521 + 1
        h.update(repr((v.numel(), int(v.sum()), int((v * wgt).sum())))
                 .encode())
    return h.hexdigest()[:16]


TURN = r'''
import json, sys
import torch
tree, cfg = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, tree)
sys.path.insert(1, cfg['tools'])
import ab_rescore as ab
from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels import rescore as krs
lib = kbuild.build(['rescore_population'])['rescore_population']
args = ab.inputs(torch, **cfg['shape'])
out = {'label': cfg['label'], 'tree': tree,
       'device': torch.cuda.get_device_name(0), 'library': lib}
for mode, caches in (('scores', False), ('caches', True)):
    out[mode] = ab.measure(torch, lambda: krs.rescore(*args, caches=caches),
                           cfg['reps'])
    out[mode]['sha'] = ab.digest(torch, krs.rescore(*args, caches=caches))
log = kbuild.BUILD_LOG.get('rescore_population', '')
out['nvcc'] = [ln for ln in log.splitlines() if 'rescore_kernel' in ln
               or 'registers' in ln]
print(json.dumps(out), flush=True)
'''

# B's kernel: its table build's share (see the module's docstring)
PROLOGUE = r'''
import ctypes, json, sys
import torch
tree, cfg = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, tree)
sys.path.insert(1, cfg['tools'])
import ab_rescore as ab
from haphic_tpu_torch.kernels import rescore as krs
dev = torch.device('cuda', torch.cuda.current_device())
sms = torch.cuda.get_device_properties(dev).multi_processor_count
reps = cfg['reps']


def timed(args, caches):
    fn = lambda: krs.rescore(*args, caches=caches)
    ms = ab.measure(torch, fn, reps)['ms']
    ev = ab.kit.kernel_events(fn, 10)
    return {'ms': ms, 'device_ms': sum(e - s for _, s, e in ev) / 1e3
            / max(1, len(ev)), 'kernels': len(ev),
            'sha': ab.digest(torch, fn())}


def force_m(G, P, k, R, caches, m):
    """Replaces the cached plan of this shape by one of m chunks a CTA;
    returns its CTAs."""
    p = krs.plan(dev, G, P, k, R)
    q = (ctypes.c_int64 * 12)(*p)
    o = 2 + 5 * caches
    q[o + 3] = m
    q[o + 4] = -(-q[1] // m)
    krs._PLANS[(dev.index, G, P, k, R)] = q
    return G * q[o + 2] * q[o + 4]


shape = cfg['shape']
P, k = shape['P'], shape['k']
for mode, caches in (('scores', False), ('caches', True)):
    line = {'prologue': mode, 'device': torch.cuda.get_device_name(0),
            'sms': sms}
    p = krs.plan(dev, 1, P, k, shape['R'])
    chunk, tile = p[0], p[2 + 5 * caches]
    # one CTA a (group, tile), at most one an SM, all chunks in it
    G = max(1, sms // -(-P // tile))
    line['sweep'] = []
    for R in [512] + [n * chunk for n in (1, 2, 3, 4)]:
        args = ab.inputs(torch, G, P, k, R, 0, 7)
        nchunks = -(-R // chunk)
        ctas = force_m(G, P, k, R, caches, nchunks)
        line['sweep'].append(dict(timed(args, caches), G=G, R=R,
                                  nchunks=nchunks, tile=tile, ctas=ctas))
        krs._PLANS.clear()
        del args
    args = ab.inputs(torch, **shape)
    G, R = shape['G'], shape['R']
    p = krs.plan(dev, G, P, k, R)
    nchunks, picked = p[1], p[2 + 5 * caches + 3]
    line.update(G=G, R=R, nchunks=nchunks, picked_m=picked, by_m=[])
    for m in sorted({1, 2, 3, 4, 6, 8, 12, nchunks, picked}):
        ctas = force_m(G, P, k, R, caches, m)
        line['by_m'].append(dict(timed(args, caches), m=m, ctas=ctas))
    krs._PLANS.clear()
    del args
    print(json.dumps(line), flush=True)
'''


def sass_loops(text: str) -> dict:
    """Per function of a cuobjdump -sass listing: its instruction count
    and its loops, the spans [target, branch] of backward branches, with
    the instructions of each kind inside."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?);', line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    kinds = {'LDS': r'\bLDS', 'I2F': r'\bI2F', 'F2F': r'\bF2F',
             'MUFU': r'\bMUFU', 'DADD': r'\bDADD', 'STG': r'\bSTG',
             'LDG': r'\bLDG', 'SHFL': r'\bSHFL'}
    out = {}
    for name, ins in funcs.items():
        if 'rescore' not in name:
            continue
        loops = []
        for addr, op in ins:
            m = re.search(r'\bBRA(?:\.\w+)*\s+(?:\S+,\s*)?0x([0-9a-f]+)', op)
            if m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                body = [o for a, o in ins if lo <= a <= addr]
                loops.append({'from': hex(lo), 'to': hex(addr),
                              'instructions': len(body),
                              **{k: sum(bool(re.search(p, o)) for o in body)
                                 for k, p in kinds.items()}})
        loops.sort(key=lambda x: -x['instructions'])
        out[name] = {'instructions': len(ins), 'loops': loops[:4]}
    return out


def child(tree, cfg, script=TURN):
    run = subprocess.run([sys.executable, '-c', script, tree,
                          json.dumps(cfg)],
                         cwd=tree, stdout=subprocess.PIPE, text=True)
    if run.returncode != 0:
        raise SystemExit('ab_rescore: {} exited {}'.format(tree,
                                                           run.returncode))
    return [json.loads(ln) for ln in run.stdout.splitlines()
            if ln.startswith('{')]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('a_dir')
    ap.add_argument('b_dir')
    ap.add_argument('--order', default='ABBA')
    ap.add_argument('--reps', type=int, default=50)
    ap.add_argument('--prologue', action='store_true',
                    help="time B's table build against its chunks")
    ap.add_argument('--sass', help='directory for the SASS listings')
    args = ap.parse_args(argv)
    trees = {'A': os.path.abspath(args.a_dir), 'B': os.path.abspath(args.b_dir)}
    libs = {}
    for turn, label in enumerate(args.order):
        cfg = {'label': label, 'tools': TOOLS, 'shape': SHAPE,
               'reps': args.reps}
        (line,) = child(trees[label], cfg)
        libs[label] = line.pop('library')
        print(json.dumps(dict(line, turn=turn)), flush=True)
    if args.prologue:
        cfg = {'tools': TOOLS, 'shape': SHAPE, 'reps': args.reps}
        for line in child(trees['B'], cfg, PROLOGUE):
            print(json.dumps(line), flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = shutil.which('cuobjdump') or os.path.join(
            os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
        for key, path in sorted(libs.items()):
            text = subprocess.run([cuobjdump, '-sass', path],
                                  stdout=subprocess.PIPE, text=True).stdout
            with open(os.path.join(args.sass, key + '.sass'), 'w') as f:
                f.write(text)
            print(json.dumps({'sass': key, 'kernels': sass_loops(text)}),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

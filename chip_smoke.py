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
             at a small shape and at the shapes the pipeline gave it,
             with CUDA-event times and the least time the card could
             take for the same work. score_population: max relative
             error <= 1e-5 (the sums run in another order).
             delta_generation (one launch per generation: delta,
             acceptance, commit, slot tables), on a GA state built by
             _Records.caches from a random population and one set of
             moves, against the plain step: delta within 1e-6 x |score|
             of the plain version's (sums in another order) where
             |delta| <= |score|, and on every row within half an ulp of
             the exact sum of the plain version's f32 terms (plus the
             f64 sums' own error); equal acceptance wherever
             |delta - thr| exceeds what the two may differ by; a repeat
             run bit-identical, and, under one acceptance mask, exactly
             equal caches, contributions, order, ori, L_slot and
             startsx, scores exactly score + delta; the same for moves
             over the whole tour
             (more touched records than the kernel keeps in shared
             memory); with no move, delta exactly 0 and the state
             unchanged. The bound is the function's least work
             (changed pairs; bound_touched_ms reads every touched
             pair); the figure that also reads the two slots of every
             pair stays beside it as bound_scan_ms.
4. sparse_pipeline
             the same pipeline through the default `auto` route on 24
             chromosomes x 1000 contigs x 20 kb (480 Mb, n = 24,000
             fragments, past SPARSE_MIN_N) with 6,000,000 pairs, seed
             17, the same flags and cut: the MCL sweep must run on the
             sparse top-K engine on the card, the GA and its kernels on
             the card (launch counts set to 0 just before and read just
             after), and the scaffolds must recover the 24 chromosomes.
             Prints n, K, the input columns over K, iterations per
             inflation, the K of each shrink per inflation batch, the
             sweep seconds, stage and wall seconds, peak card memory.
5. sparse_step
             the sparse engine on the card against the same engine on
             the CPU on a 96-fragment block matrix (equal partitions and
             iterations); then the sparse pipeline's first sweep step
             (B=4, n+1, K=128, from the first-iteration state), rerun
             with the arguments the pipeline gave it, timed with CUDA
             events, its peak card memory, and its device time from
             torch.profiler split by op and by kernel, each with its
             share.
6. polyploid_pipeline
             the pipeline phase's genome made tetraploid
             (make_polyploid_sim: chr1-4 and chr5-8 are the haplotypes
             of two chromosomes, allelic Hi-C pairs between them, four
             GFAs, a UL BAM) with --remove_allelic_links 4
             --remove_concentrated_links --gfa --ul and the same flags
             and cut: allelic pairs removed (through the clique search
             at ploidy 4), UL paths found, the MCL and the GA with both
             kernels on the card (launch counts as above), the 8
             chromosomes recovered. Prints the allelic and non-max
             pairs, allele groups, UL paths, stage and wall seconds,
             peak card memory.
7. correct_pipeline
             the pipeline phase's genome with 40 chimeric contigs
             (make_chimera_sim) and --correct_nrounds 2: at least 36
             chimeras broken (corrected_ctgs.txt), the MCL and the GA
             on the card as above, the 8 chromosomes recovered with
             each corrected fragment counted with the contig most of it
             lies in. Prints the chimeras broken, correct_s (the
             correction pass, inside cluster_s.parse), stage and wall
             seconds, peak card memory.
8. allhic    `cli.main(["allhic", group, clm, "--resume"])` on the card
             at the users' defaults (--npop 100 --ngen 5000 --seed 42) on
             the largest group of the pipeline phase (k = 1000 contigs,
             its group file and split CLM from 02.reassign), hot-started
             from that pipeline's own 03.sort tour: the GA must run on
             the card (work above NATIVE_MAX_WORK) with both kernels
             (launch counts set to 0 just before and read just after,
             one delta launch per delta generation the GA reports), the
             tour must be a permutation of the group, its >GA5000 score
             at least the hot start's, and `--resume --skipGA` on it
             must score it within 1e-5 relative of that line. Prints the
             work, route, seconds, generations per second, launches and
             peak card memory.
9. post      on the pipeline phase's output: plot's contact map
             (`post.plot.contact_map`, the part of `plot` before
             drawing) of 04.build/scaffolds.agp and the 2M pairs at
             20 kb bins (8,040 bins, a 65M-cell int64 matrix), on the
             card and on the CPU in this process: raw and symmetrised
             matrices equal cell for cell, the KR vectors, the
             normalised matrix and vmax within 1e-9 relative; then the
             same from the card's cache with --normalization log10.
             Prints bins, seconds (accumulate, normalize) on each side,
             KR iterations on each side and peak card memory. Then
             `juicer pre` on scaffolds.raw.agp and the pairs and `juicer
             post` of the unedited review: the input's scaffolds come
             back (same contigs, order and orientation); and `refsort`
             with a PAF of every contig aligned whole to its simulated
             chromosome: each of the 8 scaffolds on its own chromosome.
10. sim      `cli.main(["sim", "ga_study", "--ks", "50,200,500,1000",
             "--ngen", "5000", "--npop", "100", "--backend", "device"])`
             on the card (docs/GA_VALIDATION.md's sizes and settings):
             per k a truth rescoring and a cold and a hot GA run, every
             one on the card with both kernels (launch counts set to 0
             just before and read just after: one score launch per GA
             call, one delta launch per delta generation the GA
             reports). Every run's history may fall by no more than
             1e-6 of its score (f32 rounding when a window rescores its
             caches) and every run ends above its start; every hot run
             reaches 0.9 of the truth's score and Spearman >= 0.9
             against the simulated order (the hot start's own Spearman
             is above 0.9 already: adjacent swaps barely move it, flips
             not at all, so the score bar is the one a GA that stood
             still would fail). The arguments of every GA call's score
             launch and of each run's SIM_CHECK_GEN-th delta launch are
             kept on the host, and after the study each kernel is rerun
             on them against its plain version (the checks of phase 3)
             at the shapes the study gave it. Prints one line per run
             (k, start, records, scores, start and final Spearman,
             seconds, generations per second), one per checked GA call,
             then the launches, seconds and peak card memory. Then two
             host
             tools through the CLI: `sim score_statistics` on the allhic
             phase's tour must print its >GA5000 score, and `sim
             convert_agp_to_tour` on the pipeline's scaffolds.agp must
             list every W line's contig and orientation in order.
11. kernels  one line listing every kernel (the line before the last):
             `launches` sums the counts of every phase that drives a
             path (pipeline, sparse_pipeline, polyploid_pipeline,
             correct_pipeline, allhic, sim), `launches_by_phase` lists
             them.

The last line is {"ok": true, "device": {...}}. The script exits
non-zero, printing no result, when CUDA is unavailable, when the
package is missing, or when any phase fails.
"""

import contextlib
import io
import json
import logging
import os
import shutil
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, 'build', 'chip_smoke')
DEVICE = 'cuda'

SIM = dict(nchrs=8, ctgs_per_chr=1000, ctg_len=20000, n_pairs=2_000_000,
           seed=17)
# 24,000 one-fragment contigs, past SPARSE_MIN_N: the sparse MCL route
SPARSE_SIM = dict(nchrs=24, ctgs_per_chr=1000, ctg_len=20000,
                  n_pairs=6_000_000, seed=17)
NGEN = 500
# polyploid_pipeline: the tetraploid genome's own draws (make_polyploid_sim)
POLY_SEED = 18
POLY_ALLELIC = 25        # Hi-C pairs per allelic contig pair
POLY_OFFSET = 100        # allelic pairs at (x, x + [0, POLY_OFFSET))
POLY_FIFTH = 100         # every 100th index: a clique of five
UL_EVERY = 10            # UL reads span one in ten junctions
UL_READS = 3             # reads per junction
UL_ALN = 12000           # aligned bases on each side of a junction
# correct_pipeline
CHIMERA_SEED = 19
CHIMERAS = 40
CORRECT_NROUNDS = 2
MIN_BROKEN = 36          # chimeras that must be broken
STEP_REPS = 3            # timed sparse sweep steps
TOP_OPS = 12             # ops and kernels listed for the sparse step
SIM_FLAGS = ['--Nx', '100', '--RE_site_cutoff', '0',
             '--density_lower', '0', '--density_upper', '1',
             '--rank_sum_upper', '1', '--flank', '0',
             '--min_group_len', '0', '--min_RE_sites', '0',
             '--min_links', '1']
PLOT_BIN_KBP = 20        # post: the contact map's bin size
PLOT_TOL = 1e-9          # post: KR vectors and matrices, relative
ALLHIC_NGEN = 5000       # allhic: `--ngen` default
ALLHIC_TOL = 1e-5        # allhic: skip-GA rescoring, relative
# sim: `sim ga_study` at docs/GA_VALIDATION.md's sizes and settings
SIM_KS = [50, 200, 500, 1000]
SIM_NGEN = 5000
SIM_NPOP = 100
SIM_SEED = 42            # `--seed` default; group k simulated from it + k
SIM_MIN_SPEARMAN = 0.9   # every hot run, every k
SIM_MIN_TRUTH = 0.9      # every hot run: final score / the truth's
SIM_CHECK_GEN = 2400     # the delta launch of each run rerun (middle)
SIM_FALL_TOL = 1e-6      # history: largest fall, relative to the score
REL_TOL = 1e-5           # score_population, relative
DELTA_TOL = 1e-6         # delta_generation, relative to the row's score
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 (non-tensor)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12

KERNELS = [{
    'name': 'score_population',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/score_population.cu',
    'replaces': 'haphic_tpu/order/optimize.py:470',
}, {
    'name': 'delta_generation',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/delta_generation.cu',
    'replaces': 'haphic_tpu/order/optimize.py:824',
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


def sim_draws(nchrs, ctgs_per_chr, ctg_len, n_pairs, seed):
    """bench.py's make_sim draws, in its order: the contig names and
    sequences, then each pair's two contigs (0-based ids) and 1-based
    positions."""
    rng = np.random.default_rng(seed)
    cpc, L = ctgs_per_chr, ctg_len
    n = nchrs * cpc
    names = ['chr{}_ctg{}'.format(c + 1, i + 1)
             for c in range(nchrs) for i in range(cpc)]
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    seqs = [bases[rng.integers(0, 4, L)].tobytes() for _ in names]
    chrom = rng.integers(0, nchrs, n_pairs)
    i1 = rng.integers(0, cpc, n_pairs)
    off = np.rint(rng.normal(0, 1.2, n_pairs)).astype(np.int64)
    i2 = np.clip(i1 + off, 0, cpc - 1)
    noise = rng.random(n_pairs) < 0.02
    a = np.where(noise, rng.integers(0, n, n_pairs), chrom * cpc + i1)
    b = np.where(noise, rng.integers(0, n, n_pairs), chrom * cpc + i2)
    pa = rng.integers(1, L + 1, n_pairs)
    pb = rng.integers(1, L + 1, n_pairs)
    return names, seqs, a, pa, b, pb


def write_sim(outdir, names, seqs, a, pa, b, pb):
    """asm.fa and hic.pairs, written with plain string joins."""
    os.makedirs(outdir, exist_ok=True)
    fa = os.path.join(outdir, 'asm.fa')
    with open(fa, 'wb') as f:
        for name, seq in zip(names, seqs):
            f.write(b'>' + name.encode() + b'\n')
            f.write(b'\n'.join(seq[s:s + 70] for s in range(0, len(seq), 70)))
            f.write(b'\n')
    pairs = os.path.join(outdir, 'hic.pairs')
    with open(pairs, 'w') as f:
        f.write('## pairs format v1.0\n')
        f.writelines('r{}\t{}\t{}\t{}\t{}\t+\t+\n'.format(
            r, names[x], p, names[y], q) for r, (x, p, y, q) in enumerate(
                zip(a.tolist(), pa.tolist(), b.tolist(), pb.tolist())))
    return fa, pairs


def make_sim(outdir, **sim):
    """The simulated assembly and pairs file of bench.py's make_sim (same
    draws in the same order); no extra flags."""
    return write_sim(outdir, *sim_draws(**sim)) + ([],)


def make_polyploid_sim(outdir, **sim):
    """A tetraploid version of make_sim's genome: chr1-4 are the four
    haplotypes of one chromosome and chr5-8 those of another. Drawn from
    POLY_SEED after the base draws: at every contig index the contigs of
    a haplotype set share POLY_ALLELIC Hi-C pairs at concordant
    positions (x, x + [0, POLY_OFFSET)), and at every POLY_FIFTH-th
    index chr5's contig shares them with chr1-4's as well (a clique of
    five, which the allelic step splits). Beside it one GFA per
    haplotype (haplotype h holds chr h and chr h+4) with read depths
    (none high enough for the depth filter to drop), and a UL
    BAM whose reads span every UL_EVERY-th junction of adjacent contigs.
    Returns the files and the pipeline flags that use them."""
    names, seqs, a, pa, b, pb = sim_draws(**sim)
    nchrs, cpc, L = sim['nchrs'], sim['ctgs_per_chr'], sim['ctg_len']
    rng = np.random.default_rng(POLY_SEED)
    idx = np.arange(cpc)
    sets = (range(0, nchrs // 2), range(nchrs // 2, nchrs))
    ca = [h1 * cpc + idx for s in sets for h1 in s for h2 in s if h1 < h2]
    cb = [h2 * cpc + idx for s in sets for h1 in s for h2 in s if h1 < h2]
    fifth = np.arange(POLY_FIFTH // 2, cpc, POLY_FIFTH)
    ca += [h * cpc + fifth for h in sets[0]]
    cb += [sets[1][0] * cpc + fifth for _ in sets[0]]
    xa = np.repeat(np.concatenate(ca), POLY_ALLELIC)
    xb = np.repeat(np.concatenate(cb), POLY_ALLELIC)
    x = rng.integers(1, L - POLY_OFFSET + 1, len(xa))
    y = x + rng.integers(0, POLY_OFFSET, len(xa))
    fa, pairs = write_sim(outdir, names, seqs, np.concatenate((a, xa)),
                          np.concatenate((pa, x)), np.concatenate((b, xb)),
                          np.concatenate((pb, y)))
    depth = rng.integers(25, 36, len(names))
    gfas = []
    for h in sets[0]:
        gfas.append(os.path.join(outdir, 'h{}.gfa'.format(h + 1)))
        with open(gfas[-1], 'w') as f:
            for c in range(len(names)):
                if c // cpc in (h, h + nchrs // 2):
                    f.write('S\t{}\t*\tLN:i:{}\trd:i:{}\n'.format(
                        names[c], L, depth[c]))
    ul = os.path.join(outdir, 'ul.bam')
    junctions = [(c * cpc + i, c * cpc + i + 1) for c in range(nchrs)
                 for i in range(0, cpc - 1, UL_EVERY)]
    write_ul_bam(ul, names, L, junctions)
    return fa, pairs, ['--remove_allelic_links', str(len(sets[0])),
                       '--remove_concentrated_links', '--gfa',
                       ','.join(gfas), '--ul', ul]


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    return (b'\x1f\x8b\x08\x04' + b'\x00' * 6 + struct.pack('<H', 6)
            + b'BC' + struct.pack('<HH', 2, len(cdata) + 25) + cdata
            + struct.pack('<II', zlib.crc32(payload), len(payload)))


def _bam_record(refid, pos, flag, name, cigar, score):
    """One mapped BAM record (MAPQ 60, no mate, no sequence) with an AS
    tag; ``cigar`` is [(op index, length)] in BAM's op numbering."""
    cig = b''.join(struct.pack('<I', (ln << 4) | op) for op, ln in cigar)
    body = struct.pack('<iiBBHHHIiii', refid, pos, len(name) + 1, 60, 0,
                       len(cigar), flag, 0, -1, -1, 0)
    body += name + b'\x00' + cig + b'ASi' + struct.pack('<i', score)
    return struct.pack('<I', len(body)) + body


def write_ul_bam(path, names, ctg_len, junctions):
    """A BAM of UL_READS reads for each junction (a, b): a primary
    record on a's tail (UL_ALN bases, then a soft clip) and a
    supplementary on b's head, both forward."""
    M, S = 0, 4
    recs = []
    for a, b in junctions:
        for r in range(UL_READS):
            name = 'ul_{}_{}_{}'.format(a, b, r).encode()
            recs.append(_bam_record(a, ctg_len - UL_ALN, 0, name,
                                    [(M, UL_ALN), (S, UL_ALN)], 1000))
            recs.append(_bam_record(b, 0, 0x800, name,
                                    [(S, UL_ALN), (M, UL_ALN)], 900))
    text = b'@HD\tVN:1.6\tSO:unknown\n'
    hdr = b'BAM\x01' + struct.pack('<I', len(text)) + text
    hdr += struct.pack('<I', len(names))
    for n in names:
        hdr += struct.pack('<I', len(n) + 1) + n.encode() + b'\x00'
        hdr += struct.pack('<I', ctg_len)
    payload = hdr + b''.join(recs)
    with open(path, 'wb') as f:
        for i in range(0, len(payload), 60000):
            f.write(_bgzf_block(payload[i:i + 60000]))
        f.write(_bgzf_block(b''))         # the BGZF end-of-file block


def make_chimera_sim(outdir, **sim):
    """make_sim's genome with CHIMERAS chimeric contigs: each joins a
    contig of one chromosome to one of another (picked from
    CHIMERA_SEED after the base draws) under the name chimK. The pairs
    are drawn on the original contigs, then their coordinates are
    shifted into the chimera. Returns the files, the pipeline flags, and
    the chimeras as {name: (left contig, right contig)}."""
    names, seqs, a, pa, b, pb = sim_draws(**sim)
    cpc, L = sim['ctgs_per_chr'], sim['ctg_len']
    rng = np.random.default_rng(CHIMERA_SEED)
    chims, pending = [], None
    for c in rng.permutation(len(names)).tolist():
        if pending is None:
            pending = c
        elif pending // cpc != c // cpc:
            chims.append((pending, c))
            pending = None
        if len(chims) == CHIMERAS:
            break
    left = {l: k for k, (l, _) in enumerate(chims)}
    right = {r for _, r in chims}
    new_of = np.zeros(len(names), np.int64)
    shift = np.zeros(len(names), np.int64)
    new_names, new_seqs, table = [], [], {}
    for c in range(len(names)):
        if c in right:
            continue
        new_of[c] = len(new_names)
        if c in left:
            r = chims[left[c]][1]
            new_of[r], shift[r] = len(new_names), L
            new_names.append('chim{}'.format(left[c] + 1))
            new_seqs.append(seqs[c] + seqs[r])
            table[new_names[-1]] = (names[c], names[r])
        else:
            new_names.append(names[c])
            new_seqs.append(seqs[c])
    fa, pairs = write_sim(outdir, new_names, new_seqs, new_of[a],
                          pa + shift[a], new_of[b], pb + shift[b])
    return fa, pairs, ['--correct_nrounds', str(CORRECT_NROUNDS)], table


def chrom_of_name(name):
    """The simulated chromosome of a contig name (chrX_ctgI)."""
    return name.split('_')[0]


def check_partition(agp: str, nchrs: int, chrom_of=chrom_of_name) -> dict:
    """The scaffolds recover the simulated chromosomes as a partition:
    every scaffold holds contigs of one chromosome, and each chromosome
    lies in exactly one scaffold. Components whose ``chrom_of`` is None
    (unbroken chimeras) are left out and counted."""
    scaffolds = {}
    with open(agp) as f:
        for line in f:
            cols = line.rstrip('\n').split('\t')
            if len(cols) >= 9 and cols[4] == 'W':
                scaffolds.setdefault(cols[0], []).append(cols[5])
    chrom_of_scaffold, unknown = {}, 0
    for s, ctgs in scaffolds.items():
        chroms = {chrom_of(c) for c in ctgs}
        unknown += sum(chrom_of(c) is None for c in ctgs)
        chroms.discard(None)
        check(len(chroms) <= 1, 'scaffold {} mixes {}'.format(s, chroms))
        if chroms:
            chrom_of_scaffold[s] = chroms.pop()
    per_chrom = {}
    for s, c in chrom_of_scaffold.items():
        per_chrom.setdefault(c, []).append(s)
    check(len(per_chrom) == nchrs,
          'chromosomes found: {}'.format(sorted(per_chrom)))
    split = {c: v for c, v in per_chrom.items() if len(v) != 1}
    check(not split, 'chromosomes split over scaffolds: {}'.format(split))
    out = {'scaffolds': len(scaffolds),
           'contigs_placed': sum(len(v) for v in scaffolds.values())}
    if unknown:
        out['components_left_out'] = unknown
    return out


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


def _drive_pipeline(torch, cli, kscore, kdelta, sim, sim_dir, out_dir,
                    engine, genome=make_sim, chrom_of=chrom_of_name):
    """``genome`` (make_sim), then `cli.main(["pipeline", ...])` on the
    card with the flags it returns and the kernel launch counts set to 0
    just before and read just after. The MCL sweep must run on the card
    on ``engine``, the GA on the card with both kernels, one
    delta_generation launch per delta generation the GA reports, and the
    scaffolds must recover the simulated chromosomes. Returns (sim
    seconds, wall seconds, metrics, launches, partition summary, output
    directory)."""
    t0 = time.time()
    fa, pairs, flags = genome(os.path.join(WORK, sim_dir), **sim)
    sim_s = time.time() - t0
    out = os.path.join(WORK, out_dir)
    log = MetricsLog()
    logging.getLogger('haphic_tpu_torch').addHandler(log)
    torch.cuda.reset_peak_memory_stats()
    kscore.score_population.launches = 0
    kdelta.delta_generation.launches = 0
    t0 = time.time()
    rc = cli.main(['pipeline', fa, pairs, str(sim['nchrs']), '--outdir',
                   out, '--ngen', str(NGEN)] + SIM_FLAGS + flags)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {'score_population': kscore.score_population.launches,
                'delta_generation': kdelta.delta_generation.launches}
    logging.getLogger('haphic_tpu_torch').removeHandler(log)
    check(rc == 0, 'pipeline exit code {}'.format(rc))
    m = log.metrics
    check(m['mcl_engine'][-1] == engine, 'the MCL sweep ran on the {} '
          'engine, not the {} one'.format(m['mcl_engine'][-1], engine))
    mcl = m['mcl_route'][-1]
    check(mcl == 'cuda', 'the MCL sweep ran on {}, not the card'.format(mcl))
    check(m['ga_route'][-1] == 'cuda',
          'the GA ran on {}, not the card'.format(m['ga_route'][-1]))
    for kname, n in launches.items():
        check(n > 0, 'kernel {} was not launched on the main path'.format(
            kname))
    # the delta generations the GA says it ran, one launch each
    want = sum(m['ga_delta_gens'])
    check(launches['delta_generation'] == want,
          'delta_generation launched {} times for {} delta generations'
          .format(launches['delta_generation'], want))
    agp = os.path.join(out, '04.build', 'scaffolds.agp')
    check(os.path.exists(agp), 'no {}'.format(agp))
    part = check_partition(agp, sim['nchrs'], chrom_of)
    return sim_s, wall, m, launches, part, out


def _run_line(torch, m, sim_s, wall, launches, part):
    """The keys every pipeline phase line ends with."""
    return {'sim_s': sim_s, 'cut': {'ngen': [5000, NGEN]}, 'n': m['n'][-1],
            'mcl_engine': m['mcl_engine'][-1],
            'mcl_route': m['mcl_route'][-1],
            'cluster_map_s': m['cluster_map_s'][-1],
            'cluster_files_s': m['cluster_files_s'][-1],
            'ga_route': m['ga_route'][-1],
            'ga_delta_gens': sum(m['ga_delta_gens']),
            'stage_s': m['stage_secs'][-1],
            'cluster_s': m['cluster_secs'][-1], 'ga_s': m['ga_secs'][-1],
            'wall_s': wall,
            'max_memory_allocated': torch.cuda.max_memory_allocated(),
            'launches': launches, **part}


def phase_pipeline(torch, cli, kscore, kdelta):
    sim_s, wall, m, launches, part, _ = _drive_pipeline(
        torch, cli, kscore, kdelta, SIM, 'sim', 'out', 'dense')
    batches = m['ga_batch']
    emit({'phase': 'pipeline', 'sim': SIM, 'mcl_batches': m['batches'][-1],
          'mcl_iters_per_inflation': m['n_iters'][-1],
          'records_per_group': m['records'][-1],
          'ga_work': m['ga_work'][-1], 'ga_batches': batches,
          **_run_line(torch, m, sim_s, wall, launches, part)})
    big = max(batches, key=lambda b: b['G'] * b['R_pad'])
    return launches, big


def phase_polyploid_pipeline(torch, cli, kscore, kdelta):
    """The tetraploid genome (make_polyploid_sim) with
    --remove_allelic_links 4 --remove_concentrated_links --gfa (four
    haplotypes) --ul: allelic pairs found and removed through the clique
    search, the UL paths found, and the 8 chromosomes recovered with
    the MCL and the GA on the card."""
    sim_s, wall, m, launches, part, _ = _drive_pipeline(
        torch, cli, kscore, kdelta, SIM, 'poly_sim', 'poly_out', 'dense',
        genome=make_polyploid_sim)
    allelic = m['allelic'][-1]
    check(allelic['n_allelic_pairs'] > 0, 'no allelic pair was removed')
    check(allelic['largest_allele_group'] == 4, 'allele groups of {} '
          'contigs at ploidy 4'.format(allelic['largest_allele_group']))
    check(m['ul_paths'][-1] > 0, 'no UL path was found')
    emit({'phase': 'polyploid_pipeline', 'sim': SIM,
          'genome': {'ploidy': 4, 'allelic_pairs_per_contig_pair':
                     POLY_ALLELIC, 'fifth_every': POLY_FIFTH,
                     'ul_every': UL_EVERY, 'ul_reads': UL_READS},
          **allelic, 'ul_paths': m['ul_paths'][-1],
          **_run_line(torch, m, sim_s, wall, launches, part)})
    return launches


def _chimera_chrom_of(table, ctg_len):
    """chrom_of for the chimera genome's components: a corrected
    fragment (name:start-end) takes the chromosome of the contig most of
    it lies in; an unbroken chimera has none."""
    def chrom_of(name):
        raw, _, span = name.partition(':')
        if raw not in table:
            return chrom_of_name(raw)
        if not span:
            return None
        s, e = (int(v) for v in span.split('-'))
        in_left = max(0, min(e, ctg_len) - s + 1)
        return chrom_of_name(table[raw][in_left * 2 < e - s + 1])
    return chrom_of


def phase_correct_pipeline(torch, cli, kscore, kdelta):
    """make_sim's genome with CHIMERAS chimeric contigs and
    --correct_nrounds 2: at least MIN_BROKEN chimeras broken (from
    corrected_ctgs.txt), and the 8 chromosomes recovered with the MCL
    and the GA on the card, each corrected fragment counted with the
    contig most of it lies in."""
    table = {}

    def genome(outdir, **sim):
        fa, pairs, flags, chims = make_chimera_sim(outdir, **sim)
        table.update(chims)
        return fa, pairs, flags

    chrom_of = _chimera_chrom_of(table, SIM['ctg_len'])
    sim_s, wall, m, launches, part, out = _drive_pipeline(
        torch, cli, kscore, kdelta, SIM, 'chimera_sim', 'chimera_out',
        'dense', genome=genome, chrom_of=chrom_of)
    with open(os.path.join(out, '01.cluster', 'corrected_ctgs.txt')) as f:
        broken = {line.split(':')[0] for line in f if line.strip()}
    n_chims = len(broken & set(table))
    check(n_chims >= MIN_BROKEN, '{} of {} chimeras broken'.format(
        n_chims, len(table)))
    emit({'phase': 'correct_pipeline', 'sim': SIM, 'chimeras': len(table),
          'correct_nrounds': CORRECT_NROUNDS, 'chimeras_broken': n_chims,
          'other_contigs_broken': len(broken) - n_chims,
          'correct_s': m['cluster_secs'][-1]['correct'],
          **_run_line(torch, m, sim_s, wall, launches, part)})
    return launches


def phase_sparse_pipeline(torch, cli, kscore, kdelta, sp, sparse_min_n):
    """The default route past SPARSE_MIN_N: the same pipeline on a
    genome of SPARSE_SIM['nchrs'] * SPARSE_SIM['ctgs_per_chr'] one-
    fragment contigs runs the sparse top-K MCL engine. Returns the
    arguments of the engine's first sweep step, as the pipeline passed
    them, for phase_sparse_step, and the launch counts."""
    first = []
    step = sp._sweep_step

    def recording(*args):
        if not first:
            # the host loop updates `active` in place after each step
            first.append(args[:3] + (args[3].copy(),) + args[4:])
        return step(*args)

    sp._sweep_step = recording
    try:
        sim_s, wall, m, launches, part, _ = _drive_pipeline(
            torch, cli, kscore, kdelta, SPARSE_SIM, 'sparse_sim',
            'sparse_out', 'sparse')
    finally:
        sp._sweep_step = step
    check(first, 'the sparse engine ran no sweep step')
    check(m['n'][-1] >= sparse_min_n, 'n={} is below SPARSE_MIN_N={}'
          .format(m['n'][-1], sparse_min_n))
    emit({'phase': 'sparse_pipeline', 'sim': SPARSE_SIM, 'K': m['K'][-1],
          'overflow_cols': m['overflow_cols'][-1],
          'mcl_batches': m['batches'][-1],
          'mcl_iters_per_inflation': m['n_iters'][-1],
          'k_steps_per_batch': m['k_steps'][-1],
          'sweep_s': m['sweep_s'][-1], 'interpret_s': m['interpret_s'][-1],
          'clusters_per_inflation': m['clusters_per_inflation'][-1],
          **_run_line(torch, m, sim_s, wall, launches, part)})
    return first[0], launches


def _block_coo(n, n_blocks, seed):
    """Upper-triangle COO of a symmetric matrix of dense random blocks
    plus sparse noise links."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n))
    per = n // n_blocks
    for b in range(n_blocks):
        w = rng.integers(5, 60, (per, per)) * (rng.random((per, per)) < 0.5)
        blk = np.triu(w, 1)
        m[b * per:(b + 1) * per, b * per:(b + 1) * per] += blk + blk.T
    a, c = rng.integers(0, n, (2, 4 * n))
    np.add.at(m, (a, c), 1.0)
    np.add.at(m, (c, a), 1.0)
    i, j = np.nonzero(np.triu(m, 1))
    return i, j, m[i, j]


def _device_ops(torch, prof, top):
    """Device time of a profile, by op and by kernel. Each kernel's time
    counts once, in the innermost torch op that launched it (the ops'
    self device times) and under its own name (the kernels'). Returns
    (device ms, the ``top`` ops, the ``top`` kernels), each with its
    share of the device ms."""
    def dev_us(e):
        for attr in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0
    ops, kernels = [], []
    for e in prof.key_averages():
        us = dev_us(e)
        if us > 0:
            on_card = e.device_type == torch.autograd.DeviceType.CUDA
            (kernels if on_card else ops).append((e.key, us, e.count))
    total = sum(r[1] for r in kernels)

    def rows(lst):
        lst.sort(key=lambda r: -r[1])
        return [{'name': k[:120], 'ms': us / 1e3, 'calls': c,
                 'share': us / total} for k, us, c in lst[:top]]
    return total / 1e3, rows(ops), rows(kernels)


def phase_sparse_step(torch, sp, first_step):
    """The sparse pipeline's first sweep step (its first inflation
    batch, from its first-iteration state), again with the arguments
    the pipeline gave it, timed with CUDA events and profiled by op.
    Before it, the engine on the card against the engine on the
    CPU on a small block matrix: equal partitions and iterations."""
    i, j, w = _block_coo(96, 4, 2)
    infl = [1.2, 1.5, 2.0, 2.8]
    got = sp.run_mcl_sparse(i, j, w, 96, infl, K=48, max_iter=80,
                            device=DEVICE)
    want = sp.run_mcl_sparse(i, j, w, 96, infl, K=48, max_iter=80,
                             device='cpu')
    check(np.array_equal(got.n_iters, want.n_iters),
          'sparse MCL iterations on the card {} vs the CPU {}'.format(
              got.n_iters.tolist(), want.n_iters.tolist()))
    parts = [got.interpret(b) for b in range(len(infl))]
    check(parts == [want.interpret(b) for b in range(len(infl))]
          and None not in parts,
          'sparse MCL partitions differ between the card and the CPU')

    si, sv, f, active, n, K, chunk, pruning, expansion = first_step
    B = si.shape[0]

    def step():
        return sp._sweep_step(si, sv, f, active, n, K, chunk, pruning,
                              expansion)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(torch, step, STEP_REPS)
    peak = torch.cuda.max_memory_allocated()
    ni, nv, stat, max_nnz = step()
    check(bool(torch.isfinite(nv).all()) and int(max_nnz) <= K
          and bool((ni[:, n] == n).all()),
          'sparse step output: not finite, too wide or sentinel set')
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy_ms, ops, kernels = _device_ops(torch, prof, TOP_OPS)
    emit({'phase': 'sparse_step', 'B': B, 'n_plus_1': n + 1, 'K': K,
          'chunk': chunk, 'chunks': -(-(n + 1) // chunk),
          'candidates': B * (n + 1) * K * K, 'ms': ms, 'reps': STEP_REPS,
          'profiled_device_ms': busy_ms, 'max_nnz': int(max_nnz),
          'max_memory_allocated': peak, 'top_device_ops': ops,
          'top_device_kernels': kernels,
          'small_n_iters': got.n_iters.tolist()})


def _count_rows(path):
    with open(path) as f:
        return sum(1 for line in f if line.strip()
                   and not line.startswith('#'))


@contextlib.contextmanager
def _recorded_tours(topt):
    """Every topt.optimize_tour call made inside the block, in order:
    {'kw': its keyword arguments, 'result': the GA's result, 'wall':
    its seconds (it ends reading the result to the host)}. The CLI
    writes only files; this keeps the GA's own results."""
    calls = []
    optimize_tour = topt.optimize_tour

    def recording(*args, **kw):
        t0 = time.time()
        res = optimize_tour(*args, **kw)
        calls.append({'kw': kw, 'result': res, 'wall': time.time() - t0})
        return res

    topt.optimize_tour = recording
    try:
        yield calls
    finally:
        topt.optimize_tour = optimize_tour


def phase_allhic(torch, cli, kscore, kdelta, topt, out):
    """`allhic --resume` at its defaults on the card, on the largest
    group of the pipeline run in ``out``, hot-started from its 03.sort
    tour; then `--resume --skipGA` rescores the result."""
    from haphic_tpu_torch.io.artifacts import (parse_group_file,
                                               parse_tour_file)
    gdir = os.path.join(out, '02.reassign', 'final_groups')
    sizes = {f: _count_rows(os.path.join(gdir, f))
             for f in sorted(os.listdir(gdir))
             if f.startswith('group') and f.endswith('.txt')}
    gfile = max(sizes, key=sizes.get)
    prefix = os.path.splitext(gfile)[0]
    group = os.path.join(gdir, gfile)
    clm = os.path.join(out, '02.reassign', 'split_clms', prefix + '.clm')
    run_dir = os.path.join(WORK, 'allhic')
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    tour = os.path.join(run_dir, prefix + '.tour')
    shutil.copy(os.path.join(out, '03.sort', prefix + '.tour'), tour)
    log = MetricsLog()
    logging.getLogger('haphic_tpu_torch').addHandler(log)
    cwd = os.getcwd()
    with _recorded_tours(topt) as calls:
        os.chdir(run_dir)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kscore.score_population.launches = 0
            kdelta.delta_generation.launches = 0
            t0 = time.time()
            rc = cli.main(['allhic', group, clm, '--resume'])
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = {'score_population': kscore.score_population.launches,
                        'delta_generation': kdelta.delta_generation.launches}
            peak = torch.cuda.max_memory_allocated()
            check(rc == 0, 'allhic exit code {}'.format(rc))
            m = {k: v[-1] for k, v in log.metrics.items()}
            delta_gens = m.get('ga_delta_gens')
            with open(tour, 'rb') as f:
                ga_bytes = f.read()
            rc = cli.main(['allhic', group, clm, '--resume', '--skipGA'])
            check(rc == 0, 'allhic --skipGA exit code {}'.format(rc))
            skip_route = log.metrics['ga_route'][-1]
        finally:
            os.chdir(cwd)
            logging.getLogger('haphic_tpu_torch').removeHandler(log)
    check(m['ga_route'] == DEVICE,
          'allhic ran its GA on {}, not the card'.format(m['ga_route']))
    for kname, n in launches.items():
        check(n > 0, 'kernel {} was not launched by allhic'.format(kname))
    check(launches['delta_generation'] == delta_gens,
          'delta_generation launched {} times for {} delta generations'
          .format(launches['delta_generation'], delta_gens))
    names = sorted(c for c, _, __ in parse_group_file(group))
    final = parse_tour_file(os.path.join(run_dir, prefix + '.tour.sav'))
    check(sorted(c for c, _ in final) == names
          and {o for _, o in final} <= {'+', '-'},
          'the allhic tour is not a permutation of the group')
    with open(os.path.join(run_dir, prefix + '.tour.sav'), 'rb') as f:
        check(f.read() == ga_bytes, '--resume did not keep the GA tour '
              'as .tour.sav')
    check(parse_tour_file(tour) == final,
          '--resume --skipGA changed the tour')
    last = [l for l in ga_bytes.decode().splitlines()
            if l.startswith('>GA')][-1]
    gen, ga_score = last[3:].split('-', 1)
    ga_score = float(ga_score)
    res, skip = (c['result'] for c in calls)
    hot_score = res.history[0][1]
    check(int(gen) == ALLHIC_NGEN and res.history[-1][0] == ALLHIC_NGEN,
          'the last GA line is {}'.format(last))
    check(res.score >= hot_score, 'the >GA{} score {} is below the hot '
          "start's {}".format(gen, res.score, hot_score))
    rel = abs(skip.score - ga_score) / abs(ga_score)
    check(rel <= ALLHIC_TOL, '--skipGA scores the tour {}, its GA line {} '
          '(relative {})'.format(skip.score, ga_score, rel))
    emit({'phase': 'allhic', 'group': prefix, 'k': len(names),
          'records': m['records'][0], 'ga_work': m['ga_work'],
          'ga_route': m['ga_route'], 'ga_batch': m['ga_batch'],
          'ngen': ALLHIC_NGEN, 'ga_delta_gens': delta_gens,
          'hot_score': hot_score, 'ga_score': ga_score,
          'skip_ga_score': skip.score, 'skip_ga_rel_err': rel,
          'skip_ga_route': skip_route, 'wall_s': secs,
          'generations_per_s': ALLHIC_NGEN / secs, 'launches': launches,
          'max_memory_allocated': peak})
    # the launch counts; the GA's tour (kept as .tour.sav by --resume)
    # and its last score as the file writes it
    return launches, (os.path.join(run_dir, prefix + '.tour.sav'),
                      last.split('-', 1)[1])


def _w_lines(agp):
    """[[(contig, start, end, orientation), ...] per scaffold], in file
    order."""
    out, index = [], {}
    with open(agp) as f:
        for line in f:
            cols = line.split()
            if len(cols) >= 9 and cols[4] == 'W':
                if cols[0] not in index:
                    index[cols[0]] = len(out)
                    out.append([])
                out[index[cols[0]]].append(tuple(cols[5:9]))
    return out


def _contact_maps(torch, plot, agp, alignments, out, normalization):
    """plot.contact_map on the card, then on the CPU, of the same
    inputs; the card's peak memory."""
    runs = {}
    for dev in (DEVICE, 'cpu'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[dev] = plot.contact_map(
            agp, alignments, outdir=os.path.join(out, dev),
            bin_size_kbp=PLOT_BIN_KBP, normalization=normalization,
            device=dev)
        if dev == DEVICE:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
    return runs[DEVICE], runs['cpu'], peak


def _max_rel(torch, got, want):
    """Largest |got - want| / |want| (0 where both are 0)."""
    want = want.to(got.device)
    err = (got - want).abs()
    return float(torch.where(err == 0, torch.zeros_like(err),
                             err / want.abs()).max())


def phase_post(torch, out, sim_dir, sim):
    """plot's contact map (card against CPU), juicer pre/post and
    refsort on the pipeline run in ``out`` and its pairs."""
    from haphic_tpu_torch.post import juicer, plot, refsort
    agp = os.path.join(out, '04.build', 'scaffolds.agp')
    raw_agp = os.path.join(out, '04.build', 'scaffolds.raw.agp')
    pairs = os.path.join(sim_dir, 'hic.pairs')
    pdir = os.path.join(WORK, 'plot')
    shutil.rmtree(pdir, ignore_errors=True)
    lines = []
    for norm, source in (('KR', pairs), ('log10', os.path.join(
            pdir, 'KR', DEVICE, 'contact_matrix.pkl'))):
        got, want, peak = _contact_maps(torch, plot, agp, source,
                                        os.path.join(pdir, norm), norm)
        if got.raw is not None:
            check(torch.equal(got.raw.cpu(), want.raw),
                  'raw contact matrices differ between card and CPU')
        check(torch.equal(got.matrix.cpu(), want.matrix),
              'symmetrised contact matrices differ between card and CPU')
        if got.raw is not None:
            with open(os.path.join(pdir, norm, DEVICE,
                                   'contact_matrix.pkl'), 'rb') as f, \
                    open(os.path.join(pdir, norm, 'cpu',
                                      'contact_matrix.pkl'), 'rb') as g:
                check(f.read() == g.read(), 'the card and the CPU wrote '
                      'different contact_matrix.pkl')
        errs = {'norm': _max_rel(torch, got.norm, want.norm),
                'vmax': 0.0 if got.vmax == want.vmax else
                abs(got.vmax - want.vmax) / abs(want.vmax)}
        check(len(got.kr_vectors) == len(want.kr_vectors),
              'KR calls differ between card and CPU')
        if got.kr_vectors:
            errs['kr_vectors'] = max(_max_rel(torch, g, w) for g, w in
                                     zip(got.kr_vectors, want.kr_vectors))
        for what, err in errs.items():
            check(err <= PLOT_TOL, '{} {}: card and CPU differ by {} '
                  'relative'.format(norm, what, err))
        lines.append({'normalization': norm,
                      'source': os.path.basename(source),
                      'bins': got.bi.total_bins,
                      'cells': got.bi.total_bins ** 2,
                      'contacts': int(got.matrix.sum()),
                      'card_s': {'accumulate': got.accumulate_s,
                                 'normalize': got.normalize_s},
                      'cpu_s': {'accumulate': want.accumulate_s,
                                'normalize': want.normalize_s},
                      'kr_iters_card': got.kr_iters,
                      'kr_iters_cpu': want.kr_iters,
                      'kr_iters_equal': got.kr_iters == want.kr_iters,
                      'max_rel_err': errs, 'vmax': got.vmax,
                      'max_memory_allocated': peak})
        del got, want
        torch.cuda.empty_cache()

    jdir = os.path.join(WORK, 'juicer')
    shutil.rmtree(jdir, ignore_errors=True)
    os.makedirs(jdir)
    t0 = time.time()
    txt = juicer.juicer_pre(raw_agp, pairs, outdir=jdir)
    pre_s = time.time() - t0
    n_written = _count_rows(txt)
    t0 = time.time()
    final = juicer.juicer_post(os.path.join(jdir, 'out_JBAT.assembly'),
                               os.path.join(jdir, 'out_JBAT.liftover.agp'),
                               outdir=jdir)
    post_s = time.time() - t0
    scaffolds = _w_lines(raw_agp)
    check(_w_lines(final) == scaffolds, 'juicer post of the unedited '
          'review does not give back the input scaffolds')
    check(n_written > 0, 'juicer pre wrote no pairs')

    # the simulated truth as a PAF: each contig aligned whole, forward,
    # at its offset on its chromosome
    cpc, L = sim['ctgs_per_chr'], sim['ctg_len']
    paf = os.path.join(WORK, 'truth.paf')
    with open(paf, 'w') as f:
        for c in range(sim['nchrs']):
            for i in range(cpc):
                f.write('chr{0}_ctg{1}\t{2}\t0\t{2}\t+\tchr{0}\t{3}\t{4}\t'
                        '{5}\t{2}\t{2}\t60\n'.format(
                            c + 1, i + 1, L, cpc * L, i * L, (i + 1) * L))
    buf = io.StringIO()
    t0 = time.time()
    refsort.run_refsort(agp, paf, out=buf)
    refsort_s = time.time() - t0
    placed = {}
    for line in buf.getvalue().splitlines():
        cols = line.split('\t')
        if len(cols) >= 9 and cols[4] == 'W' and cols[0].count(':') == 2:
            placed.setdefault(cols[0], set()).add(
                chrom_of_name(cols[5]))
    refs = {name.split(':')[1] for name in placed}
    check(len(placed) == sim['nchrs'] and len(refs) == sim['nchrs']
          and all(chroms == {name.split(':')[1]}
                  for name, chroms in placed.items()),
          'refsort placed {}'.format(sorted(placed)))
    emit({'phase': 'post', 'bin_kbp': PLOT_BIN_KBP, 'plot': lines,
          'juicer': {'pairs_written': n_written, 'pre_s': pre_s,
                     'post_s': post_s, 'scaffolds': len(scaffolds)},
          'refsort': {'scaffolds_placed': sorted(placed),
                      'seconds': refsort_s}})


@contextlib.contextmanager
def _recorded_launches(topt):
    """Host copies of kernel arguments the GA passes inside the block,
    one entry per score_population call (on the delta route the GA
    scores each batch once, at its start, so an entry is a batch):
    'score' that call's arguments, 'delta' those of the batch's
    SIM_CHECK_GEN-th delta_generation call ((state before the step,
    move, (la, lb, d, w))) or None, 'n_delta' its delta calls, 'copy_s'
    the seconds the copies took. The GA reaches score_population by its
    module's name and the delta kernel's wrapper as _dgen's default
    `step`; both are restored on leaving."""
    batches = []
    score, defaults = topt.score_population, topt._dgen.__defaults__
    (step,) = defaults

    def host(xs):
        return tuple(x.to('cpu', copy=True) for x in xs)

    def recording_score(*args):
        t0 = time.time()
        batches.append({'score': host(args), 'delta': None, 'n_delta': 0})
        batches[-1]['copy_s'] = time.time() - t0
        return score(*args)

    def recording_step(state, move, la, lb, d, w, *rest, **kw):
        b = batches[-1]
        b['n_delta'] += 1
        if b['n_delta'] == SIM_CHECK_GEN:
            t0 = time.time()
            b['delta'] = (host(state), host(move), host((la, lb, d, w)))
            b['copy_s'] += time.time() - t0
        return step(state, move, la, lb, d, w, *rest, **kw)

    topt.score_population = recording_score
    topt._dgen.__defaults__ = (recording_step,)
    try:
        yield batches
    finally:
        topt.score_population = score
        topt._dgen.__defaults__ = defaults


def _check_sim_launches(torch, kscore, kdelta, topt, what, batch):
    """Each kernel rerun on the arguments one GA call gave it
    (_recorded_launches) and held against its plain version, as phase 3
    holds them: score_population within REL_TOL relative; the delta
    generation by _check_delta, then its commit by _check_commit under
    the plain version's acceptance and under all rows accepted."""
    args = [x.to(DEVICE) for x in batch['score']]
    got = kscore.score_population(*args)
    want = kscore.score_population_plain(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          'score kernel output ({})'.format(what))
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= REL_TOL, 'score kernel disagrees ({}): max relative '
          'error {}'.format(what, rel))
    G, P, k = args[0].shape
    row = {'score_population': {'G': G, 'P': P, 'k_pad': k,
                                'R_pad': args[3].shape[1],
                                'max_abs_err': float((got - want).abs()
                                                     .max()),
                                'max_rel_err': rel}}
    del args, got, want
    if batch['delta'] is None:
        return row
    state, move, (la, lb, d, w) = (tuple(x.to(DEVICE) for x in xs)
                                   for xs in batch['delta'])
    rec = types.SimpleNamespace(la=la, lb=lb, d=d, w=w)
    kern, plain = kdelta.delta_generation, kdelta.delta_generation_plain
    got = _run(kern, topt, rec, state, move)
    want = _run(plain, topt, rec, state, move)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got[0]).all()),
          'delta kernel output ({})'.format(what))
    errs = _check_delta(torch, kdelta, topt, what, rec, state, move, got,
                        want)
    mask = want[1]
    del got, want
    # the commit under the acceptance the plain version made, and with
    # every row accepted (late in a run few rows are)
    for label, acc in (('', mask), (', every row', torch.ones_like(mask))):
        got = _run(kern, topt, rec, state, move, acc)
        want = _run(plain, topt, rec, state, move, acc)
        torch.cuda.synchronize()
        _check_commit(torch, 'commit ({}{})'.format(what, label), state[-1],
                      got, want)
        del got, want
    G, P, k = state[0].shape
    row['delta_generation'] = {'G': G, 'P': P, 'k_pad': k,
                               'R_pad': state[4].shape[2],
                               'generation': SIM_CHECK_GEN,
                               'accepted_rows': int(mask.sum()), **errs}
    return row


def phase_sim(torch, cli, kscore, kdelta, topt, out, allhic_tour):
    """`sim ga_study` on the card at GA_VALIDATION's sizes with the
    torch GA forced (--backend device), each kernel then rerun against
    its plain version on arguments the study gave it; then two host
    tools of `sim` on earlier phases' files."""
    from haphic_tpu_torch.sim import ga_study
    run_dir = os.path.join(WORK, 'sim_tools')
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    tsv = os.path.join(run_dir, 'ga_study.tsv')
    log = MetricsLog()
    logging.getLogger('haphic_tpu_torch').addHandler(log)
    # calls and batches in ga_study's order: per k the truth rescoring
    # (skip_ga), the cold run, the hot run
    try:
        with _recorded_tours(topt) as calls, \
                _recorded_launches(topt) as batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kscore.score_population.launches = 0
            kdelta.delta_generation.launches = 0
            t0 = time.time()
            rc = cli.main(['sim', 'ga_study', '--ks',
                           ','.join(map(str, SIM_KS)), '--ngen',
                           str(SIM_NGEN), '--npop', str(SIM_NPOP),
                           '--seed', str(SIM_SEED), '--backend', 'device',
                           '--device', DEVICE, '--out', tsv])
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = {
                'score_population': kscore.score_population.launches,
                'delta_generation': kdelta.delta_generation.launches}
            peak = torch.cuda.max_memory_allocated()
    finally:
        logging.getLogger('haphic_tpu_torch').removeHandler(log)
    check(rc == 0, 'sim ga_study exit code {}'.format(rc))
    routes = log.metrics['ga_route']
    check(len(routes) == 3 * len(SIM_KS) and set(routes) == {DEVICE},
          'ga_study ran its GAs on {}'.format(routes))
    check(launches['score_population'] == 3 * len(SIM_KS)
          == len(calls) == len(batches),
          'score_population launched {} times for {} GA calls'.format(
              launches['score_population'], len(calls)))
    delta_gens = sum(log.metrics['ga_delta_gens'])
    check(launches['delta_generation'] == delta_gens > 0,
          'delta_generation launched {} times for {} delta generations'
          .format(launches['delta_generation'], delta_gens))
    copy_s = sum(b['copy_s'] for b in batches)
    with open(tsv) as f:
        head, *rows = [line.rstrip('\n').split('\t') for line in f]
    check(len(rows) == 2 * len(SIM_KS), 'ga_study wrote {} rows'.format(
        len(rows)))
    for i, cols in enumerate(rows):
        row = dict(zip(head, cols))
        k, start = int(row['k']), row['start']
        call, batch = calls[3 * (i // 2) + 1 + i % 2], \
            batches[3 * (i // 2) + 1 + i % 2]
        res = call['result']
        wall = call['wall'] - batch['copy_s']
        score_truth = calls[3 * (i // 2)]['result'].score
        history = [s for _, s in res.history]
        problem, true_order, _ = ga_study.simulate_group(SIM_SEED + k, k)
        spearman = ga_study.order_spearman(res.order, true_order)
        hot_start = call['kw']['hot_start']
        start_spearman = None if hot_start is None else \
            ga_study.order_spearman(hot_start[0], true_order)
        check((k, start) == (SIM_KS[i // 2], ('cold', 'hot')[i % 2])
              and (hot_start is None) == (start == 'cold'),
              'ga_study row {} is k={} {}'.format(i, k, start))
        # the best score of each window; a window that rescores its
        # caches may round it down by a few f32 ulps (both packages)
        fall = max([(a - b) / abs(a) for a, b in zip(history, history[1:])]
                   + [0.0])
        check(res.history[-1][0] == SIM_NGEN and fall <= SIM_FALL_TOL,
              'k={} {}: the GA history falls: {}'.format(k, start,
                                                         res.history))
        check(res.score > history[0], 'k={} {}: {} does not end above '
              'its start {}'.format(k, start, res.score, history[0]))
        check('{:.4f}'.format(spearman) == row['spearman'],
              'k={} {}: Spearman {} in the TSV, {} from the tour'.format(
                  k, start, row['spearman'], spearman))
        # the run's delta generations, as the GA reports them (a
        # skip_ga rescoring reports none)
        check(batch['n_delta'] == log.metrics['ga_delta_gens'][i]
              and batch['delta'] is not None,
              'k={} {}: {} delta calls recorded'.format(k, start,
                                                       batch['n_delta']))
        if start == 'hot':
            check(res.score >= SIM_MIN_TRUTH * score_truth, 'k={} hot: {} '
                  'below {} of the truth\'s {}'.format(
                      k, res.score, SIM_MIN_TRUTH, score_truth))
            check(spearman >= SIM_MIN_SPEARMAN, 'k={} hot: Spearman {} '
                  'below {}'.format(k, spearman, SIM_MIN_SPEARMAN))
        emit({'phase': 'sim', 'k': k, 'start': start,
              'records': problem.n_records, 'score0': history[0],
              'score_final': res.score, 'score_truth': score_truth,
              'final_over_truth': res.score / score_truth,
              'start_spearman': start_spearman, 'spearman': spearman,
              'largest_fall': fall, 'wall_s': wall,
              'generations_per_s': SIM_NGEN / wall})
    emit({'phase': 'sim', 'ks': SIM_KS, 'ngen': SIM_NGEN,
          'npop': SIM_NPOP, 'ga_route': DEVICE, 'seconds': secs - copy_s,
          'recording_copy_s': copy_s, 'launches': launches,
          'ga_delta_gens': delta_gens, 'max_memory_allocated': peak})
    # both kernels against their plain versions on what the study gave
    # them (these launches are not counted above)
    for i, batch in enumerate(batches):
        k, what = SIM_KS[i // 3], ('truth', 'cold', 'hot')[i % 3]
        row = _check_sim_launches(torch, kscore, kdelta, topt,
                                  'sim k={} {}'.format(k, what), batch)
        emit({'phase': 'sim_kernels', 'k': k, 'start': what, **row})
    del batches
    torch.cuda.empty_cache()

    # two host tools through the CLI: score_statistics prints (in a
    # process of its own: the harness binds sys.stdout at import)
    sav, ga_score = allhic_tour
    p = subprocess.run(
        [sys.executable, '-m', 'haphic_tpu_torch', 'sim',
         'score_statistics', sav, 'chrX', 'N50', 'HapHiC'], cwd=run_dir,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300, check=True)
    first = p.stdout.splitlines()[0].split('\t')
    check(first == ['HapHiC', 'chrX', 'N50', ga_score],
          'score_statistics printed {} for the allhic tour (>GA{}-{})'
          .format(first, ALLHIC_NGEN, ga_score))
    agp = os.path.join(out, '04.build', 'scaffolds.agp')
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        check(cli.main(['sim', 'convert_agp_to_tour', agp, 'scaffolds'])
              == 0, 'sim convert_agp_to_tour failed')
    finally:
        os.chdir(cwd)
    with open(os.path.join(run_dir, 'scaffolds.tour')) as f:
        tour = f.read().splitlines()
    want = [c + o for scaffold in _w_lines(agp) for c, _, __, o in scaffold]
    check(tour == ['>INIT', ' '.join(want)], 'convert_agp_to_tour does '
          'not list the W lines of scaffolds.agp in order')
    emit({'phase': 'sim', 'score_statistics': first,
          'convert_agp_to_tour': {'contigs': len(want)}})
    return launches


def _score_inputs(torch, G, P, k, R, seed, sort=True):
    """Random tours and records between contigs at most 4 apart; sorted
    by contig as build_problem sorts them (``sort=False``: in random
    order, the inputs of the kernel's first measurement in PERF.md)."""
    rng = np.random.default_rng(seed)
    kk = max(2, k - 3)                      # real contigs; rest k padding
    lengths = np.zeros((G, k), np.int64)
    lengths[:, :kk] = rng.integers(5000, 40000, (G, kk))
    pa = rng.integers(0, kk - 1, (G, R))
    pb = np.minimum(pa + rng.integers(1, 5, (G, R)), kk - 1)
    if sort:
        key = np.sort(pa * k + pb, axis=1)
        pa, pb = key // k, key % k
    pa, pb = pa.astype(np.int32), pb.astype(np.int32)
    d = rng.integers(1, 40000, (G, 4, R)).astype(np.float32)
    w = rng.integers(1, 4, (G, R)).astype(np.float32)
    order = np.argsort(rng.random((G, P, k)), axis=2).astype(np.int32)
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)
    return [torch.as_tensor(x, device=DEVICE)
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
    main = (big['G'], big['P'], big['k_pad'], big['R_pad'])
    shapes = [('small', 2, 6, 32, 1000),
              ('main_path_unsorted',) + main,
              ('main_path',) + main]
    for seed, (label, G, P, k, R) in enumerate(shapes):
        args = _score_inputs(torch, G, P, k, R, min(seed, 1),
                             sort=label != 'main_path_unsorted')
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


def _delta_inputs(torch, topt, trace_ga, G, P, k, R, seed):
    """A GA batch as the delta window holds it (trace_ga.make_batch:
    records between near contigs sorted by contig, the caches of a
    random population) and one move per individual drawn as _dgen
    draws it."""
    rec, state = trace_ga.make_batch(G, P, k, R, seed, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    move = topt._sample_moves(gen, (G, P), k, 1.1,
                              local_frac=topt._DELTA_LOCAL_FRAC,
                              device=DEVICE)
    return rec, state, move


def _clone(state):
    return tuple(x.clone() for x in state)


def _step(fn, topt, rec, state, move, accept=None):
    """One delta generation by ``fn`` (the kernel's wrapper or the plain
    version) on ``state``, which it updates in place."""
    return fn(state, move, rec.la, rec.lb, rec.d, rec.w,
              topt._DELTA_MIN_GAIN, topt._DELTA_SPAN_GAIN, accept=accept)


def _run(fn, topt, rec, state, move, accept=None):
    """(delta, acc, state after) of one generation on a copy of
    ``state``."""
    st = _clone(state)
    delta, acc = _step(fn, topt, rec, st, move, accept)
    return delta, acc, st


def _delta_bound_ms(torch, kdelta, state, move, acc):
    """Least time for one delta generation on this input. Bytes: the
    state of every (individual, record) pair whose contribution the move
    may change (its two slots and 20 B more: 28 B;
    kdelta.changed_records), the state of the other touched pairs of an
    accepted row (28 B), 28 B written per touched pair of an accepted
    row, the records once per group (la, lb, d[4], w: 28 B), the move's
    span of ``order`` for every row, the slot tables over the span of
    each accepted row (order, ori, L_slot read and written and startsx
    written: 28 B a slot; a flip's ori only: 8 B), and per row the move,
    its slot starts, the score and the outputs (60 B). The arithmetic
    (~40 FP32 operations per computed pair) is far below the bytes.
    Beside it, the same with the state of every touched pair read
    (bound_touched_ms), and the same with the two slots of every pair
    read as well (bound_scan_ms), as a kernel that scans them moves. Pairs are counted by the plain rules
    (kdelta.touched_records, kdelta.changed_records)."""
    posA, posB = state[4], state[7]
    G, P, R = posA.shape
    touched = kdelta.touched_records(posA, posB, move)
    changed = kdelta.changed_records(posA, posB, move)
    written = touched & acc[..., None]
    n_touched, n_changed = int(touched.sum()), int(changed.sum())
    n_written = int(written.sum())
    n_still = int((written & ~changed).sum())
    del touched, changed, written
    do, op, i, j, t = move
    span = torch.where(do, torch.where(op == 2, t - i, j - i + 1),
                       0).clamp(min=0)
    slot_bytes = torch.where(op == 3, 8, 28)
    n_span = int(span.sum())
    fixed = (28 * G * R + 28 * n_written + 4 * n_span
             + int((span * slot_bytes * acc).sum()) + 60 * G * P)
    nbytes = 28 * n_changed + 28 * n_still + fixed
    touched_bytes = 28 * n_touched + fixed
    scan_bytes = (8 * G * P * R + 20 * n_touched + 28 * G * R
                  + 28 * n_written + 60 * G * P)
    t_ops = 40 * n_changed / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'bound_touched_ms': touched_bytes / HBM_BPS * 1e3,
            'bound_scan_ms': scan_bytes / HBM_BPS * 1e3,
            'touched_pairs': n_touched, 'changed_pairs': n_changed,
            'written_pairs': n_written}


def _check_delta(torch, kdelta, topt, what, rec, state, move, got, want):
    """The kernel's (delta, acc) ``got`` against the plain version's
    ``want`` on ``state`` before the step. Every row: the kernel sums
    its f32 per-record terms in f64 and rounds once, so its delta lies
    within half an f32 ulp of the exact (f64) sum of the plain
    version's terms, plus the two f64 sums' own error (R * 2^-53 of the
    terms' magnitudes each). Rows whose |delta| is at most |score|: the
    deltas within DELTA_TOL * |score| of the plain version's (its f32
    sum runs in another order), and equal acceptance wherever
    |delta - thr| exceeds that. Rows with a larger delta, where one f32
    ulp of the delta can exceed 1e-6 * |score|: equal acceptance
    wherever |delta - thr| exceeds the most the two deltas can differ
    by the bounds above."""
    scores, R = state[-1], state[4].shape[2]
    new_c = kdelta.record_update(state, move, rec.la, rec.lb, rec.d,
                                 rec.w)[1]
    terms = (new_c - state[10]).double()
    del new_c
    exact, mag = terms.sum(dim=2), terms.abs().sum(dim=2)
    del terms
    kd = got[0].abs()
    half_ulp = 0.5 * (torch.nextafter(kd, torch.full_like(kd, np.inf))
                      - kd).double()
    bound = half_ulp + 2.0 * R * 2.0 ** -53 * mag
    exact_err = (got[0].double() - exact).abs()
    check(bool((exact_err <= bound).all()), 'delta kernel is not the exact '
          'sum rounded once ({}): max error / bound {}'.format(
              what, float((exact_err / bound).max())))
    big = want[0].abs() > scores.abs()
    err = (got[0] - want[0]).abs()
    tol = DELTA_TOL * scores.abs()
    check(bool((big | (err <= tol)).all()), 'delta kernel disagrees ({}): '
          'max |delta error| / |score| {}'.format(
              what, float(torch.where(big, 0.0, err / scores.abs()).max())))
    thr = _threshold(torch, topt, scores, move)
    big_tol = (want[0].double() - exact).abs() + bound
    sure = torch.where(big, (want[0].double() - thr.double()).abs() > big_tol,
                       (want[0] - thr).abs() > tol)
    check(torch.equal(got[1][sure], want[1][sure]),
          'delta kernel acceptance differs ({})'.format(what))
    return {'max_abs_err': float(err.max()),
            'max_err_over_score': float((err / scores.abs()).max()),
            'max_err_over_exact_bound': float((exact_err / bound).max()),
            'rows_delta_over_score': int(big.sum())}


def _check_commit(torch, what, scores, got, want):
    """Under one acceptance mask every state field but the scores is
    bit-equal; the kernel's scores are exactly score + its delta on the
    accepted rows, and within DELTA_TOL * |score| of the plain
    version's where |delta| is at most |score|."""
    for n, (a, b) in enumerate(zip(got[2][:-1], want[2][:-1])):
        check(torch.equal(a, b), 'delta {} differs in state field {}'
              .format(what, n))
    check(torch.equal(got[2][-1],
                      torch.where(got[1], scores + got[0], scores)),
          'delta {}: scores are not score + delta'.format(what))
    small = want[0].abs() <= scores.abs()
    check(bool(((got[2][-1] - want[2][-1]).abs()
                <= DELTA_TOL * scores.abs())[small].all()),
          'delta {}: scores differ'.format(what))


def phase_delta(torch, kdelta, topt, trace_ga, big, launches):
    rows = []
    shapes = [('small', 2, 6, 32, 1000),
              ('main_path', big['G'], big['P'], big['k_pad'],
               big['R_pad'])]
    kern, plain = kdelta.delta_generation, kdelta.delta_generation_plain
    for seed, (label, G, P, k, R) in enumerate(shapes):
        rec, state, move = _delta_inputs(torch, topt, trace_ga, G, P, k, R,
                                         seed)
        scores = state[-1]
        # the deltas, and the acceptance each version makes
        got = _run(kern, topt, rec, state, move)
        want = _run(plain, topt, rec, state, move)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got[0]).all()),
              'delta kernel output at {} shape'.format(label))
        errs = _check_delta(torch, kdelta, topt, '{} shape'.format(label),
                            rec, state, move, got, want)
        # the same generation again: the same bits
        again = _run(kern, topt, rec, state, move)
        torch.cuda.synchronize()
        for a, b in zip(got[:2] + got[2], again[:2] + again[2]):
            check(torch.equal(a, b), 'delta kernel is not repeatable at '
                  '{} shape'.format(label))
        mask = want[1]
        del got, want, again
        # one acceptance mask for both: the commit is exactly equal
        got = _run(kern, topt, rec, state, move, mask)
        want = _run(plain, topt, rec, state, move, mask)
        torch.cuda.synchronize()
        _check_commit(torch, 'commit at {} shape'.format(label), scores,
                      got, want)
        del got, want
        # moves over the whole tour, all accepted: every record touched;
        # a flip changes every contribution (more new states than the
        # kernel keeps in shared memory), an inversion none
        ones = torch.ones_like(mask)
        for op in (3, 1):
            whole = (torch.ones_like(move[0]), torch.full_like(move[1], op),
                     torch.zeros_like(move[2]),
                     torch.full_like(move[3], k - 1),
                     torch.full_like(move[4], k - 1))
            got = _run(kern, topt, rec, state, whole, ones)
            want = _run(plain, topt, rec, state, whole, ones)
            torch.cuda.synchronize()
            what = 'whole-tour moves (op {}) at {} shape'.format(op, label)
            _check_delta(torch, kdelta, topt, what, rec, state, whole, got,
                         want)
            _check_commit(torch, what, scores, got, want)
            del got, want
        # no move: delta exactly 0.0, nothing written
        still = (torch.zeros_like(move[0]),) + tuple(move[1:])
        d0, _, st0 = _run(kern, topt, rec, state, still, ones)
        torch.cuda.synchronize()
        check(bool((d0 == 0.0).all()),
              'delta kernel gives a nonzero delta with no move')
        for a, b in zip(st0, state):
            check(torch.equal(a, b), 'delta kernel changed the state '
                  'with no move')
        del st0
        bound = _delta_bound_ms(torch, kdelta, state, move, mask)
        # times: the same move and acceptance applied again and again to
        # one copy of the state (the moves permute slots inside their
        # own range, so each repetition touches the same records)
        timed = _clone(state)
        ms = _time_ms(torch, lambda: _step(kern, topt, rec, timed, move,
                                           mask), 20)
        plain_ms = _time_ms(torch, lambda: _step(plain, topt, rec, timed,
                                                 move, mask), 3)
        del timed
        row = {'shape': label, 'G': G, 'P': P, 'k': k, 'R': R, **errs,
               'pairs': G * P * R, 'accepted_rows': int(mask.sum()),
               'ms': ms, 'plain_ms': plain_ms, **bound}
        emit({'phase': 'kernel', 'name': 'delta_generation',
              'main_path_launches': launches['delta_generation'], **row})
        rows.append(row)
        del rec, state, move
        torch.cuda.empty_cache()
    return rows


def _threshold(torch, topt, scores, move):
    do, op, i, j, t = move
    spanv = torch.where(op == 2, t - i, j - i).to(torch.float32)
    return scores * (topt._DELTA_MIN_GAIN + topt._DELTA_SPAN_GAIN * spanv)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: CUDA is not available\n')
        return 1
    sys.path.insert(0, REPO)
    from haphic_tpu_torch import cli
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.cluster.sweep import SPARSE_MIN_N
    from haphic_tpu_torch.kernels import build as kbuild
    from haphic_tpu_torch.kernels import delta as kdelta
    from haphic_tpu_torch.kernels import score as kscore
    from haphic_tpu_torch.kernels import trace_ga
    from haphic_tpu_torch.order import optimize as topt

    phase_env(torch, kbuild)
    launches, big = phase_pipeline(torch, cli, kscore, kdelta)
    main_rows = {
        'score_population': phase_kernel(torch, kscore, big, launches)[-1],
        'delta_generation': phase_delta(torch, kdelta, topt, trace_ga,
                                        big, launches)[-1]}
    torch.cuda.empty_cache()
    by_phase = {'pipeline': launches}
    first_step, by_phase['sparse_pipeline'] = phase_sparse_pipeline(
        torch, cli, kscore, kdelta, sp, SPARSE_MIN_N)
    phase_sparse_step(torch, sp, first_step)
    del first_step                # its tensors would count in the next peaks
    torch.cuda.empty_cache()
    by_phase['polyploid_pipeline'] = phase_polyploid_pipeline(
        torch, cli, kscore, kdelta)
    torch.cuda.empty_cache()
    by_phase['correct_pipeline'] = phase_correct_pipeline(
        torch, cli, kscore, kdelta)
    torch.cuda.empty_cache()
    out = os.path.join(WORK, 'out')
    by_phase['allhic'], allhic_tour = phase_allhic(
        torch, cli, kscore, kdelta, topt, out)
    torch.cuda.empty_cache()
    phase_post(torch, out, os.path.join(WORK, 'sim'), SIM)
    torch.cuda.empty_cache()
    by_phase['sim'] = phase_sim(torch, cli, kscore, kdelta, topt, out,
                                allhic_tour)
    kernels = []
    for k in KERNELS:
        row = main_rows[k['name']]
        counts = {p: n[k['name']] for p, n in by_phase.items()}
        # no single PyTorch call computes either function
        kernels.append(dict(k, launches=sum(counts.values()),
                            launches_by_phase=counts,
                            max_abs_err=row['max_abs_err'], ms=row['ms'],
                            plain_ms=row['plain_ms'],
                            bound_ms=row['bound_ms'],
                            bound_by=row['bound_by'], library_ms=None))
    print(nvidia_smi(), flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())

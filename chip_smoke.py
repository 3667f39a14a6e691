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
             before and read just after (the dense sweep through the
             mcl_column kernel and its final matrices through
             mcl_interpret, one launch per batch the sweep logs; the GA
             through its three kernels, one
             delta_generation launch per delta generation and one
             rescore_population launch per rescoring call it reports,
             `ga_delta_gens` and `ga_rescores`). The scaffolds must
             recover the 8 simulated chromosomes as a partition.
3. dense_step
             the pipeline's first inflation batch (B = 6, n = 8000) as
             its first run_mcl_partitions call gave it: one iteration
             (the third: the torch.matmul expansion, then the column
             pass with the convergence statistic) through mcl_column and
             through its plain version, each timed with CUDA events, its
             peak card memory and its device time from torch.profiler by
             op and by kernel, the gemm apart. On that iteration's inputs
             mcl_column against its plain version: values within rtol
             1e-5 / atol 1e-8, equal nonzero sets and argmax rows
             (columns with an entry within 1e-5 x pruning of pruning, or
             whose two largest q lie within 1e-6 relative, excused and
             counted), the statistic within 1e-7 and the same
             convergence decision; both timed (the kernel's ms and
             plain_ms, its plan from mcl_column.plan(n) and the rate it
             reached on the bytes it moves, tb_s). Then the whole batch
             through _mcl_batched with the kernel and with its plain
             version in its place: equal iteration counts and
             partitions by interpret_result. On the kernel's final
             matrices, mcl_interpret against its plain version: labels
             exactly equal and their partitions equal to
             interpret_result's; both timed (ms, plain_ms), the bound
             from the bytes it must move (each attractor row once, the
             diagonal, the labels) and the attractors per matrix.
4. kernel    every kernel against its plain torch version on the card,
             at a small shape and at the shapes the pipeline gave it,
             with CUDA-event times and the least time the card could
             take for the same work. score_population: max relative
             error <= 1e-5 (the sums run in another order).
             delta_generation (one launch per generation: the moves
             from their draws, delta, acceptance, commit, slot tables),
             on a GA state built by _Records.caches from a random
             population and one set of draws: in draws mode (the GA's)
             its moves bit-equal to _moves_from_draws's and its delta,
             acceptance and state bit-equal to the move mode's on those
             moves; in move mode against the plain step: delta within
             1e-6 x |score|
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
             unchanged. Timed in draws mode (ms: successive
             generations from fresh draws, as the GA runs them; plain_ms
             _moves_from_draws and the plain step on the same draws;
             bound_ms the mean over the timed generations) and in move
             mode (move_mode_ms: the first move and mask repeated, beside
             its bound, move_mode_bound_ms). The bound is the function's
             least work
             (changed pairs; bound_touched_ms reads every touched
             pair); the figure that also reads the two slots of every
             pair stays beside it as bound_scan_ms.
             rescore_population (the GA cycle's rescoring: caches,
             contributions, row sums), at a small shape and on the
             arguments of the dense pipeline's largest batch's first
             rescoring (G = 7, P = 100, k = 1024, R = 196,608), in caches
             mode against rescore_plain: L_slot, startsx, the six caches
             and the contributions bit-equal; each score within half an
             ulp of the exact (f64) sum of the plain version's f32
             contributions plus the f64 sums' own error; scores mode
             equal to caches mode; a repeat bit-identical; the rows of
             groups [2, 5) launched alone bit-equal to the same rows of
             the whole launch. Timed in both modes (ms by CUDA events,
             device_ms by torch.profiler, plain_ms, bound_ms: bytes in
             caches mode, operations in scores mode); one launch a call
             by the wrapper's counter, and no device kernel but the
             rescoring kernel, at most one a call, in the profiler's
             record (profiled_kernels: it records fewer than launched
             late in this process), in either mode.
5. sparse_pipeline
             the same pipeline through the default `auto` route on 24
             chromosomes x 1000 contigs x 20 kb (480 Mb, n = 24,000
             fragments, past SPARSE_MIN_N) with 6,000,000 pairs, seed
             17, the same flags and cut: the MCL sweep must run on the
             sparse top-K engine on the card through the ell_build
             kernel (its input ELL), the sparse_column kernel and the
             col_allclose kernel (its convergence statistic), the GA and
             its kernels on the card (launch counts of all six set to 0
             just before and read just after), and the scaffolds must
             recover the 24 chromosomes.
             Prints n, K, the input columns over K, iterations per
             inflation, the K of each shrink per inflation batch, the
             sweep seconds, stage and wall seconds, peak card memory;
             col_allclose launched once per sweep step.
6. sparse_step
             the sparse engine on the card against the same engine on
             the CPU on a 96-fragment block matrix (equal partitions and
             iterations); then the sparse pipeline's first sweep step
             (B=4, n+1, K=128, from the first-iteration state), rerun
             with the arguments the pipeline gave it, timed with CUDA
             events (and again through the plain versions of the column
             pass and the statistic), its peak card memory, and its
             device time from torch.profiler split by op and by kernel,
             each with its share (no sort or cummax may be left in it).
             Then sparse_column against its plain version on that
             step's columns: equal sets of entries above 1e-6, values
             within rtol 1e-5 / atol 1e-7; both timed over the step's
             chunks (the kernel's ms and plain_ms); and the step's
             column shapes (kernelkit.column_stats: real sources,
             real candidates, distinct ids, capped columns). Then
             col_allclose against its plain version on the step's own
             columns (old: the iterate's, new: sparse_column's output):
             the same -inf columns, the others within 1e-9 absolute, the
             same convergence decision (<= 1e-8) for each inflation;
             over all the step's columns in one call, as the sweep
             calls it (one launch a step): the kernel's launch timed
             (ms, and device_ms and profiled_kernels by torch.profiler,
             as for the rescoring), the wrapper with the
             order flag the host loop reads (wrapper_ms), and the plain
             version (plain_ms); its bound from the step's real entries.
             The step's arguments go to build/chip_smoke/sparse_step.pt
             for `python3 tools/sparse_column_phases.py --iterate`.
7. ell_build
             the links that tieguanyin_2x.cluster_sets hands the sparse
             engine (hicbench's genome and stage under ELL_SEED, then
             build_adjacency_coo: n = 20,443, 7.23M links) at K = 128:
             coo_to_ell on the card (the ell_build kernel) against
             coo_to_ell on the CPU (its plain version, which the CPU
             tests hold bit-equal to the JAX package's numpy), idx and
             val bit-equal, the same overflow, no column through global
             memory (coo_to_ell.wide_columns 0); the whole card call
             (upload, kernel, reads: call_ms) and the CPU's (plain_ms);
             the wrapper on links already on the card (its two reads of
             the card included) by CUDA events (ms) against its bound
             (the links read once and the ELL written once at 3.35
             TB/s: bound_ms; their upload at 64 GB/s apart:
             upload_bound_ms); the card call's peak memory.
8. polyploid_pipeline
             the pipeline phase's genome at half its contigs and pairs
             (8 x 500 contigs, 1,000,000 pairs: a cut, for time) made
             tetraploid
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
9. correct_pipeline
             the pipeline phase's genome with 40 chimeric contigs
             (make_chimera_sim) and --correct_nrounds 2: at least 36
             chimeras broken (corrected_ctgs.txt), the MCL and the GA
             on the card as above, the 8 chromosomes recovered with
             each corrected fragment counted with the contig most of it
             lies in. Prints the chimeras broken, correct_s (the
             correction pass, inside cluster_s.parse), stage and wall
             seconds, peak card memory.
10. allhic    `cli.main(["allhic", group, clm, "--resume"])` on the card
             at the users' defaults (--npop 100 --ngen 5000 --seed 42) on
             the largest group of the pipeline phase (k = 1000 contigs,
             its group file and split CLM from 02.reassign), hot-started
             from that pipeline's own 03.sort tour: the GA must run on
             the card (work above NATIVE_MAX_WORK) with its three
             kernels (launch counts set to 0 just before and read just
             after, one delta launch per delta generation and one
             rescoring launch per rescoring call the GA reports), the
             tour must be a permutation of the group, its >GA5000 score
             at least the hot start's, and `--resume --skipGA` on it
             must score it within 1e-5 relative of that line. Prints the
             work, route, seconds, generations per second, launches and
             peak card memory.
11. post     on the pipeline phase's output: plot's contact map
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
12. sim      `cli.main(["sim", "ga_study", "--ks", "50,200,500,1000",
             "--ngen", "5000", "--npop", "100", "--backend", "device"])`
             on the card (docs/GA_VALIDATION.md's sizes and settings):
             per k a truth rescoring and a cold and a hot GA run, every
             one on the card with the GA's three kernels (launch counts
             set to 0 just before and read just after: one score launch
             per GA call, one delta launch per delta generation and one
             rescoring launch per rescoring call the GA reports).
             Every run's history may fall by no more than 1e-6 of its
             score (f32 rounding when a window rescores its
             caches) and every run ends above its start; every hot run
             reaches 0.9 of the truth's score and Spearman >= 0.9
             against the simulated order (the hot start's own Spearman
             is above 0.9 already: adjacent swaps barely move it, flips
             not at all, so the score bar is the one a GA that stood
             still would fail). The arguments of every GA call's score
             launch, of its first rescoring launch and of each run's
             SIM_CHECK_GEN-th delta launch are kept on the host, and
             after the study each kernel is rerun on them against its
             plain version (the checks of phase 4) at the shapes the
             study gave it (the rescoring at P = 100 and, on the truth's
             population, P = 4). Prints one line per run
             (k, start, records, scores, start and final Spearman,
             seconds, generations per second), one per checked GA call,
             then the launches, seconds and peak card memory. Then two
             host
             tools through the CLI: `sim score_statistics` on the allhic
             phase's tour must print its >GA5000 score, and `sim
             convert_agp_to_tour` on the pipeline's scaffolds.agp must
             list every W line's contig and orientation in order.
13. mesh_pipeline
             the pipeline phase's genome, flags and cut through `python
             -m torch.distributed.run --standalone --nproc_per_node 2`
             with --use_mesh on: each rank is this script's worker
             (`chip_smoke.py --mesh-worker pipeline spec.json`), which
             calls the same `cli.main(["pipeline", ...])` with the launch
             counts set to 0 just before and read just after. On one
             card both ranks run on cuda:0 over gloo; with two cards,
             one each over NCCL. Ingest, the 20 inflations and the GA's
             groups shard over the ranks. Each rank's MCL must run on the
             card through mcl_column and mcl_interpret (one labels
             launch per batch it logs) and its GA with its three
             kernels, one delta launch per delta generation and one
             rescoring launch per rescoring call it reports; out_mesh/ and
             out_mesh.rank1/ must equal the single-process out/ byte for
             byte (every
             01.cluster file, scaffolds.agp, scaffolds.raw.agp), and the
             8 chromosomes come back. Prints backend, world, wall, and per
             rank its stage seconds, seconds and bytes in collectives
             and peak card memory.
14. mesh_sparse
             the sparse pipeline's adjacency (n = 24,000, K = 128), its
             first inflation batch (4 of 20 inflations, a cut), through
             the column-sharded run_mcl_sparse on two torchrun ranks
             (`--mesh-worker sparse`) against the meshless run on the
             card: iterates, iteration counts and K shrinks bit-equal.
             Prints each sharded step's ms, its all-gather ms and bytes,
             peak card memory and sparse_column and col_allclose
             launches per rank (counted from 0 just before its run; one
             col_allclose launch per rank per step).
15. mesh_nccl
             a one-rank NCCL group in this process, so that NCCL's
             collectives run on CUDA tensors even on one card: the
             sharded dense sweep (its first 5 inflations at n = 8000,
             through mcl_column and mcl_interpret), the sharded sparse
             step (the sparse
             pipeline's first step, through sparse_column and
             col_allclose) and the
             sharded GA (the pipeline's
             own GA call: 7 groups, the GA's three kernels, one launch
             per delta generation and per rescoring call it reports;
             launch counts set to 0 just before and read just after
             each) against the meshless calls, bit-equal.
16. kernels  one line listing every kernel (the line before the last):
             `launches` sums the counts of every phase that drives a
             path (pipeline, sparse_pipeline, polyploid_pipeline,
             correct_pipeline, allhic, sim, mesh_pipeline over its two
             ranks, mesh_sparse over its two ranks, mesh_nccl),
             `launches_by_phase` lists them; sparse_column's and
             col_allclose's ms, plain_ms, bound_ms and max_abs_err are
             phase 6's, ell_build's phase 7's, mcl_column's and
             mcl_interpret's phase 3's (with the column pass's plan and
             tb_s, the labels' bytes and attractors),
             rescore_population's phase 4's main_path row in caches mode
             (its scores mode beside them as `scores`).

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
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import kernelkit as kit  # noqa: E402
WORK = os.path.join(REPO, 'build', 'chip_smoke')
DEVICE = 'cuda'

SIM = dict(nchrs=8, ctgs_per_chr=1000, ctg_len=20000, n_pairs=2_000_000,
           seed=17)
# 24,000 one-fragment contigs, past SPARSE_MIN_N: the sparse MCL route
SPARSE_SIM = dict(nchrs=24, ctgs_per_chr=1000, ctg_len=20000,
                  n_pairs=6_000_000, seed=17)
NGEN = 500
# the polyploid genome: the dense genome at half its contigs and pairs
# (a cut, for time: every check keeps its meaning)
POLY_SIM = dict(SIM, ctgs_per_chr=500, n_pairs=1_000_000)
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
STAT_TOL = 1e-9          # col_allclose against its plain version, absolute
ELL_SEED = 3250002601    # ell_build: the tea cell's links under this seed
ELL_REPS = 20            # ell_build: timed launches
CONVERGED = 1e-8         # the sweep's convergence threshold on the statistic
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
MESH_WORLD = 2           # mesh_pipeline, mesh_sparse: torchrun ranks
MESH_SPARSE_B = 4        # mesh_sparse: the sweep's first inflation batch
MESH_DENSE_B = 5         # mesh_nccl: the dense sweep's first 5 inflations
REL_TOL = 1e-5           # score_population, relative
DELTA_TOL = 1e-6         # delta_generation, relative to the row's score

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
}, {
    'name': 'sparse_column',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/sparse_column.cu',
    'replaces': 'haphic_tpu/cluster/sparse_mcl.py:164',
}, {
    'name': 'mcl_column',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/mcl_column.cu',
    'replaces': 'haphic_tpu/cluster/mcl.py:86',
}, {
    'name': 'col_allclose',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/col_allclose.cu',
    'replaces': 'haphic_tpu/cluster/sparse_mcl.py:114',
}, {
    'name': 'rescore_population',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/rescore_population.cu',
    'replaces': 'haphic_tpu/order/optimize.py:911',
}, {
    'name': 'mcl_interpret',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/mcl_interpret.cu',
    'replaces': 'haphic_tpu/cluster/mcl.py:283',
}, {
    'name': 'ell_build',
    'route': 'cuda',
    'source': 'haphic_tpu_torch/kernels/csrc/ell_build.cu',
    'replaces': 'haphic_tpu/cluster/sparse_mcl.py:411',
}]
# the GA's kernels: every phase that drives a GA launches all three
GA_KERNELS = ('score_population', 'delta_generation', 'rescore_population')
# the dense MCL sweep's kernels on the card: the column pass and the labels
DENSE_KERNELS = ('mcl_column', 'mcl_interpret')
# the sparse engine's: the input ELL, the column step, the statistic
SPARSE_KERNELS = ('ell_build', 'sparse_column', 'col_allclose')


def kernel_wrappers():
    """{kernel name: its wrapper}, each wrapper carrying its launch
    count as ``launches``."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    from haphic_tpu_torch.kernels import delta as kdelta
    from haphic_tpu_torch.kernels import ell_build as keb
    from haphic_tpu_torch.kernels import mcl_column as kmc
    from haphic_tpu_torch.kernels import mcl_interpret as kmi
    from haphic_tpu_torch.kernels import rescore as krs
    from haphic_tpu_torch.kernels import score as kscore
    from haphic_tpu_torch.kernels import sparse_column as kcol
    return {'score_population': kscore.score_population,
            'delta_generation': kdelta.delta_generation,
            'sparse_column': kcol.sparse_column,
            'mcl_column': kmc.mcl_column,
            'col_allclose': kca.col_allclose,
            'rescore_population': krs.rescore,
            'mcl_interpret': kmi.mcl_labels,
            'ell_build': keb.ell_build}


def zero_launches(names):
    for fn in (kernel_wrappers()[n] for n in names):
        fn.launches = 0


def read_launches(names) -> dict:
    wrappers = kernel_wrappers()
    return {n: wrappers[n].launches for n in names}


def check_ga_launches(launches, delta_gens, rescores, what):
    """One delta_generation launch per delta generation and one
    rescore_population launch per rescoring call, as the GA reports
    them (``ga_delta_gens``, ``ga_rescores``)."""
    check(launches['delta_generation'] == delta_gens,
          '{}: delta_generation launched {} times for {} delta generations'
          .format(what, launches['delta_generation'], delta_gens))
    check(launches['rescore_population'] == rescores,
          '{}: rescore_population launched {} times for {} rescoring calls'
          .format(what, launches['rescore_population'], rescores))


def check_label_launches(launches, m, what):
    """One mcl_interpret launch per batch of the dense sweeps on the
    card, as they log their batches: every batch's partitions read from
    its labels."""
    batches = [b for call in m.get('batches', []) for b in call]
    check(launches['mcl_interpret'] == len(batches),
          '{}: mcl_interpret launched {} times for {} dense batches'
          .format(what, launches['mcl_interpret'], len(batches)))


T0 = time.time()


def emit(obj):
    """One JSON line; a phase line also gets 'at_s', the seconds since
    the script started."""
    if 'phase' in obj:
        obj = dict(obj, at_s=time.time() - T0)
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError('chip_smoke: {}'.format(what))


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
    emit({'phase': 'env', 'nvidia_smi': kit.nvidia_smi(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'device': torch.cuda.get_device_name(0),
          'kernel_build_s': secs,
          'libraries': {n: os.path.relpath(p, REPO)
                        for n, p in paths.items()}})


def _drive_pipeline(torch, cli, sim, sim_dir, out_dir,
                    engine, genome=make_sim, chrom_of=chrom_of_name):
    """``genome`` (make_sim), then `cli.main(["pipeline", ...])` on the
    card with the flags it returns and the kernel launch counts set to 0
    just before and read just after. The MCL sweep must run on the card
    on ``engine`` (the sparse one through sparse_column and
    col_allclose, the dense one through mcl_column), the GA on the card
    with its three kernels, one delta_generation launch per delta
    generation and one rescore_population launch per rescoring call the
    GA reports, and the scaffolds must recover the simulated
    chromosomes. On the dense engine mcl_interpret must launch once per
    batch the sweeps log (check_label_launches). Returns (sim seconds,
    wall seconds, metrics, launches, partition summary, output
    directory)."""
    t0 = time.time()
    fa, pairs, flags = genome(os.path.join(WORK, sim_dir), **sim)
    sim_s = time.time() - t0
    out = os.path.join(WORK, out_dir)
    log = MetricsLog()
    logging.getLogger('haphic_tpu_torch').addHandler(log)
    torch.cuda.reset_peak_memory_stats()
    names = [k['name'] for k in KERNELS]
    zero_launches(names)
    t0 = time.time()
    rc = cli.main(['pipeline', fa, pairs, str(sim['nchrs']), '--outdir',
                   out, '--ngen', str(NGEN)] + SIM_FLAGS + flags)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(names)
    logging.getLogger('haphic_tpu_torch').removeHandler(log)
    check(rc == 0, 'pipeline exit code {}'.format(rc))
    m = log.metrics
    check(m['mcl_engine'][-1] == engine, 'the MCL sweep ran on the {} '
          'engine, not the {} one'.format(m['mcl_engine'][-1], engine))
    mcl = m['mcl_route'][-1]
    check(mcl == 'cuda', 'the MCL sweep ran on {}, not the card'.format(mcl))
    check(m['ga_route'][-1] == 'cuda',
          'the GA ran on {}, not the card'.format(m['ga_route'][-1]))
    for kname in GA_KERNELS + (SPARSE_KERNELS if engine == 'sparse'
                               else DENSE_KERNELS):
        check(launches[kname] > 0, 'kernel {} was not launched on the main '
              'path'.format(kname))
    if engine == 'dense':
        check_label_launches(launches, m, 'pipeline')
    # the delta generations and rescorings the GA says it ran, one
    # launch each
    check_ga_launches(launches, sum(m['ga_delta_gens']),
                      sum(m['ga_rescores']), 'pipeline')
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
            'ga_rescores': sum(m['ga_rescores']),
            'stage_s': m['stage_secs'][-1],
            'cluster_s': m['cluster_secs'][-1], 'ga_s': m['ga_secs'][-1],
            'wall_s': wall,
            'max_memory_allocated': torch.cuda.max_memory_allocated(),
            'launches': launches, **part}


def phase_pipeline(torch, cli):
    sim_s, wall, m, launches, part, _ = _drive_pipeline(
        torch, cli, SIM, 'sim', 'out', 'dense')
    batches = m['ga_batch']
    emit({'phase': 'pipeline', 'sim': SIM, 'mcl_batches': m['batches'][-1],
          'mcl_iters_per_inflation': m['n_iters'][-1],
          'records_per_group': m['records'][-1],
          'ga_work': m['ga_work'][-1], 'ga_batches': batches,
          **_run_line(torch, m, sim_s, wall, launches, part)})
    big = max(batches, key=lambda b: b['G'] * b['R_pad'])
    return launches, big


def phase_polyploid_pipeline(torch, cli):
    """The tetraploid genome (make_polyploid_sim) with
    --remove_allelic_links 4 --remove_concentrated_links --gfa (four
    haplotypes) --ul: allelic pairs found and removed through the clique
    search, the UL paths found, and the 8 chromosomes recovered with
    the MCL and the GA on the card."""
    sim_s, wall, m, launches, part, _ = _drive_pipeline(
        torch, cli, POLY_SIM, 'poly_sim', 'poly_out', 'dense',
        genome=make_polyploid_sim)
    allelic = m['allelic'][-1]
    check(allelic['n_allelic_pairs'] > 0, 'no allelic pair was removed')
    check(allelic['largest_allele_group'] == 4, 'allele groups of {} '
          'contigs at ploidy 4'.format(allelic['largest_allele_group']))
    check(m['ul_paths'][-1] > 0, 'no UL path was found')
    emit({'phase': 'polyploid_pipeline', 'sim': POLY_SIM,
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


def phase_correct_pipeline(torch, cli):
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
        torch, cli, SIM, 'chimera_sim', 'chimera_out',
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


def phase_sparse_pipeline(torch, cli, sp, sparse_min_n):
    """The default route past SPARSE_MIN_N: the same pipeline on a
    genome of SPARSE_SIM['nchrs'] * SPARSE_SIM['ctgs_per_chr'] one-
    fragment contigs runs the sparse top-K MCL engine. Returns the
    arguments of the engine's first sweep step, as the pipeline passed
    them, for phase_sparse_step, and the launch counts."""
    first = []
    steps = [0]
    step = sp._sweep_step

    def recording(*args, **kw):
        if not first:
            # the host loop updates `active` in place after each step
            first.append(args[:3] + (args[3].copy(),) + args[4:])
        steps[0] += 1
        return step(*args, **kw)

    sp._sweep_step = recording
    try:
        sim_s, wall, m, launches, part, _ = _drive_pipeline(
            torch, cli, SPARSE_SIM, 'sparse_sim',
            'sparse_out', 'sparse')
    finally:
        sp._sweep_step = step
    check(first, 'the sparse engine ran no sweep step')
    check(launches['col_allclose'] == steps[0], 'col_allclose launched {} '
          'times in {} sweep steps'.format(launches['col_allclose'],
                                          steps[0]))
    check(m['n'][-1] >= sparse_min_n, 'n={} is below SPARSE_MIN_N={}'
          .format(m['n'][-1], sparse_min_n))
    emit({'phase': 'sparse_pipeline', 'sim': SPARSE_SIM, 'K': m['K'][-1],
          'overflow_cols': m['overflow_cols'][-1],
          'mcl_batches': m['batches'][-1],
          'mcl_iters_per_inflation': m['n_iters'][-1],
          'k_steps_per_batch': m['k_steps'][-1],
          'sweep_s': m['sweep_s'][-1], 'sweep_steps': steps[0],
          'interpret_s': m['interpret_s'][-1],
          'clusters_per_inflation': m['clusters_per_inflation'][-1],
          **_run_line(torch, m, sim_s, wall, launches, part)})
    return first[0], launches


def tea_links(torch, seed):
    """The links that tieguanyin_2x.cluster_sets hands the sparse engine
    under ``seed`` (hicbench's genome and stage, then the pipeline's
    build_adjacency_coo, as run_clustering calls it): (i, j, w, n)."""
    from haphic_tpu_torch.cluster.sweep import build_adjacency_coo
    from hicbench import genome as hgen
    from hicbench import harness, stages
    cfg = harness.load('configs', 'tieguanyin_2x')
    mix = harness.load('traffic', 'cluster_sets')
    stage = stages.load(mix['stage']).Stage(
        cfg, mix, hgen.make(cfg, seed), torch.device(DEVICE), seed)
    i, j, w, _ = build_adjacency_coo(stage.flank, stage.filtered,
                                     len(stage.frags))
    return i, j, w, stage.m


def phase_ell_build(torch, sp):
    """ell_build on the links of tieguanyin_2x.cluster_sets (n = 20,443,
    7.23M links, K = 128): coo_to_ell on the card against coo_to_ell on
    the CPU (the plain version, timed once), idx and val to the bit,
    overflow equal, no column through global memory; the whole card call
    (upload, kernel, reads) timed; the wrapper on links already on the
    card (its two reads of the card included) timed by CUDA events over
    ELL_REPS calls, against its bound (the links read once and the ELL
    written once at 3.35 TB/s; their upload at the host link's rate
    apart); its peak card memory. Returns the kernel's row."""
    from haphic_tpu_torch.kernels import ell_build as keb
    t0 = time.time()
    i, j, w, n = tea_links(torch, ELL_SEED)
    draw_s = time.time() - t0
    K, E = sp.DEFAULT_K, len(i)
    t0 = time.perf_counter()
    want = sp.coo_to_ell(i, j, w, n, K)
    plain_ms = (time.perf_counter() - t0) * 1e3
    sp.coo_to_ell(i, j, w, n, K, device=DEVICE)          # the build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n0 = keb.ell_build.launches
    t0 = time.perf_counter()
    got = sp.coo_to_ell(i, j, w, n, K, device=DEVICE)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    check(keb.ell_build.launches == n0 + 1, 'coo_to_ell launched ell_build '
          '{} times'.format(keb.ell_build.launches - n0))
    wide = sp.coo_to_ell.wide_columns
    equal = (torch.equal(got[0].cpu(), want[0]) and
             torch.equal(got[1].cpu().view(torch.int32),
                         want[1].view(torch.int32)))
    check(equal and got[2] == want[2], 'ell_build differs from its plain '
          'version on the tea cell\'s links (overflow {} vs {})'.format(
              got[2], want[2]))
    check(wide == 0, '{} columns took the global-memory path'.format(wide))
    del got
    links = [torch.as_tensor(x, device=DEVICE) for x in (i, j, w)]
    ms = kit.time_ms(lambda: keb.ell_build(*links, n, K), ELL_REPS)
    widths = np.bincount(np.concatenate([j, i[i != j]]), minlength=n) + 1
    row = {'ms': ms, 'plain_ms': plain_ms,
           'bound_ms': kit.ell_build_bound_ms(E, n, K),
           'bound_by': 'bytes', 'max_abs_err': 0.0,
           'bytes': kit.ell_build_least_bytes(E, n, K)}
    emit({'phase': 'ell_build', 'seed': ELL_SEED, 'n': n, 'links': E,
          'K': K, 'widest_column': int(widths.max()),
          'overflow_cols': want[2], 'wide_columns': wide,
          'bit_equal': True, 'draw_s': draw_s, 'call_ms': call_ms,
          'upload_bound_ms': kit.ell_build_upload_ms(E),
          'peak_bytes': peak, **row})
    return row


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
    the pipeline gave it, timed with CUDA events and profiled by op;
    the same step through the plain versions of the column pass and the
    statistic, timed; the statistic's sort and cummax must be gone from
    the step's device ops. Before it, the engine on the card against the
    engine on the CPU on a small block matrix: equal partitions and
    iterations. Then sparse_column held against its plain version on the
    step's columns (equal kept sets above KEPT, values within RTOL/ATOL),
    and col_allclose against its plain version on the step's own column
    pairs (the iterate's columns, sparse_column's output): the same -inf
    columns, the others within STAT_TOL, the same convergence decision
    (<= CONVERGED) for each inflation; each pair timed over the step's
    chunks, the statistic in one call over all of the step's columns, as
    the sweep calls it (one launch a step). Returns the two kernels'
    rows."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    from haphic_tpu_torch.kernels import sparse_column as kcol
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
    # for `python3 tools/sparse_column_phases.py --iterate`
    torch.save({'idx': si, 'val': sv, 'infl': f,
                'active': torch.as_tensor(active), 'n': int(n), 'K': int(K),
                'chunk': int(chunk), 'pruning': float(pruning),
                'expansion': int(expansion)},
               os.path.join(WORK, 'sparse_step.pt'))

    # col_allclose's order flag, passed and read as the host loop does
    flag = torch.zeros(1, dtype=torch.int32, device=si.device)

    def step():
        return sp._sweep_step(si, sv, f, active, n, K, chunk, pruning,
                              expansion, bad=flag)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = kit.time_ms(step, STEP_REPS)
    peak = torch.cuda.max_memory_allocated()
    n0 = kca.col_allclose.launches
    ni, nv, stat, max_nnz = step()
    check(kca.col_allclose.launches == n0 + 1, 'a sweep step launched '
          'col_allclose {} times'.format(kca.col_allclose.launches - n0))
    check(bool(torch.isfinite(nv).all()) and int(max_nnz) <= K
          and bool((ni[:, n] == n).all()) and int(flag) == 0,
          'sparse step output: not finite, too wide, sentinel set or out '
          'of ELL order')
    with mock.patch.object(sp, 'sparse_column', kcol.sparse_column_plain), \
            mock.patch.object(sp, 'col_allclose',
                              kit.col_allclose_plain_stat):
        plain_step_ms = kit.time_ms(step, STEP_REPS)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy_ms, ops, kernels = _device_ops(torch, prof, TOP_OPS)
    # the plain statistic's sort and scans, which the kernel replaces
    stat_ops = {e.key: e.count for e in prof.key_averages()
                if e.key in ('aten::sort', 'aten::cummax',
                             'aten::_cummax_helper')}
    check(not stat_ops, "the step still runs the plain statistic's ops: "
          '{}'.format(stat_ops))
    # the kernel against its plain version on the step's own columns
    sel = torch.as_tensor(np.flatnonzero(active), device=si.device)
    A_i, A_v, fa = si[sel], sv[sel], f[sel]
    cols = [lambda fn=fn: kit.step_columns(fn, A_i, A_v, fa, n, K, chunk,
                                           pruning, expansion)
            for fn in (kcol.sparse_column, kcol.sparse_column_plain)]
    kout, pout = cols[0](), cols[1]()
    torch.cuda.synchronize()
    cmp = kit.sparse_column_compare(*kout, *pout, n)
    check(cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0,
          "sparse_column disagrees with its plain version on the "
          "pipeline's step: {}".format(cmp))
    del pout
    # the statistic on the step's own column pairs in one call, as the
    # sweep calls it: the wrapper (its checks, its kernel, the order
    # flag), the kernel's launch alone and the plain version
    stats = [lambda fn=fn, kw=kw: kit.step_stats(fn, A_i, A_v, *kout, n,
                                                 **kw)
             for fn, kw in ((kca.col_allclose, {'bad': flag}),
                            (kca._launch, {'bad': flag}),
                            (kca.col_allclose_plain, {}))]
    kst, pst = stats[0](), stats[2]()
    check(int(flag) == 0, "col_allclose found the step's columns out of "
          'ELL order')
    scmp = kit.col_allclose_compare(kst, pst)
    decide = [(x.amax(dim=1) <= CONVERGED).tolist() for x in (kst, pst)]
    check(scmp['inf_differ'] == 0 and scmp['max_abs_err'] <= STAT_TOL
          and decide[0] == decide[1], "col_allclose disagrees with its "
          "plain version on the pipeline's step: {}, converged {} vs {}"
          .format(scmp, decide[0], decide[1]))
    scmp.update(equal_columns=int((kst == pst).sum()),
                columns=kst.numel(), stat=kst.amax(dim=1).tolist(),
                converged=decide[0])
    stat_ms = kit.time_ms(stats[1], STEP_REPS)
    scmp.update(_profiled(stats[1], STEP_REPS, 'col_allclose_kernel',
                          lambda: kca.col_allclose.launches))
    scmp['wrapper_ms'] = kit.time_ms(stats[0], STEP_REPS)
    stat_plain_ms = kit.time_ms(stats[2], STEP_REPS)
    sbound, sbound_by = kit.col_allclose_bound_ms(A_i, kout[0], n)
    del kout, kst, pst
    srow = {'max_abs_err': scmp['max_abs_err'], 'ms': stat_ms,
            'plain_ms': stat_plain_ms, 'bound_ms': sbound,
            'bound_by': sbound_by}
    shapes = kit.column_stats(A_i, A_v, n, K, chunk)
    col_ms = kit.time_ms(cols[0], STEP_REPS)
    col_plain_ms = kit.time_ms(cols[1], STEP_REPS)
    bound, bound_by = kit.sparse_column_bound_ms(A_i.shape[0], A_i.shape[1],
                                                 K)
    row = {'max_abs_err': cmp['max_abs_err'], 'ms': col_ms,
           'plain_ms': col_plain_ms, 'bound_ms': bound, 'bound_by': bound_by}
    emit({'phase': 'sparse_step', 'B': B, 'n_plus_1': n + 1, 'K': K,
          'chunk': chunk, 'chunks': -(-(n + 1) // chunk),
          'candidates': B * (n + 1) * K * K, 'ms': ms,
          'plain_step_ms': plain_step_ms, 'reps': STEP_REPS,
          'profiled_device_ms': busy_ms, 'max_nnz': int(max_nnz),
          'max_memory_allocated': peak, 'top_device_ops': ops,
          'top_device_kernels': kernels,
          'small_n_iters': got.n_iters.tolist(), 'column_stats': shapes,
          'sparse_column': dict(row, **cmp),
          'col_allclose': dict(srow, **scmp)})
    return row, srow


def _dense_batch(torch, tmcl, dense_call):
    """The first inflation batch of the dense pipeline's first
    run_mcl_partitions call, rebuilt as cluster.mcl._sweep builds it:
    (pre-expanded matrix, the batch's inflations, expansion, max_iter,
    pruning)."""
    kw = dense_call['kw']
    ci, cj, cw, m = kw['coo']
    a = tmcl.densify_coo(ci, cj, cw, int(m), DEVICE)
    pre = tmcl._matpower(tmcl._colnorm(a), kw['expansion'])
    del a
    infl = [float(x) for x in dense_call['args'][1]]
    B = tmcl._batch_size(len(infl), int(m))
    return (pre, torch.as_tensor(np.asarray(infl[:B], np.float32),
                                 device=DEVICE),
            kw['expansion'], kw['max_iter'], float(kw['pruning']))


def _gemm_split(busy_ms, kernels):
    """(gemm ms, the rest's ms) of a profile's device ms and its
    _device_ops kernel rows: cuBLAS's kernels carry 'gemm' in their
    names."""
    gemm = sum(k['ms'] for k in kernels if 'gemm' in k['name'].lower())
    return gemm, busy_ms - gemm


def _iteration_profile(torch, iteration):
    """``iteration`` timed with CUDA events, its peak card memory over
    what was resident, and its device time from torch.profiler by op and
    by kernel, the cuBLAS gemm apart."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = kit.time_ms(iteration, STEP_REPS)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        iteration()
        torch.cuda.synchronize()
    busy_ms, ops, kernels = _device_ops(torch, prof, 40)
    gemm_ms, rest_ms = _gemm_split(busy_ms, kernels)
    return {'iteration_ms': ms, 'profiled_device_ms': busy_ms,
            'gemm_ms': gemm_ms, 'column_pass_ms': rest_ms,
            'resident_bytes': resident, 'max_memory_allocated': peak,
            'top_device_ops': ops[:TOP_OPS],
            'top_device_kernels': kernels[:TOP_OPS]}


def _labels_row(torch, tmcl, kmi, final, parts):
    """mcl_interpret on the final matrices of the dense pipeline's first
    batch: its labels equal to its plain version's, exactly, and the
    partitions built from them equal to ``parts`` (interpret_result's on
    the same matrices); both timed with CUDA events, the bound from the
    bytes it must move (kernelkit.mcl_labels_least_bytes)."""
    got = kmi.mcl_labels(final)
    want = kmi.mcl_labels_plain(final)
    err = int((got - want).abs().max())
    from_labels = [tmcl.partition_from_labels(x) for x in got.cpu().numpy()]
    check(err == 0 and from_labels == parts, "mcl_interpret on the dense "
          "pipeline's first batch: labels off the plain version's by up "
          "to {}, partitions {} interpret_result's".format(
              err, 'equal to' if from_labels == parts else 'unlike'))
    del got, want
    torch.cuda.empty_cache()
    return {'max_abs_err': err,
            'ms': kit.time_ms(lambda: kmi.mcl_labels(final), STEP_REPS),
            'plain_ms': kit.time_ms(lambda: kmi.mcl_labels_plain(final), 1),
            'bound_ms': kit.mcl_labels_bound_ms(final), 'bound_by': 'bytes',
            'bytes': kit.mcl_labels_least_bytes(final),
            'attractors': (torch.diagonal(final, dim1=-2, dim2=-1) != 0)
            .sum(dim=1).tolist()}


def phase_dense_step(torch, tmcl, kmc, kmi, dense_call):
    """The dense pipeline's first inflation batch (B = 6, n = 8000), as
    its first run_mcl_partitions call gave it. One iteration (the third:
    expansion by torch.matmul, then the column pass with the statistic)
    through mcl_column and through its plain version: each timed with
    CUDA events, its peak card memory, its device time by op and by
    kernel with the gemm apart. On that iteration's inputs the kernel
    against its plain version: values within rtol 1e-5 / atol 1e-8, equal
    nonzero sets and argmax rows (columns with an entry within
    1e-5·pruning of pruning or a near tie excused, counted), the
    statistic within 1e-7 with the same decision; both timed. Then the
    whole batch through _mcl_batched with the kernel and with the plain
    version in its place: equal iteration counts and partitions (by
    interpret_result). On the kernel's final matrices, mcl_interpret
    (_labels_row). Returns the rows of mcl_column and mcl_interpret."""
    pre, infl, expansion, max_iter, pruning = _dense_batch(torch, tmcl,
                                                          dense_call)
    B, n = infl.shape[0], pre.shape[0]
    m = kmc.mcl_column(pre[None].expand(B, n, n), infl, pruning)[0]
    m = kmc.mcl_column(tmcl._matpower(m, expansion), infl, pruning)[0]
    line = {'phase': 'dense_step', 'B': B, 'n': n, 'expansion': expansion,
            'reps': STEP_REPS}
    for name, fn in (('kernel', kmc.mcl_column),
                     ('plain', kmc.mcl_column_plain)):
        torch.cuda.empty_cache()
        line[name] = _iteration_profile(torch, lambda fn=fn: fn(
            tmcl._matpower(m, expansion), infl, pruning, old=m))
    # the kernel against its plain version on the iteration's inputs
    e = tmcl._matpower(m, expansion)
    got, stat = kmc.mcl_column(e, infl, pruning, old=m)
    want, want_stat = kmc.mcl_column_plain(e, infl, pruning, old=m)
    cmp = kit.mcl_column_compare(got, want,
                                 kmc._inflate(e, infl.view(-1, 1, 1)), pruning)
    del got, want
    stat_err = float((stat - want_stat).abs().max())
    check(cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0
          and cmp['argmax_differ'] == 0 and stat_err <= 1e-7
          and torch.equal(stat <= 1e-8, want_stat <= 1e-8),
          "mcl_column disagrees with its plain version on the dense "
          "pipeline's iteration: {}, statistic {} vs {}".format(
              cmp, stat.tolist(), want_stat.tolist()))
    col_ms, col_plain_ms = (
        kit.time_ms(lambda fn=fn: fn(e, infl, pruning, old=m), STEP_REPS)
        for fn in (kmc.mcl_column, kmc.mcl_column_plain))
    bound, bound_by = kit.mcl_column_bound_ms(B, n, True)
    plan = kmc.plan(n)
    del e, m
    torch.cuda.empty_cache()
    # the whole batch both ways
    batch = {}
    for name in ('kernel', 'plain'):
        with (mock.patch.object(tmcl, 'mcl_column', kmc.mcl_column_plain)
              if name == 'plain' else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.time()
            mm, iters, _ = tmcl._mcl_batched(pre, infl, expansion, max_iter,
                                             pruning)
            nz = (mm != 0).cpu().numpy()
            batch[name] = {'s': time.time() - t0,
                           'n_iters': iters.tolist(),
                           'parts': [tmcl.interpret_result(x) for x in nz]}
            del nz
            if name == 'kernel':
                labels = _labels_row(torch, tmcl, kmi, mm,
                                     batch[name]['parts'])
            del mm
            torch.cuda.empty_cache()
    parts = batch['kernel'].pop('parts')
    check(batch['kernel']['n_iters'] == batch['plain']['n_iters']
          and parts == batch['plain'].pop('parts') and None not in parts,
          'the first batch through the kernel: iterations {} and partitions '
          'differ from the plain version\'s {}'.format(
              batch['kernel']['n_iters'], batch['plain']['n_iters']))
    row = {'max_abs_err': cmp['max_abs_err'], 'ms': col_ms,
           'plain_ms': col_plain_ms, 'bound_ms': bound, 'bound_by': bound_by,
           'plan': plan._asdict(),
           'tb_s': kit.mcl_column_pass_bytes(B, n, True) / col_ms / 1e9}
    emit(dict(line, mcl_column=dict(row, **cmp, stat=stat.tolist(),
                                    stat_max_abs_err=stat_err),
              mcl_interpret=labels, batch=batch,
              clusters=[len(p) for p in parts]))
    return row, labels


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


def phase_allhic(torch, cli, topt, out):
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
            zero_launches(GA_KERNELS)
            t0 = time.time()
            rc = cli.main(['allhic', group, clm, '--resume'])
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = read_launches(GA_KERNELS)
            peak = torch.cuda.max_memory_allocated()
            check(rc == 0, 'allhic exit code {}'.format(rc))
            m = {k: v[-1] for k, v in log.metrics.items()}
            delta_gens = m.get('ga_delta_gens')
            rescores = m.get('ga_rescores')
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
    check_ga_launches(launches, delta_gens, rescores, 'allhic')
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
          'ga_rescores': rescores,
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
    scores each group once, at its batch's start, one launch per group;
    in `sim` a GA call is one group, so there an entry is a GA call):
    'score' that call's arguments, 'rescore' those of the first rescore
    call after it (the batch's first rescoring: its whole G; without
    the ``caches`` flag) or None, 'delta' those of the
    SIM_CHECK_GEN-th delta generation after it ((state before the step,
    its seven draws, (la, lb, d, w), (mutprob, local_frac))) or None,
    'n_delta' its delta calls, 'copy_s' the seconds the copies took. The
    GA reaches score_population, rescore and the delta kernel's wrapper
    (delta_generation_from_draws) by their module's names; all are
    restored on leaving."""
    batches = []
    score, rescore = topt.score_population, topt.rescore
    step = topt.delta_generation_from_draws

    def host(xs):
        return tuple(x.to('cpu', copy=True) for x in xs)

    def recording_score(*args):
        t0 = time.time()
        batches.append({'score': host(args), 'rescore': None, 'delta': None,
                        'n_delta': 0})
        batches[-1]['copy_s'] = time.time() - t0
        return score(*args)

    def recording_rescore(*args, caches):
        b = batches[-1]
        if b['rescore'] is None:
            t0 = time.time()
            b['rescore'] = host(args)
            b['copy_s'] += time.time() - t0
        return rescore(*args, caches=caches)

    def recording_step(state, draws, la, lb, d, w, mutprob, local_frac,
                       *rest, **kw):
        b = batches[-1]
        b['n_delta'] += 1
        if b['n_delta'] == SIM_CHECK_GEN:
            t0 = time.time()
            b['delta'] = (host(state), host(draws), host((la, lb, d, w)),
                          (mutprob, local_frac))
            b['copy_s'] += time.time() - t0
        return step(state, draws, la, lb, d, w, mutprob, local_frac, *rest,
                    **kw)

    topt.score_population = recording_score
    topt.rescore = recording_rescore
    topt.delta_generation_from_draws = recording_step
    try:
        yield batches
    finally:
        topt.score_population = score
        topt.rescore = rescore
        topt.delta_generation_from_draws = step


def _check_sim_launches(torch, kscore, kdelta, krs, topt, what, batch):
    """Each kernel rerun on the arguments one GA call gave it
    (_recorded_launches) and held against its plain version, as phase 4
    holds them: score_population within REL_TOL relative; the rescoring
    by _check_rescore (on the score call's population, with la and lb
    from its records, where the call ran no rescoring: the truth's
    skip_ga call at P = 4); the delta generation from its draws by
    _check_draws (its moves and its result bit-equal to the move mode's
    on the moves _moves_from_draws makes), then the move mode by
    _check_delta and its commit by _check_commit under the plain
    version's acceptance and under all rows accepted."""
    if batch['rescore'] is not None:
        args = [x.to(DEVICE) for x in batch['rescore']]
    else:
        order, ori, lengths, pa, pb, d, w = [x.to(DEVICE)
                                             for x in batch['score']]
        Li = lengths.to(torch.int32)
        args = [order, ori, lengths, pa, pb, torch.gather(Li, 1, pa.long()),
                torch.gather(Li, 1, pb.long()), d, w]
    rescore_row = _check_rescore(torch, krs, args, what)
    del args
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
                                'max_rel_err': rel},
           'rescore_population': rescore_row}
    del args, got, want
    if batch['delta'] is None:
        return row
    state, draws, (la, lb, d, w) = (tuple(x.to(DEVICE) for x in xs)
                                    for xs in batch['delta'][:3])
    settings = batch['delta'][3]
    move = topt._moves_from_draws(*draws, state[0].shape[-1], *settings)
    rec = types.SimpleNamespace(la=la, lb=lb, d=d, w=w)
    kern, plain = kdelta.delta_generation, kdelta.delta_generation_plain
    got = _run(kern, topt, rec, state, move)
    want = _run(plain, topt, rec, state, move)
    drawn = _run_draws(torch, kdelta, topt, rec, state, draws, settings)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got[0]).all()),
          'delta kernel output ({})'.format(what))
    _check_draws(torch, what, move, got, drawn)
    errs = _check_delta(torch, kdelta, topt, what, rec, state, move, got,
                        want)
    mask = want[1]
    del got, want, drawn
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


def phase_sim(torch, cli, kscore, kdelta, krs, topt, out, allhic_tour):
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
            zero_launches(GA_KERNELS)
            t0 = time.time()
            rc = cli.main(['sim', 'ga_study', '--ks',
                           ','.join(map(str, SIM_KS)), '--ngen',
                           str(SIM_NGEN), '--npop', str(SIM_NPOP),
                           '--seed', str(SIM_SEED), '--backend', 'device',
                           '--device', DEVICE, '--out', tsv])
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = read_launches(GA_KERNELS)
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
    rescores = sum(log.metrics['ga_rescores'])
    check(delta_gens > 0 and rescores > 0, 'ga_study reports {} delta '
          'generations and {} rescorings'.format(delta_gens, rescores))
    check_ga_launches(launches, delta_gens, rescores, 'sim')
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
          'ga_delta_gens': delta_gens, 'ga_rescores': rescores,
          'max_memory_allocated': peak})
    # the kernels against their plain versions on what the study gave
    # them (these launches are not counted above)
    for i, batch in enumerate(batches):
        k, what = SIM_KS[i // 3], ('truth', 'cold', 'hot')[i % 3]
        row = _check_sim_launches(torch, kscore, kdelta, krs, topt,
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


def _profiled(fn, calls, name, launches):
    """{'device_ms': the mean device ms of ``fn``'s kernel by
    torch.profiler (None where it recorded none), 'profiled_kernels':
    the kernels it recorded} over ``calls`` calls, after checking that
    the wrapper's launch counter (``launches()``) rose by one a call and
    that the profiler recorded no kernel but ``name``, at most one a
    call. The counter proves the launches: late in this process the
    profiler records fewer kernels than were launched (kernelkit.py)."""
    n0 = launches()
    events = kit.kernel_events(fn, calls)
    check(launches() == n0 + calls + 1, '{}: {} calls (and a warm-up) '
          'counted {} launches'.format(name, calls, launches() - n0))
    kit.check_kernels(events, calls, name)
    return {'device_ms': kit.device_ms(events) if events else None,
            'profiled_kernels': len(events)}


def phase_kernel(torch, kscore, main_args, launches):
    """score_population held against its plain version and timed: at a
    small shape, on random unsorted records at the main path's shape,
    and ('main_path') on the host copy ``main_args`` of the arguments of
    the dense pipeline's largest launch. The GA launches the kernel once
    per group (optimize._Records.score), so that launch is one group."""
    rows = []
    G, P, k = main_args[0].shape
    main = (G, P, k, main_args[3].shape[1])
    cases = [('small', lambda: _score_inputs(torch, 2, 6, 32, 1000, 0)),
             ('main_path_unsorted',
              lambda: _score_inputs(torch, *main, 1, sort=False)),
             ('main_path', lambda: [x.to(DEVICE) for x in main_args])]
    for label, make in cases:
        args = make()
        G, P, k = args[0].shape
        R = args[3].shape[1]
        got = kscore.score_population(*args)
        want = kscore.score_population_plain(*args)
        torch.cuda.synchronize()
        check(got.shape == (G, P) and bool(torch.isfinite(got).all()),
              'score kernel output at {} shape'.format(label))
        abs_err = float((got - want).abs().max())
        rel_err = float(((got - want).abs() / want.abs()).max())
        check(rel_err <= REL_TOL, 'score kernel disagrees at {} shape: '
              'max relative error {}'.format(label, rel_err))
        ms = kit.time_ms(lambda: kscore.score_population(*args), 20)
        plain_ms = kit.time_ms(
            lambda: kscore.score_population_plain(*args), 3)
        # each input read once (order, ori, lengths; pa, pb, d[4], w per
        # record), the scores written once
        nbytes = G * P * k * 8 + G * k * 8 + G * R * 28 + G * P * 4
        ops = 25 * G * P * R
        t_bytes = nbytes / kit.HBM_BPS * 1e3
        t_ops = ops / kit.FP32_FLOPS * 1e3
        row = {'shape': label, 'G': G, 'P': P, 'k': k, 'R': R,
               'max_abs_err': abs_err, 'max_rel_err': rel_err, 'ms': ms,
               'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
               'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
        emit({'phase': 'kernel', 'name': 'score_population',
              'main_path_launches': launches['score_population'], **row})
        rows.append(row)
        del args, got, want
    return rows


def _rescore_inputs(torch, G, P, k, R, seed):
    """A random population and records as _Records hands them to
    rescore (la, lb gathered from the lengths)."""
    order, ori, lengths, pa, pb, d, w = _score_inputs(torch, G, P, k, R,
                                                      seed)
    Li = lengths.to(torch.int32)
    return [order, ori, lengths, pa, pb, torch.gather(Li, 1, pa.long()),
            torch.gather(Li, 1, pb.long()), d, w]


def _check_rescore(torch, krs, args, what):
    """rescore_population against its plain version on ``args``: in
    caches mode L_slot, startsx, the six caches and the contributions
    bit-equal, and each score within half an f32 ulp of the exact (f64)
    sum of the plain version's f32 contributions, plus the f64 sums' own
    error (R * 2^-53 of the contributions' magnitudes each); scores
    mode gives the caches mode's scores; a repeat gives the same bits;
    and, where the launch has five groups or more, the rows of groups
    [2, 5) launched alone are the same bits. Returns the errors."""
    got = krs.rescore(*args, caches=True)
    want = krs.rescore_plain(*args, caches=True)
    torch.cuda.synchronize()
    for n, (a, b) in enumerate(zip(got[:-1], want[:-1])):
        check(torch.equal(a, b), 'rescore kernel differs in field {} ({})'
              .format(n, what))
    c = want[-2].double()
    exact, mag = c.sum(dim=2), c.abs().sum(dim=2)
    del c
    ks = got[-1].abs()
    half_ulp = 0.5 * (torch.nextafter(ks, torch.full_like(ks, np.inf))
                      - ks).double()
    bound = half_ulp + 2.0 * args[3].shape[1] * 2.0 ** -53 * mag
    exact_err = (got[-1].double() - exact).abs()
    check(bool((exact_err <= bound).all()), 'rescore kernel scores are not '
          'the exact sum rounded once ({}): max error / bound {}'.format(
              what, float((exact_err / bound).max())))
    check(torch.equal(krs.rescore(*args, caches=False), got[-1]),
          'rescore kernel: scores mode differs from caches mode ({})'
          .format(what))
    again = krs.rescore(*args, caches=True)
    check(all(torch.equal(a, b) for a, b in zip(again, got)),
          'rescore kernel is not repeatable ({})'.format(what))
    del again
    if args[0].shape[0] >= 5:
        part = krs.rescore(*[x[2:5].contiguous() for x in args],
                           caches=False)
        check(torch.equal(part, got[-1][2:5]), 'rescore kernel: groups '
              '[2, 5) launched alone differ ({})'.format(what))
    G, P, k = args[0].shape
    return {'G': G, 'P': P, 'k_pad': k, 'R_pad': args[3].shape[1],
            'max_abs_err': float((got[-1] - want[-1]).abs().max()),
            'max_err_over_exact_bound': float((exact_err / bound).max()),
            'rows_differing_from_plain': int((got[-1] != want[-1]).sum())}


def phase_rescore(torch, krs, main_args, launches):
    """rescore_population held against its plain version
    (_check_rescore) and timed in both modes, at a small shape and
    ('main_path') on the host copy ``main_args`` of the arguments of the
    dense pipeline's largest batch's first rescoring."""
    rows = []
    cases = [('small', lambda: _rescore_inputs(torch, 6, 6, 32, 1000, 0)),
             ('main_path', lambda: [x.to(DEVICE) for x in main_args])]
    for label, make in cases:
        args = make()
        G, P, k = args[0].shape
        R = args[3].shape[1]
        row = {'shape': label,
               **_check_rescore(torch, krs, args, label + ' shape')}
        for mode, caches in (('scores', False), ('caches', True)):
            ms = kit.time_ms(lambda: krs.rescore(*args, caches=caches), 20)
            prof = _profiled(lambda: krs.rescore(*args, caches=caches), 10,
                             'rescore_kernel', lambda: krs.rescore.launches)
            plain_ms = kit.time_ms(
                lambda: krs.rescore_plain(*args, caches=caches), 3)
            bound, by = kit.rescore_bound_ms(G, P, k, R, caches)
            row[mode] = {'ms': ms, **prof, 'plain_ms': plain_ms,
                         'bound_ms': bound, 'bound_by': by}
        # the line's main figures: caches mode (the bytes the delta
        # kernel then reads are written here)
        row.update({x: row['caches'][x]
                    for x in ('ms', 'plain_ms', 'bound_ms', 'bound_by')})
        emit({'phase': 'kernel', 'name': 'rescore_population',
              'main_path_launches': launches['rescore_population'], **row})
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def _delta_inputs(torch, topt, trace_ga, G, P, k, R, seed):
    """A GA batch as the delta window holds it (trace_ga.make_batch:
    records between near contigs sorted by contig, the caches of a
    random population), the seven draws of one move per individual as
    _dgen draws them, and the moves _moves_from_draws makes of them."""
    rec, state = trace_ga.make_batch(G, P, k, R, seed, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    draws = topt._move_draws(topt._Draws(gen, G), (G, P), k, DEVICE)
    move = topt._moves_from_draws(*draws, k, *_ga_moves(topt))
    return rec, state, draws, move


def _ga_moves(topt):
    """(mutprob, local_frac) of the delta generations' moves (_dgen)."""
    return 1.1, topt._DELTA_LOCAL_FRAC


def _step_draws(kdelta, topt, rec, state, draws, settings, moves_out=None):
    """One delta generation from its draws (the kernel's draws mode, the
    GA's route; settings: (mutprob, local_frac)) on ``state``, which it
    updates in place."""
    return kdelta.delta_generation_from_draws(
        state, draws, rec.la, rec.lb, rec.d, rec.w, *settings,
        topt._DELTA_MIN_GAIN, topt._DELTA_SPAN_GAIN, moves_out=moves_out)


def _run_draws(torch, kdelta, topt, rec, state, draws, settings):
    """(delta, acc, state after, moves) of _step_draws on a copy of
    ``state``."""
    st = _clone(state)
    G, P = state[0].shape[:2]
    moves = tuple(torch.empty((G, P), dtype=dt, device=DEVICE)
                  for dt in (torch.bool,) + (torch.int32,) * 4)
    delta, acc = _step_draws(kdelta, topt, rec, st, draws, settings, moves)
    return delta, acc, st, moves


def _check_draws(torch, what, move, got, drawn):
    """The draws mode's moves bit-equal to _moves_from_draws's ``move``,
    and its delta, acceptance and state bit-equal to the move mode's
    ``got`` on that move."""
    for name, a, b in zip(('do', 'op', 'i', 'j', 't'), drawn[3], move):
        check(torch.equal(a, b), 'delta kernel draws mode: move {} differs '
              'from _moves_from_draws ({})'.format(name, what))
    check(torch.equal(drawn[0], got[0]) and torch.equal(drawn[1], got[1]),
          'delta kernel draws mode: delta or acceptance differs from the '
          'move mode ({})'.format(what))
    for n, (a, b) in enumerate(zip(drawn[2], got[2])):
        check(torch.equal(a, b), 'delta kernel draws mode: state field {} '
              'differs from the move mode ({})'.format(n, what))


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
    written: 28 B a slot; a flip's ori only: 8 B), and per row the seven
    draws (28 B; the move mode reads the move's 17 B instead), its slot
    starts, the score and the outputs (71 B). The arithmetic
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
             + int((span * slot_bytes * acc).sum()) + 71 * G * P)
    nbytes = 28 * n_changed + 28 * n_still + fixed
    touched_bytes = 28 * n_touched + fixed
    scan_bytes = (8 * G * P * R + 20 * n_touched + 28 * G * R
                  + 28 * n_written + 71 * G * P)
    t_ops = 40 * n_changed / kit.FP32_FLOPS * 1e3
    t_bytes = nbytes / kit.HBM_BPS * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'bound_touched_ms': touched_bytes / kit.HBM_BPS * 1e3,
            'bound_scan_ms': scan_bytes / kit.HBM_BPS * 1e3,
            'touched_pairs': n_touched, 'changed_pairs': n_changed,
            'written_pairs': n_written}


def _mean_bound(torch, kdelta, topt, rec, state, seq):
    """The mean of _delta_bound_ms over the generations of the draws
    ``seq`` after its first (the timing's warm-up), each on the state
    the generations before it left and with the acceptance it makes;
    the pair counts and the accepted rows are means too."""
    walk, rows = _clone(state), []
    for n, draws in enumerate(seq):
        _, acc, nxt, move = _run_draws(torch, kdelta, topt, rec, walk,
                                       draws, _ga_moves(topt))
        if n:
            rows.append(dict(_delta_bound_ms(torch, kdelta, walk, move,
                                             acc),
                             accepted_rows_per_gen=int(acc.sum())))
        walk = nxt
    del walk
    labels = [r['bound_by'] for r in rows]
    out = {key: sum(r[key] for r in rows) / len(rows)
           for key in rows[0] if key != 'bound_by'}
    out['bound_by'] = max(set(labels), key=labels.count)
    return out


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
        rec, state, draws, move = _delta_inputs(torch, topt, trace_ga, G, P,
                                                k, R, seed)
        scores = state[-1]
        # the deltas, and the acceptance each version makes; the draws
        # mode (the GA's) bit-equal to the move mode on its moves
        got = _run(kern, topt, rec, state, move)
        want = _run(plain, topt, rec, state, move)
        drawn = _run_draws(torch, kdelta, topt, rec, state, draws,
                           _ga_moves(topt))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got[0]).all()),
              'delta kernel output at {} shape'.format(label))
        errs = _check_delta(torch, kdelta, topt, '{} shape'.format(label),
                            rec, state, move, got, want)
        _check_draws(torch, '{} shape'.format(label), move, got, drawn)
        _check_delta(torch, kdelta, topt, 'draws mode at {} shape'.format(
            label), rec, state, move, drawn, want)
        del drawn
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
        # times, each over successive generations from fresh draws
        # (drawn before the timing) on one copy of the state, as the GA
        # runs them: ms the draws mode, plain_ms _moves_from_draws and
        # the plain step (the sequence's first generations); the bound
        # is the mean of the timed generations'. move_mode_ms: the first
        # draws' move and mask applied again and again to one copy of
        # the state (the moves permute slots inside their own range, so
        # each repetition touches the same records), beside that
        # generation's bound (move_mode_bound_ms)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + 1000)
        seq = [topt._move_draws(topt._Draws(gen, G), (G, P), k, DEVICE)
               for _ in range(21)]
        bound = _mean_bound(torch, kdelta, topt, rec, state, seq)

        def timed_seq(fn, reps):
            st, it = _clone(state), iter(seq)
            return kit.time_ms(lambda: fn(st, next(it)), reps)
        ms = timed_seq(lambda st, dr: _step_draws(
            kdelta, topt, rec, st, dr, _ga_moves(topt)), 20)
        plain_ms = timed_seq(lambda st, dr: _step(
            plain, topt, rec, st, topt._moves_from_draws(
                *dr, k, *_ga_moves(topt))), 3)
        timed = _clone(state)
        move_ms = kit.time_ms(lambda: _step(kern, topt, rec, timed, move,
                                            mask), 20)
        del timed
        first = _delta_bound_ms(torch, kdelta, state, move, mask)
        row = {'shape': label, 'G': G, 'P': P, 'k': k, 'R': R, **errs,
               'pairs': G * P * R, 'accepted_rows': int(mask.sum()),
               'ms': ms, 'plain_ms': plain_ms, **bound,
               'move_mode_ms': move_ms,
               'move_mode_bound_ms': first['bound_ms']}
        emit({'phase': 'kernel', 'name': 'delta_generation',
              'main_path_launches': launches['delta_generation'], **row})
        rows.append(row)
        del rec, state, draws, move
        torch.cuda.empty_cache()
    return rows


def _threshold(torch, topt, scores, move):
    do, op, i, j, t = move
    spanv = torch.where(op == 2, t - i, j - i).to(torch.float32)
    return scores * (topt._DELTA_MIN_GAIN + topt._DELTA_SPAN_GAIN * spanv)


@contextlib.contextmanager
def _first_call(module, name, keep):
    """Appends {'args', 'kw', 'result'} of the first call of
    module.name made inside the block to ``keep`` (the port calls these
    by their module's name); restored on leaving. The stand-in shares
    the function's attributes, so that the counters the function keeps
    on itself (run_mcl_partitions.syncs: it reaches them by its
    module's name) count on through it."""
    fn = getattr(module, name)

    def recording(*args, **kw):
        res = fn(*args, **kw)
        if not keep:
            keep.append({'args': args, 'kw': kw, 'result': res})
        return res

    recording.__dict__ = fn.__dict__
    setattr(module, name, recording)
    try:
        yield keep
    finally:
        setattr(module, name, fn)


def _torchrun(kind, spec, timeout):
    """`python -m torch.distributed.run --standalone --nproc_per_node
    MESH_WORLD chip_smoke.py --mesh-worker kind spec.json`: one process
    per rank, each on cuda:{LOCAL_RANK % device_count}. Returns (wall
    seconds, each rank's JSON record)."""
    path = os.path.join(WORK, 'mesh_{}.json'.format(kind))
    with open(path, 'w') as f:
        json.dump(spec, f)
    for r in range(MESH_WORLD):
        with contextlib.suppress(FileNotFoundError):
            os.remove('{}.rank{}'.format(path, r))
    env = dict(os.environ, PYTHONPATH=REPO)
    # one node: the ranks meet on the loopback interface
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    env.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', str(MESH_WORLD), os.path.abspath(__file__),
         '--mesh-worker', kind, path], env=env, capture_output=True,
        text=True, timeout=timeout)
    wall = time.time() - t0
    with open(os.path.join(WORK, 'mesh_{}.log'.format(kind)), 'w') as f:
        f.write(proc.stdout + proc.stderr)
    sys.stderr.write(proc.stderr[-4000:])
    check(proc.returncode == 0, 'torchrun {} exit code {}'.format(
        kind, proc.returncode))
    recs = []
    for r in range(MESH_WORLD):
        with open('{}.rank{}'.format(path, r)) as f:
            recs.append(json.load(f))
    return wall, recs


def mesh_worker(kind, spec_path) -> int:
    """One rank under torchrun (chip_smoke.py --mesh-worker kind spec):
    'pipeline' runs `cli.main(spec['argv'])` with the launch counts set
    to 0 just before and read just after; 'sparse' runs the sharded
    run_mcl_sparse on spec['coo'] and times each sweep step. Writes the
    rank's record to <spec>.rank<r>."""
    import torch
    sys.path.insert(0, REPO)
    from haphic_tpu_torch.parallel import mesh as pmesh
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ['RANK'])
    logging.basicConfig(level=logging.INFO)
    rec = {'rank': rank, 'local_rank': int(os.environ['LOCAL_RANK'])}
    if kind == 'pipeline':
        from haphic_tpu_torch import cli
        log = MetricsLog()
        logging.getLogger('haphic_tpu_torch').addHandler(log)
        names = GA_KERNELS + DENSE_KERNELS
        zero_launches(names)
        t0 = time.time()
        rc = cli.main(spec['argv'])
        torch.cuda.synchronize()
        rec.update(rc=rc, wall_s=time.time() - t0, metrics=log.metrics,
                   launches=read_launches(names),
                   device=str(torch.cuda.current_device()),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    else:
        from haphic_tpu_torch.cluster import sparse_mcl as sp
        from haphic_tpu_torch.kernels import col_allclose as kca
        from haphic_tpu_torch.kernels import sparse_column as kcol
        pmesh.init_distributed('cuda')
        mesh = pmesh.make_mesh('cuda')
        d = np.load(spec['coo'])
        steps = []
        step = sp._sharded_sweep_step

        def timed(m, idx, *rest, **kw):
            torch.cuda.synchronize()
            st0 = dict(m.stats)
            t0 = time.perf_counter()
            out = step(m, idx, *rest, **kw)
            torch.cuda.synchronize()
            steps.append({
                'ms': (time.perf_counter() - t0) * 1e3,
                'gather_ms': (m.stats['collective_s']
                              - st0['collective_s']) * 1e3,
                'bytes': m.stats['collective_bytes']
                - st0['collective_bytes'], 'K': int(idx.shape[2])})
            return out

        sp._sharded_sweep_step = timed
        torch.cuda.reset_peak_memory_stats()
        kcol.sparse_column.launches = 0
        kca.col_allclose.launches = 0
        t0 = time.time()
        res = sp.run_mcl_sparse(d['i'], d['j'], d['w'], int(d['n']),
                                d['inflations'].tolist(), K=int(d['K']),
                                expansion=int(d['expansion']),
                                max_iter=int(d['max_iter']),
                                pruning=float(d['pruning']), mesh=mesh)
        sweep_s = time.time() - t0
        launches = {'sparse_column': kcol.sparse_column.launches,
                    'col_allclose': kca.col_allclose.launches}
        np.save('{}.idx{}.npy'.format(spec_path, rank), res.idx)
        np.save('{}.val{}.npy'.format(spec_path, rank), res.val)
        rec.update(rc=0, sweep_s=sweep_s, n_iters=res.n_iters.tolist(),
                   converged=res.converged.tolist(), k_steps=res.k_steps,
                   steps=steps, launches=launches, backend=mesh.backend,
                   world=mesh.world,
                   device=str(mesh.device),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        pmesh.shutdown_distributed()
    with open('{}.rank{}'.format(spec_path, rank), 'w') as f:
        json.dump(rec, f, default=str)
    return int(rec['rc'])


def _read_all(root, rels):
    """{rel: bytes} of the files ``rels`` under root, read from 16
    threads (tens of thousands of small files: the opens dominate)."""
    from concurrent.futures import ThreadPoolExecutor

    def read(rel):
        with open(os.path.join(root, rel), 'rb') as f:
            return f.read()
    with ThreadPoolExecutor(16) as pool:
        return dict(zip(rels, pool.map(read, rels)))


def phase_mesh_pipeline(torch, out):
    """The dense phase's genome, flags and cut through `python -m
    torch.distributed.run --standalone --nproc_per_node 2 -m
    haphic_tpu_torch pipeline ... --use_mesh on` (here through this
    script's worker, which calls the same cli.main): ingest, the
    inflations and the GA groups shard over the two ranks (both on
    cuda:0 over gloo on one card, one card each over NCCL on two).
    Each rank's MCL and GA must run on the card with their kernels
    (mcl_column, mcl_interpret, score_population, delta_generation,
    rescore_population), one delta launch per delta generation, one
    rescoring launch per rescoring call and one labels launch per dense
    batch it reports; out_mesh/ and
    out_mesh.rank1/ must equal the single-process out/: every
    01.cluster file, scaffolds.agp and scaffolds.raw.agp; the 8
    chromosomes come back. Returns the launches summed over the
    ranks."""
    fa = os.path.join(WORK, 'sim', 'asm.fa')
    pairs = os.path.join(WORK, 'sim', 'hic.pairs')
    mesh_out = os.path.join(WORK, 'out_mesh')
    for r in range(MESH_WORLD):
        shutil.rmtree(mesh_out + ('.rank{}'.format(r) if r else ''),
                      ignore_errors=True)
    argv = ['pipeline', fa, pairs, str(SIM['nchrs']), '--outdir', mesh_out,
            '--ngen', str(NGEN), '--use_mesh', 'on'] + SIM_FLAGS
    wall, recs = _torchrun('pipeline', {'argv': argv}, 420)
    launches = dict.fromkeys(GA_KERNELS + DENSE_KERNELS, 0)
    ranks = []
    for r, rec in enumerate(recs):
        m = rec['metrics']
        check(rec['rc'] == 0, 'rank {} exit code {}'.format(r, rec['rc']))
        mesh = m['mesh'][-1]
        check(mesh['world'] == MESH_WORLD and mesh['rank'] == r,
              'rank {} mesh {}'.format(r, mesh))
        check(m['mcl_route'][-1] == 'cuda' and m['ga_route'][-1] == 'cuda',
              'rank {}: MCL on {}, GA on {}'.format(
                  r, m['mcl_route'][-1], m['ga_route'][-1]))
        for kname, n in rec['launches'].items():
            check(n > 0, 'rank {} launched no {}'.format(r, kname))
            launches[kname] += n
        check_ga_launches(rec['launches'], sum(m['ga_delta_gens']),
                          sum(m['ga_rescores']), 'rank {}'.format(r))
        check_label_launches(rec['launches'], m, 'rank {}'.format(r))
        ranks.append({'rank': r, 'device': mesh['device'],
                      'backend': mesh['backend'],
                      'mcl_shard': m['mcl_shard'][-1],
                      'ga_batches': m['ga_batch'],
                      'ga_delta_gens': sum(m['ga_delta_gens']),
                      'ga_rescores': sum(m['ga_rescores']),
                      'launches': rec['launches'],
                      'stage_s': m['stage_secs'][-1],
                      'cluster_s': m['cluster_secs'][-1],
                      'ga_s': m['ga_secs'][-1], 'wall_s': rec['wall_s'],
                      'collectives': m['mesh_stats'][-1],
                      'max_memory_allocated': rec['max_memory_allocated']})
    rels = ['04.build/scaffolds.agp', '04.build/scaffolds.raw.agp']
    for d, _, files in os.walk(os.path.join(out, '01.cluster')):
        rels += [os.path.relpath(os.path.join(d, f), out) for f in files
                 if not os.path.islink(os.path.join(d, f))]
    t0 = time.time()
    want = _read_all(out, rels)
    for r in range(MESH_WORLD):
        got = mesh_out + ('.rank{}'.format(r) if r else '')
        bad = [rel for rel, data in _read_all(got, rels).items()
               if data != want[rel]]
        check(not bad, 'rank {} differs from the single-process run in '
              '{} files, e.g. {}'.format(r, len(bad), bad[:5]))
        part = check_partition(os.path.join(got, '04.build',
                                            'scaffolds.agp'), SIM['nchrs'])
    emit({'phase': 'mesh_pipeline', 'world': MESH_WORLD,
          'backend': ranks[0]['backend'], 'sim': SIM,
          'cut': {'ngen': [5000, NGEN]}, 'files_equal': len(rels),
          'wall_s': wall, 'compare_s': time.time() - t0, 'ranks': ranks,
          'launches': launches, **part})
    return launches


def phase_mesh_sparse(torch, sp, call):
    """The sparse phase's adjacency (n = 24,000, K = 128), its first
    inflation batch only (a cut: MESH_SPARSE_B of its inflations),
    through the column-sharded run_mcl_sparse on two torchrun ranks,
    against the meshless run on the same input: iterates, iteration
    counts and K shrinks bit-equal. Prints each sharded step's ms and
    all-gather ms and bytes, the peak memory per rank. Returns the
    sparse_column and col_allclose launches summed over the ranks
    (counted in each rank from 0 just before its run_mcl_sparse)."""
    (i, j, w, n, infl), kw = call['args'], call['kw']
    infl = list(infl)[:MESH_SPARSE_B]
    coo = os.path.join(WORK, 'mesh_sparse_coo.npz')
    np.savez(coo, i=i, j=j, w=w, n=n, inflations=np.asarray(infl),
             K=kw['K'], expansion=kw['expansion'], max_iter=kw['max_iter'],
             pruning=kw['pruning'])
    wall, recs = _torchrun('sparse', {'coo': coo}, 300)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    want = sp.run_mcl_sparse(i, j, w, n, infl, K=kw['K'],
                             expansion=kw['expansion'],
                             max_iter=kw['max_iter'],
                             pruning=kw['pruning'], device=DEVICE)
    meshless_s = time.time() - t0
    spec = os.path.join(WORK, 'mesh_sparse.json')
    ranks = []
    launches = {'sparse_column': 0, 'col_allclose': 0}
    for r, rec in enumerate(recs):
        for kname in launches:
            n_r = rec['launches'][kname]
            check(n_r > 0, 'rank {} launched no {}'.format(r, kname))
            launches[kname] += n_r
        check(rec['launches']['col_allclose'] == len(rec['steps']),
              'rank {}: col_allclose launched {} times in {} sharded steps'
              .format(r, rec['launches']['col_allclose'], len(rec['steps'])))
        idx = np.load('{}.idx{}.npy'.format(spec, r))
        val = np.load('{}.val{}.npy'.format(spec, r))
        diff = int((idx != want.idx).sum() + (val != want.val).sum())
        check(diff == 0, 'rank {}: {} iterate entries differ from the '
              'meshless run'.format(r, diff))
        check(rec['n_iters'] == want.n_iters.tolist()
              and rec['k_steps'] == want.k_steps,
              'rank {}: iterations {} / K steps {} vs meshless {} / {}'
              .format(r, rec['n_iters'], rec['k_steps'],
                      want.n_iters.tolist(), want.k_steps))
        st = rec['steps']
        full = [x for x in st if x['K'] == kw['K']]
        ranks.append({'rank': r, 'device': rec['device'],
                      'sweep_s': rec['sweep_s'], 'steps': len(st),
                      'launches': rec['launches'],
                      'step_ms_at_K': [x['ms'] for x in full],
                      'gather_ms_at_K': [x['gather_ms'] for x in full],
                      'gather_bytes_at_K': full[0]['bytes'] if full else 0,
                      'gather_ms_total': sum(x['gather_ms'] for x in st),
                      'max_memory_allocated': rec['max_memory_allocated']})
    emit({'phase': 'mesh_sparse', 'world': recs[0]['world'],
          'backend': recs[0]['backend'], 'n': n, 'K': kw['K'],
          'inflations': infl, 'cut': {'inflations': [len(call['args'][4]),
                                                     len(infl)]},
          'n_iters': want.n_iters.tolist(), 'k_steps': want.k_steps,
          'equal': True, 'wall_s': wall, 'meshless_s': meshless_s,
          'meshless_max_memory_allocated': torch.cuda.max_memory_allocated(),
          'ranks': ranks, 'launches': launches})
    return launches


def phase_mesh_nccl(torch, sp, topt, dense_call, ga_call, step_args):
    """A one-rank NCCL group in this process, so that NCCL's collectives
    run on CUDA tensors on the card even with one card: the sharded
    dense sweep (its first MESH_DENSE_B inflations, n = 8000), the
    sharded sparse step (the sparse pipeline's first step, B = 4, n+1 =
    24,001, K = 128) and the sharded GA (the dense pipeline's call, its
    batch of 7 groups) against the meshless calls: bit-equal."""
    from haphic_tpu_torch.cluster import mcl as tmcl
    from haphic_tpu_torch.kernels import col_allclose as kca
    from haphic_tpu_torch.kernels import mcl_column as kmc
    from haphic_tpu_torch.kernels import mcl_interpret as kmi
    from haphic_tpu_torch.kernels import sparse_column as kcol
    from haphic_tpu_torch.parallel import mesh as pmesh
    store = os.path.join(WORK, 'nccl_store')
    with contextlib.suppress(FileNotFoundError):
        os.remove(store)
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    pmesh.init_distributed(DEVICE, init_method='file://' + store, rank=0,
                           world_size=1)
    try:
        mesh = pmesh.make_mesh(DEVICE)
        check(mesh.backend == 'nccl', 'backend {}'.format(mesh.backend))
        line = {'phase': 'mesh_nccl', 'world': mesh.world,
                'backend': mesh.backend}
        # dense sweep
        kw = dict(dense_call['kw'])
        kw.pop('device', None)
        infl = list(dense_call['args'][1])[:MESH_DENSE_B]
        kmc.mcl_column.launches = 0
        kmi.mcl_labels.launches = 0
        t0 = time.time()
        got = pmesh.mcl_sweep_sharded_partitions(mesh, None, infl, **kw)
        torch.cuda.synchronize()
        t1 = time.time()
        mcl_launches = kmc.mcl_column.launches
        label_launches = kmi.mcl_labels.launches
        check(mcl_launches > 0 and label_launches > 0, 'the sharded dense '
              'sweep launched mcl_column {} and mcl_interpret {} times'
              .format(mcl_launches, label_launches))
        want = tmcl.run_mcl_partitions(None, infl, device=DEVICE, **kw)
        line['dense'] = {'n': kw['coo'][3], 'inflations': infl,
                         'n_iters': got[1].tolist(), 'sharded_s': t1 - t0,
                         'launches': mcl_launches,
                         'label_launches': label_launches,
                         'meshless_s': time.time() - t1}
        check(got[0] == want[0] and np.array_equal(got[1], want[1]),
              'sharded dense sweep differs from the meshless one')
        # sparse step
        si, sv, f, active, n, K, chunk, pruning, expansion = step_args
        si, sv, f = si.to(DEVICE), sv.to(DEVICE), f.to(DEVICE)
        kcol.sparse_column.launches = 0
        kca.col_allclose.launches = 0
        t0 = time.time()
        g = sp._sharded_sweep_step(mesh, si, sv, f, active, n, K, chunk,
                                   pruning, expansion)
        torch.cuda.synchronize()
        t1 = time.time()
        col_launches = kcol.sparse_column.launches
        stat_launches = kca.col_allclose.launches
        check(col_launches > 0 and stat_launches == 1, 'the sharded '
              'sparse step launched sparse_column {} and col_allclose {} '
              'times'.format(col_launches, stat_launches))
        w_ = sp._sweep_step(si, sv, f, active, n, K, chunk, pruning,
                            expansion)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(g[:2], w_[:2]))
              and torch.equal(g[2].double(), w_[2].double())
              and int(g[3]) == int(w_[3]),
              'sharded sparse step differs from the meshless one')
        line['sparse_step'] = {'B': int(si.shape[0]), 'n_plus_1': n + 1,
                               'K': K, 'launches': col_launches,
                               'stat_launches': stat_launches,
                               'sharded_s': t1 - t0,
                               'meshless_s': time.time() - t1}
        del si, sv, g, w_
        # GA
        kw = dict(ga_call['kw'], mesh=mesh)
        log = MetricsLog()
        logging.getLogger('haphic_tpu_torch').addHandler(log)
        zero_launches(GA_KERNELS)
        t0 = time.time()
        try:
            res = topt.optimize_tours(*ga_call['args'], **kw)
        finally:
            logging.getLogger('haphic_tpu_torch').removeHandler(log)
        secs = time.time() - t0
        launches = dict(read_launches(GA_KERNELS),
                        sparse_column=col_launches, mcl_column=mcl_launches,
                        col_allclose=stat_launches,
                        mcl_interpret=label_launches)
        for kname in GA_KERNELS:
            check(launches[kname] > 0, 'the sharded GA launched no {}'
                  .format(kname))
        check_ga_launches(launches, sum(log.metrics['ga_delta_gens']),
                          sum(log.metrics['ga_rescores']), 'sharded GA')
        want = ga_call['result']
        same = [np.array_equal(a.order, b.order)
                and np.array_equal(a.ori, b.ori) and a.score == b.score
                and a.history == b.history for a, b in zip(res, want)]
        check(len(res) == len(want) and all(same),
              'sharded GA differs from the meshless one in groups {}'
              .format([t for t, ok in enumerate(same) if not ok]))
        line['ga'] = {'groups': len(res), 'sharded_s': secs,
                      'launches': launches}
        line['collectives'] = dict(mesh.stats)
        line['equal'] = True
        emit(line)
    finally:
        pmesh.shutdown_distributed()
    return launches


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == '--mesh-worker':
        return mesh_worker(sys.argv[2], sys.argv[3])
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: CUDA is not available\n')
        return 1
    sys.path.insert(0, REPO)
    from haphic_tpu_torch import cli
    from haphic_tpu_torch.cluster import mcl as tmcl
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.cluster.sweep import SPARSE_MIN_N
    from haphic_tpu_torch.kernels import build as kbuild
    from haphic_tpu_torch.kernels import delta as kdelta
    from haphic_tpu_torch.kernels import mcl_column as kmc
    from haphic_tpu_torch.kernels import mcl_interpret as kmi
    from haphic_tpu_torch.kernels import rescore as krs
    from haphic_tpu_torch.kernels import score as kscore
    from haphic_tpu_torch.order import optimize as topt

    import trace_ga

    phase_env(torch, kbuild)
    dense_call, ga_call, sparse_call = [], [], []
    with _first_call(tmcl, 'run_mcl_partitions', dense_call), \
            _first_call(topt, 'optimize_tours', ga_call), \
            _recorded_launches(topt) as ga_launches:
        launches, big = phase_pipeline(torch, cli)
    main_rows = dict(zip(DENSE_KERNELS, phase_dense_step(
        torch, tmcl, kmc, kmi, dense_call[0])))
    torch.cuda.empty_cache()
    # the largest score launch (most tours x records) of the pipeline
    main_score = max((b['score'] for b in ga_launches), key=lambda a:
                     a[0].shape[0] * a[0].shape[1] * a[3].shape[1])
    # the largest batch's first rescoring
    main_rescore = max((b['rescore'] for b in ga_launches
                        if b['rescore'] is not None), key=lambda a:
                       a[0].shape[0] * a[0].shape[1] * a[3].shape[1])
    del ga_launches
    main_rows['score_population'] = phase_kernel(torch, kscore, main_score,
                                                 launches)[-1]
    main_rows['rescore_population'] = phase_rescore(torch, krs, main_rescore,
                                                    launches)[-1]
    del main_rescore
    main_rows['delta_generation'] = phase_delta(torch, kdelta, topt,
                                                trace_ga, big, launches)[-1]
    torch.cuda.empty_cache()
    by_phase = {'pipeline': launches}
    with _first_call(sp, 'run_mcl_sparse', sparse_call):
        first_step, by_phase['sparse_pipeline'] = phase_sparse_pipeline(
            torch, cli, sp, SPARSE_MIN_N)
    sparse_call[0].pop('result')
    main_rows['sparse_column'], main_rows['col_allclose'] = \
        phase_sparse_step(torch, sp, first_step)
    main_rows['ell_build'] = phase_ell_build(torch, sp)
    # on the host: its tensors would count in the next peaks
    step_args = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                      for x in first_step)
    del first_step
    torch.cuda.empty_cache()
    by_phase['polyploid_pipeline'] = phase_polyploid_pipeline(
        torch, cli)
    torch.cuda.empty_cache()
    by_phase['correct_pipeline'] = phase_correct_pipeline(
        torch, cli)
    torch.cuda.empty_cache()
    out = os.path.join(WORK, 'out')
    by_phase['allhic'], allhic_tour = phase_allhic(
        torch, cli, topt, out)
    torch.cuda.empty_cache()
    phase_post(torch, out, os.path.join(WORK, 'sim'), SIM)
    torch.cuda.empty_cache()
    by_phase['sim'] = phase_sim(torch, cli, kscore, kdelta, krs, topt, out,
                                allhic_tour)
    torch.cuda.empty_cache()
    by_phase['mesh_pipeline'] = phase_mesh_pipeline(torch, out)
    by_phase['mesh_sparse'] = phase_mesh_sparse(torch, sp, sparse_call[0])
    by_phase['mesh_nccl'] = phase_mesh_nccl(
        torch, sp, topt, dense_call[0], ga_call[0], step_args)
    kernels = []
    for k in KERNELS:
        row = main_rows[k['name']]
        counts = {p: n.get(k['name'], 0) for p, n in by_phase.items()}
        check(sum(counts.values()) > 0, 'kernel {} was launched on no '
              'path'.format(k['name']))
        # no single PyTorch call computes any of the eight functions
        kernels.append(dict(k, launches=sum(counts.values()),
                            launches_by_phase=counts,
                            max_abs_err=row['max_abs_err'], ms=row['ms'],
                            plain_ms=row['plain_ms'],
                            bound_ms=row['bound_ms'],
                            bound_by=row['bound_by'], library_ms=None,
                            **{x: row[x] for x in ('plan', 'tb_s', 'scores',
                                                   'bytes', 'attractors')
                               if x in row}))
    print(kit.nvidia_smi(), flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())

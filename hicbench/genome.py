"""The benchmark's genomes: a configuration's published sizes turned into
contigs, Hi-C link counts between them and the MCL fragment link list.
Everything here is numpy on the host and imports nothing of the program.

The Hi-C library has the published depth: ``hic_depth_x`` times the
genome, read as pairs of ``read_bp`` reads, every pair mapped. A share
``trans_share`` of the pairs have both ends uniform over the genome; the
rest lie on one chromosome at a separation s whose density follows the
contact-decay law P(s) ~ 1/s (Lieberman-Aiden et al. 2009) from
``s_min_bp`` to the chromosome's length. The expected number of pairs
between two contigs of one chromosome is that law integrated over the
two contigs, so the link counts are drawn as Poisson counts of those
expectations; the uniform pairs are drawn one by one, and each link
keeps how many of its pairs are uniform (``w_trans``), so that
``clm.py`` can place every read pair of a link.

The counts are drawn from the configuration's ``genome_seed``; a run's
``--seed`` relabels them: it orders the kept fragments of the MCL input
at random. So every seed gives the program the same work in another
order, and two seeds' times differ no more than two runs of one seed.

The Nx selection is a copy of ``haphic_tpu_torch/core/fragments.py``'s
(commit 2773cb2): the fragments in input order, shuffled by
``random.Random(12345)``, stably sorted by length (descending), kept
while the cumulative length stays under Nx percent, plus one.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Tuple

import numpy as np

BIN_MIN_BP = 100_000
BIN_MAX_BP = 2_000_000


@dataclass
class Sizes:
    """The sizes that follow from a configuration (printed by each run)."""
    contigs: int
    groups: int
    contig_bp: int
    bin_bp: int
    fragments: int          # contigs after the Nx cut (no contig is split)
    pairs: int              # read pairs of the library
    trans_pairs: int        # of them, uniform over the genome


@dataclass
class Genome:
    sizes: Sizes
    group_start: np.ndarray     # int64 [groups + 1]: first contig of each
    i: np.ndarray               # int64 [links]: contig pairs, i < j
    j: np.ndarray
    w: np.ndarray               # float64 [links]: read pairs between them
    w_trans: np.ndarray         # float64 [links]: of w, the uniform pairs
    seed: int                   # the run's seed: the labels' order


def derive(cfg: dict) -> Sizes:
    """The sizes of ``cfg``: equal contigs, the bin rule of HapHiC
    (clamp(genome / groups / 30, 100 kb, 2 Mb)), the Nx cut, the
    library's read pairs."""
    pub, asm = cfg['published'], cfg['assumed']
    n = int(pub['contigs'])
    genome_bp = int(pub['genome_bp'])
    groups = int(pub['chromosomes']) * int(pub['haplotypes'])
    contig_bp = genome_bp // n
    bin_bp = min(max(genome_bp // groups // 30, BIN_MIN_BP), BIN_MAX_BP)
    if contig_bp > bin_bp:
        raise ValueError('contigs of {} bp would be split into {} bp bins'
                         .format(contig_bp, bin_bp))
    kept = int(nx_mask(n, int(cfg['pipeline']['Nx'])).sum())
    pairs = int(round(float(pub['hic_depth_x']) * genome_bp
                      / (2 * int(asm['read_bp']))))
    return Sizes(contigs=n, groups=groups, contig_bp=contig_bp,
                 bin_bp=bin_bp, fragments=kept, pairs=pairs,
                 trans_pairs=int(round(pairs * float(asm['trans_share']))))


def nx_mask(n: int, nx: int) -> np.ndarray:
    """bool [n]: the fragments the Nx cut keeps, for n equal fragments
    in input order (copy of the port's selection, see the header)."""
    order = list(range(n))
    rng = random.Random()
    rng.seed(12345)
    rng.shuffle(order)
    mask = np.zeros(n, dtype=bool)
    selected = 0
    for fid in order:
        if (selected + 1) / n * 100 < nx or nx == 100:
            mask[fid] = True
            selected += 1
    if nx != 100 and selected < n:
        mask[order[selected]] = True
    return mask


def _x_log_x(u: np.ndarray) -> np.ndarray:
    return np.where(u > 0, u * np.log(np.maximum(u, 1)), 0.0)


def cis_expected(d: np.ndarray, contig_bp: int, chrom_bp: int,
                 cis_pairs: float, s_min_bp: int) -> np.ndarray:
    """The expected read pairs between two contigs ``d`` >= 1 contigs
    apart on a chromosome of ``chrom_bp`` that holds ``cis_pairs``
    pairs, under a pair density kappa / |x - y| for |x - y| >= s_min.

    Over two contigs of length L, the integral of 1 / (y - x) is
    L (g(d + 1) - 2 g(d) + g(d - 1)) with g(u) = u ln u (the terms in L
    ln L and linear in u cancel), less s_min for adjacent contigs (the
    strip |x - y| < s_min across their boundary). kappa makes the whole
    chromosome hold cis_pairs: C ln(C / s_min) - C + s_min."""
    C, L, s = float(chrom_bp), float(contig_bp), float(s_min_bp)
    kappa = cis_pairs / (C * np.log(C / s) - C + s)
    d = d.astype(np.float64)
    area = L * (_x_log_x(d + 1) - 2 * _x_log_x(d) + _x_log_x(d - 1))
    return kappa * (area - np.where(d == 1, s, 0.0))


def make(cfg: dict, seed: int) -> Genome:
    """The genome of ``cfg``, drawn from its ``genome_seed``, to be
    labelled by ``seed``."""
    sizes = derive(cfg)
    asm = cfg['assumed']
    n, G, L = sizes.contigs, sizes.groups, sizes.contig_bp
    per = np.full(G, n // G, dtype=np.int64)
    per[:n % G] += 1
    start = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(per, out=start[1:])
    rng = np.random.default_rng(int(asm['genome_seed']))
    cis_total = sizes.pairs - sizes.trans_pairs
    keys, counts = [], []
    for g in range(G):
        k = int(per[g])
        a, b = np.triu_indices(k, 1)
        lam = cis_expected(np.arange(1, k), L, k * L,
                           cis_total * k / n, int(asm['s_min_bp']))
        c = rng.poisson(lam[b - a - 1])
        nz = c > 0
        keys.append((start[g] + a[nz]) * n + start[g] + b[nz])
        counts.append(c[nz])
    # the uniform pairs; those inside one contig are no link
    ta = rng.integers(0, n, sizes.trans_pairs)
    tb = rng.integers(0, n, sizes.trans_pairs)
    sel = ta != tb
    lo, hi = np.minimum(ta[sel], tb[sel]), np.maximum(ta[sel], tb[sel])
    keys.append(lo * n + hi)
    counts.append(np.ones(int(sel.sum()), dtype=np.int64))
    key, inv = np.unique(np.concatenate(keys), return_inverse=True)
    w = np.bincount(inv, weights=np.concatenate(counts).astype(np.float64))
    n_trans = counts[-1].size
    w_trans = np.bincount(inv[inv.size - n_trans:], minlength=key.size
                          ).astype(np.float64)
    return Genome(sizes=sizes, group_start=start, i=key // n, j=key % n,
                  w=w, w_trans=w_trans, seed=seed % 2 ** 64)


def fragment_links(gn: Genome, nx: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(ci, cj, cw, m): the MCL input as the cluster stage hands it to
    the engines (``cluster/sweep.build_adjacency_coo``): pair counts
    between distinct kept fragments, upper triangle (ci < cj) in local
    ids of the kept fragments, ordered at random by the run's seed,
    float64 weights.
    Every position lies in a flanking region (contigs are shorter than
    twice the default 500 kb flank), so every pair counts."""
    keep = nx_mask(gn.sizes.contigs, nx)
    m = int(keep.sum())
    local = np.full(gn.sizes.contigs, -1, dtype=np.int64)
    local[keep] = np.random.default_rng([gn.seed, 0]).permutation(m)
    li, lj = local[gn.i], local[gn.j]
    sel = (li >= 0) & (lj >= 0)
    lo = np.minimum(li[sel], lj[sel])
    hi = np.maximum(li[sel], lj[sel])
    order = np.argsort(lo * m + hi)
    return lo[order], hi[order], gn.w[sel][order], m

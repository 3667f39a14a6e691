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

A configuration whose ``assumed`` has a ``length_law`` gets contigs of
unequal lengths instead (``make_lengths``): the log-normal law of the
published mean and N50, contigs over the bin size split into bins as
HapHiC does, and the links between the kept fragments' flanking regions
drawn from the same decay law integrated over those regions.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Tuple

import numpy as np
from scipy.special import ndtri

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


def make(cfg: dict, seed: int):
    """The genome of ``cfg``, drawn from its ``genome_seed``, to be
    labelled by ``seed``: a ``Layout`` where the configuration assumes
    a length law, else a ``Genome`` of equal contigs."""
    if 'length_law' in cfg['assumed']:
        return make_lengths(cfg, seed)
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


# ---- contigs of unequal lengths ----

@dataclass
class LayoutSizes:
    """The sizes of a ``Layout`` (printed by each run)."""
    contigs: int
    groups: int
    bin_bp: int
    fragments: int          # after contigs over bin_bp are split
    kept: int               # fragments the Nx cut keeps
    split_contigs: int
    n50_bp: int             # of the drawn lengths
    sigma: float            # the log-normal's shape, fit to the N50
    pairs: int
    trans_pairs: int


@dataclass
class Layout:
    """Contigs of unequal lengths, ids running along the chromosomes,
    split into fragments; the links between kept fragments' flanking
    regions, in genome fragment ids (bins in order within a contig,
    contigs in id order)."""
    sizes: LayoutSizes
    group_start: np.ndarray     # int64 [groups + 1]: first contig of each
    contig_len: np.ndarray      # int64 [contigs]
    frag_offset: np.ndarray     # int64 [contigs + 1]: first fragment
    frag_len: np.ndarray        # int64 [fragments]
    keep: np.ndarray            # bool [fragments]: the Nx cut
    i: np.ndarray               # int64 [links]: fragment pairs, i < j
    j: np.ndarray
    w: np.ndarray               # float64 [links]: read pairs between them
    seed: int


def _n50(lengths: np.ndarray) -> int:
    s = np.sort(lengths)[::-1]
    c = np.cumsum(s)
    return int(s[np.searchsorted(c, c[-1] / 2)])


def lengths(n: int, genome_bp: int, n50_bp: int) -> Tuple[np.ndarray,
                                                          float]:
    """(n contig lengths in ascending order summing to genome_bp, sigma):
    the log-normal law at the quantiles (k + 1/2) / n, its shape sigma
    fit by bisection so that the lengths' N50 is n50_bp (to the step
    between two lengths), scaled to the genome."""
    z = ndtri((np.arange(n) + 0.5) / n)

    def at(sigma):
        x = np.exp(sigma * (z - z.max()))
        out = np.maximum(np.round(x * (genome_bp / x.sum())), 1)
        out = out.astype(np.int64)
        out[-1] += genome_bp - int(out.sum())
        return out
    lo, hi = 0.01, 5.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if _n50(at(mid)) < n50_bp:
            lo = mid
        else:
            hi = mid
    return at(hi), hi


def bins(contig_len: np.ndarray, bin_bp: int
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(frag_offset [contigs + 1], frag_len [fragments]): a contig over
    bin_bp split into bins of bin_bp from its start, the last bin the
    rest; as ``haphic_tpu_torch/core/fragments.py`` ``build_fragments``
    (commit 1df7d85)."""
    split = contig_len > bin_bp
    nb = np.where(split, (contig_len + bin_bp - 1) // bin_bp, 1)
    off = np.zeros(contig_len.size + 1, dtype=np.int64)
    np.cumsum(nb, out=off[1:])
    ctg = np.repeat(np.arange(contig_len.size), nb)
    k = np.arange(int(off[-1])) - off[ctg]
    flen = np.where(k < nb[ctg] - 1, bin_bp, contig_len[ctg] - k * bin_bp)
    return off, flen.astype(np.int64)


def nx_keep(frag_len: np.ndarray, nx: int) -> np.ndarray:
    """bool [fragments]: the fragments the Nx cut keeps, fragments in
    input order (the copy of the port's selection, for any lengths)."""
    m = frag_len.size
    order = list(range(m))
    rng = random.Random()
    rng.seed(12345)
    rng.shuffle(order)
    order.sort(key=lambda f: int(frag_len[f]), reverse=True)
    total = int(frag_len.sum())
    mask = np.zeros(m, dtype=bool)
    acc = selected = 0
    for f in order:
        acc += int(frag_len[f])
        if acc / total * 100 < nx or nx == 100:
            mask[f] = True
            selected += 1
    if nx != 100 and selected < m:
        mask[order[selected]] = True
    return mask


def _phi(u: np.ndarray, s: float) -> np.ndarray:
    """The second antiderivative of 1/u on u >= s (0 below s), 0 with
    its slope at s: u ln(u / s) - u + s."""
    v = np.maximum(u, s)
    return np.where(u > s, v * np.log(v / s) - v + s, 0.0)


def pair_integral(x0, x1, y0, y1, s: float) -> np.ndarray:
    """The integral of 1 / (y - x) over x in [x0, x1), y in [y0, y1),
    y - x >= s, for x1 <= y0: the contact law over two regions."""
    return (_phi(y1 - x0, s) - _phi(y1 - x1, s) - _phi(y0 - x0, s)
            + _phi(y0 - x1, s))


def make_lengths(cfg: dict, seed: int) -> Layout:
    """The genome of ``cfg`` with contigs of the law's lengths.

    The lengths are dealt to the contigs by a permutation drawn from
    ``genome_seed``; ``chromosomes x haplotypes`` groups take n / groups
    contigs each, in id order. A pair is a link of the flank COO where
    both its ends lie in kept fragments, in their flanking regions (the
    first and last ``flank_kbp`` of a fragment longer than twice that,
    else the whole fragment: ``core/contacts.py`` ``is_flank``), and on
    two fragments. The cis pairs between two regions are a Poisson count
    of the law's integral over them (``pair_integral``); the uniform
    pairs are drawn one by one."""
    pub, asm = cfg['published'], cfg['assumed']
    n = int(pub['contigs'])
    genome_bp = int(pub['genome_bp'])
    G = int(pub['chromosomes']) * int(pub['haplotypes'])
    bin_bp = min(max(genome_bp // G // 30, BIN_MIN_BP), BIN_MAX_BP)
    flank = int(cfg['pipeline']['flank_kbp']) * 1000
    s_min = float(asm['s_min_bp'])
    rng = np.random.default_rng(int(asm['genome_seed']))
    law, sigma = lengths(n, genome_bp, int(pub['contig_n50_bp']))
    clen = law[rng.permutation(n)]
    off, flen = bins(clen, bin_bp)
    m = int(flen.size)
    keep = nx_keep(flen, int(cfg['pipeline']['Nx']))
    pairs = int(round(float(pub['hic_depth_x']) * genome_bp
                      / (2 * int(asm['read_bp']))))
    trans_pairs = int(round(pairs * float(asm['trans_share'])))
    per = np.full(G, n // G, dtype=np.int64)
    per[:n % G] += 1
    gstart = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(per, out=gstart[1:])
    # each fragment's start on the genome's one coordinate, contigs end
    # to end in id order
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(clen, out=cstart[1:])
    fstart = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(flen, out=fstart[1:])
    # the flanking regions of the kept fragments: (fragment, start, end)
    kf = np.flatnonzero(keep)
    two = flen[kf] > 2 * flank
    rf = np.concatenate([kf, kf[two]])
    r0 = np.concatenate([fstart[kf], fstart[kf[two]] + flen[kf[two]] - flank])
    r1 = np.concatenate([np.where(two, fstart[kf] + flank,
                                  fstart[kf] + flen[kf]),
                         fstart[kf[two]] + flen[kf[two]]])
    o = np.argsort(r0, kind='stable')
    rf, r0, r1 = rf[o], r0[o], r1[o]
    rg = np.searchsorted(gstart, np.searchsorted(off, rf, side='right') - 1,
                         side='right') - 1
    cis_total = pairs - trans_pairs
    keys, counts = [], []
    for g in range(G):
        sel = np.flatnonzero(rg == g)
        chrom = float(cstart[gstart[g + 1]] - cstart[gstart[g]])
        kappa = (cis_total * chrom / genome_bp
                 / float(_phi(np.array([chrom]), s_min)[0]))
        a, b = np.triu_indices(sel.size, 1)
        a, b = sel[a], sel[b]
        other = rf[a] != rf[b]
        a, b = a[other], b[other]
        lam = kappa * pair_integral(r0[a].astype(np.float64),
                                    r1[a].astype(np.float64),
                                    r0[b].astype(np.float64),
                                    r1[b].astype(np.float64), s_min)
        key = np.minimum(rf[a], rf[b]) * m + np.maximum(rf[a], rf[b])
        uk, inv = np.unique(key, return_inverse=True)
        c = rng.poisson(np.bincount(inv, weights=lam))
        keys.append(uk[c > 0])
        counts.append(c[c > 0])
    # the uniform pairs whose two ends fall in two kept fragments'
    # flanking regions
    ends = []
    for _ in range(2):
        x = rng.integers(0, genome_bp, trans_pairs)
        f = np.searchsorted(fstart, x, side='right') - 1
        u = x - fstart[f]
        ok = keep[f] & ((flen[f] <= 2 * flank) | (u < flank)
                        | (u >= flen[f] - flank))
        ends.append((f, ok))
    (fa, oka), (fb, okb) = ends
    sel = oka & okb & (fa != fb)
    keys.append(np.minimum(fa[sel], fb[sel]) * m
                + np.maximum(fa[sel], fb[sel]))
    counts.append(np.ones(int(sel.sum()), dtype=np.int64))
    key, inv = np.unique(np.concatenate(keys), return_inverse=True)
    w = np.bincount(inv, weights=np.concatenate(counts).astype(np.float64))
    sizes = LayoutSizes(
        contigs=n, groups=G, bin_bp=bin_bp, fragments=m,
        kept=int(keep.sum()), split_contigs=int((clen > bin_bp).sum()),
        n50_bp=_n50(clen), sigma=float(sigma), pairs=pairs,
        trans_pairs=trans_pairs)
    return Layout(sizes=sizes, group_start=gstart, contig_len=clen,
                  frag_offset=off, frag_len=flen, keep=keep, i=key // m,
                  j=key % m, w=w, seed=seed % 2 ** 64)

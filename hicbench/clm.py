"""The CLM and HT links of a genome's groups, drawn read pair by read
pair. Everything here is numpy on the host and imports nothing of the
program.

``genome.make`` gives each linked contig pair its count of read pairs,
and how many of them are uniform over the genome. Here each of those
read pairs gets its two positions:

- a pair of one chromosome lies at a separation s whose density is
  ~ 1/s from ``s_min_bp`` (the law ``genome.cis_expected`` integrates):
  over the rectangle of two contigs d contigs apart, s has the density
  (L - |s - d L|) / s on [max((d - 1) L, s_min), (d + 1) L], drawn by
  rejection from 1/s, and the left end is uniform over the positions
  that s leaves;
- a uniform pair has both ends uniform on its contigs.

The positions are drawn from the configuration's ``genome_seed``, one
generator a group (and one for the uniform pairs), so every run draws
the same reads. A run's ``--seed`` relabels the contigs inside each
group (``relabel``): the same work in another order.

Each read pair becomes one CLM record, as the port's ingest writes it
(``haphic_tpu_torch/core/contacts.py``, from HapHiC_cluster.py's CLM
statement): the contig pair (i < j) and the distance the pair would
span with the two contigs adjacent in each orientation, with 1-based
positions p and 0-based p0 = p - 1:

    d(+,+) = len_i - p0_i + p0_j        d(-,+) = p0_i + p0_j
    d(+,-) = len_i - p0_i + len_j - p0_j  d(-,-) = p0_i + len_j - p0_j

Every record is kept: the CLM is not capped. The records come ordered
by contig pair, as the port's ingest orders them. The HT links count the
read pairs by the half of each contig they fall in (tail when 2 p >
len), node ``contig * 2 + is_tail``, as (i, j, w) with i < j.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from hicbench import genome as gen


@dataclass
class Reads:
    """Read pairs between distinct contigs: contig ids a < b in the
    genome's labels, 1-based positions on each."""
    a: np.ndarray       # int64 [R]
    b: np.ndarray
    pa: np.ndarray
    pb: np.ndarray


@dataclass
class Clm:
    """CLM records in a run's labels (the fields ``group_problem``
    reads): pair_i < pair_j, d int64 [4, R]; and the 1-based positions
    they were made from."""
    pair_i: np.ndarray
    pair_j: np.ndarray
    d: np.ndarray
    pi: np.ndarray
    pj: np.ndarray


@dataclass
class Links:
    """Pair counts stored once, i < j (the HT form fast sort reads)."""
    i: np.ndarray
    j: np.ndarray
    w: np.ndarray


def separations(dd: np.ndarray, L: float, s_min: float,
                rng: np.random.Generator) -> np.ndarray:
    """float64 [n]: one separation for each read pair of two contigs of
    length ``L``, ``dd`` >= 1 contigs apart, under density 1/s for s >=
    s_min: log-uniform proposals on the rectangle's range, each kept
    with probability (L - |s - dd L|) / L."""
    dd = dd.astype(np.float64)
    lo = np.maximum((dd - 1) * L, s_min)
    ratio = (dd + 1) * L / lo
    s = np.empty(dd.size)
    todo = np.arange(dd.size)
    while todo.size:
        x = lo[todo] * ratio[todo] ** rng.random(todo.size)
        keep = rng.random(todo.size) * L < L - np.abs(x - dd[todo] * L)
        s[todo[keep]] = x[keep]
        todo = todo[~keep]
    return s


def _cis_positions(dd, L: int, s_min: int, rng):
    s = separations(dd, float(L), float(s_min), rng)
    off = dd * float(L)
    lo = np.maximum(0.0, off - s)
    hi = np.minimum(float(L), off + L - s)
    x = lo + rng.random(s.size) * (hi - lo)
    y = x + s - off
    return _one_based(x, L), _one_based(y, L)


def _one_based(x, L: int):
    return np.clip(np.floor(x).astype(np.int64), 0, L - 1) + 1


THREADS = min(8, os.cpu_count() or 1)


def _on_threads(fn, items, threads: int):
    with ThreadPoolExecutor(max(1, threads)) as ex:
        return list(ex.map(fn, items))


def _slices(n: int, parts: int):
    edges = np.linspace(0, n, parts + 1).astype(np.int64)
    return [slice(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def draw_reads(gn: gen.Genome, cfg: dict, groups: Sequence[int],
               threads: int = THREADS) -> Reads:
    """Every read pair of the links with both contigs in ``groups``,
    the groups drawn on ``threads`` threads (numpy leaves the GIL in its
    loops; each group has its own generator, so the draw is the same on
    any number)."""
    asm = cfg['assumed']
    L = gn.sizes.contig_bp
    seed = int(asm['genome_seed'])
    gs = gn.group_start
    group_of = np.searchsorted(gs, np.arange(gn.sizes.contigs),
                               side='right') - 1
    inside = np.isin(group_of, np.asarray(groups))
    sel = inside[gn.i] & inside[gn.j]
    li, lj = gn.i[sel], gn.j[sel]
    cis = (gn.w[sel] - gn.w_trans[sel]).astype(np.int64)
    trans = gn.w_trans[sel].astype(np.int64)

    def one(g):
        rng = np.random.default_rng([seed, 1, int(g)])
        m = (group_of[li] == g) & (cis > 0)
        a = np.repeat(li[m], cis[m])
        b = np.repeat(lj[m], cis[m])
        pa, pb = _cis_positions(b - a, L, int(asm['s_min_bp']), rng)
        return a, b, pa, pb

    out = _on_threads(one, groups, threads)
    rng = np.random.default_rng([seed, 2])
    a, b = np.repeat(li, trans), np.repeat(lj, trans)
    out.append((a, b, rng.integers(1, L + 1, a.size),
                rng.integers(1, L + 1, a.size)))
    return Reads(*(np.concatenate([o[k] for o in out]) for k in range(4)))


def relabel(gn: gen.Genome, seed: int) -> np.ndarray:
    """int64 [contigs]: each contig's id in the run's labels, a random
    permutation inside each group drawn from ``seed``."""
    rng = np.random.default_rng([seed % 2 ** 64, 3])
    new = np.empty(gn.sizes.contigs, dtype=np.int64)
    gs = gn.group_start
    for g in range(gn.sizes.groups):
        new[gs[g]:gs[g + 1]] = gs[g] + rng.permutation(gs[g + 1] - gs[g])
    return new


def records(reads: Reads, new: np.ndarray, lengths: np.ndarray,
            threads: int = THREADS) -> Clm:
    """The CLM of ``reads`` in the labels ``new``: each pair ordered
    i < j in those labels, its four distances from its positions, the
    records in the order the port's ingest hands them on
    (``core/contacts.py``): by contig pair (i, j), a pair's records in
    the order they were drawn. Done in slices on ``threads`` threads;
    the order is a stable sort by the bucket of i's range (a radix sort
    of small integers), then each bucket by (i, j)."""
    R, n = reads.a.size, int(lengths.size)
    parts = 4 * max(1, threads)
    i, j, pi, pj = (np.empty(R, np.int64) for _ in range(4))
    bucket = np.empty(R, np.int16)

    def label(s):
        a, b = new[reads.a[s]], new[reads.b[s]]
        swap = a > b
        i[s], j[s] = np.where(swap, b, a), np.where(swap, a, b)
        pi[s] = np.where(swap, reads.pb[s], reads.pa[s])
        pj[s] = np.where(swap, reads.pa[s], reads.pb[s])
        bucket[s] = i[s] * parts // n

    _on_threads(label, _slices(R, parts), threads)
    o = np.argsort(bucket, kind='stable')
    ends = np.cumsum(np.bincount(bucket, minlength=parts))

    def by_pair(k):
        seg = o[ends[k - 1] if k else 0:ends[k]]     # a view of o
        seg[:] = seg[np.argsort(i[seg] * n + j[seg], kind='stable')]

    _on_threads(by_pair, range(parts), threads)
    out = Clm(*(np.empty(R, np.int64) for _ in range(2)),
              np.empty((4, R), np.int64), *(np.empty(R, np.int64)
                                            for _ in range(2)))

    def gather(s):
        oo = o[s]
        ci, cj = i[oo], j[oo]
        p0i, p0j = pi[oo] - 1, pj[oo] - 1
        li, lj = lengths[ci], lengths[cj]
        out.pair_i[s], out.pair_j[s] = ci, cj
        out.pi[s], out.pj[s] = p0i + 1, p0j + 1
        out.d[:, s] = np.stack([li - p0i + p0j, li - p0i + lj - p0j,
                                p0i + p0j, p0i + lj - p0j])

    _on_threads(gather, _slices(R, parts), threads)
    return out


def group_rows(clm: Clm, lo: int, hi: int) -> np.ndarray:
    """int64: the indices of the records with both contigs in [lo, hi),
    found through the pair order (pair_i sorted)."""
    a, b = np.searchsorted(clm.pair_i, [lo, hi])
    return a + np.flatnonzero(clm.pair_j[a:b] < hi)


def ht_links(clm: Clm, lengths: np.ndarray, lo: int, hi: int) -> Links:
    """The HT links of the records with both contigs in [lo, hi)."""
    m = group_rows(clm, lo, hi)
    i, j = clm.pair_i[m], clm.pair_j[m]
    hti = 2 * i + (2 * clm.pi[m] > lengths[i])
    htj = 2 * j + (2 * clm.pj[m] > lengths[j])
    n2 = 2 * int(lengths.size)
    key, cnt = np.unique(hti * n2 + htj, return_counts=True)
    return Links(i=key // n2, j=key % n2, w=cnt.astype(np.float64))

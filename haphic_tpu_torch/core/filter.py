"""Fragment filtering ahead of Markov clustering.

Vectorized re-implementation of the reference's filter_fragments
(scripts/HapHiC_cluster.py:741-940) and check_param (:2481-2507):

  (1) Nx subset (precomputed in Fragments.nx_mask)
  (2) RE-site count   > cutoff
  (3) link-density    rank window [lower, upper) over density-sorted frags
  (4) read-depth      IQR upper filter (only with GFA depths)
  (5) topN rank-sum   IQR upper filter (chimera / collapse detector)
  whitelist fragments re-added at the end

All steps operate on integer fragment ids and numpy arrays; sort ties
are broken by fragment id (the reference's tie order is Python-set
iteration order, which is not deterministic — fragment-id order is the
canonical choice here and does not change which *values* pass filters).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from itertools import combinations
from typing import Optional, Set, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import COO
from haphic_tpu_torch.core.fragments import Fragments

logger = logging.getLogger(__name__)


@dataclass
class Param:
    """A dual-mode numeric CLI parameter: plain fraction ('0.2') or
    multiple ('0.2X') — parity with check_param
    (scripts/HapHiC_cluster.py:2481-2507)."""
    value: float
    is_multiple: bool

    @classmethod
    def parse(cls, name: str, raw) -> 'Param':
        s = str(raw)
        if s and s[-1] in ('X', 'x'):
            try:
                return cls(float(s[:-1]), True)
            except ValueError:
                raise RuntimeError(
                    'Parameter check failed: {} {}'.format(name, raw))
        try:
            v = float(s)
        except ValueError:
            raise RuntimeError('Parameter check failed: {} {}'.format(name, raw))
        if not 0 <= v <= 1:
            raise RuntimeError(
                'Parameter check failed: {} {} (fraction mode requires '
                '0 <= value <= 1)'.format(name, raw))
        return cls(v, False)


def _window_upper(values: np.ndarray, limit: float, strict: bool) -> int:
    """First index whose value exceeds ``limit`` in a sorted array —
    reproducing the reference's for/else scan (e.g. lines :786-792).
    ``strict``: break on value > limit (upper bounds); otherwise on
    value >= limit (the density_lower bound)."""
    if strict:
        over = values > limit
    else:
        over = values >= limit
    idx = np.argmax(over) if over.any() else len(values)
    return int(idx)


@dataclass
class FilterResult:
    kept_ids: np.ndarray          # int64 fragment ids used for MCL
    density: np.ndarray           # float per fragment (0 where absent)
    average_density: float
    n_nx: int
    n_after_re: int
    n_after_density: int
    n_after_depth: int
    n_after_rank_sum: int


def filter_fragments(frags: Fragments, flank: COO, frag_links: np.ndarray,
                     RE_site_cutoff: int = 25,
                     density_lower: str = '0.2X', density_upper: str = '1.9X',
                     topN: int = 10, rank_sum_upper: str = '1.5X',
                     rank_sum_hard_cutoff: int = 0,
                     read_depth_upper: str = '1.5X',
                     read_depth: Optional[np.ndarray] = None,
                     whitelist: Optional[Set[str]] = None) -> FilterResult:
    """Returns the fragment ids to cluster (ascending id order).

    ``frag_links``: per-fragment flank-link totals (contacts.LinkData).
    ``read_depth``: per-*contig* GFA read depth, or None.
    """
    whitelist = whitelist or set()
    m = len(frags)
    re_sites = frags.frag_re

    # (1) + (2)
    nx_ids = np.nonzero(frags.nx_mask)[0]
    keep_re = re_sites[nx_ids] > RE_site_cutoff
    re_ids = nx_ids[keep_re]
    logger.info('[Nx filtering] %d fragments kept', len(nx_ids))
    logger.info('[RE sites filtering] %d fragments removed, %d fragments kept',
                len(nx_ids) - len(re_ids), len(re_ids))

    # (3) link density window
    has_links = frag_links[re_ids] > 0
    density = np.where(has_links,
                       frag_links[re_ids] / re_sites[re_ids], 0.0)
    total_links = int(frag_links[re_ids][has_links].sum())
    total_re = 1 + int((re_sites[re_ids][has_links] - 1).sum())
    average_density = total_links / total_re

    order = np.argsort(density, kind='stable')
    sorted_ids = re_ids[order]
    sorted_density = density[order]
    nfrags = len(sorted_ids)

    p_lower = Param.parse('--density_lower', density_lower)
    p_upper = Param.parse('--density_upper', density_upper)
    if p_lower.is_multiple:
        lower = _window_upper(sorted_density,
                              average_density * p_lower.value, strict=False)
    else:
        lower = int(nfrags * p_lower.value)
    if p_upper.is_multiple:
        upper = _window_upper(sorted_density,
                              average_density * p_upper.value, strict=True)
    else:
        upper = int(nfrags * p_upper.value)

    density_ids = sorted_ids[lower:upper]
    logger.info('[link density filtering] %d fragments removed, %d fragments kept',
                nfrags - len(density_ids), len(density_ids))

    # (4) read depth IQR filter (contig-level depth applied to fragments)
    if read_depth is not None:
        depths = read_depth[frags.ctg_of_frag[sorted_ids]]
        dorder = np.argsort(depths, kind='stable')
        depth_sorted_ids = sorted_ids[dorder]
        depth_sorted = depths[dorder]
        q1, med, q3 = np.quantile(depth_sorted, (0.25, 0.5, 0.75))
        iqr = q3 - q1
        logger.info('[read depth filtering] Q1=%s, median=%s, Q3=%s, IQR=Q3-Q1=%s',
                    q1, med, q3, iqr)
        p_depth = Param.parse('--read_depth_upper', read_depth_upper)
        if p_depth.is_multiple:
            dupper = _window_upper(depth_sorted, q3 + p_depth.value * iqr,
                                   strict=True)
        else:
            dupper = int(nfrags * p_depth.value)
        depth_kept = set(depth_sorted_ids[:dupper].tolist())
        before = len(density_ids)
        density_ids = np.asarray(
            [i for i in density_ids.tolist() if i in depth_kept],
            dtype=np.int64)
        logger.info('[read depth filtering] %d fragments removed, %d fragments kept',
                    before - len(density_ids), len(density_ids))

    # (5) topN rank-sum filter over the filtered flank-link matrix
    rank_ids, n_hard = _rank_sum_filter(
        density_ids, flank, m, topN, rank_sum_upper, rank_sum_hard_cutoff)
    logger.info('[rank sum filtering] %d fragments removed, %d fragments kept',
                len(density_ids) - n_hard - len(rank_ids), len(rank_ids))

    kept = set(rank_ids.tolist())
    n_added = 0
    if whitelist:
        for fid in range(m):
            if frags.asm.names[int(frags.ctg_of_frag[fid])] in whitelist \
                    and frags.nx_mask[fid] and fid not in kept:
                kept.add(fid)
                n_added += 1
        if n_added:
            logger.info('[rank sum filtering] %d fragments added (whitelist), '
                        '%d fragments are used to perform Markov clustering',
                        n_added, len(kept))

    kept_arr = np.asarray(sorted(kept), dtype=np.int64)
    density_full = np.zeros(m)
    density_full[re_ids] = density
    return FilterResult(kept_ids=kept_arr, density=density_full,
                        average_density=average_density,
                        n_nx=len(nx_ids), n_after_re=len(re_ids),
                        n_after_density=len(density_ids) if read_depth is None
                        else len(density_ids),
                        n_after_depth=len(density_ids),
                        n_after_rank_sum=len(rank_ids))


def _topn_ranks_dense(mat: np.ndarray, topN: int):
    """(top neighbors, rank lookup fn) from the dense link matrix."""
    nf = mat.shape[0]
    order = np.argsort(-mat, axis=1, kind='stable')       # (nf, nf)
    rank_of = np.empty_like(order)
    rows = np.arange(nf)[:, None]
    rank_of[rows, order] = np.arange(nf)[None, :]
    top = order[:, :min(topN, nf)]
    return top, lambda x, y: rank_of[x, y]


def _topn_ranks_sparse(ii, jj, ww, nf: int, topN: int):
    """Same (top, rank) semantics as the dense path in O(nnz log nnz):
    rank(x, y) = #entries of row x strictly stronger than mat[x, y]
    plus equal-valued entries of smaller index — for zero-valued
    (unlinked) pairs that is deg(x) + (#zero columns with index < y).
    The dense path argsorts nf² entries (2 GB and ~10 s at nf=16000);
    the adjacency holds all the information."""
    rows = np.concatenate([ii, jj])
    cols = np.concatenate([jj, ii])
    vals = np.concatenate([ww, ww])
    # collapse duplicates
    key = rows * nf + cols
    o = np.argsort(key, kind='stable')
    key, vals = key[o], vals[o]
    uk, start = np.unique(key, return_index=True)
    vals = np.add.reduceat(vals, start) if len(vals) else vals
    rows, cols = uk // nf, uk % nf

    # per-row ordering by (-w, col): global lexsort
    o2 = np.lexsort((cols, -vals, rows))
    r_s, c_s, v_s = rows[o2], cols[o2], vals[o2]
    deg = np.zeros(nf, dtype=np.int64)
    np.add.at(deg, rows, 1)
    ptr = np.zeros(nf + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    pos_in_row = np.arange(len(r_s)) - ptr[r_s]

    # id-ascending view for "nonzeros of x below y" queries; since
    # (rows, cols) pairs are unique, key order IS (row, id) order
    key_adj = rows * nf + cols                   # sorted ascending
    # rank position of each existing (x, y) entry, queryable by key
    pos_of_key = np.empty(len(key_adj), dtype=np.int64)
    # map sorted-by-(row,-w,col) entries back to (row,col)-key order
    back = np.argsort(o2, kind='stable')
    pos_of_key = pos_in_row[back]

    t = min(topN, nf)

    # top-t per row: the first t of the row's (-w, col)-sorted entries,
    # zero-filled (dense semantics: zero-valued columns rank after all
    # positives, ascending index, skipping indices already linked)
    top = np.full((nf, t), -1, dtype=np.int64)
    have = np.arange(t)[None, :] < deg[:, None]
    slot = ptr[:-1][:, None] + np.arange(t)[None, :]
    if len(c_s):
        top = np.where(have, c_s[np.minimum(slot, len(c_s) - 1)], -1)
    for x in np.nonzero(deg < t)[0]:       # rare rows with deg < topN
        linked = set(c_s[ptr[x]:ptr[x + 1]].tolist())
        fill = []
        cand = 0
        while len(fill) < t - deg[x]:
            if cand not in linked:
                fill.append(cand)
            cand += 1
        top[x, deg[x]:] = fill

    def rank(x, y):
        """Vectorized rank queries (equal-length arrays x, y)."""
        q = x * nf + y
        loc = np.searchsorted(key_adj, q)
        hit = np.zeros(len(q), dtype=bool)
        if len(key_adj):
            inb = loc < len(key_adj)
            hit[inb] = key_adj[loc[inb]] == q[inb]
        out = np.empty(len(q), dtype=np.int64)
        # existing entries: their position in the (-w, col) row order
        out[hit] = pos_of_key[loc[hit]]
        # zero entries: deg(x) + #zero columns of x with index < y
        #             = deg(x) + y - #linked columns of x with index < y
        miss = ~hit
        if miss.any():
            xm, ym = x[miss], y[miss]
            below = np.searchsorted(key_adj, xm * nf + ym) - ptr[xm]
            out[miss] = deg[xm] + ym - below
        return out

    return top, rank


# Dense is faster below this fragment count; above it the nf² argsort
# dominates the whole filter stage (measured 21.6 s at nf=16000).
RANK_SUM_DENSE_MAX_N = 4096


def _rank_sum_filter(ids: np.ndarray, flank: COO, n_frag: int, topN: int,
                     rank_sum_upper: str, hard_cutoff: int
                     ) -> Tuple[np.ndarray, int]:
    """TopN rank-sum filter (reference lines :864-927), vectorized.

    For each fragment, rank all filtered fragments by link count
    (descending, index tie-break); rank_sum = sum over topN pairs of
    min(rank(a→b), rank(b→a)). High rank sums indicate fragments whose
    strongest partners disagree — chimeras or collapsed repeats.
    """
    nf = len(ids)
    if nf == 0:
        return ids, 0
    lookup = np.full(n_frag, -1, dtype=np.int64)
    lookup[ids] = np.arange(nf)
    sel = (lookup[flank.i] >= 0) & (lookup[flank.j] >= 0)
    ii, jj = lookup[flank.i[sel]], lookup[flank.j[sel]]
    ww = flank.w[sel]
    if nf <= RANK_SUM_DENSE_MAX_N:
        mat = np.zeros((nf, nf), dtype=np.float64)
        np.add.at(mat, (ii, jj), ww)
        np.add.at(mat, (jj, ii), ww)
        top, rank = _topn_ranks_dense(mat, topN)
    else:
        top, rank = _topn_ranks_sparse(ii, jj, ww, nf, topN)

    t = top.shape[1]
    rank_sum = np.zeros(nf, dtype=np.int64)
    for a, b in combinations(range(t), 2):
        ta, tb = top[:, a], top[:, b]
        rank_sum += np.minimum(rank(ta, tb), rank(tb, ta))

    n_hard = 0
    if hard_cutoff:
        ok = rank_sum <= hard_cutoff
        n_hard = int((~ok).sum())
        ids, rank_sum = ids[ok], rank_sum[ok]

    sorder = np.argsort(rank_sum, kind='stable')
    sorted_ids = ids[sorder]
    sorted_rs = rank_sum[sorder]
    q1, med, q3 = np.quantile(sorted_rs, (0.25, 0.5, 0.75))
    iqr = q3 - q1
    logger.info('[rank sum filtering] Q1=%s, median=%s, Q3=%s, IQR=Q3-Q1=%s',
                q1, med, q3, iqr)
    p = Param.parse('--rank_sum_upper', rank_sum_upper)
    if p.is_multiple:
        upper = _window_upper(sorted_rs.astype(np.float64),
                              q3 + p.value * iqr, strict=True)
    else:
        upper = int(len(sorted_rs) * p.value)
    return sorted_ids[:upper], n_hard


def normalize_by_nlinks(flank: COO, frag_links: np.ndarray) -> COO:
    """links /= geometric mean of the two fragments' totals
    (parity: scripts/HapHiC_cluster.py:718-724)."""
    w = flank.w / np.sqrt(frag_links[flank.i] * frag_links[flank.j])
    return COO(i=flank.i, j=flank.j, w=w)


def normalize_by_length(flank: COO, frag_len: np.ndarray, flank_kbp: int) -> COO:
    """links /= (Mb flank length product)
    (parity: scripts/HapHiC_cluster.py:727-738)."""
    two_flanks = flank_kbp * 2000
    li = frag_len[flank.i].astype(np.float64)
    lj = frag_len[flank.j].astype(np.float64)
    if two_flanks:
        li = np.minimum(li, two_flanks)
        lj = np.minimum(lj, two_flanks)
    w = flank.w / ((li / 1e6) * (lj / 1e6))
    return COO(i=flank.i, j=flank.j, w=w)

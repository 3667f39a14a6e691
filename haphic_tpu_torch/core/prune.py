"""Allelic / concentrated Hi-C link pruning and phasing down-weighting.

Parity targets in the reference (scripts/HapHiC_cluster.py):
  * cal_concordance_ratio (:419-428)  — allelic contig pairs produce
    read pairs concentrated on a diagonal (y = x + b or y = -x + b);
    the ratio is the mode frequency of the binned diagonal index;
  * cal_concentration_adj_ratio (:431-451) — pairs whose links pile
    into few 10 kb bins (repeat-driven) get their counts down-weighted;
  * remove_allelic_HiC_links (:474-692) — concordant pairs are deleted,
    allele groups are found by clique search with recursive
    weakest-edge splitting, and Hungarian maximum matching across
    allele-group pairs deletes links between non-max matches;
  * reduce_inter_hap_HiC_links (:695-707) — inter-haplotype links are
    multiplied by (1 - phasing_weight).

The per-pair ratio statistics are computed vectorized over all pairs at
once (sort + run-length mode); the clique/matching machinery operates
only on the small allelic subgraph and stays host-side. The clique
search is the port's own copy of networkx's (``find_cliques``), which
yields the cliques in the same order: the card machine has no networkx.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import COO, CoordPairs
from haphic_tpu_torch.core.fragments import Fragments
from haphic_tpu_torch.io.fasta import Assembly

logger = logging.getLogger(__name__)


def _segment_mode_counts(seg_ids: np.ndarray, values: np.ndarray,
                         n_seg: int) -> np.ndarray:
    """For each segment, the count of the most frequent value."""
    if len(seg_ids) == 0:
        return np.zeros(n_seg, dtype=np.int64)
    order = np.lexsort((values, seg_ids))
    s = seg_ids[order]
    v = values[order]
    new_run = np.ones(len(s), dtype=bool)
    new_run[1:] = (s[1:] != s[:-1]) | (v[1:] != v[:-1])
    run_starts = np.nonzero(new_run)[0]
    run_seg = s[run_starts]
    run_len = np.diff(np.append(run_starts, len(s)))
    out = np.zeros(n_seg, dtype=np.int64)
    np.maximum.at(out, run_seg, run_len)
    return out


def concordance_ratios(coords: CoordPairs, lengths: np.ndarray,
                       nwindows: int) -> np.ndarray:
    """Vectorized cal_concordance_ratio for every recorded pair.

    Returns one ratio per unique pair (aligned with coords.upair_*).
    """
    n_pairs = len(coords.upair_i)
    if n_pairs == 0:
        return np.zeros(0)
    shorter = np.minimum(lengths[coords.upair_i], lengths[coords.upair_j])
    bin_width = np.maximum(shorter // nwindows, 1)
    seg = np.repeat(np.arange(n_pairs), coords.counts)
    bw = bin_width[seg]
    y_minus_x = (coords.cj - coords.ci) // bw
    y_plus_x = (coords.cj + coords.ci) // bw
    m1 = _segment_mode_counts(seg, y_minus_x, n_pairs)
    m2 = _segment_mode_counts(seg, y_plus_x, n_pairs)
    npairs = coords.counts.astype(np.float64)
    return np.maximum(m1, m2) / np.maximum(npairs, 1)


def concentration_adj_ratios(coords: CoordPairs,
                             bin_width: int = 10000,
                             concentration_ratio: float = 10.0
                             ) -> np.ndarray:
    """Vectorized cal_concentration_adj_ratio per recorded pair.
    ``concentration_ratio`` is the bins-vs-median multiplier the
    reference hardcodes to 10 (HapHiC_cluster.py:448-449: bins holding
    >= 10x the median link count are deemed concentrated); exposed
    here as a tuning knob (--concentration_ratio, default matches the
    reference)."""
    n_pairs = len(coords.upair_i)
    out = np.ones(n_pairs)
    seg = np.repeat(np.arange(n_pairs), coords.counts)

    def one_axis(c):
        bins = c // bin_width
        # per (segment, bin) counts
        order = np.lexsort((bins, seg))
        s, b = seg[order], bins[order]
        new_run = np.ones(len(s), dtype=bool)
        new_run[1:] = (s[1:] != s[:-1]) | (b[1:] != b[:-1])
        run_starts = np.nonzero(new_run)[0]
        run_seg = s[run_starts]
        run_cnt = np.diff(np.append(run_starts, len(s)))
        # per-pair median of run counts, fully vectorized: sort runs by
        # (pair, count) and index the middle element(s) of each group
        order2 = np.lexsort((run_cnt, run_seg))
        g, v = run_seg[order2], run_cnt[order2]
        starts = np.nonzero(np.r_[True, g[1:] != g[:-1]])[0] \
            if len(g) else np.empty(0, np.int64)
        glens = np.diff(np.append(starts, len(g)))
        med = np.zeros(n_pairs)
        if len(g):
            lo = starts + (glens - 1) // 2
            hi = starts + glens // 2
            med[g[starts]] = (v[lo] + v[hi]) / 2.0
        big = run_cnt >= concentration_ratio * med[run_seg]
        conc_sum = np.bincount(run_seg[big], weights=run_cnt[big],
                               minlength=n_pairs)
        ratios = 1.0 - conc_sum / np.maximum(coords.counts, 1)
        ratios[coords.counts == 0] = 0.0
        return ratios

    return one_axis(coords.ci) * one_axis(coords.cj)


def apply_concentration_adjustment(full: COO, coords: CoordPairs,
                                   max_read_pairs: int,
                                   concentration_ratio: float = 10.0
                                   ) -> COO:
    """full_link_dict[pair] *= adj_ratio for pairs that reached
    max_read_pairs (parity: run(), :2899-2902)."""
    if coords is None or len(coords.upair_i) == 0:
        return full
    adj = concentration_adj_ratios(
        coords, concentration_ratio=concentration_ratio)
    reached = coords.total_counts >= max_read_pairs
    n = int(max(full.i.max(), full.j.max())) + 1 if len(full.i) else 1
    fk = coords.upair_i[reached].astype(np.int64) * n + \
        coords.upair_j[reached].astype(np.int64)
    fv = adj[reached]
    if not len(fk):
        return full
    order = np.argsort(fk)
    fk, fv = fk[order], fv[order]
    keys = full.i.astype(np.int64) * n + full.j.astype(np.int64)
    idx = np.searchsorted(fk, keys)
    hit = (idx < len(fk)) & (fk[np.minimum(idx, len(fk) - 1)] == keys)
    w = full.w.copy()
    w[hit] *= fv[idx[hit]]
    return COO(i=full.i, j=full.j, w=w)


def find_cliques(g: Dict[int, Dict[int, object]]) -> Iterator[List[int]]:
    """The maximal cliques of the undirected graph ``g`` (each node's
    neighbours, as networkx.Graph keeps its adjacency: nodes and
    neighbours in insertion order), each a list of nodes, in the order
    networkx.find_cliques yields them on the graph built by the same
    insertions, and with its order inside each clique: networkx 3.x's
    non-recursive pivoting Bron–Kerbosch (networkx/algorithms/clique.py,
    BSD-3-Clause, (C) NetworkX Developers), step for step. Its sets are
    built by the same operations from the same insertion orders, so
    they iterate alike and ``max`` and ``set.pop`` pick the same
    nodes."""
    if len(g) == 0:
        return
    adj = {u: {v for v in g[u] if v != u} for u in g}
    Q: List[Optional[int]] = []
    # set(G) fills its set from an iterator over the node dict; a set
    # made from the dict itself is sized ahead and iterates otherwise
    cand = set(iter(g))
    subg = cand.copy()
    stack = []
    Q.append(None)

    u = max(subg, key=lambda u: len(cand & adj[u]))
    ext_u = cand - adj[u]

    try:
        while True:
            if ext_u:
                q = ext_u.pop()
                cand.remove(q)
                Q[-1] = q
                adj_q = adj[q]
                subg_q = subg & adj_q
                if not subg_q:
                    yield Q[:]
                else:
                    cand_q = cand & adj_q
                    if cand_q:
                        stack.append((subg, cand, ext_u))
                        Q.append(None)
                        subg = subg_q
                        cand = cand_q
                        u = max(subg, key=lambda u: len(cand & adj[u]))
                        ext_u = cand - adj[u]
            else:
                Q.pop()
                subg, cand, ext_u = stack.pop()
    except IndexError:
        pass


def _split_cliques(adj: Dict[int, Dict[int, float]],
                   cliques: List[Tuple[int, ...]],
                   ploidy: int) -> Set[Tuple[int, ...]]:
    """Recursive weakest-edge clique splitting
    (parity: scripts/HapHiC_cluster.py:525-550)."""
    out: Set[Tuple[int, ...]] = set()
    stack = [tuple(c) for c in cliques]
    cached: Set[Tuple[int, ...]] = set()
    while stack:
        clique = stack.pop()
        if len(clique) <= ploidy:
            out.add(tuple(sorted(clique)))
            continue
        if clique in cached:
            continue
        cached.add(clique)
        # built as networkx builds it: nodes first, then the edges
        sub: Dict[int, Dict[int, None]] = {a: {} for a in clique}
        weakest = (None, None, np.inf)
        for a in clique:
            for b in clique:
                if a < b and b in adj.get(a, {}):
                    w = adj[a][b]
                    sub[a][b] = sub[b][a] = None
                    if w < weakest[2]:
                        weakest = (a, b, w)
        if weakest[0] is None:
            out.add(tuple(sorted(clique)))
            continue
        del sub[weakest[0]][weakest[1]], sub[weakest[1]][weakest[0]]
        for c in find_cliques(sub):
            stack.append(tuple(c))
    return out


@dataclass
class AllelicResult:
    full: COO
    flank: COO
    filtered_ids: np.ndarray
    n_allelic_pairs: int
    n_nonmax_pairs: int


def remove_allelic_links(asm: Assembly, frags: Fragments, full: COO,
                         flank: COO, coords: CoordPairs,
                         filtered_ids: np.ndarray, ploidy: int,
                         concordance_ratio_cutoff: float = 0.2,
                         nwindows: int = 50, min_read_pairs: int = 20,
                         max_read_pairs: int = 200,
                         ctg_pair_to_frag: Optional[COO] = None
                         ) -> AllelicResult:
    """Full allelic-link removal (parity: :474-692).

    ``filtered_ids``: fragment ids that passed filter_fragments; the
    returned set drops fragments isolated by the link removal.
    """
    from scipy.optimize import linear_sum_assignment

    logger.info('Removing Hi-C links between allelic contig pairs...')
    n = len(asm)
    full_map: Dict[Tuple[int, int], float] = {
        (int(a), int(b)): float(w)
        for a, b, w in zip(full.i, full.j, full.w)}

    # 1) concordant (allelic) pairs
    ratios = concordance_ratios(coords, asm.lengths, nwindows)
    enough = (coords.total_counts >= max_read_pairs) | \
             (coords.counts >= min_read_pairs)
    if logger.isEnabledFor(logging.DEBUG):
        # per-pair diagnostics consumed by `haphic sim
        # allelic_contig_statistics`. The reference reports
        # concordance_ratio=0 for pairs failing the read-pair gate
        # (HapHiC_cluster.py:598), so the gated value is logged — not
        # the raw computed ratio — to keep downstream ROC statistics
        # comparable (parity: :582,592-598).
        for ui, uj, r, ok in zip(coords.upair_i, coords.upair_j, ratios,
                                 enough):
            pair = (int(ui), int(uj))
            logger.debug('%s %s links=%d concordance_ratio=%s',
                         asm.names[pair[0]], asm.names[pair[1]],
                         int(full_map.get(pair, 0)), r if ok else 0)
    allelic_sel = enough & (ratios > concordance_ratio_cutoff)
    allelic_pairs = [(int(a), int(b)) for a, b in
                     zip(coords.upair_i[allelic_sel],
                         coords.upair_j[allelic_sel])
                     if (int(a), int(b)) in full_map]

    inter_allele: Dict[Tuple[int, int], float] = {}
    removed_pairs: Set[Tuple[int, int]] = set()
    for pair in allelic_pairs:
        inter_allele[pair] = full_map[pair]
        removed_pairs.add(pair)
        del full_map[pair]

    # 2) allele groups
    if ploidy > 2 and inter_allele:
        # nodes and neighbours in the order networkx.Graph.add_edge
        # would insert them
        adj: Dict[int, Dict[int, float]] = {}
        for (a, b), w in inter_allele.items():
            adj.setdefault(a, {})[b] = w
            adj.setdefault(b, {})[a] = w
        groups = _split_cliques(adj, list(find_cliques(adj)), ploidy)
    else:
        groups = {tuple(sorted(p)) for p in inter_allele}

    ctg_groups: Dict[int, Set[Tuple[int, ...]]] = {}
    for grp in groups:
        for c in grp:
            ctg_groups.setdefault(c, set()).add(grp)

    # 3) Hungarian max matching between allele-group pairs
    solution_cache: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]], np.ndarray] = {}

    def matching(group_pair):
        if group_pair in solution_cache:
            return solution_cache[group_pair]
        g1, g2 = group_pair
        deg = max(len(g1), len(g2))
        m = np.zeros((deg, deg))
        for i1, c1 in enumerate(g1):
            for i2, c2 in enumerate(g2):
                key = (min(c1, c2), max(c1, c2))
                if key in full_map:
                    m[i1, i2] = full_map[key]
        sol = linear_sum_assignment(-m)[1]
        solution_cache[group_pair] = sol
        return sol

    nonmax: Set[Tuple[int, int]] = set()
    for (c1, c2) in list(full_map.keys()):
        if c1 not in ctg_groups or c2 not in ctg_groups:
            continue
        broken = False
        for g1 in ctg_groups[c1]:
            for g2 in ctg_groups[c2]:
                gp = tuple(sorted((g1, g2)))
                sol = matching(gp)
                if c1 in gp[0] and c2 in gp[1]:
                    i1, i2 = gp[0].index(c1), gp[1].index(c2)
                else:
                    i1, i2 = gp[0].index(c2), gp[1].index(c1)
                if sol[i1] != i2:
                    nonmax.add((c1, c2))
                    broken = True
                    break
            if broken:
                break
    for pair in nonmax:
        removed_pairs.add(pair)
        del full_map[pair]

    # apply removals to the COOs
    keys_full = full.i.astype(np.int64) * n + full.j.astype(np.int64)
    removed_keys = np.asarray([a * n + b for a, b in removed_pairs],
                              dtype=np.int64)
    keep_full = ~np.isin(keys_full, removed_keys)
    new_full = COO(i=full.i[keep_full], j=full.j[keep_full],
                   w=full.w[keep_full])

    # flank: map removed ctg pairs to frag pairs
    m_frag = len(frags)
    filtered_set = np.zeros(m_frag, dtype=bool)
    filtered_set[filtered_ids] = True
    if ctg_pair_to_frag is not None and len(ctg_pair_to_frag.i):
        sel = np.isin(ctg_pair_to_frag.i, removed_keys)
        bad_frag_keys = ctg_pair_to_frag.j[sel]
    else:
        # unbinned: frag id of a contig is frag_offset[ctg]
        bad = []
        for a, b in removed_pairs:
            fa = int(frags.frag_offset[a])
            fb = int(frags.frag_offset[b])
            lo, hi = min(fa, fb), max(fa, fb)
            bad.append(lo * m_frag + hi)
        bad_frag_keys = np.asarray(bad, dtype=np.int64)
    keys_flank = flank.i.astype(np.int64) * m_frag + \
        flank.j.astype(np.int64)
    both_filtered = filtered_set[flank.i] & filtered_set[flank.j]
    drop = np.isin(keys_flank, bad_frag_keys) & both_filtered
    new_flank = COO(i=flank.i[~drop], j=flank.j[~drop], w=flank.w[~drop])

    # 4) drop isolated filtered fragments
    remaining = np.zeros(m_frag, dtype=bool)
    bf = filtered_set[new_flank.i] & filtered_set[new_flank.j]
    remaining[new_flank.i[bf]] = True
    remaining[new_flank.j[bf]] = True
    new_filtered = np.asarray(
        [f for f in filtered_ids.tolist() if remaining[f]], dtype=np.int64)
    logger.info('Removed %d allelic and %d non-max-match contig pairs; '
                '%d isolated fragments dropped',
                len(allelic_pairs), len(nonmax),
                len(filtered_ids) - len(new_filtered),
                extra={'metrics': {'allelic': {
                    'n_allelic_pairs': len(allelic_pairs),
                    'n_nonmax_pairs': len(nonmax),
                    'allele_groups': len(groups),
                    'largest_allele_group': max(map(len, groups),
                                                default=0)}}})
    return AllelicResult(full=new_full, flank=new_flank,
                         filtered_ids=new_filtered,
                         n_allelic_pairs=len(allelic_pairs),
                         n_nonmax_pairs=len(nonmax))


def reduce_inter_hap_links_frag(flank: COO, frags: Fragments,
                                hap_of_ctg: np.ndarray,
                                weight: float) -> COO:
    """flank links between fragments of different haplotypes are
    multiplied by (1 - weight); zeroed entries are dropped
    (parity: :695-707)."""
    hap_i = hap_of_ctg[frags.ctg_of_frag[flank.i]]
    hap_j = hap_of_ctg[frags.ctg_of_frag[flank.j]]
    inter = hap_i != hap_j
    w = np.where(inter, flank.w * (1.0 - weight), flank.w)
    keep = w != 0
    return COO(i=flank.i[keep], j=flank.j[keep], w=w[keep])


def reduce_inter_hap_links_ctg(full: COO, hap_of_ctg: np.ndarray,
                               weight: float) -> COO:
    inter = hap_of_ctg[full.i] != hap_of_ctg[full.j]
    w = np.where(inter, full.w * (1.0 - weight), full.w)
    keep = w != 0
    return COO(i=full.i[keep], j=full.j[keep], w=w[keep])

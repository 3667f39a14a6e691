"""Reassignment & rescue of contigs after Markov clustering.

Semantics-parity re-implementation of the reference reassignment engine
(scripts/HapHiC_reassign.py:200-427, 489-622, 865-913) on integer
contig/group ids:

  * parse_link_dict  → per-contig {group: links} tables built from the
    full (inter-contig) link COO (:217-263), optional nlinks
    normalization with total-rescale;
  * run_reassignment → per-round sequential sweep over contigs (longest
    first) with RE / links / ambiguity / density / density-ratio gates
    and incremental table updates (:266-427);
  * convergence check + additional rescue round (nround=0) (:865-880);
  * agglomerative hierarchical clustering of groups down to
    ``nclusters`` via average linkage on (max_density - density)
    (:489-560);
  * cluster file emission + CLM splitting (:454-487, :581-622).

The sweep is inherently sequential (each decision mutates the tables
the next contig reads), so it stays host-side; the per-contig work is
O(groups + neighbors). All sort ties are canonicalized on contig /
group ids (the reference's tie order depends on dict/set iteration).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import COO
from haphic_tpu_torch.io.fasta import Assembly

logger = logging.getLogger(__name__)

UNGROUPED = -1


@dataclass
class ReassignParams:
    """Defaults mirror `haphic reassign` (scripts/HapHiC_reassign.py:674-712)."""
    min_group_len: float = 5.0        # Mbp
    max_ctg_len: float = 10000.0      # kbp
    min_RE_sites: int = 25
    min_links: int = 25
    min_link_density: float = 0.0001
    min_density_ratio: float = 4.0
    ambiguous_cutoff: float = 0.6
    reassign_nrounds: int = 5
    normalize_by_nlinks: bool = False
    nclusters: int = 0
    no_additional_rescue: bool = False
    gfa: bool = False


@dataclass
class Groups:
    """Final grouping: list of contig-id lists + names."""
    members: List[List[int]]          # per group, sorted len desc
    names: List[str]                  # 'group{n}_{len}bp'
    lengths: List[int]
    ctg_group: np.ndarray             # int per contig (UNGROUPED = -1)


class _LinkTables:
    """ctg → {group: links} plus adjacency, with incremental updates."""

    def __init__(self, n_ctg: int):
        self.group_links: List[Dict[int, float]] = [dict() for _ in range(n_ctg)]
        self.neighbors: List[List[Tuple[int, float]]] = [[] for _ in range(n_ctg)]


def build_link_tables(full: COO, ctg_group: np.ndarray,
                      normalize_by_nlinks: bool = False
                      ) -> Tuple[_LinkTables, COO]:
    """parse_link_dict parity (scripts/HapHiC_reassign.py:217-263)."""
    n = len(ctg_group)
    t = _LinkTables(n)
    w = full.w.astype(np.float64)
    if normalize_by_nlinks:
        totals = np.zeros(n)
        np.add.at(totals, full.i, w)
        np.add.at(totals, full.j, w)
        total_links = w.sum()
        w = w / np.sqrt(totals[full.i] * totals[full.j])
        w = w * (total_links / w.sum())
    full = COO(i=full.i, j=full.j, w=w)

    for a, b, links in zip(full.i.tolist(), full.j.tolist(), w.tolist()):
        ga, gb = int(ctg_group[a]), int(ctg_group[b])
        if gb != UNGROUPED:
            t.group_links[a][gb] = t.group_links[a].get(gb, 0) + links
        if ga != UNGROUPED:
            t.group_links[b][ga] = t.group_links[b].get(ga, 0) + links
        t.neighbors[a].append((b, links))
        t.neighbors[b].append((a, links))
    return t, full


def run_reassignment(sorted_ctgs: Sequence[Tuple[int, int]],
                     tables: _LinkTables, ctg_group: np.ndarray,
                     lengths: np.ndarray, re_sites: np.ndarray,
                     group_re: Dict[int, float], n_groups: int,
                     p: ReassignParams, whitelist: Set[int],
                     nround: int) -> Dict[str, int]:
    """One sweep (parity: scripts/HapHiC_reassign.py:266-427).
    ``re_sites`` includes the +1 pseudo-count; ``group_re`` includes a
    +1 pseudo-count per group. nround==0 is the extra rescue round."""
    result = {'consistent': 0, 'rescued': 0, 'reassigned': 0,
              'not_rescued': 0}
    round_name = 'round{}'.format(nround) if nround else 'additional_rescue'

    # dismiss groups smaller than min_group_len (only from round 2 on)
    if p.min_group_len and nround > 1:
        group_len: Dict[int, int] = {}
        for c in range(len(ctg_group)):
            g = int(ctg_group[c])
            if g != UNGROUPED:
                group_len[g] = group_len.get(g, 0) + int(lengths[c])
        dismissed = {g for g, gl in group_len.items()
                     if gl / 1e6 < p.min_group_len}
        if dismissed:
            for c in range(len(ctg_group)):
                if int(ctg_group[c]) in dismissed:
                    ctg_group[c] = UNGROUPED
                for g in dismissed:
                    tables.group_links[c][g] = 0

    def link_density(c: int, g: int, former: int, links: float) -> float:
        gre = group_re[g]
        if g == former:
            return links / gre
        return links / (gre + re_sites[c] - 1)

    def update(c: int, new_group: int) -> None:
        former = int(ctg_group[c])
        ctg_group[c] = new_group
        for nb, links in tables.neighbors[c]:
            gl = tables.group_links[nb]
            if former != UNGROUPED:
                gl[former] -= links
            if new_group in gl:
                gl[new_group] += links
            elif new_group != UNGROUPED:
                gl[new_group] = links

    for c, clen in sorted_ctgs:
        former = int(ctg_group[c])
        gl = tables.group_links[c]
        wl = c in whitelist

        if (re_sites[c] - 1 < p.min_RE_sites and not wl) or not gl:
            result['not_rescued'] += 1
            continue
        # best group; ties canonicalized on group id
        ranked = sorted(gl.items(), key=lambda x: (-x[1], x[0]))
        max_group, max_links = ranked[0]
        second_links = ranked[1][1] if len(ranked) > 1 else 0

        if max_links < p.min_links and not wl:
            result['not_rescued'] += 1
            continue
        if nround and max_links and second_links / max_links >= \
                p.ambiguous_cutoff and not wl:
            result['not_rescued'] += 1
            continue
        max_density = link_density(c, max_group, former, max_links)
        if max_density < p.min_link_density and not wl:
            result['not_rescued'] += 1
            continue

        others = ranked[1:]
        if p.gfa:
            others = [(g, l) for g, l in others if l]
            denom = len(others)
        else:
            denom = len(group_re) - 1
        other_sum = sum(link_density(c, g, former, l) for g, l in others)
        if other_sum and denom:
            avg_other = other_sum / denom
        else:
            avg_other = 1e9

        if former == UNGROUPED:
            if max_density / avg_other >= p.min_density_ratio:
                update(c, max_group)
                group_re[max_group] += re_sites[c] - 1
                result['rescued'] += 1
            else:
                result['not_rescued'] += 1
        elif former in gl and gl[former] == max_links:
            result['consistent'] += 1
        elif nround and clen <= p.max_ctg_len * 1000 and \
                max_density / avg_other >= p.min_density_ratio:
            update(c, max_group)
            if former != UNGROUPED:
                group_re[former] -= re_sites[c] - 1
            group_re[max_group] += re_sites[c] - 1
            result['reassigned'] += 1
        else:
            result['consistent'] += 1

    logger.info('[result::%s] Total: %d, consistent: %d, rescued: %d, '
                'reassigned: %d, not rescued: %d', round_name,
                len(sorted_ctgs), result['consistent'], result['rescued'],
                result['reassigned'], result['not_rescued'])
    return result


def agglomerative_merge(full: COO, ctg_group: np.ndarray,
                        hiconf: np.ndarray, group_re_hiconf: Dict[int, float],
                        n_groups: int, nclusters: int,
                        normalize_by_nlinks: bool = False,
                        links_out: Optional[str] = None
                        ) -> List[List[int]]:
    """Merge groups down to ``nclusters`` with average-linkage AHC on
    distance = max_density - density (parity:
    scripts/HapHiC_reassign.py:489-560). Returns, per merged cluster,
    the list of original group ids.

    The tree is scipy's average linkage over the condensed upper
    triangle, which is what scikit-learn's AgglomerativeClustering
    (precomputed metric, average linkage) builds internally; cutting
    it at ``nclusters`` gives the same partition. Label numbering may
    differ, which is harmless: finalize_groups renames by length."""
    from scipy.cluster.hierarchy import cut_tree, linkage

    pair_links: Dict[Tuple[int, int], float] = {}
    for a, b, links in zip(full.i.tolist(), full.j.tolist(),
                           full.w.tolist()):
        if not (hiconf[a] and hiconf[b]):
            continue
        ga, gb = int(ctg_group[a]), int(ctg_group[b])
        if ga == UNGROUPED or gb == UNGROUPED or ga == gb:
            continue
        key = (min(ga, gb), max(ga, gb))
        pair_links[key] = pair_links.get(key, 0) + links

    if normalize_by_nlinks:
        totals: Dict[int, float] = {}
        for (ga, gb), links in pair_links.items():
            totals[ga] = totals.get(ga, 0) + links
            totals[gb] = totals.get(gb, 0) + links

    density = np.zeros((n_groups, n_groups))
    max_density = 0.0
    rows = []
    for (ga, gb), links in sorted(pair_links.items()):
        if normalize_by_nlinks:
            d = links / (totals[ga] * totals[gb])
        else:
            d = links / (group_re_hiconf.get(ga, 1) *
                         group_re_hiconf.get(gb, 1))
        density[ga, gb] = density[gb, ga] = d
        max_density = max(max_density, d)
        rows.append((ga, gb, links, d))
    if links_out:
        with open(links_out, 'w') as f:
            f.write('group1\tgroup2\tlinks\tlink_density\n')
            for ga, gb, links, d in rows:
                f.write('{}\t{}\t{}\t{}\n'.format(ga, gb, links, d))

    dist = max_density - density
    iu, ju = np.triu_indices(n_groups, k=1)
    tree = linkage(dist[iu, ju], method='average')
    labels = cut_tree(tree, n_clusters=nclusters).ravel()
    merged: Dict[int, List[int]] = {}
    for g, lab in enumerate(labels):
        merged.setdefault(int(lab), []).append(g)
    return [merged[k] for k in sorted(merged)]


def finalize_groups(ctg_group: np.ndarray, asm: Assembly) -> Groups:
    """Name groups 'group{n}_{len}bp' by total length descending
    (parity: clusters_output, scripts/HapHiC_reassign.py:454-487).
    Tie-break: smallest member contig id."""
    member_map: Dict[int, List[int]] = {}
    for c in range(len(ctg_group)):
        g = int(ctg_group[c])
        if g != UNGROUPED:
            member_map.setdefault(g, []).append(c)
    stats = []
    for g, members in member_map.items():
        total = int(asm.lengths[members].sum())
        stats.append((g, total, min(members)))
    stats.sort(key=lambda x: (-x[1], x[2]))

    out_members: List[List[int]] = []
    out_names: List[str] = []
    out_lens: List[int] = []
    new_ctg_group = np.full(len(ctg_group), UNGROUPED, dtype=np.int64)
    for n, (g, total, _) in enumerate(stats, 1):
        members = sorted(member_map[g],
                         key=lambda c: (-int(asm.lengths[c]), c))
        out_members.append(members)
        out_names.append('group{}_{}bp'.format(n, total))
        out_lens.append(total)
        for c in members:
            new_ctg_group[c] = n - 1
    return Groups(members=out_members, names=out_names, lengths=out_lens,
                  ctg_group=new_ctg_group)


def write_group_files(groups: Groups, asm: Assembly, outdir: str,
                      prefix: str = 'reassigned') -> str:
    """reassigned_groups/ or hc_groups/ emission
    (byte format parity: scripts/HapHiC_reassign.py:454-487)."""
    os.makedirs(outdir, exist_ok=True)
    cpath = os.path.join(outdir, '{}_clusters.txt'.format(prefix))
    with open(cpath, 'w') as f:
        f.write('#Group\tnContigs\tContigs\n')
        for name, members in zip(groups.names, groups.members):
            ctgs = [asm.names[c] for c in members]
            f.write('{}\t{}\t{}\n'.format(name, len(ctgs), ' '.join(ctgs)))
    for name, members in zip(groups.names, groups.members):
        with open(os.path.join(outdir, '{}_{}.txt'.format(prefix, name)),
                  'w') as f:
            f.write('#Contig\tRECounts\tLength\n')
            for c in members:
                f.write('{}\t{}\t{}\n'.format(
                    asm.names[c], int(asm.re_sites[c]),
                    int(asm.lengths[c])))
    return cpath


def split_clm_file(clm_file: str, groups: Groups, asm: Assembly,
                   outdir: str) -> None:
    """Write split_clms/{group}.clm keeping intra-group lines
    (parity: scripts/HapHiC_reassign.py:581-622)."""
    os.makedirs(outdir, exist_ok=True)
    name_group: Dict[str, str] = {}
    for gname, members in zip(groups.names, groups.members):
        for c in members:
            name_group[asm.names[c]] = gname
    fps = {g: open(os.path.join(outdir, '{}.clm'.format(g)), 'w')
           for g in groups.names}
    try:
        with open(clm_file) as f:
            for line in f:
                cols = line.split()
                c1, c2 = cols[0][:-1], cols[1][:-1]
                g1 = name_group.get(c1)
                if g1 is not None and name_group.get(c2) == g1:
                    fps[g1].write(line)
    finally:
        for fp in fps.values():
            fp.close()


@dataclass
class ReassignResult:
    groups: Groups
    nrounds_run: int
    hc_applied: bool


def reassign(asm: Assembly, full: COO,
             initial_groups: List[List[int]],
             params: Optional[ReassignParams] = None,
             whitelist: Optional[Set[int]] = None) -> ReassignResult:
    """Full reassignment stage (parity: run(),
    scripts/HapHiC_reassign.py:846-913): initial clusters → N rounds of
    reassignment (+ convergence early-exit) → extra rescue → optional
    AHC merge to ``nclusters`` → final group naming."""
    p = params or ReassignParams()
    whitelist = whitelist or set()
    n = len(asm)

    ctg_group = np.full(n, UNGROUPED, dtype=np.int64)
    group_re: Dict[int, float] = {}
    for g, members in enumerate(initial_groups):
        if p.min_group_len and \
                asm.lengths[members].sum() / 1e6 < p.min_group_len:
            continue
        group_re[g] = 1
        for c in members:
            ctg_group[c] = g
            group_re[g] += int(asm.re_sites[c]) - 1
    hiconf = ctg_group != UNGROUPED      # "grouped_ctgs" in the reference

    tables, full_n = build_link_tables(
        full, ctg_group, normalize_by_nlinks=p.normalize_by_nlinks)

    # contigs longest-first; ties by input order (reference stable sort
    # over fa_dict iteration order, :46)
    sorted_ctgs = sorted(
        ((c, int(asm.lengths[c])) for c in range(n)),
        key=lambda x: (-x[1], asm.input_order.get(asm.names[x[0]], x[0])))

    last: Optional[np.ndarray] = None
    rounds = 0
    for r in range(p.reassign_nrounds):
        rounds = r + 1
        run_reassignment(sorted_ctgs, tables, ctg_group, asm.lengths,
                         asm.re_sites, group_re, len(initial_groups), p,
                         whitelist, r + 1)
        if r > 0 and last is not None and np.array_equal(last, ctg_group):
            logger.info('[result::round%d] Result has converged after %d '
                        'rounds of reassignment, break', r + 1, r)
            break
        last = ctg_group.copy()
    if not p.no_additional_rescue:
        run_reassignment(sorted_ctgs, tables, ctg_group, asm.lengths,
                         asm.re_sites, group_re, len(initial_groups), p,
                         whitelist, 0)

    groups = finalize_groups(ctg_group, asm)

    hc_applied = False
    if p.nclusters and p.nclusters < len(groups.names):
        # per-(renamed)-group high-confidence RE sums
        re_hiconf: Dict[int, float] = {}
        for g, members in enumerate(groups.members):
            re_hiconf[g] = sum(int(asm.re_sites[c]) - 1
                               for c in members if hiconf[c]) or 1
        merged = agglomerative_merge(
            full_n, groups.ctg_group, hiconf, re_hiconf,
            len(groups.names), p.nclusters,
            normalize_by_nlinks=p.normalize_by_nlinks)
        ctg_group2 = np.full(n, UNGROUPED, dtype=np.int64)
        for new_g, old_groups in enumerate(merged):
            for og in old_groups:
                for c in groups.members[og]:
                    ctg_group2[c] = new_g
        groups = finalize_groups(ctg_group2, asm)
        hc_applied = True
    elif p.nclusters > len(groups.names):
        logger.info('Parameter nclusters (%d) is greater than the number of '
                    'clusters (%d) after reassignment, try higher inflations',
                    p.nclusters, len(groups.names))

    return ReassignResult(groups=groups, nrounds_run=rounds,
                          hc_applied=hc_applied)

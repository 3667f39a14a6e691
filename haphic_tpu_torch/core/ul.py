"""Ultra-long read integration.

Semantics parity with the reference UL subsystem
(scripts/HapHiC_cluster.py:1755-1984): primary + best supplementary
alignments of one UL read vote for an adjacency between two contig
ends (H/T); the resulting weighted HT graph is pruned by support and
degree, linear/circular paths are extracted, and the Hi-C link tables
get a ×2 boost on UL-supported pairs.

HT nodes are integers ``2*ctg + is_tail`` (matching contacts'
HT link encoding); paths are lists of those ids.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import COO
from haphic_tpu_torch.core.fragments import Fragments

logger = logging.getLogger(__name__)

OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_EQ, OP_X = 0, 1, 2, 3, 4, 5, 7, 8
FLAG_REVERSE = 0x10
FLAG_SUPPLEMENTARY = 0x800


def _cigar_stats(cig) -> Tuple[int, int, int, int, int, int]:
    """(lead_soft, trail_soft, lead_hard, trail_hard, q_aln, r_aln)."""
    lead_soft = trail_soft = lead_hard = trail_hard = 0
    q_aln = r_aln = 0
    n = len(cig)
    for t, (op, ln) in enumerate(cig):
        if op == OP_H:
            if t == 0:
                lead_hard = ln
            else:
                trail_hard = ln
        elif op == OP_S:
            if q_aln == 0:
                lead_soft = ln
            else:
                trail_soft = ln
        elif op in (OP_M, OP_EQ, OP_X):
            q_aln += ln
            r_aln += ln
        elif op == OP_I:
            q_aln += ln
        elif op in (OP_D, OP_N):
            r_aln += ln
    return lead_soft, trail_soft, lead_hard, trail_hard, q_aln, r_aln


def _query_termini(flag, cig) -> Tuple[int, int]:
    """Alignment interval on the ORIGINAL read (parity:
    get_query_alignment_termini, :1772-1787)."""
    ls, ts, lh, th, q_aln, _ = _cigar_stats(cig)
    q_start = ls
    q_end = ls + q_aln
    if not flag & FLAG_REVERSE:
        return q_start + lh, q_end + lh
    read_len = lh + ls + q_aln + ts + th
    return read_len - q_end + lh, read_len - q_start + lh


class _Graph:
    def __init__(self):
        self.w: Dict[Tuple[int, int], int] = {}
        self.adj: Dict[int, Set[int]] = {}

    def add_edge(self, a: int, b: int) -> None:
        key = (min(a, b), max(a, b))
        self.w[key] = self.w.get(key, 0) + 1
        self.adj.setdefault(a, set()).add(b)
        self.adj.setdefault(b, set()).add(a)

    def remove_edge(self, a: int, b: int) -> None:
        key = (min(a, b), max(a, b))
        if key in self.w:
            del self.w[key]
            self.adj[a].discard(b)
            self.adj[b].discard(a)

    def degree(self, a: int) -> int:
        return len(self.adj.get(a, ()))


def parse_ul_alignments(bam_path: str, names: List[str],
                        lengths: np.ndarray,
                        min_ul_mapq: int = 30,
                        min_ul_alignment_length: int = 10000,
                        max_distance_to_end: int = 100,
                        max_overlap_ratio: float = 0.5,
                        max_gap_len: int = 10000,
                        min_ul_support: int = 2) -> List[List[int]]:
    """Parse a UL-read BAM → contig-end adjacency paths
    (parity: :1763-1909). ``names`` must be the assembly's sorted
    contig table; BAM references are remapped onto it."""
    from haphic_tpu_torch.io.bam import find_int_tag, open_detail_bam

    bam = open_detail_bam(bam_path)
    name2id = {c: i for i, c in enumerate(names)}
    remap = np.asarray([name2id.get(c, -1) for c in bam.ref_names],
                       np.int64)

    g = _Graph()
    primary: Optional[Tuple] = None
    supp: List[Tuple] = []

    def flush():
        if not supp or primary is None:
            return
        # best supplementary by AS score (parity :1789-1794)
        best = max(supp, key=lambda s: s[5])
        _link(primary, best)

    def _link(p, s):
        # p/s: (ctg, flag, cig, q_start, q_end, score)
        semi = [[(p, 0), (p, 1)], [(s, 0), (s, 1)]]   # [(aln, is_tail)]
        if p[1] & FLAG_REVERSE:
            semi[0].reverse()
        if s[1] & FLAG_REVERSE:
            semi[1].reverse()
        semi.sort(key=lambda x: x[0][0][3])           # by read start
        left = semi[0][1][0][0] * 2 + semi[0][1][1]
        right = semi[1][0][0][0] * 2 + semi[1][0][1]
        g.add_edge(left, right)
        g.add_edge(p[0] * 2, p[0] * 2 + 1)
        g.add_edge(s[0] * 2, s[0] * 2 + 1)

    for qname, flag, refid, pos, mapq, cig, aux in bam.detail_records():
        if flag & 0x4 or refid < 0:
            continue
        c = int(remap[refid]) if refid < len(remap) else -1
        if c < 0:
            continue
        ls, ts, lh, th, q_aln, r_aln = _cigar_stats(cig)
        if mapq < min_ul_mapq or r_aln < min_ul_alignment_length:
            continue
        ref_len = int(lengths[c])
        if pos > max_distance_to_end and \
                ref_len - (pos + r_aln) > max_distance_to_end:
            continue
        q_start, q_end = _query_termini(flag, cig)
        score = find_int_tag(aux, b'AS') or 0
        rec = (c, flag, cig, q_start, q_end, score, qname)

        if flag in (0, 16):
            flush()
            primary = rec
            supp = []
        elif flag & FLAG_SUPPLEMENTARY and primary is not None and \
                qname == primary[6] and c != primary[0]:
            p_lo, p_hi = primary[3] + 1, primary[4]
            s_lo, s_hi = q_start + 1, q_end
            o_lo, o_hi = max(p_lo, s_lo), min(p_hi, s_hi)
            if o_lo <= o_hi:
                ovl = o_hi - o_lo + 1
                if ovl / min(p_hi - p_lo + 1, s_hi - s_lo + 1) \
                        > max_overlap_ratio:
                    continue
            else:
                gap = max(s_lo, p_lo) - min(s_hi, p_hi) - 1
                if gap > max_gap_len:
                    continue
            supp.append(rec)
    flush()

    # support filter (parity :1873-1876 — applies to every edge)
    for (a, b), w in list(g.w.items()):
        if w < min_ul_support:
            g.remove_edge(a, b)
    # degree filter: drop inter-contig edges touching degree>2 nodes
    for (a, b) in list(g.w.keys()):
        if (g.degree(a) > 2 or g.degree(b) > 2) and a // 2 != b // 2:
            g.remove_edge(a, b)

    # connected components → linear / broken-circular paths
    paths: List[List[int]] = []
    seen: Set[int] = set()
    for start in sorted(g.adj):
        if start in seen or not g.adj[start]:
            continue
        comp: Set[int] = set()
        stack = [start]
        while stack:
            x = stack.pop()
            if x in comp:
                continue
            comp.add(x)
            stack.extend(g.adj[x])
        seen |= comp
        if len(comp) < 4:
            continue
        ends = [x for x in comp if g.degree(x) == 1]
        if len(ends) == 2:
            node = ends[0]
        elif not ends:
            # circular: break the weakest edge
            edges = [(k, w) for k, w in g.w.items()
                     if k[0] in comp and k[1] in comp]
            (a, b), _ = min(edges, key=lambda kv: kv[1])
            g.remove_edge(a, b)
            node = a
        else:
            logger.debug('UL subgraph with %d loose ends skipped',
                         len(ends))
            continue
        # walk the path
        path = [node]
        prev = -1
        while True:
            nxts = [x for x in g.adj[node] if x != prev]
            if not nxts:
                break
            prev, node = node, nxts[0]
            path.append(node)
        paths.append(path)
    return paths


def path_ctg_set(paths: List[List[int]]) -> Set[int]:
    """Contigs adjacent in UL paths (whitelist, parity :2813-2824)."""
    out: Set[int] = set()
    for path in paths:
        for i in range(1, len(path) - 1, 2):
            out.add(path[i] // 2)
            out.add(path[i + 1] // 2)
    return out


def boost_ht_links(paths: List[List[int]], ht: COO, n_ctg: int) -> COO:
    """×2 HT links on UL-supported end pairs (parity :1912-1933)."""
    boosted: Set[Tuple[int, int]] = set()
    for path in paths:
        for i in range(1, len(path) - 1, 2):
            a, b = path[i], path[i + 1]
            boosted.add((min(a, b), max(a, b)))
    if not boosted:
        return ht
    w = ht.w.copy()
    for t, (a, b) in enumerate(zip(ht.i.tolist(), ht.j.tolist())):
        if (min(a, b), max(a, b)) in boosted:
            w[t] *= 2
    return COO(i=ht.i, j=ht.j, w=w)


def boost_flank_and_full(paths: List[List[int]], flank: COO, full: COO,
                         frags: Fragments) -> Tuple[COO, COO]:
    """×2 full links on UL-adjacent contig pairs and ×2 flank links on
    every fragment pair whose contigs share a UL path
    (parity :1936-1984)."""
    adjacent: Set[Tuple[int, int]] = set()
    path_pairs: Set[Tuple[int, int]] = set()
    for path in paths:
        ctgs = set()
        for i in range(1, len(path) - 1, 2):
            a, b = path[i] // 2, path[i + 1] // 2
            adjacent.add((min(a, b), max(a, b)))
            ctgs.add(a)
            ctgs.add(b)
        for a in ctgs:
            for b in ctgs:
                if a < b:
                    path_pairs.add((a, b))
    fw = full.w.copy()
    for t, (a, b) in enumerate(zip(full.i.tolist(), full.j.tolist())):
        if (min(a, b), max(a, b)) in adjacent:
            fw[t] *= 2
    kw = flank.w.copy()
    cf = frags.ctg_of_frag
    for t, (fa, fb) in enumerate(zip(flank.i.tolist(),
                                     flank.j.tolist())):
        a, b = int(cf[fa]), int(cf[fb])
        if (min(a, b), max(a, b)) in path_pairs:
            kw[t] *= 2
    return COO(i=flank.i, j=flank.j, w=kw), COO(i=full.i, j=full.j, w=fw)

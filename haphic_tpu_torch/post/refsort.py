"""Reference-guided ordering and orientation of final scaffolds.

Semantics parity with `haphic refsort` (scripts/HapHiC_refsort.py):
minimap2 PAF alignments against a reference genome pick, per scaffold,
the dominant reference chromosome (by aligned-length sum, :81-134) and
a forward/reverse weighted LIS decides the scaffold's presentation
orientation (:175-254). The AGP is re-emitted grouped by reference
chromosome with `group:chr:±` names; reversed scaffolds get their AGP
lines mirrored (:256-342). Optionally writes the re-oriented FASTA.
"""

from __future__ import annotations

import logging
import sys
from collections import defaultdict
from typing import Dict, List, Optional, TextIO, Tuple

from haphic_tpu_torch.io.fasta import revcomp

logger = logging.getLogger(__name__)


def parse_agp(agp: str, min_ctg_len_mbp: float):
    """(parity: :28-64) Returns ctg→placements, group→agp lines,
    group→len, and solo-short groups excluded from sorting."""
    ctg_group: Dict[str, List[Tuple]] = defaultdict(list)
    group_ctgs: Dict[str, List[Tuple[str, int]]] = defaultdict(list)
    group_len: Dict[str, int] = defaultdict(int)
    group_lines: Dict[str, List[str]] = defaultdict(list)
    with open(agp) as f:
        for line in f:
            if not line.strip() or line.startswith('#'):
                continue
            cols = line.split()
            group, gstart, gend = cols[0], int(cols[1]), int(cols[2])
            group_len[group] = max(group_len[group], gend)
            group_lines[group].append(line)
            if cols[4] != 'W':
                continue
            ctg, cstart, cend = cols[5], int(cols[6]), int(cols[7])
            orient = 1 if cols[8] == '+' else -1
            ctg_group[ctg].append((group, cstart, cend, gstart, gend,
                                   orient))
            group_ctgs[group].append((ctg, cend - cstart + 1))

    one_ctg_groups = set()
    for group, lens in group_ctgs.items():
        if len(lens) == 1 and sum(l for _, l in lens) < \
                min_ctg_len_mbp * 1e6:
            one_ctg_groups.add(group)
            ctg = lens[0][0]
            ctg_group[ctg] = [p for p in ctg_group[ctg] if p[0] != group]
    return ctg_group, group_lines, group_len, one_ctg_groups


def _max_ovl_group(placements, a_start, a_end) -> Optional[str]:
    best, best_ovl = None, -1
    for group, cstart, cend, _, __, ___ in placements:
        ovl = min(cend, a_end) - max(cstart, a_start)
        ovl_len = ovl + 1 if ovl >= 0 else 0
        if ovl_len > best_ovl:
            best_ovl = ovl_len
            best = group
    return best


def parse_paf(paf: str, ctg_group, aln_len_cutoff: int):
    """(parity: :81-134) group → {ref: ([aln...], aln_len_sum)}."""
    group_ref: Dict[str, Dict[str, list]] = defaultdict(dict)
    with open(paf) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if int(cols[11]) < 1:
                continue
            ctg, a_start, a_end, ref = cols[0], int(cols[2]), \
                int(cols[3]), cols[5]
            orient = 1 if cols[4] == '+' else -1
            if a_end - a_start < aln_len_cutoff or ctg not in ctg_group:
                continue
            placements = ctg_group[ctg]
            if not placements:
                continue
            if len(placements) == 1:
                group = placements[0][0]
            else:
                group = _max_ovl_group(placements, a_start, a_end)
            r_start, r_end = int(cols[7]), int(cols[8])
            aln = (ctg, a_end - a_start + 1,
                   (a_end - a_start) / 2 + a_start,
                   (r_end - r_start) / 2 + r_start, orient)
            if ref not in group_ref[group]:
                group_ref[group][ref] = [[aln], a_end - a_start + 1]
            else:
                group_ref[group][ref][0].append(aln)
                group_ref[group][ref][1] += a_end - a_start + 1
    return group_ref


def alignment_check(group_len, group_ref, one_ctg_groups,
                    aln_len_cutoff: int) -> None:
    missing = [g for g in group_len
               if g not in group_ref and g not in one_ctg_groups]
    if missing:
        raise RuntimeError(
            'Alignment check failed. Cannot find any alignment >= {} bp '
            'in the following group(s): {}'.format(aln_len_cutoff,
                                                   ','.join(missing)))


def _find_lis(aln_order_list, aln_len_list, forward: bool):
    """Weighted LIS over signed positions (parity: :175-214)."""
    order_list, order_len = [], {}
    for i, (aln, order) in enumerate(aln_order_list):
        if (forward and order < 0) or (not forward and order > 0):
            continue
        if order in order_len:
            continue
        order_list.append(order)
        order_len[order] = aln_len_list[i]
    if not order_list:
        return 0
    dp = [0] * len(order_list)
    best = 0
    for i in range(len(order_list)):
        dp[i] = order_len[order_list[i]]
        for j in range(i):
            if order_list[i] > order_list[j] and \
                    dp[i] < dp[j] + order_len[order_list[i]]:
                dp[i] = dp[j] + order_len[order_list[i]]
        if dp[i] >= dp[best]:
            best = i
    return dp[best]


def orient_groups(ctg_group, group_ref) -> Dict[str, List[Tuple[str, int, float]]]:
    """Per reference chromosome: [(group, ±1, lis_score)]
    (parity: :216-254)."""
    ref_groups: Dict[str, List[Tuple[str, int, float]]] = defaultdict(list)
    for group, ref_aln in group_ref.items():
        max_ref = max(ref_aln, key=lambda r: ref_aln[r][1])
        aln_list = []
        for aln in ref_aln[max_ref][0]:
            ctg, aln_len, aln_mid, ref_mid, orient = aln
            for _, cstart, cend, gstart, gend, ctg_orient in \
                    ctg_group[ctg]:
                if not cstart <= aln_mid <= cend:
                    continue
                order = gstart + aln_mid
                if orient * ctg_orient == -1:
                    order = -order
                aln_list.append((aln, order, aln_len, ref_mid))
        aln_list.sort(key=lambda x: x[-1])
        aln_order_list = [[a, o] for a, o, _, __ in aln_list]
        aln_len_list = [l for _, __, l, ___ in aln_list]
        f = _find_lis(aln_order_list, aln_len_list, True)
        r = _find_lis(aln_order_list, aln_len_list, False)
        logger.info('group: %s\tforward LIS: %s\treverse LIS: %s',
                    group, f, r)
        if f > r:
            ref_groups[max_ref].append((group, 1, f))
        else:
            ref_groups[max_ref].append((group, -1, r))
    return ref_groups


def _flip_orient(o: str) -> str:
    return '-' if o == '+' else '+'


def run_refsort(agp: str, paf: str, fasta: Optional[str] = None,
                out: TextIO = sys.stdout,
                fasta_out: Optional[str] = None,
                min_ctg_len: float = 10, aln_len_cutoff: int = 5000,
                skip_aln_check: bool = False,
                ref_order: Optional[str] = None,
                keep_original_ids: bool = False,
                max_width: int = 60) -> None:
    """Emit the reference-sorted AGP to ``out`` (and FASTA when both
    ``fasta`` and ``fasta_out`` are given)."""
    ctg_group, group_lines, group_len, one_ctg_groups = \
        parse_agp(agp, min_ctg_len)
    group_ref = parse_paf(paf, ctg_group, aln_len_cutoff)
    if not skip_aln_check:
        alignment_check(group_len, group_ref, one_ctg_groups,
                        aln_len_cutoff)
    ref_groups = orient_groups(ctg_group, group_ref)

    seqs = None
    fout = None
    if fasta and fasta_out:
        from haphic_tpu_torch.io.fasta import iter_fasta
        seqs = {name: seq for name, seq in iter_fasta(fasta)}
        fout = open(fasta_out, 'w')

    def emit_seq(chunks: List[str]) -> None:
        seq = ''.join(chunks)
        for i in range(0, len(seq), max_width):
            fout.write(seq[i:i + max_width] + '\n')

    def line_seq(cols) -> str:
        if cols[4] == 'W':
            ctg, s, e, o = cols[5], int(cols[6]), int(cols[7]), cols[8]
            sub = seqs[ctg][s - 1:e]
            return sub if o == '+' else revcomp(sub)
        return 'N' * int(cols[5])

    order_list = (ref_order.split(',') if ref_order
                  else sorted(ref_groups.keys()))
    output_groups = set()
    for ref in order_list:
        groups = sorted(ref_groups.get(ref, []), key=lambda x: -x[2])
        for group, orient, _ in groups:
            if group in one_ctg_groups or group is None:
                continue
            output_groups.add(group)
            new_id = group if keep_original_ids else \
                '{}:{}:{}'.format(group, ref, '+' if orient == 1 else '-')
            if fout:
                fout.write('>{}\n'.format(new_id))
            chunks: List[str] = []
            if orient == 1:
                for line in group_lines[group]:
                    cols = line.split()
                    out.write('{}\t{}'.format(
                        new_id, line.split(maxsplit=1)[-1]))
                    if fout:
                        chunks.append(line_seq(cols))
            else:
                glen = group_len[group]
                for n, line in enumerate(group_lines[group][::-1], 1):
                    cols = line.split()
                    s, e = int(cols[1]), int(cols[2])
                    rs, re_ = glen - e + 1, glen - s + 1
                    last = _flip_orient(cols[-1]) if cols[4] == 'W' \
                        else cols[-1]
                    out.write('{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                        new_id, rs, re_, n, cols[4], cols[5], cols[6],
                        cols[7], last))
                    if fout:
                        if cols[4] == 'W':
                            sub = seqs[cols[5]][int(cols[6]) - 1:
                                                int(cols[7])]
                            chunks.append(sub if last == '+'
                                          else revcomp(sub))
                        else:
                            chunks.append('N' * int(cols[5]))
            if fout:
                emit_seq(chunks)

    # remaining groups (unanchored / solo) keep their original lines
    for group, lines in group_lines.items():
        if group in output_groups:
            continue
        if fout:
            fout.write('>{}\n'.format(group))
            chunks = []
        for line in lines:
            out.write(line)
            if fout:
                chunks.append(line_seq(line.split()))
        if fout:
            emit_seq(chunks)
    if fout:
        fout.close()

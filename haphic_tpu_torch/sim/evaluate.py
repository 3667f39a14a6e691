"""Scaffold evaluation against simulated ground truth.

Faithful re-implementation of simulation/generate_truth.py +
simulation/evaluate_scaffolds.py: every contig is classified as exactly
one of syntenic / unanchored / newly-anchored / translocation /
relocation / inversion / inversion+relocation via weighted-LIS
analysis per (scaffold, source-chromosome) block; partition invariants
asserted as in the reference (:311-323).
"""

from __future__ import annotations

import random
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from haphic_tpu_torch.sim.generators import decode_truth_id


def generate_truth(ctg_ids: Sequence[str],
                   chr_pattern: str = r'.+') -> Dict[str, List[Tuple[str, str]]]:
    """Truth tours from truth-encoded contig IDs
    (parity: simulation/generate_truth.py): per chromosome, contigs in
    fragment order with their true orientation; contigs whose source
    doesn't match ``chr_pattern`` go to 'unanchored'."""
    truth: Dict[str, List[Tuple[int, str, str]]] = defaultdict(list)
    for ctg in ctg_ids:
        parts = ctg.rsplit('_', 5)
        if len(parts) == 6 and re.match(chr_pattern, parts[0]):
            source = parts[0]
            order = int(parts[1])
            orient = parts[4]
        else:
            source, order, orient = 'unanchored', 0, '+'
        truth[source].append((order, ctg, orient))
    out: Dict[str, List[Tuple[str, str]]] = {}
    for source, lst in truth.items():
        lst.sort()
        out[source] = [(c, o) for _, c, o in lst]
    return out


def write_truth(truth: Dict[str, List[Tuple[str, str]]], path: str
                ) -> None:
    with open(path, 'w') as f:
        for source, ctgs in truth.items():
            f.write('>{}\n'.format(source))
            for c, o in ctgs:
                f.write('{} {}\n'.format(c, o))


def parse_truth(path: str):
    truth: Dict[str, List[Tuple[str, str]]] = {}
    with open(path) as f:
        cur = None
        for line in f:
            if not line.strip():
                continue
            if line.startswith('>'):
                cur = line.split()[0][1:]
                truth[cur] = []
            else:
                c, o = line.split()
                truth[cur].append((c, o))
    return truth


@dataclass
class EvalResult:
    counts: Dict[str, int] = field(default_factory=dict)
    lengths: Dict[str, int] = field(default_factory=dict)
    classes: Dict[str, List[str]] = field(default_factory=dict)
    n_scaffolds: int = 0
    total_ctg_num: int = 0
    total_ctg_len: int = 0

    def pct(self, key: str) -> float:
        return self.lengths.get(key, 0) / self.total_ctg_len * 100 \
            if self.total_ctg_len else 0.0


def _find_lis(ctg_order_list, length_of, forward: bool):
    order_list, order_ctg, order_len = [], {}, {}
    for ctg, order in ctg_order_list:
        if (forward and order < 0) or (not forward and order > 0):
            continue
        order_list.append(order)
        order_ctg[order] = ctg
        order_len[order] = length_of[ctg]
    if not order_list:
        return 0, []
    dp = [0] * len(order_list)
    seqp: List[Optional[int]] = [None] * len(order_list)
    best = 0
    for i in range(len(order_list)):
        dp[i] = order_len[order_list[i]]
        for j in range(i):
            if order_list[i] > order_list[j] and \
                    dp[i] < dp[j] + order_len[order_list[i]]:
                dp[i] = dp[j] + order_len[order_list[i]]
                seqp[i] = j
        if dp[i] >= dp[best]:
            best = i
    max_sum = dp[best]
    seq = []
    idx: Optional[int] = best
    while idx is not None:
        seq.append(order_ctg[order_list[idx]])
        idx = seqp[idx]
    seq.reverse()
    return max_sum, seq


def evaluate_scaffolds(truth: Dict[str, List[Tuple[str, str]]],
                       agp_path: str, verbose: bool = False
                       ) -> EvalResult:
    """Classify every contig (parity: evaluate_scaffolds.py:56-323)."""
    ctg_info: Dict[str, List] = {}
    for source, lst in truth.items():
        for idx, (ctg, orient) in enumerate(lst, 1):
            ctg_info[ctg] = [source, idx, orient]

    scaffold_dict: Dict[str, Dict[str, List[Tuple[str, str]]]] = \
        defaultdict(dict)
    scaffold_nctgs: Dict[str, int] = defaultdict(int)
    with open(agp_path) as f:
        for line in f:
            if not line.strip() or line.startswith('#'):
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            ctg = cols[5]
            ctg_len = int(cols[2]) - int(cols[1]) + 1
            ctg_info[ctg].append(ctg_len)
            scaf = cols[0]
            scaffold_nctgs[scaf] += 1
            source = ctg_info[ctg][0]
            scaffold_dict[scaf].setdefault(source, []).append(
                (ctg, cols[8]))

    length_of = {c: info[3] for c, info in ctg_info.items()}
    source_len = {s: sum(length_of[c] for c, _ in lst)
                  for s, lst in truth.items()}
    white_list = {lst[0][0] for s, lst in truth.items()
                  if s != 'unanchored' and len(lst) == 1}

    unanchored: List[str] = []
    newly_anchored: List[str] = []
    scaffold_stat: Dict[str, List[List]] = {}
    for scaf, sources in scaffold_dict.items():
        first_ctg = list(sources.values())[0][0][0]
        if scaffold_nctgs[scaf] < 2 and first_ctg not in white_list:
            unanchored.append(first_ctg)
            continue
        scaffold_stat[scaf] = []
        for source, ctg_list in sources.items():
            if source == 'unanchored':
                newly_anchored.extend(c for c, _ in ctg_list)
                continue
            len_sum = sum(length_of[c] for c, _ in ctg_list)
            scaffold_stat[scaf].append(
                [source, len_sum / source_len[source], len_sum])
        rng = random.Random(12345)
        rng.shuffle(scaffold_stat[scaf])
        scaffold_stat[scaf].sort(key=lambda x: x[1:], reverse=True)

    dominant_by_source: Dict[str, Tuple[str, float]] = {}
    for scaf, stat in scaffold_stat.items():
        if not stat:
            continue
        source, ratio = stat[0][0], stat[0][1]
        if source not in dominant_by_source or \
                ratio > dominant_by_source[source][1]:
            dominant_by_source[source] = (scaf, ratio)
    dominant_source: Dict[str, str] = {
        scaf: source for source, (scaf, _) in dominant_by_source.items()}

    translocation: List[str] = []
    relocation: List[str] = []
    inversion: List[str] = []
    inv_and_rel: List[str] = []
    syntenic: List[str] = []

    for scaf, sources in scaffold_dict.items():
        first_ctg = list(sources.values())[0][0][0]
        if scaffold_nctgs[scaf] < 2 and first_ctg not in white_list:
            continue
        for source, ctg_list in sources.items():
            if source != 'unanchored' and \
                    dominant_source.get(scaf) != source:
                translocation.extend(c for c, _ in ctg_list)
            elif source != 'unanchored':
                ctg_order_list = []
                for ctg, ori_scaf in ctg_list:
                    idx, ori_truth = ctg_info[ctg][1:3]
                    ctg_order_list.append(
                        (ctg, idx if ori_scaf == ori_truth else -idx))
                f_sum, f_lis = _find_lis(ctg_order_list, length_of, True)
                r_sum, r_lis = _find_lis(ctg_order_list, length_of, False)
                if f_sum >= r_sum:
                    lis, lis_order = f_lis, 1
                else:
                    lis, lis_order = r_lis, -1
                syntenic.extend(lis)
                # merge non-LIS runs
                merged: List = []
                last_order = 0
                for ctg, order in ctg_order_list:
                    if ctg in lis:
                        merged.append((ctg, order))
                        last_order = 0
                    else:
                        if order * last_order > 0 and \
                                order == last_order + 1:
                            merged[-1].append((ctg, order))
                        else:
                            merged.append([(ctg, order)])
                        last_order = order
                new_list: List[Tuple[str, int]] = []
                all_inv: List[Tuple[str, int]] = []
                for seg in merged:
                    if isinstance(seg, list):
                        if seg[0][1] * lis_order > 0:
                            relocation.extend(c for c, _ in seg)
                            new_list.extend(seg)
                        else:
                            all_inv.extend(seg)
                            new_list.extend(
                                (c, -o) for c, o in seg[::-1])
                    else:
                        new_list.append(seg)
                _, new_lis = _find_lis(new_list, length_of,
                                       lis_order == 1)
                for ctg in new_lis:
                    if ctg not in lis and ctg not in relocation:
                        inversion.append(ctg)
                re_rel = set(lis) - set(new_lis)
                relocation.extend(re_rel)
                syntenic = [c for c in syntenic if c not in re_rel]
                for ctg, _ in all_inv:
                    if ctg not in inversion:
                        inv_and_rel.append(ctg)

    res = EvalResult()
    res.classes = {
        'syntenic': syntenic, 'unanchored': unanchored,
        'newly_anchored': newly_anchored,
        'translocation': translocation, 'relocation': relocation,
        'inversion': inversion,
        'inversion_and_relocation': inv_and_rel}
    res.total_ctg_num = len(ctg_info)
    res.total_ctg_len = sum(length_of.values())
    for key, lst in res.classes.items():
        res.counts[key] = len(lst)
        res.lengths[key] = sum(length_of[c] for c in lst)
    res.n_scaffolds = sum(
        1 for scaf, n in scaffold_nctgs.items()
        if n > 1 or (n == 1 and list(scaffold_dict[scaf].values())
                     [0][0][0] in white_list))

    # partition invariants (reference asserts :311-323)
    assert sum(res.counts.values()) == res.total_ctg_num
    covered = set()
    for lst in res.classes.values():
        covered |= set(lst)
    assert covered == set(ctg_info.keys())

    if verbose:
        print('###### summary ######')
        print('Number of scaffolds (at least two contigs): {}'
              .format(res.n_scaffolds))
        print('Total contigs: {} / {} bp'.format(res.total_ctg_num,
                                                 res.total_ctg_len))
        for key in res.classes:
            print('{} contigs: {} / {} bp / {:.2f} %'.format(
                key, res.counts[key], res.lengths[key], res.pct(key)))
    return res

"""Readers for the reference's on-disk artifacts, so every stage can be
run standalone on files produced by HapHiC or by this framework:

  * full_links.pkl / HT_links.pkl — {(name, name): links} pickles
    (written at scripts/HapHiC_cluster.py:2880,:2931)
  * *.clusters.txt / group*.txt   — cluster tables (:2199-2218)
  * *.clm                          — ALLHiC CLM text (:376-392)
  * Juicebox .assembly             — (HapHiC_reassign.py:169-199)
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import CLMData, COO
from haphic_tpu_torch.io.fasta import Assembly


def load_link_pickle(path: str, name2id: Dict[str, int],
                     n: Optional[int] = None) -> COO:
    """{(name_i, name_j): links} pickle → contig-id COO (i < j)."""
    with open(path, 'rb') as f:
        d = pickle.load(f)
    ii, jj, ww = [], [], []
    for (a, b), w in d.items():
        if a in name2id and b in name2id:
            x, y = name2id[a], name2id[b]
            ii.append(min(x, y))
            jj.append(max(x, y))
            ww.append(w)
    return COO(i=np.asarray(ii, np.int64), j=np.asarray(jj, np.int64),
               w=np.asarray(ww, np.float64))


def load_ht_pickle(path: str, name2id: Dict[str, int]) -> COO:
    """{(ctg_H/T, ctg_H/T): links} pickle → HT-node COO
    (node = 2*ctg + is_tail)."""
    with open(path, 'rb') as f:
        d = pickle.load(f)
    ii, jj, ww = [], [], []
    for (a, b), w in d.items():
        ca, sa = a.rsplit('_', 1)
        cb, sb = b.rsplit('_', 1)
        if ca not in name2id or cb not in name2id:
            continue
        ii.append(name2id[ca] * 2 + (sa == 'T'))
        jj.append(name2id[cb] * 2 + (sb == 'T'))
        ww.append(w)
    return COO(i=np.asarray(ii, np.int64), j=np.asarray(jj, np.int64),
               w=np.asarray(ww, np.float64))


def parse_clusters_file(path: str) -> List[Tuple[str, List[str]]]:
    """[(group_name, [ctg, ...])] in file order."""
    out: List[Tuple[str, List[str]]] = []
    with open(path) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            out.append((cols[0], cols[2:]))
    return out


def parse_group_file(path: str) -> List[Tuple[str, int, int]]:
    """[(ctg, RE_counts, length)] (format: scripts/HapHiC_cluster.py:2213)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            out.append((cols[0], int(cols[1]), int(cols[2])))
    return out


def parse_tour_file(path: str) -> List[Tuple[str, str]]:
    """Final ordering = last non-empty line of a .tour file
    (parity: scripts/HapHiC_build.py:29-57) → [(ctg, '+'|'-')]."""
    last = ''
    with open(path) as f:
        for line in f:
            if line.strip():
                last = line.strip()
    if last.startswith('>'):
        return []
    return [(tok[:-1], tok[-1]) for tok in last.split()]


def parse_assembly_file(path: str) -> List[Tuple[str, List[str]]]:
    """Juicebox .assembly → [(groupN, [ctg, ...])]
    (parity: scripts/HapHiC_reassign.py:169-199; orientation signs are
    ignored, as in the reference)."""
    ctg_of_num: Dict[str, str] = {}
    groups: List[Tuple[str, List[str]]] = []
    n = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if line.startswith('>'):
                ctg_of_num[cols[1]] = cols[0][1:]
            else:
                n += 1
                groups.append(('group{}'.format(n),
                               [ctg_of_num[x.strip('-')] for x in cols]))
    return groups


def parse_clm_file(path: str, name2id: Dict[str, int]) -> CLMData:
    """ALLHiC CLM text → record-level CLMData (one record per read
    pair; the four orientation lines of a pair are merged back)."""
    pair_i: List[int] = []
    pair_j: List[int] = []
    d_rows: List[List[int]] = [[], [], [], []]
    # per pair, the 4 combo lines appear consecutively (writer order)
    pending: Dict[Tuple[int, int, int], List[int]] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            head, cnt, rest = line.rstrip('\n').split('\t')
            a, b = head.split()
            ca, oa = a[:-1], a[-1]
            cb, ob = b[:-1], b[-1]
            if ca not in name2id or cb not in name2id:
                continue
            combo = 2 * (oa == '-') + (ob == '-')
            vals = rest.split()
            # writer duplicates every distance (d d), ascending
            dists = [int(v) for v in vals[::2]]
            key = (name2id[ca], name2id[cb])
            pending.setdefault(key, [None] * 4)[combo] = dists
    for (a, b), combos in pending.items():
        if any(c is None for c in combos):
            continue
        R = len(combos[0])
        for r in range(R):
            pair_i.append(a)
            pair_j.append(b)
            for c in range(4):
                d_rows[c].append(combos[c][r])
    return CLMData(pair_i=np.asarray(pair_i, np.int64),
                   pair_j=np.asarray(pair_j, np.int64),
                   d=np.asarray(d_rows, np.int64))

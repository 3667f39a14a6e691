"""Writers for the reference-compatible link artifacts:

  * full_links.pkl — {(ctg_i, ctg_j): links} pickle
    (reference: scripts/HapHiC_cluster.py:2931)
  * HT_links.pkl   — {(ctg_H/T_i, ctg_H/T_j): links} pickle
    (reference: scripts/HapHiC_cluster.py:2880)
  * paired_links.clm — ALLHiC CLM text
    (format per scripts/HapHiC_cluster.py:376-392: four orientation lines
    per contig pair with >= 2 read pairs; distances sorted ascending and
    each emitted twice; count column = 2 * n_read_pairs)
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import CLMData, COO, LinkData

ORI = (('+', '+'), ('+', '-'), ('-', '+'), ('-', '-'))


def full_link_dict(link_data: LinkData, names: List[str]
                   ) -> Dict[Tuple[str, str], float]:
    full = link_data.full
    out: Dict[Tuple[str, str], float] = {}
    for a, b, c in zip(full.i.tolist(), full.j.tolist(), full.w.tolist()):
        out[(names[a], names[b])] = int(c) if float(c).is_integer() else c
    return out


def ht_link_dict(link_data: LinkData, names: List[str]
                 ) -> Dict[Tuple[str, str], int]:
    ht = link_data.ht
    out: Dict[Tuple[str, str], int] = {}
    for a, b, c in zip(ht.i.tolist(), ht.j.tolist(), ht.w.tolist()):
        na = names[a // 2] + ('_T' if a % 2 else '_H')
        nb = names[b // 2] + ('_T' if b % 2 else '_H')
        out[(na, nb)] = int(c)
    return out


def write_pickle(obj, path: str) -> None:
    with open(path, 'wb') as f:
        pickle.dump(obj, f)


def write_clm(clm: CLMData, names: List[str], path: str,
              min_read_pairs: int = 2) -> None:
    """Emit the CLM text file, byte-compatible with output_clm
    (scripts/HapHiC_cluster.py:376-392)."""
    n = len(names)
    key = clm.pair_i * n + clm.pair_j
    # records already sorted by key (contacts.finalize); group boundaries
    uk, starts, counts = np.unique(key, return_index=True, return_counts=True)
    keep = counts >= min_read_pairs

    # per-combo, distances sorted ascending within each pair
    sorted_d = []
    for c in range(4):
        order = np.lexsort((clm.d[c], key))
        sorted_d.append(clm.d[c][order])

    # pair emission order = first occurrence in the alignment stream
    # (insertion order of the reference's clm_dict)
    emit = np.arange(len(uk))
    if clm.u_first_seen is not None and len(clm.u_first_seen) == len(uk):
        emit = emit[np.argsort(clm.u_first_seen, kind='stable')]

    # one bulk int->str pass per combo (np.char.mod's per-element
    # sprintf and per-segment '{0} {0}'.format loops both cost tens of
    # seconds at 10M read pairs; Python str() over a plain int list is
    # the fastest available conversion)
    strs = [list(map(str, sorted_d[c].tolist())) for c in range(4)]

    ni_all = [names[int(k) // n] for k in uk]
    nj_all = [names[int(k) % n] for k in uk]
    with open(path, 'w') as f:
        for t in emit[keep[emit]]:
            s, c = int(starts[t]), int(counts[t])
            ni, nj = ni_all[t], nj_all[t]
            for combo in range(4):
                seg = strs[combo][s:s + c]
                body = ' '.join('%s %s' % (v, v) for v in seg)
                f.write('{}{} {}{}\t{}\t{}\n'.format(
                    ni, ORI[combo][0], nj, ORI[combo][1], 2 * c, body))


def coo_to_name_dict(coo: COO, name_of) -> Dict[Tuple[str, str], float]:
    out: Dict[Tuple[str, str], float] = {}
    for a, b, c in zip(coo.i.tolist(), coo.j.tolist(), coo.w.tolist()):
        out[(name_of(a), name_of(b))] = int(c) if float(c).is_integer() else c
    return out

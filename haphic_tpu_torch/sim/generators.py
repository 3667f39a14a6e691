"""Simulation generators — the paper-reproduction harness re-built
(reference simulation/*.py, SURVEY.md §2 #34 / §4).

Unlike the reference (which pairs its generators with external read
simulators and aligners), `sim_hic_pairs` produces 4DN .pairs directly
from a distance-decay contact model, so the conformance loop
(simulate → scaffold → evaluate) is fully self-contained.

Truth-encoding contig IDs follow the reference convention
(simulation/sim_contigs.py output_fasta):
    {ChromID}_{fragNum}_{start}_{end}_{orientation}_{fragLen}
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from haphic_tpu_torch.io.fasta import revcomp


def sim_haplotypes(seqs: Dict[str, str], ploidy: int = 2,
                   div: float = 0.002, seed: int = 1,
                   ts_tv_ratio: float = 2.0,
                   weights: Tuple[float, float, float] = (90, 5, 5)
                   ) -> Tuple[List[Dict[str, str]], List[Tuple]]:
    """Mutate a template genome into ``ploidy`` haplotypes
    (semantics: simulation/sim_haplotypes.py — per-haplotype mutation
    streams with substitution/insertion/deletion weights; haplotype
    names get a '_hapN'-style suffix appended to the chromosome id).

    Returns (haplotype genome dicts, allele_info records
    (chrom, pos, hap, op))."""
    rng = np.random.default_rng(seed)
    subw, insw, delw = np.asarray(weights, float) / sum(weights)
    r = ts_tv_ratio
    op_p = np.asarray([subw * r / (1 + r), subw / (2 * r + 2),
                       subw / (2 * r + 2), insw / 4, insw / 4, insw / 4,
                       insw / 4, delw])
    sub_choice = {'A': 'GCT', 'T': 'CAG', 'C': 'TAG', 'G': 'ATC'}
    ins_base = {3: 'A', 4: 'T', 5: 'C', 6: 'G'}

    haps: List[Dict[str, str]] = []
    allele_info: List[Tuple] = []
    for h in range(ploidy):
        genome: Dict[str, str] = {}
        for chrom, seq in seqs.items():
            n = len(seq)
            mutate = rng.random(n) < div
            ops = rng.choice(8, size=int(mutate.sum()), p=op_p)
            out = []
            k = 0
            for i, base in enumerate(seq):
                if not mutate[i] or base == 'N':
                    out.append(base)
                    continue
                op = int(ops[k])
                k += 1
                allele_info.append((chrom, i + 1, h + 1, op))
                if op <= 2:
                    out.append(sub_choice.get(base, 'N')[op])
                elif op <= 6:
                    out.append(base)
                    out.append(ins_base[op])
                # op == 7: deletion — emit nothing
            genome['{}_{}'.format(chrom, h + 1)] = ''.join(out)
        haps.append(genome)
    return haps, allele_info


def sim_contigs(seqs: Dict[str, str], mean: int, cv: float,
                seed: int = 1, min_len: int = 5000,
                min_last_len: Optional[int] = None) -> Dict[str, str]:
    """Split chromosomes into contigs with normally distributed lengths
    and random orientations; IDs encode the truth
    (parity: simulation/sim_contigs.py)."""
    from scipy import stats
    if min_last_len is None:
        min_last_len = int(0.5 * mean * (1 - cv))
    total = sum(len(s) for s in seqs.values())
    n = int(total // mean * 5) + 10
    lens = [int(v) for v in stats.norm.rvs(loc=mean, scale=cv * mean,
                                           size=n, random_state=seed)
            if int(v) >= min_len]
    oris = stats.bernoulli.rvs(0.5, size=len(lens),
                               random_state=seed).tolist()

    out: Dict[str, str] = {}
    m = 0
    for chrom, seq in seqs.items():
        chr_len = len(seq)
        pieces: List[int] = []
        if chr_len <= lens[0]:
            pieces.append(chr_len)
        else:
            while lens and chr_len > lens[0]:
                pieces.append(lens.pop(0))
                chr_len -= pieces[-1]
            if chr_len and chr_len >= min_last_len and chr_len >= min_len:
                pieces.append(chr_len)
                if lens:
                    lens.pop(0)
            elif chr_len:
                pieces[-1] += chr_len
        p = 0
        for k, L in enumerate(pieces, 1):
            sub = seq[p:p + L]
            ori = '+'
            if oris[m]:
                sub = revcomp(sub)
                ori = '-'
            m += 1
            out['{}_{}_{}_{}_{}_{}'.format(chrom, k, p + 1, p + L,
                                           ori, L)] = sub
            p += L
    return out


def sim_chimeric_contigs(ctgs: Dict[str, str], n_chimeras: int,
                         seed: int = 1) -> Dict[str, str]:
    """Join random contig halves into misassembled chimeras
    (semantics: simulation/sim_chimeric_contigs.py — the chimera name
    concatenates the two parents with '_chimeric')."""
    rng = random.Random(seed)
    names = list(ctgs)
    rng.shuffle(names)
    out = dict(ctgs)
    made = 0
    while made < n_chimeras and len(names) >= 2:
        a = names.pop()
        b = names.pop()
        sa, sb = out.pop(a), out.pop(b)
        ha = len(sa) // 2
        hb = len(sb) // 2
        out['{}_{}_chimeric'.format(a, b)] = sa[:ha] + sb[hb:]
        out['{}_rest'.format(a)] = sa[ha:]
        out['{}_rest'.format(b)] = sb[:hb]
        made += 1
    return out


def sim_hic_pairs(ctgs: Dict[str, str], n_pairs: int, seed: int = 1,
                  decay: float = 150000.0,
                  trans_frac: float = 0.05,
                  chrom_of: Optional[Dict[str, Tuple[str, int, int, str]]]
                  = None) -> List[Tuple[str, str, int, str, int]]:
    """Simulate Hi-C read pairs with exponential distance decay on the
    underlying chromosomes. Contig IDs must be truth-encoded (or pass
    ``chrom_of`` explicitly: ctg → (chrom, start, end, ori)).

    Returns .pairs records (readID, ctg1, pos1, ctg2, pos2), 1-based.
    """
    rng = np.random.default_rng(seed)
    if chrom_of is None:
        chrom_of = {c: decode_truth_id(c) for c in ctgs}

    # chromosome layouts
    chrom_ctgs: Dict[str, List[Tuple[int, int, str, str]]] = {}
    for ctg, (chrom, start, end, ori) in chrom_of.items():
        chrom_ctgs.setdefault(chrom, []).append((start, end, ori, ctg))
    for chrom in chrom_ctgs:
        chrom_ctgs[chrom].sort()
    chrom_len = {c: max(e for _, e, __, ___ in v)
                 for c, v in chrom_ctgs.items()}
    chroms = sorted(chrom_len)
    probs = np.asarray([chrom_len[c] for c in chroms], float)
    probs /= probs.sum()

    def locate(chrom: str, gpos: int):
        for start, end, ori, ctg in chrom_ctgs[chrom]:
            if start <= gpos <= end:
                if ori == '+':
                    return ctg, gpos - start + 1
                return ctg, end - gpos + 1
        return None, 0

    recs: List[Tuple[str, str, int, str, int]] = []
    k = 0
    while len(recs) < n_pairs:
        k += 1
        if rng.random() < trans_frac and len(chroms) > 1:
            c1, c2 = rng.choice(len(chroms), size=2, replace=False)
            ch1, ch2 = chroms[c1], chroms[c2]
            g1 = int(rng.integers(1, chrom_len[ch1] + 1))
            g2 = int(rng.integers(1, chrom_len[ch2] + 1))
        else:
            ch1 = ch2 = chroms[int(rng.choice(len(chroms), p=probs))]
            g1 = int(rng.integers(1, chrom_len[ch1] + 1))
            g2 = g1 + int(rng.exponential(decay)) + 1
            if g2 > chrom_len[ch1]:
                continue
        ctg1, p1 = locate(ch1, g1)
        ctg2, p2 = locate(ch2, g2)
        if ctg1 is None or ctg2 is None:
            continue
        recs.append(('read{}'.format(k), ctg1, p1, ctg2, p2))
    return recs


def decode_truth_id(ctg_id: str) -> Tuple[str, int, int, str]:
    """'{Chrom}_{n}_{start}_{end}_{ori}_{len}' → (chrom, start, end, ori)."""
    parts = ctg_id.rsplit('_', 5)
    return parts[0], int(parts[2]), int(parts[3]), parts[4]


def mock_gfa(ctgs: Dict[str, str], path: str, depth: int = 30,
             jitter: int = 0, seed: int = 1) -> None:
    """Minimal hifiasm-style GFA with LN/rd tags
    (parity: simulation/mock_gfa.py)."""
    rng = random.Random(seed)
    with open(path, 'w') as f:
        for name, seq in ctgs.items():
            d = depth + (rng.randint(-jitter, jitter) if jitter else 0)
            f.write('S\t{}\t*\tLN:i:{}\trd:i:{}\n'.format(
                name, len(seq), max(d, 1)))

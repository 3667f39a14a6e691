"""Simulation/evaluation harness tools — functional equivalents of the
reference's `simulation/` scripts (SURVEY.md §2 #34, §4). Exposed via
``haphic sim <cmd>``; each maps to one reference script (named in the
docstring). These are host-side text/format tools; the compute-heavy
evaluation (weighted LIS etc.) lives in sim/evaluate.py.
"""

from __future__ import annotations

import collections
import os
import random
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, TextIO, Tuple

from haphic_tpu_torch.io.fasta import iter_fasta, revcomp


# ---------------------------------------------------------------------------
# Competitor adapters (simulation/convert_*.py)

def _write_tour(prefix: str, ordering: Sequence[str]) -> str:
    path = '{}.tour'.format(prefix)
    with open(path, 'w') as f:
        f.write('>INIT\n')
        f.write('{}\n'.format(' '.join(ordering)))
    return path


def convert_agp_to_tour(agp: str, prefix: str) -> str:
    """YaHS/SALSA2 AGP → .tour (simulation/convert_agp_to_tour.py)."""
    ordering = []
    with open(agp) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            if cols[4] == 'W':
                ordering.append(cols[5] + cols[8])
    return _write_tour(prefix, ordering)


def convert_assembly_to_tour(assembly: str, prefix: str) -> str:
    """3D-DNA .assembly → .tour (simulation/convert_assembly_to_tour.py)."""
    name_of = {}
    ordering = []
    with open(assembly) as f:
        for line in f:
            cols = line.split()
            if line.startswith('>'):
                name_of[cols[1]] = cols[0][1:]
            else:
                for tok in cols:
                    if tok.startswith('-'):
                        ordering.append(name_of[tok[1:]] + '-')
                    else:
                        ordering.append(name_of[tok] + '+')
    return _write_tour(prefix, ordering)


def convert_agp_to_groups(agp: str, outdir: str = '.') -> List[str]:
    """YaHS/SALSA AGP → per-scaffold group files with contigs renamed
    `<ctg>_seg<N>` per appearance (simulation/convert_agp_to_groups.py).
    Groups with <2 contigs are skipped."""
    groups: 'collections.OrderedDict[str, List[Tuple[str, int]]]' = \
        collections.OrderedDict()
    seg_count: Dict[str, int] = collections.defaultdict(int)
    with open(agp) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            seg_count[cols[5]] += 1
            seg = '{}_seg{}'.format(cols[5], seg_count[cols[5]])
            groups.setdefault(cols[0], []).append(
                (seg, int(cols[7]) - int(cols[6]) + 1))
    written = []
    n = 0
    for segs in groups.values():
        if len(segs) < 2:
            continue
        n += 1
        path = os.path.join(outdir, 'group{}.txt'.format(n))
        with open(path, 'w') as fo:
            for seg, length in segs:
                fo.write('{}\tNA\t{}\n'.format(seg, length))
        written.append(path)
    return written


def convert_assembly_to_groups(assembly: str, outdir: str = '.'
                               ) -> List[str]:
    """3D-DNA final .assembly → group files; only fragments whose name
    starts with 'Chr' are indexed, groups with <2 members skipped
    (simulation/convert_assembly_to_groups.py)."""
    frag_of: Dict[str, Tuple[str, int]] = {}
    written = []
    n = 0
    with open(assembly) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if line.startswith('>Chr'):
                frag_of[cols[1]] = (cols[0][1:], int(cols[2]))
            elif not line.startswith('>'):
                if len(cols) < 2:
                    continue
                n += 1
                path = os.path.join(outdir, 'group{}.txt'.format(n))
                with open(path, 'w') as fo:
                    for tok in cols:
                        num = tok.strip('-')
                        if num in frag_of:
                            frag, length = frag_of[num]
                            fo.write('{}\tNA\t{}\n'.format(frag, length))
                written.append(path)
    return written


def convert_lachesis_result_to_groups(clusters: str, fasta: str,
                                      outdir: str = '.') -> List[str]:
    """LACHESIS clusters.by_name.txt (one group per line, contig names
    space-separated) → HapHiC-style group files with lengths from the
    FASTA; <2-contig lines skipped
    (simulation/convert_lachesis_result_to_groups.py)."""
    lengths = {name: len(seq) for name, seq in iter_fasta(fasta)}
    written = []
    n = 0
    with open(clusters) as f:
        for line in f:
            if not line.strip() or line.startswith('#'):
                continue
            ctgs = line.split()
            if len(ctgs) < 2:
                continue
            n += 1
            path = os.path.join(outdir, 'group{}.txt'.format(n))
            with open(path, 'w') as fo:
                for ctg in ctgs:
                    fo.write('{}\tNA\t{}\n'.format(ctg, lengths[ctg]))
            written.append(path)
    return written


def convert_lachesis_ordering_to_tour(fasta: str, prefix: str,
                                      ordering_files: Sequence[str]
                                      ) -> Optional[str]:
    """LACHESIS group*.ordering files (cols: index, contig, orient 0/1)
    → one concatenated .tour restricted to contigs present in the FASTA;
    files sorted by group number; nothing written for <2 entries
    (simulation/convert_lachesis_ordering_to_tour.py)."""
    known = {name for name, _seq in iter_fasta(fasta)}
    ordering = []
    for path in sorted(
            ordering_files,
            key=lambda x: int(os.path.basename(x).split('.')[0]
                              .replace('group', ''))):
        with open(path) as f:
            for line in f:
                if not line.strip() or line.startswith('#'):
                    continue
                cols = line.split()
                if cols[1] in known:
                    ordering.append(
                        cols[1] + ('+' if cols[2] == '0' else '-'))
    if len(ordering) > 1:
        return _write_tour(prefix, ordering)
    return None


# ---------------------------------------------------------------------------
# Group-file and score statistics

def sim_group_files(fasta: str, outdir: str = '.') -> List[str]:
    """One group file per `<group>_...` name prefix, contigs sorted by
    descending length, GATC RE counts (simulation/sim_group_files.py)."""
    per_group: 'collections.OrderedDict[str, List[Tuple[str, int, int]]]' \
        = collections.OrderedDict()
    for name, seq in iter_fasta(fasta):
        seq = seq.upper()
        per_group.setdefault(name.split('_')[0], []).append(
            (name, seq.count('GATC'), len(seq)))
    written = []
    for group, rows in per_group.items():
        path = os.path.join(outdir, 'group_{}.txt'.format(group))
        with open(path, 'w') as fo:
            fo.write('#Contig\tRECounts\tLength\n')
            for name, re_sites, length in sorted(rows, key=lambda r: r[2],
                                                 reverse=True):
                fo.write('{}\t{}\t{}\n'.format(name, re_sites, length))
        written.append(path)
    return written


def score_statistics(tour: str, chrom: str, n50: str, program: str,
                     each_iteration: bool = False,
                     out: TextIO = sys.stdout,
                     err: TextIO = sys.stderr) -> None:
    """GA score per >GA checkpoint of a .tour file
    (simulation/score_statistics.py; checkpoints every 500 gens)."""
    start_score = ''
    score = ''
    ngen = 0
    with open(tour) as f:
        for line in f:
            if line.startswith('>GA') and not line.startswith('>GA2-0'):
                score = line.strip().split('-')[-1]
                if not start_score:
                    start_score = score
                if each_iteration:
                    err.write('{}\t{}\t{}\t{}\t{}\n'.format(
                        program, chrom, n50, ngen, score))
                ngen += 500
    out.write('{}\t{}\t{}\t{}\n'.format(program, chrom, n50, score))
    if program == 'HapHiC':
        out.write('{}_presort\t{}\t{}\t{}\n'.format(program, chrom, n50,
                                                    start_score))


def result_statistics(fasta: str, groups: Sequence[str],
                      excluded_chrs: Iterable[str] = ('Chr4', 'Chr8'),
                      out: TextIO = sys.stdout,
                      err: TextIO = sys.stderr) -> Dict[str, float]:
    """Anchoring/contamination metrics over truth-encoded group files
    (simulation/result_statistics.py). Contig ids are
    `<Chr>_<hap>_...`; 'collapsed'/'chimeric' contigs are skipped and
    `excluded_chrs` replicates the paper's Chr4/Chr8 exclusion."""
    excluded = set(excluded_chrs)
    total_len = 0
    for name, seq in iter_fasta(fasta):
        if 'collapsed' in name or 'chimeric' in name:
            continue
        total_len += len(seq)

    anchored_len: Dict[str, int] = collections.defaultdict(int)
    largest: Dict[str, int] = collections.defaultdict(int)
    homo_err = nonhomo_err = 0
    ex_anchored = ex_homo = ex_nonhomo = 0
    for group in groups:
        rows = []
        with open(group) as f:
            for line in f:
                if line.strip() and not line.startswith('#'):
                    rows.append(line)
        if len(rows) < 2:
            err.write('group file {} is skipped because of {} contig '
                      'inside\n'.format(group, len(rows)))
            continue
        per_chr: Dict[str, int] = collections.defaultdict(int)
        ex_group_len = 0
        for line in rows:
            if 'collapsed' in line or 'chimeric' in line:
                continue
            cols = line.split()
            source = '_'.join(cols[0].split('_')[:2])
            length = int(cols[2])
            per_chr[source] += length
            anchored_len[source] += length
            if source.split('_')[0] not in excluded:
                ex_group_len += length
        if not per_chr:
            continue
        ranked = sorted(per_chr.items(), key=lambda x: x[1])
        dominant = ranked[-1][0]
        for source, length in ranked:
            largest[source] = max(largest[source], length)
            if source != dominant:
                if source.split('_')[0] == dominant.split('_')[0]:
                    homo_err += length
                else:
                    nonhomo_err += length
        if dominant.split('_')[0] in excluded:
            continue
        ex_anchored += ex_group_len
        for source, length in ranked:
            if source.split('_')[0] in excluded or source == dominant:
                continue
            if source.split('_')[0] == dominant.split('_')[0]:
                ex_homo += length
            else:
                ex_nonhomo += length

    anchored = sum(anchored_len.values())
    contiguity = sum(largest[c] / anchored_len[c] for c in largest) / \
        len(anchored_len)
    ex_chrs = [c for c in anchored_len if c.split('_')[0] not in excluded]
    ex_contiguity = sum(largest[c] / anchored_len[c] for c in largest
                        if c.split('_')[0] not in excluded) / len(ex_chrs)
    stats = {
        'Contiguity': contiguity,
        'Inter_homo_error_rate': homo_err / anchored * 100,
        'Inter_nonhomo_error_rate': nonhomo_err / anchored * 100,
        'Chr4_8_excluded_contiguity': ex_contiguity,
        'Chr4_8_excluded_inter_homo_error_rate':
            ex_homo / ex_anchored * 100 if ex_anchored else 0.0,
        'Chr4_8_excluded_inter_nonhomo_error_rate':
            ex_nonhomo / ex_anchored * 100 if ex_anchored else 0.0,
        'Ngroups': len(groups),
        'Anchoring rate': anchored / total_len * 100,
    }
    for key, val in stats.items():
        if 'rate' in key.lower():
            out.write('{}\t{}%\n'.format(key, val))
        else:
            out.write('{}\t{}\n'.format(key, val))
    return stats


def link_statistics(fasta: str, bam: str, tag: str, outdir: str = '.'
                    ) -> str:
    """Per-contig intra-chrom / inter-homolog / inter-nonhomolog Hi-C
    link composition from inter-contig read1 records
    (simulation/link_statistics.py; truth-encoded `<Chr>_<hap>_...`
    contig ids). Uses the built-in BAM reader instead of pysam."""
    from haphic_tpu_torch.io.bam import _PyBam
    counts: Dict[str, List[int]] = {}
    for name, _seq in iter_fasta(fasta):
        counts[name] = [0, 0, 0]
    reader = _PyBam(bam)
    names = reader.ref_names
    for chunk in reader.records(1 << 16):
        ref, _pos, mref, _mpos, flag, _mapq = chunk
        for r, mr, fl in zip(ref.tolist(), mref.tolist(), flag.tolist()):
            if not fl & 0x40 or r == mr or r < 0 or mr < 0:
                continue
            a, b = names[r], names[mr]
            pa, pb = a.split('_'), b.split('_')
            if pa[0] == pb[0]:
                idx = 1 if pa[1] != pb[1] else 0
            else:
                idx = 2
            counts[a][idx] += 1
            counts[b][idx] += 1
    path = os.path.join(outdir, '{}_HiC_links.txt'.format(tag))
    with open(path, 'w') as fo:
        for ctg, c in counts.items():
            fo.write('{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                ctg, c[0], c[1], c[2], sum(c), tag))
    return path


# ---------------------------------------------------------------------------
# FASTA / input manipulation

def shuffle_fasta(fasta: str, seed: int = 12345, offset: int = 0,
                  outdir: str = '.') -> str:
    """Shuffle record order, byte-preserving sequence lines
    (simulation/shuffle_fasta.py; seeded with seed+offset)."""
    order: List[str] = []
    chunks: Dict[str, List[str]] = {}
    with open(fasta) as f:
        cur = None
        for line in f:
            if not line.strip():
                continue
            if line.startswith('>'):
                cur = line.split()[0][1:]
                order.append(cur)
                chunks[cur] = []
            else:
                chunks[cur].append(line)
    rng = random.Random()
    rng.seed(seed + offset)
    rng.shuffle(order)
    out = os.path.join(outdir, 'shuffled_' + os.path.basename(fasta))
    with open(out, 'w') as fo:
        for name in order:
            fo.write('>{}\n'.format(name))
            fo.writelines(chunks[name])
    return out


def split_fasta(fasta: str, bin_size: Optional[int] = None,
                seed: int = 12345, out: TextIO = sys.stdout) -> None:
    """Split sequences at N runs into `<ID>_ctg<N>[_bin<M>]` pieces and
    reverse-complement a seeded Bernoulli(0.5) subset, appending `_+`or
    `_-` to the id (simulation/split_fasta.py — same scipy RNG so the
    orientation assignment is reproducible)."""
    import scipy.stats

    pieces: List[Tuple[str, str, int]] = []
    for name, seq in iter_fasta(fasta):
        seq = seq.replace('n', 'N')
        n = 0
        for ctg in seq.split('N'):
            if not ctg:
                continue
            n += 1
            if bin_size:
                size = bin_size * 1000
                for m in range(len(ctg) // size + 1):
                    sub = ctg[m * size:(m + 1) * size]
                    pieces.append(('{}_ctg{}_bin{}'.format(name, n, m + 1),
                                   sub, len(sub)))
            else:
                pieces.append(('{}_ctg{}'.format(name, n), ctg, len(ctg)))

    flips = scipy.stats.bernoulli.rvs(0.5, size=len(pieces),
                                      random_state=seed).tolist()
    for flip, (name, seq, length) in zip(flips, pieces):
        if flip:
            name += '_-'
            seq = revcomp(seq)
        else:
            name += '_+'
        out.write('>{}\n'.format(name))
        for x in range(length // 60 + 1):
            out.write(seq[x * 60:(x + 1) * 60] + '\n')


def sample_mnd(mnd: str, npairs: int, proportion: float,
               seed: int = 12345, out: TextIO = sys.stdout) -> int:
    """Seeded subsample of a merged_nodups.txt by line number
    (simulation/sample_mnd.py — same stdlib RNG for identical picks)."""
    rng = random.Random()
    rng.seed(seed)
    picked = set(rng.sample(range(npairs), int(npairs * proportion)))
    kept = 0
    with open(mnd) as f:
        for n, line in enumerate(f):
            if n in picked:
                out.write(line)
                kept += 1
    return kept


def sort_agp(agp: str, chr_ordering: Sequence[str],
             out: TextIO = sys.stdout) -> None:
    """Reorder AGP groups by their dominant source chromosome (top-10
    longest truth-encoded contigs vote), appending unmatched groups
    (simulation/sort_agp.py)."""
    group_ctgs: Dict[str, List[Tuple[str, int]]] = collections.defaultdict(
        list)
    group_lines: 'collections.OrderedDict[str, List[str]]' = \
        collections.OrderedDict()
    chrs = set(chr_ordering)
    with open(agp) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            group_lines.setdefault(cols[0], []).append(line)
            if cols[4] != 'W':
                continue
            source = cols[5].rsplit('_', 2)[0]
            if source in chrs:
                group_ctgs[cols[0]].append((cols[5], int(cols[7])))

    chr_to_groups: Dict[str, List[str]] = collections.defaultdict(list)
    for group, ctgs in group_ctgs.items():
        ranked = sorted(ctgs, key=lambda x: x[1], reverse=True)
        if len(ranked) < 10:
            continue
        votes: Dict[str, int] = collections.defaultdict(int)
        for ctg, length in ranked[:10]:
            votes[ctg.rsplit('_', 2)[0]] += length
        best = sorted(votes.items(), key=lambda x: x[1], reverse=True)[0][0]
        chr_to_groups[best].append(group)

    emitted = set()
    for chrom in chr_ordering:
        for group in chr_to_groups[chrom]:
            emitted.add(group)
            out.writelines(group_lines[group])
    for group, lines in group_lines.items():
        if group not in emitted:
            out.writelines(lines)


# ---------------------------------------------------------------------------
# Error simulators (simulation/sim_switch_errors.py,
# sim_for_reassignment.py)

def sim_switch_errors(fasta: str, allele_info: str, rate: float = 0.1,
                      seed: int = 12345, outdir: str = '.') -> List[str]:
    """Swap a seeded fraction of allele assignments between haplotypes
    and re-emit per-haplotype FASTAs + new_allele_info.txt
    (simulation/sim_switch_errors.py — identical RNG call sequence so
    seeded outputs match)."""
    import numpy as np

    alleles: List[list] = []
    ploidy = 0
    with open(allele_info) as f:
        f.readline()
        for line in f:
            cols = line.split()
            alleles.append([cols[1], int(cols[2]), cols[3:]])
            ploidy = len(cols[3:]) - 1

    n_err = int(len(alleles) * rate)
    rng = random.Random()
    rng.seed(seed)
    picked = rng.sample(alleles, n_err)
    np.random.seed(seed * 2)
    targets = np.random.choice(list(range(ploidy - 1)), n_err,
                               p=[1 / (ploidy - 1)] * (ploidy - 1))
    swapped = {}
    for entry, t in zip(picked, targets.tolist()):
        swapped[id(entry)] = t

    trans = {}
    for n in range(ploidy):
        others = list(range(ploidy))
        others.pop(n)
        trans[n] = others

    by_pos: Dict[Tuple[str, int], list] = {}
    for entry in alleles:
        by_pos[(entry[0], entry[1])] = entry

    base_name = os.path.basename(fasta).rsplit('.', 1)[0]
    out_paths = [os.path.join(outdir, '{}_hap{}.fa'.format(base_name,
                                                           n + 1))
                 for n in range(ploidy)]
    fps = [open(p, 'w') for p in out_paths]
    info_path = os.path.join(outdir, 'new_allele_info.txt')
    fnew = open(info_path, 'w')
    fnew.write('Number\tChrom\tRef_coord\tRef_base\t{}\n'.format(
        '\t'.join('hap_{}'.format(n + 1) for n in range(ploidy))))
    allele_n = 0
    for name, seq in iter_fasta(fasta):
        seq = seq.upper()
        for n, fp in enumerate(fps):
            fp.write('>{}_{}\n'.format(name.rsplit('_', 1)[0], n + 1))
        buffers = [[] for _ in range(ploidy)]
        for pos, base in enumerate(seq, 1):
            entry = by_pos.get((name, pos))
            if entry is None:
                for buf in buffers:
                    buf.append(base)
                continue
            allele_n += 1
            bases = entry[2]
            if id(entry) in swapped:
                # swap the first divergent haplotype with another
                for n, b in enumerate(bases[1:]):
                    if b != bases[0]:
                        break
                m = trans[n][swapped[id(entry)]]
                bases[n + 1], bases[m + 1] = bases[m + 1], bases[n + 1]
            fnew.write('{}\t{}\t{}\t{}\n'.format(allele_n, name, pos,
                                                 '\t'.join(bases)))
            for n, buf in enumerate(buffers):
                if bases[n + 1] != '-':
                    buf.append(bases[n + 1])
        for fp, buf in zip(fps, buffers):
            fp.write(''.join(buf) + '\n')
    fnew.close()
    for fp in fps:
        fp.close()
    return out_paths + [info_path]


def sim_for_reassignment(fasta: str, ratio: float,
                         error_type: str = 'inter_homo',
                         seed: int = 12345, output_groups: bool = False,
                         outdir: str = '.') -> str:
    """Perturb the truth clustering of `<Chr>_<hap>_...` contigs to
    emit clusters (and optionally group files) with a controlled error
    rate / contiguity (simulation/sim_for_reassignment.py; identical
    RNG call sequence)."""
    import math

    import numpy as np

    source_of: 'collections.OrderedDict[str, List[str]]' = \
        collections.OrderedDict()
    lengths: Dict[str, int] = {}
    for name, seq in iter_fasta(fasta):
        source = '_'.join(name.split('_')[:2])
        source_of.setdefault(source, []).append(name)
        lengths[name] = len(seq)

    new: 'collections.OrderedDict[str, List[str]]' = \
        collections.OrderedDict()
    if error_type == 'contiguity':
        split_n = math.ceil(1 / ratio)
        for m, (source, ctgs) in enumerate(source_of.items()):
            max_n = int(ratio * len(ctgs))
            rest = sorted(ctgs)
            n = 0
            for n in range(1, split_n):
                rng = random.Random()
                rng.seed(seed * n + m)
                for ctg in rng.sample(rest, max_n):
                    new.setdefault('{}_{}'.format(source, n),
                                   []).append(ctg)
                    rest.remove(ctg)
            for ctg in rest:
                new.setdefault('{}_{}'.format(source, n + 1),
                               []).append(ctg)
    else:
        all_ctgs = sorted(c for ctgs in source_of.values() for c in ctgs)
        n_err = int(ratio * len(all_ctgs))
        ploidy = max(int(s.split('_')[1]) for s in source_of)
        rng = random.Random()
        rng.seed(seed)
        errs = rng.sample(all_ctgs, n_err)
        if error_type == 'inter_homo':
            k = ploidy - 1
        elif error_type == 'inter_nonhomo':
            k = len(source_of) - ploidy
        else:                       # anchoring_rate: drop the contigs
            k = 0
        if k:
            np.random.seed(seed * 2)
            choice = np.random.choice(list(range(k)), n_err,
                                      p=[1 / k] * k).tolist()
        for source, ctgs in source_of.items():
            for ctg in ctgs:
                if ctg not in errs:
                    new.setdefault(source, []).append(ctg)
                    continue
                if error_type == 'anchoring_rate':
                    continue
                if error_type == 'inter_homo':
                    others = ['{}_{}'.format(source.split('_')[0], n + 1)
                              for n in range(ploidy)]
                    others.remove(source)
                else:
                    others = sorted(
                        s for s in source_of
                        if s.split('_')[0] != source.split('_')[0])
                dest = others[choice[errs.index(ctg)]]
                new.setdefault(dest, []).append(ctg)

    clusters_path = os.path.join(
        outdir, '{}_{}.clusters.txt'.format(error_type, ratio))
    with open(clusters_path, 'w') as fc:
        fc.write('#Group\tnContigs\tContigs\n')
        for source, ctgs in new.items():
            fc.write('{}\t{}\t{}\n'.format(source, len(ctgs),
                                           ' '.join(ctgs)))
            if output_groups:
                gp = os.path.join(outdir, '{}_{}.group_{}.txt'.format(
                    error_type, ratio, source))
                with open(gp, 'w') as fg:
                    fg.write('#Contig\tRECounts\tLength\n')
                    for ctg in ctgs:
                        fg.write('{}\tNA\t{}\n'.format(ctg, lengths[ctg]))
    return clusters_path


# ---------------------------------------------------------------------------
# Correction evaluation (simulation/get_haphic_break_points.py,
# extract_corrected_ctgs_from_*.py, summarize_correction.py)

def get_haphic_break_points(raw_fasta: str, corrected_fasta: str,
                            n50: str, out: TextIO = sys.stdout) -> None:
    """Per-raw-contig break-point table from a HapHiC-corrected FASTA
    whose broken contigs carry `_break<N>` suffixes
    (simulation/get_haphic_break_points.py). Columns:
    program, N50, raw contig, chimera type, #breaks, cumulative break
    positions."""
    raw_ids: 'collections.OrderedDict[str, List[List[str]]]' = \
        collections.OrderedDict()
    with open(raw_fasta) as f:
        for line in f:
            if line.startswith('>'):
                raw_ids[line.split()[0][1:]] = []

    lengths: Dict[str, int] = {}
    with open(corrected_fasta) as f:
        cur = None
        for line in f:
            if line.startswith('>'):
                cur = line.split()[0][1:]
                lengths[cur] = 0
                if cur not in raw_ids:
                    nbreaks = cur.count('break')
                    splits = cur.rsplit('_', nbreaks)
                    raw_ids[splits[0]].append(splits[-nbreaks:])
            else:
                lengths[cur] += len(line.strip())

    for raw_id, breaks in raw_ids.items():
        if 'chimeric' in raw_id:
            if 'inter_homo' in raw_id:
                ctype = 'Inter_homo'
            elif 'inner_chrom' in raw_id:
                ctype = 'Intra_chrom'
            else:
                ctype = 'Inter_nonhomo'
        else:
            ctype = 'Non_chimeric'
        if breaks:
            p = 0
            points = []
            for b in sorted(breaks):
                p += lengths['_'.join([raw_id] + b)]
                points.append(p)
            out.write('HapHiC\t{}\t{}\t{}\t{}\t{}\n'.format(
                n50, raw_id, ctype, len(points) - 1,
                ' '.join(str(x) for x in points[:-1])))
        else:
            out.write('HapHiC\t{}\t{}\t{}\t0\tNA\n'.format(n50, raw_id,
                                                           ctype))


def extract_corrected_ctgs_from_yahs_agp(agp: str, fasta: str,
                                         out: TextIO = sys.stdout
                                         ) -> None:
    """YaHS AGP W lines → `<ctg>_<start>_<end>` corrected-contig FASTA
    (simulation/extract_corrected_ctgs_from_yahs_agp.py)."""
    seqs = {name: seq for name, seq in iter_fasta(fasta)}
    with open(agp) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            s, e = int(cols[6]), int(cols[7])
            out.write('>{}_{}_{}\n{}\n'.format(
                cols[5], cols[6], cols[7], seqs[cols[5]][s - 1:e]))


def extract_corrected_ctgs_from_salsa_agp(agp: str, fasta: str,
                                          out: TextIO = sys.stdout
                                          ) -> None:
    """SALSA AGP → corrected-contig FASTA; SALSA renames broken contigs
    `<ctg>_<n>` with per-fragment local coordinates, so positions are
    re-accumulated onto the raw contig
    (simulation/extract_corrected_ctgs_from_salsa_agp.py)."""
    seqs = {name: seq for name, seq in iter_fasta(fasta)}
    frags: Dict[str, List[Tuple[int, int, int]]] = \
        collections.defaultdict(list)
    entries: List[Tuple[str, str]] = []
    with open(agp) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            if cols[5] in seqs:
                s, e = int(cols[6]), int(cols[7])
                entries.append(('{}_{}_{}'.format(cols[5], cols[6],
                                                  cols[7]),
                                seqs[cols[5]][s - 1:e]))
            else:
                raw, n = cols[5].rsplit('_', 1)
                frags[raw].append((int(n), int(cols[6]), int(cols[7])))
    for raw, frag_list in frags.items():
        acc = 0
        for _n, start, end in sorted(frag_list):
            rs, re_ = start + acc - 1, end + acc
            entries.append(('{}_{}_{}'.format(raw, rs + 1, re_),
                            seqs[raw][rs:re_]))
            acc += end
    for name, seq in entries:
        out.write('>{}\n{}\n'.format(name, seq))


def extract_corrected_ctgs_from_3d_dna_assembly(assembly: str,
                                                fasta: str,
                                                out: TextIO = sys.stdout
                                                ) -> None:
    """3D-DNA .assembly `:::fragment_N` records → corrected-contig
    FASTA with accumulated coordinates
    (simulation/extract_corrected_ctgs_from_3d_dna_assembly.py)."""
    seqs = {name: seq for name, seq in iter_fasta(fasta)}
    frags: 'collections.OrderedDict[str, List[Tuple[int, int]]]' = \
        collections.OrderedDict()
    acc = 0
    with open(assembly) as f:
        for line in f:
            if not line.startswith('>') or line.startswith('>hic_gap_'):
                continue
            cols = line.split()
            raw = cols[0].split(':::fragment')[0][1:]
            frag_len = int(cols[2])
            if raw in frags:
                frags[raw].append((acc + 1, acc + frag_len))
                acc += frag_len
            else:
                frags[raw] = [(1, frag_len)]
                acc = frag_len
    for raw, spans in frags.items():
        for start, end in spans:
            out.write('>{}_{}_{}\n{}\n'.format(raw, start, end,
                                               seqs[raw][start - 1:end]))


def summarize_correction(stat: str, outdir: str = '.') -> None:
    """Aggregate a correction_stat.txt (rows from
    get_*_break_points.py) into summary.txt + break_point_distance.txt
    (simulation/summarize_correction.py). True error positions are
    decoded from the chimera simulator's truth-encoded ids."""
    def true_break(cid: str) -> int:
        parts = cid.split('_')
        if parts[-1][-1] == '0':
            return int(parts[6]) // 2
        return int(parts[13]) // 2

    def interval(dist: int) -> str:
        for hi, label in ((500, '[0, 500]'), (1000, '(500, 1000]')):
            if dist <= hi:
                return label
        for hi, label in ((5000, '(1000, 5000]'), (10000,
                                                   '(5000, 10000]'),
                          (50000, '(10000, 50000]'),
                          (100000, '(50000, 100000]')):
            if dist < hi:
                return label
        return '>100000'

    kinds = ('Inter_homo', 'Inter_nonhomo', 'Intra_chrom',
             'Non_chimeric')
    summary: Dict[tuple, List[int]] = collections.defaultdict(
        lambda: [0] * 8)
    dists: Dict[tuple, List[List[int]]] = collections.defaultdict(
        lambda: [[], [], []])
    with open(stat) as f:
        for line in f:
            cols = line.strip().split('\t')
            key = (cols[0], cols[1])
            kind = cols[3]
            broken = int(cols[4]) > 0
            base = kinds.index(kind) * 2
            summary[key][base + (0 if broken else 1)] += 1
            if broken and kind != 'Non_chimeric':
                slot = kinds.index(kind)
                for p in cols[5].split():
                    dists[key][slot].append(
                        abs(int(p) - true_break(cols[2])))

    with open(os.path.join(outdir, 'summary.txt'), 'w') as f:
        for (prog, n50), counts in summary.items():
            for i, kind in enumerate(kinds):
                f.write('{}\t{}\t{}\tBroken\t{}\n'.format(
                    prog, n50, kind, counts[2 * i]))
                f.write('{}\t{}\t{}\tUnbroken\t{}\n'.format(
                    prog, n50, kind, counts[2 * i + 1]))
    with open(os.path.join(outdir, 'break_point_distance.txt'),
              'w') as f:
        for (prog, n50), per_kind in dists.items():
            for kind, dlist in zip(kinds[:3], per_kind):
                for d in dlist:
                    f.write('{}\t{}\t{}\t{}\n'.format(prog, n50, kind,
                                                      interval(d)))


def _chimera_type(raw_id: str) -> str:
    if 'chimeric' in raw_id:
        if 'inter_homo' in raw_id:
            return 'Inter_homo'
        if 'inner_chrom' in raw_id:
            return 'Intra_chrom'
        return 'Inter_nonhomo'
    return 'Non_chimeric'


def _emit_break_rows(prog: str, n50: str,
                     rows: Iterable[Tuple[str, List[int]]],
                     out: TextIO) -> None:
    for raw_id, points in rows:
        if points:
            out.write('{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                prog, n50, raw_id, _chimera_type(raw_id), len(points),
                ' '.join(str(p) for p in points)))
        else:
            out.write('{}\t{}\t{}\t{}\t0\tNA\n'.format(
                prog, n50, raw_id, _chimera_type(raw_id)))


def get_yahs_break_points(raw_fasta: str, agp: str, n50: str,
                          out: TextIO = sys.stdout) -> None:
    """YaHS keeps raw contig names with raw end coordinates in its AGP;
    break points = all W-line end coords but the last
    (simulation/get_yahs_break_points.py)."""
    ends: 'collections.OrderedDict[str, List[int]]' = \
        collections.OrderedDict()
    with open(raw_fasta) as f:
        for line in f:
            if line.startswith('>'):
                ends[line.split()[0][1:]] = []
    with open(agp) as f:
        for line in f:
            cols = line.split()
            if cols and cols[4] == 'W':
                ends[cols[5]].append(int(cols[7]))
    _emit_break_rows('YaHS', n50,
                     ((rid, sorted(e)[:-1] if len(e) > 1 else [])
                      for rid, e in ends.items()), out)


def get_salsa_break_points(raw_fasta: str, agp: str, n50: str,
                           out: TextIO = sys.stdout) -> None:
    """SALSA renames fragments `<ctg>_<n>` with local coordinates;
    break points are accumulated fragment lengths
    (simulation/get_salsa_break_points.py)."""
    frags: 'collections.OrderedDict[str, List[Tuple[int, int]]]' = \
        collections.OrderedDict()
    with open(raw_fasta) as f:
        for line in f:
            if line.startswith('>'):
                frags[line.split()[0][1:]] = []
    with open(agp) as f:
        for line in f:
            cols = line.split()
            if cols and cols[4] == 'W' and cols[5] not in frags:
                raw, n = cols[5].rsplit('_', 1)
                frags[raw].append((int(n), int(cols[7])))

    def rows():
        for raw_id, fl in frags.items():
            points: List[int] = []
            p = 0
            for _n, frag_len in sorted(fl)[:-1]:
                points.append(frag_len + p)
                p += frag_len
            yield raw_id, points
    _emit_break_rows('SALSA2', n50, rows(), out)


def get_3d_dna_break_points(raw_fasta: str, assembly: str, n50: str,
                            out: TextIO = sys.stdout) -> None:
    """3D-DNA marks misjoins as `:::debris` fragments; a break point is
    the midpoint of each interior debris region
    (simulation/get_3d_dna_break_points.py)."""
    lengths: Dict[str, int] = {}
    debris: 'collections.OrderedDict[str, List[Tuple[int, int]]]' = \
        collections.OrderedDict()
    order: List[str] = []
    with open(raw_fasta) as f:
        cur = None
        for line in f:
            if line.startswith('>'):
                cur = line.split()[0][1:]
                lengths[cur] = 0
                debris[cur] = []
                order.append(cur)
            else:
                lengths[cur] += len(line.strip())
    last = ''
    start = 0
    with open(assembly) as f:
        for line in f:
            if not line.startswith('>'):
                continue
            cols = line.split()
            frag = cols[0][1:]
            if frag in debris:
                continue
            frag_len = int(cols[2])
            raw = frag.split(':::')[0]
            if raw != last:
                last = raw
                start = 0
            if frag.endswith('debris'):
                debris[raw].append((start + 1, start + frag_len + 1))
            start += frag_len

    def rows():
        for raw_id in order:
            regions = _merge_spans(debris[raw_id])
            points = []
            # interior regions only: a debris block touching either
            # contig end is a trim, not a misjoin break
            if not any(lo <= 0 for lo, _hi in regions):
                for lo, hi in regions:
                    if hi - 1 != lengths[raw_id]:
                        points.append((hi - lo - 1) // 2 + lo)
            yield raw_id, points
    _emit_break_rows('3D-DNA', n50, rows(), out)


def _merge_spans(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def get_allhic_break_points(raw_fasta: str, corrected_fasta: str,
                            n50: str, out: TextIO = sys.stdout) -> None:
    """ALLHiC corrector renames fragments `<ctg>_<start>_<end>`;
    break points = sorted end coords but the last
    (simulation/get_allhic_break_points.py)."""
    ends: 'collections.OrderedDict[str, List[int]]' = \
        collections.OrderedDict()
    with open(raw_fasta) as f:
        for line in f:
            if line.startswith('>'):
                ends[line.split()[0][1:]] = []
    with open(corrected_fasta) as f:
        for line in f:
            if line.startswith('>'):
                cid = line.split()[0][1:]
                if cid not in ends:
                    splits = cid.rsplit('_', 2)
                    ends[splits[0]].append(int(splits[-1]))
    _emit_break_rows('ALLHiC', n50,
                     ((rid, sorted(e)[:-1] if e else [])
                      for rid, e in ends.items()), out)


def sim_collapsed_regions(fasta: str, allele_info: str,
                          collapsed_len: int = 500000,
                          collapsed_ratio: float = 0.2,
                          weights: Sequence[float] = (0.7, 0.2, 0.1),
                          seed: int = 12345, strict: bool = False,
                          outdir: str = '.') -> Tuple[str, str]:
    """Simulate collapsed regions in a phased template genome
    (simulation/sim_collapsed_regions.py). Samples non-overlapping
    windows per template chromosome, collapses 2/3/4 haplotypes per
    window (weighted), and writes two FASTAs:

      haplotypes_collapsed_<len>_<ratio>.fa — fragment-level genome with
        truth-encoded ids `<chr>_<haps>_<lo>_<hi>_[collapsed_ctg_|
        remaining_hap_]<n>_<±>`;
      haplotypes_template_<len>_<ratio>.fa — chromosome-level
        uncollapsed genome for Hi-C read simulation.

    Allele divergence between haplotypes is applied from
    allele_info.txt (sim_haplotypes truth table). Returns both paths."""
    import math
    from itertools import combinations

    import numpy as np

    seqs: 'collections.OrderedDict[str, str]' = collections.OrderedDict()
    for name, seq in iter_fasta(fasta):
        seqs[name] = seq.upper()

    alleles: Dict[str, Dict[int, List[str]]] = collections.defaultdict(
        dict)
    with open(allele_info) as f:
        ploidy = len(f.readline().split()[4:])
        for line in f:
            cols = line.split()
            alleles[cols[1]][int(cols[2])] = cols[3:]

    single_hap_len = sum(len(s) for s in seqs.values())
    weights = list(weights)
    if sum(weights) != 1:
        weights = [w / sum(weights) for w in weights]
    n_regions = int(single_hap_len * ploidy /
                    ((1 / collapsed_ratio +
                      (weights[0] + 2 * weights[1] + 3 * weights[2]))
                     * collapsed_len))

    # --- sample non-overlapping collapsed windows (same RNG draws as
    # the reference: oversample x50, then first-fit non-overlapping)
    candidates = [(name, len(seq) - collapsed_len + 1)
                  for name, seq in seqs.items()]
    total_cand = sum(n for _name, n in candidates)
    rng = random.Random()
    rng.seed(seed)
    sampled = rng.sample(range(total_cand), n_regions * 50)
    rng2 = random.Random()
    rng2.seed(seed * 2)
    rng2.shuffle(sampled)

    windows: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(
        list)
    placed = 0
    for index in sampled:
        acc = 0
        for name, n in candidates:
            acc += n
            if acc - 1 >= index:
                break
        lo = index - (acc - n) + 1
        hi = index - (acc - n) + collapsed_len
        if any(lo <= h and l <= hi for l, h in windows[name]):
            continue
        windows[name].append((lo, hi))
        placed += 1
        if placed == n_regions:
            break
    if strict and placed != n_regions:
        raise RuntimeError('could not place {} non-overlapping collapsed '
                           'regions (placed {})'.format(n_regions,
                                                        placed))

    # --- collapse types and orientations
    all_haps = list(range(1, ploidy + 1))
    types: List[Tuple[int, ...]] = []
    probs: List[float] = []
    for k, w in zip((2, 3, 4), weights):
        if w and k <= ploidy:
            combos = list(combinations(all_haps, k))
            types.extend(combos)
            probs.extend([w / len(combos)] * len(combos))
    np.random.seed(seed * 3)
    type_idx = np.random.choice(list(range(1, len(types) + 1)), placed,
                                p=probs).tolist()
    np.random.seed(seed * 4)
    oris = np.random.choice(['+', '-'], placed * ploidy,
                            p=[0.5, 0.5]).tolist()

    col_path = os.path.join(outdir, 'haplotypes_collapsed_{}_{}.fa'
                            .format(collapsed_len, collapsed_ratio))
    tmp_path = os.path.join(outdir, 'haplotypes_template_{}_{}.fa'
                            .format(collapsed_len, collapsed_ratio))

    def hap_seq(name: str, lo: int, hi: int, hap0: int) -> str:
        """Apply hap-specific alleles (0-based hap index) to [lo,hi]."""
        base = seqs[name][lo - 1:hi]
        table = alleles.get(name)
        if not table:
            return base
        out = list(base)
        drop = []
        for m in range(len(out)):
            entry = table.get(lo + m)
            if entry is not None:
                b = entry[hap0 + 1]
                if b == '-':
                    drop.append(m)
                else:
                    out[m] = b
        for m in reversed(drop):
            out.pop(m)
        return ''.join(out)

    def oriented(s: str, orient: str) -> str:
        return s if orient == '+' else revcomp(s)

    with open(col_path, 'w') as fcol, open(tmp_path, 'w') as ftmp:
        index = 0
        for name, seq in seqs.items():
            father = name.split('_')[0]
            spans = sorted(windows.get(name, []))
            # interleave collapsed and non-collapsed intervals
            pieces: List[Tuple[int, int, bool]] = []
            pos = 1
            for lo, hi in spans:
                if pos < lo:
                    pieces.append((pos, lo - 1, False))
                pieces.append((lo, hi, True))
                pos = hi + 1
            if pos <= len(seq):
                pieces.append((pos, len(seq), False))

            n_nc = sum(1 for p in pieces if not p[2])
            np.random.seed(seed * 5 + list(seqs).index(name))
            nc_oris = np.random.choice(['+', '-'], n_nc * ploidy,
                                       p=[0.5, 0.5]).tolist()
            tmp_parts: List[List[str]] = [[] for _ in range(ploidy)]
            index_nc = 0
            for n, (lo, hi, is_col) in enumerate(pieces):
                if is_col:
                    haps = types[type_idx[index] - 1]
                    haps_str = ''.join(str(h) for h in haps)
                    orient = oris[index * ploidy + haps[0]]
                    fcol.write('>{}_{}_{}_{}_collapsed_ctg_{}_{}\n{}\n'
                               .format(father, haps_str, lo, hi, n + 1,
                                       orient,
                                       oriented(hap_seq(name, lo, hi,
                                                        haps[0] - 1),
                                                orient)))
                    for p in haps:
                        tmp_parts[p - 1].append(
                            hap_seq(name, lo, hi, haps[0] - 1))
                    for p in sorted(set(all_haps) - set(haps)):
                        orient = oris[index * ploidy + p - 1]
                        fcol.write('>{}_{}_{}_{}_remaining_hap_{}_{}\n'
                                   '{}\n'.format(
                                       father, p, lo, hi, n + 1, orient,
                                       oriented(hap_seq(name, lo, hi,
                                                        p - 1), orient)))
                        tmp_parts[p - 1].append(hap_seq(name, lo, hi,
                                                        p - 1))
                    index += 1
                else:
                    for p in all_haps:
                        orient = nc_oris[index_nc * ploidy + p - 1]
                        fcol.write('>{}_{}_{}_{}_{}_{}\n{}\n'.format(
                            father, p, lo, hi, n + 1, orient,
                            oriented(hap_seq(name, lo, hi, p - 1),
                                     orient)))
                        tmp_parts[p - 1].append(hap_seq(name, lo, hi,
                                                        p - 1))
                    index_nc += 1
            for p in all_haps:
                ftmp.write('>{}_{}\n{}\n'.format(
                    father, p, ''.join(tmp_parts[p - 1])))
    return col_path, tmp_path


def generic_result_statistics(fasta: str, chr_pattern: str,
                              groups: Sequence[str],
                              out: TextIO = sys.stdout,
                              err: TextIO = sys.stderr
                              ) -> Dict[str, float]:
    """result_statistics generalized to real genomes: contigs whose id
    matches ``chr_pattern`` are truth-anchored, others count toward
    anchoring length only (simulation/generic_result_statistics.py)."""
    total_len = 0
    for name, seq in iter_fasta(fasta):
        if 'collapsed' in name or 'chimeric' in name:
            continue
        total_len += len(seq)

    pat = re.compile(chr_pattern)
    anchored_len: Dict[str, int] = collections.defaultdict(int)
    largest: Dict[str, int] = collections.defaultdict(int)
    homo_err = nonhomo_err = 0
    for group in groups:
        rows = []
        with open(group) as f:
            for line in f:
                if line.strip() and not line.startswith('#'):
                    rows.append(line)
        if len(rows) < 2:
            err.write('group file {} is skipped because of {} contig '
                      'inside\n'.format(group, len(rows)))
            continue
        per_chr: Dict[str, int] = collections.defaultdict(int)
        for line in rows:
            if 'collapsed' in line or 'chimeric' in line:
                continue
            cols = line.split()
            length = int(cols[2])
            if pat.match(cols[0]):
                source = '_'.join(cols[0].split('_')[:2])
                per_chr[source] += length
                anchored_len[source] += length
            else:
                anchored_len['other'] += length
        if not per_chr:
            continue
        ranked = sorted(per_chr.items(), key=lambda x: x[1])
        dominant = ranked[-1][0]
        for source, length in ranked:
            largest[source] = max(largest[source], length)
            if source != dominant:
                if source.split('_')[0] == dominant.split('_')[0]:
                    homo_err += length
                else:
                    nonhomo_err += length

    anchored = sum(anchored_len.values())
    n_sources = len([c for c in anchored_len if c != 'other'])
    stats = {
        'Contiguity': sum(largest[c] / anchored_len[c]
                          for c in largest) / n_sources,
        'Inter_homo_error_rate': homo_err / anchored * 100,
        'Inter_nonhomo_error_rate': nonhomo_err / anchored * 100,
        'Ngroups': len(groups),
        'Anchoring rate': anchored / total_len * 100,
    }
    for key, val in stats.items():
        if 'rate' in key.lower():
            out.write('{}\t{}%\n'.format(key, val))
        else:
            out.write('{}\t{}\n'.format(key, val))
    return stats


def draw_tour_file(fasta: str, tour: str, program: str, n50: str,
                   ccc: bool = False, plot: bool = True,
                   outdir: str = '.', out: TextIO = sys.stdout):
    """Order-vs-truth dotplot of a tour against its dominant source
    chromosome, with optional Lin's Concordance Correlation Coefficient
    (simulation/draw_tour_file.py; the derange2 cost needs the external
    derange2 binary and is not reimplemented). Truth-encoded contig ids
    `<chr>_<n>_<start>_<end>_<orient>_<len±>`. Returns
    (line_list, ccc)."""
    import numpy as np

    with open(tour) as f:
        last = ''
        for line in f:
            if line.strip():
                last = line
    ctgs = last.split()

    chr_len: Dict[str, int] = collections.defaultdict(int)
    for ctg in ctgs:
        parts = ctg.split('_')
        chr_len[parts[0]] += int(parts[-1][:-1])
    dominant = sorted(chr_len.items(), key=lambda x: x[1])[-1][0]

    line_list: List[List[int]] = []
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    acc = 0
    for ctg in ctgs:
        parts = ctg.split('_')
        if parts[0] != dominant:
            continue
        strand = '+' if parts[-2] == parts[-1][-1] else '-'
        length = int(parts[-1][:-1])
        span = np.arange(acc + 1, acc + length + 1)
        if strand == '+':
            line_list.append([acc + 1, acc + length])
            xs.append(span)
        else:
            line_list.append([acc + length, acc + 1])
            xs.append(span[::-1])
        line_list.append([int(parts[2]), int(parts[3])])
        ys.append(np.arange(int(parts[2]), int(parts[3]) + 1))
        acc += length

    ccc_val = None
    if ccc and xs:
        y_pred = np.concatenate(xs).astype(np.float64)
        y_true = np.concatenate(ys).astype(np.float64)
        cor = np.corrcoef(y_true, y_pred)[0][1]
        num = 2 * cor * y_true.std() * y_pred.std()
        den = (y_true.var() + y_pred.var() +
               (y_true.mean() - y_pred.mean()) ** 2)
        ccc_val = round(num / den, 8)

    group_name = os.path.basename(tour).split('.tour')[0]
    if plot:
        import matplotlib
        matplotlib.use('Agg')
        from matplotlib import pyplot as plt
        plt.figure(figsize=(2.5, 2.5))
        plt.xlabel('{} (Mb)'.format(group_name), fontsize=9)
        plt.ylabel('{} (Mb)'.format(dominant), fontsize=9)
        for n in range(len(line_list) // 2):
            x, y = line_list[2 * n], line_list[2 * n + 1]
            color = '#E64B35' if x[1] > x[0] else '#3C91BF'
            plt.plot([v / 1e6 for v in x], [v / 1e6 for v in y],
                     color=color, linewidth=2)
        if ccc_val is not None:
            plt.legend(loc='upper center', frameon=False,
                       title="Lin's CCC = {:.2f}".format(ccc_val))
        plt.savefig(os.path.join(
            outdir, '{}_{}_{}.pdf'.format(group_name, program, n50)),
            bbox_inches='tight')
        plt.close()
    if ccc_val is not None:
        out.write('{}\t{}\t{}\t{}\n'.format(group_name, program, n50,
                                            ccc_val))
    return line_list, ccc_val


# ---------------------------------------------------------------------------
# Small analysis/utility scripts

def add_allele_tag(cor_file: str, allele_table: str,
                   out: TextIO = sys.stdout) -> None:
    """Append min-density and is-allelic columns to a correlation table
    using an ALLHiC-style Allele.ctg.table
    (simulation/add_allele_tag.py)."""
    from itertools import combinations
    allelic: set = set()
    with open(allele_table) as f:
        for line in f:
            if not line.strip():
                continue
            ctgs = line.split()[2:]
            for a, b in combinations(ctgs, 2):
                if a.split('_')[:2] != b.split('_')[:2]:
                    allelic.add(tuple(sorted((a, b))))
    with open(cor_file) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            tag = tuple(sorted(cols[:2])) in allelic
            out.write('{}\t{}\t{}\n'.format(
                line.strip(), min(float(cols[4]), float(cols[6])),
                'True' if tag else 'False'))


def allele_statistics(allele_info: str, prefix: str,
                      chrom: str = 'Chr1_1', outdir: str = '.') -> str:
    """Pairwise allele-type classification (identical / InDel /
    SNP transition / transversion) of a 4-haplotype allele_info.txt,
    restricted to ``chrom`` (simulation/allele_statistics.py)."""
    def allele_type(b1: str, b2: str) -> str:
        if b1 == b2:
            return 'Identical'
        if '-' in (b1, b2) or len(b1) != len(b2):
            return 'InDel'
        if (b1 in 'AG' and b2 in 'TC') or (b2 in 'AG' and b1 in 'TC'):
            return 'SNP_transversion'
        return 'SNP_transition'

    from itertools import combinations
    path = os.path.join(outdir, prefix + '.txt')
    with open(allele_info) as fin, open(path, 'w') as fout:
        fin.readline()
        for line in fin:
            cols = line.split()
            if cols[1] != chrom:
                break
            haps = cols[4:8]
            types = [allele_type(haps[i], haps[j])
                     for i, j in combinations(range(4), 2)]
            fout.write('{}\t{}\n'.format(line.strip(), '\t'.join(types)))
    return path


def density_statistics(density_file: str, out: TextIO = sys.stdout
                       ) -> None:
    """Annotate a link_density table with the collapse level (#haps)
    decoded from truth-encoded ids (simulation/density_statistics.py)."""
    with open(density_file) as f:
        for line in f:
            tag, ctg, density = line.strip().split('\t')
            out.write('{}\t{}\tnhap{}\n'.format(
                tag, density, len(ctg.split('_')[1])))


def get_paf_alignments(pafs: Sequence[str], out: TextIO = sys.stdout
                       ) -> None:
    """PAF → two rows per alignment (start/end anchor points) for
    dotplot-style downstream plotting
    (simulation/get_paf_alignments.py)."""
    for paf in pafs:
        with open(paf) as f:
            n = 0
            for line in f:
                if not line.strip():
                    continue
                n += 1
                cols = line.split()
                if cols[4] == '+':
                    qs, qe = int(cols[2]) + 1, int(cols[3])
                else:
                    qs, qe = int(cols[3]), int(cols[2]) + 1
                pair = '{}_{}'.format(cols[0], cols[5])
                out.write('{}\t{}\t{}\talignment_{}\t{}\t{}\n'.format(
                    pair, cols[1], cols[6], n, qs, int(cols[7])))
                out.write('{}\t{}\t{}\talignment_{}\t{}\t{}\n'.format(
                    pair, cols[1], cols[6], n, qe, int(cols[8])))


def filter_bam_from_list(bam: str, listf: str, threads: int = 8,
                         out: TextIO = sys.stdout) -> None:
    """Drop reads named in a list file from a BAM, streaming SAM via
    samtools (simulation/filter_bam_from_list.py)."""
    drop = set()
    with open(listf) as f:
        for line in f:
            if line.strip():
                drop.add(line.strip())
    with os.popen('samtools view -h {} -@ {}'.format(bam, threads)) as f:
        for line in f:
            if line.startswith('@') or line.split()[0] not in drop:
                out.write(line)


def filter_fastq_len(fastq_files: Sequence[str],
                     len_cutoff: int = 50000,
                     out_path: str = 'output.fq.gz') -> int:
    """Length-filter FASTQ reads (gz in/out) into one output.fq.gz,
    also requiring |seq| == |qual| (simulation/filter_fastq_len.py)."""
    import gzip
    kept = 0
    with gzip.open(out_path, 'wt') as fout:
        for fq in fastq_files:
            fopen = gzip.open if fq.endswith('.gz') else open
            with fopen(fq, 'rt') as fin:
                for line1 in fin:
                    line2 = fin.readline()
                    line3 = fin.readline()
                    line4 = fin.readline()
                    if (len(line2) >= len_cutoff
                            and len(line2) == len(line4)):
                        fout.writelines((line1, line2, line3, line4))
                        kept += 1
    return kept


def interpret_switch_errors(allele_info: str, new_allele_info: str,
                            out: TextIO = sys.stdout) -> None:
    """Report which haplotype pairs were swapped between an original
    and a switch-error allele table
    (simulation/interpret_switch_errors.py)."""
    def load(path):
        keys, haps = [], []
        with open(path) as f:
            f.readline()
            for line in f:
                cols = line.split()
                keys.append((cols[1], cols[2]))
                haps.append(tuple(cols[4:8]))
        return keys, haps

    k1, h1 = load(allele_info)
    k2, h2 = load(new_allele_info)
    if k1 != k2:
        raise RuntimeError('allele tables disagree on loci')
    for n in range(len(k1)):
        if h1[n] != h2[n]:
            out.write('{}\n'.format('<->'.join(
                'hap{}'.format(m + 1) for m in range(4)
                if h1[n][m] != h2[n][m])))


def split_mnd(mnd: str, chrs: Sequence[str], outdir: str = '.'
              ) -> List[str]:
    """Split a merged_nodups.txt by source chromosome, keeping only
    intra-chromosome pairs (simulation/split_mnd.py)."""
    outs = {c: open(os.path.join(outdir, c + '.mnd'), 'w')
            for c in chrs}
    try:
        with open(mnd) as f:
            for line in f:
                cols = line.split()
                if cols[1].split('_')[0] == cols[5].split('_')[0]:
                    src = cols[1].split('_')[0]
                    if src in outs:
                        outs[src].write(line)
    finally:
        for fo in outs.values():
            fo.close()
    return [os.path.join(outdir, c + '.mnd') for c in chrs]


def split_bam(bam: str, chrs: Sequence[str], threads: int = 8,
              outdir: str = '.') -> List[str]:
    """Split a BAM into per-source-chromosome SAMs (intra-chromosome
    pairs only), streaming via samtools (simulation/split_bam.py)."""
    outs = {c: open(os.path.join(outdir, c + '.sam'), 'w')
            for c in chrs}
    try:
        with os.popen('samtools view -h {} -@ {}'.format(
                bam, threads)) as f:
            for line in f:
                if line.startswith('@'):
                    if line.startswith('@SQ'):
                        src = line.split()[1].split('_')[0][3:]
                        if src in outs:
                            outs[src].write(line)
                    else:
                        for fo in outs.values():
                            fo.write(line)
                else:
                    cols = line.split()
                    src = cols[2].split('_')[0]
                    if src in outs and (cols[6] == '=' or
                                        cols[6].split('_')[0] == src):
                        outs[src].write(line)
    finally:
        for fo in outs.values():
            fo.close()
    return [os.path.join(outdir, c + '.sam') for c in chrs]


# ---------------------------------------------------------------------------
# ROC analyses of the cluster stage's filtering logs

def _filter_roc(fout: TextIO, total: set, ranked: List[str],
                positives: set, label: str, tag: str) -> None:
    """ROC sweep over top-fraction cutoffs 0..1 step 0.025: contigs in
    the top (1-cutoff) tail of the ranked list are 'detected'
    (shared by simulation/{chimeric,collapsed}_contig_statistics.py)."""
    fout.write('HapHiC\t{}\t{}\t1\t0\t0\n'.format(tag, label))
    n = len(ranked)
    for step in range(41):
        param = step * 0.025
        cut = int(n * param)
        detected = set(ranked[cut:])
        tp = detected & positives
        fp = detected - positives
        fn = positives - tp
        tn = (total - positives) - detected
        tpr = len(tp) / (len(tp) + len(fn)) if positives else 0.0
        fpr = len(fp) / (len(fp) + len(tn)) if (fp or tn) else 0.0
        fout.write('HapHiC\t{}\t{}\t{}\t{}\t{}\n'.format(
            tag, label, round(param, 3), tpr, fpr))


def _parse_filter_log(result: str, method: str, tag: str,
                      table_path: str) -> List[str]:
    """Extract per-fragment filtering scores from a cluster-stage log
    (rank-sum or link-density lines) in log order; writes the
    `<tag>\\t<ctg>\\t<score>` side table."""
    if method == 'link_density':
        pat = re.compile(
            r'.+link density filtering\] Fragment ([\w+-]+).+'
            r'density=([\d.]+)')
    else:
        pat = re.compile(
            r'.+rank sum filtering\] Fragment ([\w+-]+).+rank sum=(\d+)')
    ranked: List[str] = []
    with open(result) as f, open(table_path, 'w') as fout:
        for line in f:
            m = pat.match(line)
            if m:
                ctg, score = m.groups()
                ranked.append(ctg)
                fout.write('{}\t{}\t{}\n'.format(tag, ctg, score))
    return ranked


def chimeric_contig_statistics(fasta: str, result: str, n50: str,
                               outdir: str = '.') -> str:
    """ROC of the rank-sum chimera detector against truth-encoded
    chimeric contig ids (simulation/chimeric_contig_statistics.py).
    Writes rank_sum.txt + ROC.txt."""
    total, homo, nonhomo, inner = set(), set(), set(), set()
    with open(fasta) as f:
        for line in f:
            if line.startswith('>'):
                cid = line.split()[0][1:]
                total.add(cid)
                if 'inter_homo' in line:
                    homo.add(cid)
                elif 'inter_nonhomo' in line:
                    nonhomo.add(cid)
                elif 'inner' in line:
                    inner.add(cid)
    ranked = _parse_filter_log(result, 'rank_sum', n50,
                               os.path.join(outdir, 'rank_sum.txt'))
    if len(ranked) != len(total):
        raise RuntimeError('log covers {} fragments, FASTA has {}'
                           .format(len(ranked), len(total)))
    roc = os.path.join(outdir, 'ROC.txt')
    with open(roc, 'w') as fout:
        _filter_roc(fout, total, ranked, homo, 'inter_homo', n50)
        _filter_roc(fout, total, ranked, nonhomo, 'inter_nonhomo', n50)
        _filter_roc(fout, total, ranked, inner, 'intra_chrom', n50)
    return roc


def collapsed_contig_statistics(fasta: str, result: str, tag: str,
                                method: str = 'link_density',
                                outdir: str = '.') -> str:
    """ROC of the link-density (or rank-sum) collapse detector against
    truth-encoded `<chr>_<haps>_...` ids
    (simulation/collapsed_contig_statistics.py). Writes
    link_density.txt + ROC.txt."""
    total = set()
    by_level: Dict[int, set] = {2: set(), 3: set(), 4: set()}
    with open(fasta) as f:
        for line in f:
            if line.startswith('>'):
                cid = line.split()[0][1:]
                total.add(cid)
                nhaps = len(cid.split('_')[1])
                if nhaps in by_level:
                    by_level[nhaps].add(cid)
    ranked = _parse_filter_log(result, method, tag,
                               os.path.join(outdir, 'link_density.txt'))
    if len(ranked) != len(total):
        raise RuntimeError('log covers {} fragments, FASTA has {}'
                           .format(len(ranked), len(total)))
    roc = os.path.join(outdir, 'ROC.txt')
    with open(roc, 'w') as fout:
        for nhaps, label in ((2, 'two_hap_collapsed'),
                             (3, 'three_hap_collapsed'),
                             (4, 'four_hap_collapsed')):
            _filter_roc(fout, total, ranked, by_level[nhaps], label, tag)
    return roc


# ---------------------------------------------------------------------------
# Synteny (jcvi) helpers and PBS accounting

def extract_SVs_from_simple(simple: str, gene_bed: str,
                            chrom: str = 'Chr02', outdir: str = '.'
                            ) -> Tuple[str, str, str]:
    """Split starred SV blocks of a jcvi .anchors.simple into
    inversion/translocation/inv+trans BED files using gene coordinates
    (simulation/extract_SVs_from_simple.py)."""
    pos: Dict[str, Tuple[int, int]] = {}
    with open(gene_bed) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            if cols[0] == chrom:
                pos[cols[3]] = (int(cols[1]), int(cols[2]))
    prefix = os.path.join(outdir,
                          os.path.basename(gene_bed).rsplit('.')[0])
    paths = tuple('{}_{}.bed'.format(prefix, k)
                  for k in ('inv', 'trans', 'invtr'))
    counts = {'g': 0, 'b': 0, 'r': 0}
    names = {'g': 'INV', 'b': 'TRANS', 'r': 'INVTR'}
    files = {k: open(p, 'w') for k, p in zip('gbr', paths)}
    try:
        with open(simple) as f:
            for line in f:
                if not line.strip() or '*' not in line:
                    continue
                sv = line[0]
                cols = line[2:].split()
                if cols[0] not in pos:
                    continue
                span = pos[cols[0]] + pos[cols[1]]
                counts[sv] += 1
                files[sv].write('{}\t{}\t{}\t{}{}\t0\t+\n'.format(
                    chrom, min(span), max(span), names[sv], counts[sv]))
    finally:
        for fo in files.values():
            fo.close()
    return paths


def filter_orthologous_anchors(anchors_simple: str, bed1: str, bed2: str,
                               chrs1: Sequence[str],
                               chrs2: Sequence[str],
                               out: TextIO = sys.stdout) -> None:
    """Keep collinear jcvi anchors between paired chromosomes and star
    out-of-order blocks as inversions (g*), translocations (b*) or
    both (r*) (simulation/filter_orthologous_anchors.py)."""
    def parse_bed(bed):
        chr_of: Dict[str, str] = {}
        order: Dict[str, List[str]] = collections.defaultdict(list)
        with open(bed) as f:
            for line in f:
                if line.strip():
                    cols = line.split()
                    chr_of[cols[3]] = cols[0]
                    order[cols[0]].append(cols[3])
        return chr_of, order

    chr1_of, order1 = parse_bed(bed1)
    chr2_of, order2 = parse_bed(bed2)
    chrs1 = list(chrs1)
    chrs2 = list(chrs2)
    former1: List[str] = []
    former2: List[str] = []
    with open(anchors_simple) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.split()
            c1, c2 = chr1_of[cols[0]], chr2_of[cols[2]]
            if chrs1.index(c1) != chrs2.index(c2):
                continue
            if not (former1 and chr1_of[former1[-1]] == c1):
                out.write(('g*' + line) if cols[-1] == '-' else line)
                former1, former2 = [cols[0]], [cols[2]]
                continue
            if max(order2[c2].index(g) for g in former2) > \
                    order2[c2].index(cols[2]):
                out.write(('r*' if cols[-1] == '-' else 'b*') + line)
                continue
            if cols[-1] == '-':
                out.write('g*' + line)
                former2.append(cols[2])
                continue
            out.write(line)
            former1.append(cols[0])
            former2.append(cols[2])


def pbsperf(jobids: Sequence[str], ndays: int = 100,
            out: TextIO = sys.stdout) -> Tuple[float, float, float]:
    """Aggregate PBS tracejob accounting (wall/CPU minutes, peak GiB)
    for the paper's benchmark table (simulation/pbsperf.py). Requires
    the `tracejob` binary on a PBS host."""
    ids = [j.split('.')[0] for j in jobids]
    if len(ids) != len(set(ids)):
        raise RuntimeError('Find repeated JobID!')
    pat = re.compile(r'.+Exit_status=(\d).+resources_used.cput=([\w:]+) '
                     r'resources_used.mem=(\d+)kb.+'
                     r'resources_used.walltime=([\d:]+)')

    def secs(t: str) -> int:
        hh, mm, ss = t.split(':')
        return int(hh) * 3600 + int(mm) * 60 + int(ss)

    peak = cput = wallt = 0
    for jobid in ids:
        with os.popen('tracejob {} -n {} 2>&1'.format(jobid, ndays)) as f:
            for line in f:
                m = pat.match(line)
                if m:
                    status, cpu, mem, wall = m.groups()
                    if status != '0':
                        raise RuntimeError(
                            'Exit status != 0 ({}, Exit_status={})'
                            .format(jobid, status))
                    cput += secs(cpu)
                    wallt += secs(wall)
                    peak = max(peak, int(mem))
                elif "Couldn't find Job Id" in line:
                    raise RuntimeError(line)
    wall_min = round(wallt / 60, 2)
    cpu_min = round(cput / 60, 2)
    peak_gib = round(peak / (1024 * 1024), 2)
    out.write('Wall time = {} min\nCPU time = {} min\n'
              'Peak memory = {} GiB\n'.format(wall_min, cpu_min,
                                              peak_gib))
    return wall_min, cpu_min, peak_gib


# ---------------------------------------------------------------------------
# Mock nucmer delta for dotplot validation (simulation/mock_delta.py,
# validate_mock_delta.py)

def _write_nogaps(fasta: str, outdir: str = '.') -> Tuple[str, Dict[str,
                                                                    int]]:
    """Write `<base>.chrs.nogaps<ext>` with Ns stripped; return its
    absolute path and per-sequence lengths."""
    base, ext = os.path.splitext(os.path.basename(fasta))
    path = os.path.join(outdir, '{}.chrs.nogaps{}'.format(base, ext))
    lens: Dict[str, int] = {}
    with open(path, 'w') as fo:
        for name, seq in iter_fasta(fasta):
            seq = seq.upper().replace('N', '')
            fo.write('>{}\n{}\n'.format(name, seq))
            lens[name] = len(seq)
    return os.path.abspath(path), lens


def mock_delta(query_agp: str, query_fasta: str, ref_fasta: str,
               outdir: str = '.') -> str:
    """Mock a nucmer .delta from a scaffold AGP over truth-encoded
    contigs `<refchr>_ctg<N>_<±>` so mummerplot-style dotplots can be
    drawn without alignment (simulation/mock_delta.py). Adjacent
    collinear contigs are merged into one alignment block; gap lengths
    are subtracted since the no-gap FASTAs drop Ns."""
    alignments: 'collections.OrderedDict[str, list]' = \
        collections.OrderedDict()
    per_ref: Dict[str, List[Tuple[str, int, int]]] = \
        collections.defaultdict(list)
    offsets: Dict[str, int] = collections.defaultdict(int)
    with open(query_agp) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            scaf = cols[0]
            if cols[4] == 'W':
                off = offsets[scaf]
                s, e = int(cols[1]) - off, int(cols[2]) - off
                ctg, ctg_len, aln_ori = cols[5], int(cols[7]), cols[8]
                ref_chrom, order, ctg_ori = ctg.rsplit('_', 2)
                orient = '+' if aln_ori == ctg_ori else '-'
                alignments.setdefault(scaf, []).append(
                    (s, e, ctg, orient))
                per_ref[ref_chrom].append((ctg, ctg_len,
                                           int(order[3:])))
            elif cols[4] in ('U', 'N'):
                offsets[scaf] += int(cols[5])

    ref_chrs, ref_lens = _write_nogaps(ref_fasta, outdir)
    query_chrs, query_lens = _write_nogaps(query_fasta, outdir)

    ctg_pos: Dict[str, Tuple[str, int, int]] = {}
    for ref_chrom, ctgs in per_ref.items():
        start = 1
        for ctg, ctg_len, _order in sorted(ctgs, key=lambda x: x[2]):
            ctg_pos[ctg] = (ref_chrom, start, start + ctg_len - 1)
            start += ctg_len

    path = os.path.join(outdir, 'mock.delta')
    with open(path, 'w') as f:
        f.write('{} {}\nNUCMER\n'.format(ref_chrs, query_chrs))

        def emit(scaf, chrom, orient, cs, ce, ss, se):
            f.write('>{} {} {} {}\n'.format(chrom, scaf,
                                            ref_lens[chrom],
                                            query_lens[scaf]))
            if orient == '+':
                f.write('{} {} {} {} 0 0 0\n0\n'.format(cs, ce, ss, se))
            else:
                f.write('{} {} {} {} 0 0 0\n0\n'.format(ce, cs, se, ss))

        for scaf, alns in alignments.items():
            last_se = last_ce = 0
            last_chrom = last_ori = ''
            m_cs = m_ss = 0
            for s, e, ctg, orient in alns:
                chrom, cs, ce = ctg_pos[ctg]
                if orient == '-':
                    cs, ce = ce, cs
                    contiguous = last_ce == cs + 1
                else:
                    contiguous = last_ce == cs - 1
                if last_chrom == '' or (chrom == last_chrom and
                                        contiguous and
                                        last_se == s - 1 and
                                        last_ori == orient):
                    if last_chrom == '':
                        m_cs, m_ss = cs, s
                        last_chrom, last_ori = chrom, orient
                    last_ce, last_se = ce, e
                    continue
                emit(scaf, last_chrom, last_ori, m_cs, last_ce, m_ss,
                     last_se)
                m_cs, m_ss = cs, s
                last_ce, last_se = ce, e
                last_chrom, last_ori = chrom, orient
            emit(scaf, last_chrom, last_ori, m_cs, last_ce, m_ss,
                 last_se)
    return path


def validate_mock_delta(ref_fa: str, query_fa: str, delta: str,
                        out: TextIO = sys.stdout) -> None:
    """Assert every mocked delta block's reference slice equals the
    (possibly reverse-complemented) query slice
    (simulation/validate_mock_delta.py)."""
    ref = {n: s.upper() for n, s in iter_fasta(ref_fa)}
    query = {n: s.upper() for n, s in iter_fasta(query_fa)}
    with open(delta) as f:
        for line in f:
            if not line.startswith('>'):
                continue
            cols = line.split()
            chrom, scaf = cols[0][1:], cols[1]
            rseq, qseq = ref[chrom], query[scaf]
            assert len(rseq) == int(cols[2])
            assert len(qseq) == int(cols[3])
            rs, re_, ss, se = [int(v) for v in f.readline().split()[:4]]
            assert 'N' not in rseq[rs - 1:re_]
            if ss < se:
                assert rseq[rs - 1:re_] == qseq[ss - 1:se]
            else:
                assert rseq[rs - 1:re_] == revcomp(qseq[se - 1:ss])
    out.write('Check Passed...\n')


def haplotype_kmers(ref: str, asm: str, kmer_size: int = 201,
                    bin_size: int = 500000, outdir: str = '.'
                    ) -> List[str]:
    """Classify canonical assembly k-mers against a phased reference
    (`chr<N>_<hap>` sequence names) and emit per-bin haplotype
    composition tables `<seq>_k<k>_<bin>.txt`
    (simulation/haplotype_kmers.py). Columns: seq, start, end, primary
    source (hapN / shared / other_chrom / unreliable), alpha (primary
    hap fraction of chromosome-specific k-mers), raw counts."""
    def canonical(s: str) -> str:
        r = revcomp(s)
        return s if s < r else r

    asm_seqs = {n: s.upper() for n, s in iter_fasta(asm)}

    # per assembly sequence: ordered canonical k-mer list (N-free)
    kmers_of: Dict[str, List[str]] = {}
    all_kmers: set = set()
    for name, seq in asm_seqs.items():
        ks = []
        for i in range(len(seq) - kmer_size + 1):
            kf = seq[i:i + kmer_size]
            if 'N' in kf:
                continue
            ks.append(canonical(kf))
        kmers_of[name] = ks
        all_kmers.update(ks)

    # annotate with reference sources
    sources: Dict[str, Dict[str, int]] = {}
    for rname, seq in iter_fasta(ref):
        seq = seq.upper()
        for i in range(len(seq) - kmer_size + 1):
            kf = seq[i:i + kmer_size]
            if 'N' in kf:
                continue
            kmer = canonical(kf)
            if kmer in all_kmers:
                sources.setdefault(kmer, collections.defaultdict(int))[
                    rname] += 1

    written = []
    for name, ks in kmers_of.items():
        # dominant chromosome of this assembly sequence
        chr_votes: Dict[str, int] = collections.defaultdict(int)
        bins: List[Dict[str, int]] = []
        for i, kmer in enumerate(ks):
            b = i // bin_size
            while len(bins) <= b:
                bins.append(collections.defaultdict(int))
            src = sources.get(kmer)
            if src is None:
                bins[b]['unknown'] += 1
            elif len(src) == 1:
                rname = next(iter(src))
                bins[b][rname] += 1
                chr_votes[rname.split('_')[0]] += 1
            else:
                chroms = {r.split('_')[0] for r in src}
                if len(chroms) == 1:
                    chrom = chroms.pop()
                    bins[b][chrom + '_shared'] += 1
                    chr_votes[chrom] += 1
                else:
                    bins[b]['nonspecific'] += 1
        est_chr = sorted(chr_votes.items(), key=lambda x: x[1])[-1][0] \
            if chr_votes else ''
        path = os.path.join(outdir, '{}_k{}_{}.txt'.format(
            name, kmer_size, bin_size))
        written.append(path)
        with open(path, 'w') as fo:
            for b, counts in enumerate(bins):
                start = b * bin_size + 1
                stat: Dict[str, int] = collections.defaultdict(int)
                chr_specific = 0
                for src, n in counts.items():
                    if src.endswith('_shared'):
                        if src[:-len('_shared')] == est_chr:
                            stat['shared'] += n
                            chr_specific += n
                        else:
                            stat['other_chrom'] += n
                    elif '_' in src and src.split('_')[0] == est_chr:
                        stat['hap{}'.format(src.split('_')[1])] += n
                        chr_specific += n
                    elif src in ('nonspecific', 'unknown'):
                        stat['unreliable'] += n
                    else:
                        stat['other_chrom'] += n
                ranked = sorted(stat.items(), key=lambda x: x[1])
                primary = ranked[-1][0]
                alpha = 1.0
                if primary == 'shared' or primary.startswith('hap'):
                    max_n = 0
                    for s, n in ranked:
                        if s.startswith('hap') and n > max_n:
                            max_n, primary = n, s
                    if chr_specific:
                        alpha = max_n / chr_specific
                fo.write('{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                    name, start, start + bin_size - 1, primary, alpha,
                    dict(counts)))
    return written


# ---------------------------------------------------------------------------
# Allelic-pruning ROC (simulation/allelic_contig_statistics.py)

def _parse_truth_ctg(ctg: str) -> Tuple[str, str, Tuple[int, int], int]:
    """Truth-encoded id `{Chrom}_{hap}_{frag}_{start}_{end}_{ori}_{len}`
    → (homolog group, source chromosome, source span, length)."""
    el = ctg.split('_')
    return (el[0], '_'.join(el[:2]), (int(el[3]), int(el[4])),
            int(el[6]))


def allelic_contig_statistics(result: str, allele_table: str, tag: str,
                              overlap_len_cutoff: int = 10000,
                              link_cutoff: int = 20, outdir: str = '.'
                              ) -> Tuple[str, str]:
    """ROC of concordance-ratio allelic detection vs truth overlaps,
    compared against an ALLHiC-style synteny allele table
    (simulation/allelic_contig_statistics.py). ``result`` is a cluster
    stage ``--verbose`` log; pairs are read from its
    `<ctg1> <ctg2> links=N concordance_ratio=R` lines (any log prefix).
    Writes concordance_ratio.txt and ROC.txt; returns their paths."""
    synteny: set = set()
    with open(allele_table) as f:
        for line in f:
            cols = line.split()
            for i in range(2, len(cols)):
                for j in range(i + 1, len(cols)):
                    synteny.add(tuple(sorted((cols[i], cols[j]))))

    info_cache: Dict[str, Tuple[str, str, Tuple[int, int], int]] = {}
    total_pairs: set = set()
    allelic_pairs: set = set()
    allhic_positive: set = set()
    ranked: List[Tuple[Tuple[str, str], float]] = []

    cr_path = os.path.join(outdir, 'concordance_ratio.txt')
    with open(result) as fin, open(cr_path, 'w') as fout:
        for line in fin:
            if 'concordance_ratio=' not in line:
                continue
            cols = line.split()
            li = next((k for k, c in enumerate(cols)
                       if c.startswith('links=')), None)
            if li is None or li < 2:
                continue
            ctg_1, ctg_2 = cols[li - 2], cols[li - 1]
            links = int(cols[li].split('=')[-1])
            ratio = float(cols[li + 1].split('=')[-1])
            pair = tuple(sorted((ctg_1, ctg_2)))
            is_synteny = pair in synteny

            for c in (ctg_1, ctg_2):
                if c not in info_cache:
                    info_cache[c] = _parse_truth_ctg(c)
            homo_1, chr_1, span_1, len_1 = info_cache[ctg_1]
            homo_2, chr_2, span_2, len_2 = info_cache[ctg_2]
            if homo_1 != homo_2:
                continue

            ovl_len = ovl_pct = 0
            if chr_1 != chr_2:
                type_ = 'Inter_homo'
                lo = max(span_1[0], span_2[0])
                hi = min(span_1[1], span_2[1])
                if hi >= lo:
                    ovl_len = hi - lo + 1
                    ovl_pct = ovl_len * 2 / (len_1 + len_2) * 100
            else:
                type_ = 'Intra_chrom'

            if ovl_pct == 0:
                interval = '0'
            else:
                hi_edge = min(int((ovl_pct - 1e-12) // 10) * 10 + 10,
                              100)
                interval = '({}, {}]'.format(hi_edge - 10, hi_edge)

            if links >= link_cutoff:
                if ovl_len >= overlap_len_cutoff:
                    total_pairs.add(pair)
                    allelic_pairs.add(pair)
                    if is_synteny:
                        allhic_positive.add(pair)
                    ranked.append((pair, ratio))
                elif type_ == 'Intra_chrom':
                    total_pairs.add(pair)
                    if is_synteny:
                        allhic_positive.add(pair)
                    ranked.append((pair, ratio))

            fout.write('{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                tag, ctg_1, ctg_2, type_, ovl_pct, interval, ratio,
                links, is_synteny))

    # ROC over concordance-ratio cutoffs 0, 0.05, ..., 1.0 (seeded
    # shuffle before the descending sort for robust tie-breaking; a
    # local RNG so callers' global random state is untouched)
    random.Random(12345).shuffle(ranked)
    ranked.sort(key=lambda x: x[1], reverse=True)

    roc_path = os.path.join(outdir, 'ROC.txt')
    with open(roc_path, 'w') as fout:
        fout.write('HapHiC\t{}\t{}\t{}\t{}\n'.format(tag, 1, 0, 0))
        for step in range(21):
            param = step * 5 / 100
            tp_set: set = set()
            fp_set: set = set()
            for pair, ratio in ranked:
                if ratio <= param:
                    break
                if pair in allelic_pairs:
                    tp_set.add(pair)
                else:
                    fp_set.add(pair)
            fn = allelic_pairs - tp_set
            tn = (total_pairs - allelic_pairs) - (tp_set | fp_set)
            tpr = len(tp_set) / (len(tp_set) + len(fn)) \
                if (tp_set or fn) else 0.0
            fpr = len(fp_set) / (len(fp_set) + len(tn)) \
                if (fp_set or tn) else 0.0
            fout.write('HapHiC\t{}\t{}\t{}\t{}\n'.format(
                tag, param, tpr, fpr))

        tp_set = allhic_positive & allelic_pairs
        fp_set = allhic_positive - allelic_pairs
        fn = allelic_pairs - tp_set
        tn = (total_pairs - allelic_pairs) - (tp_set | fp_set)
        tpr = len(tp_set) / (len(tp_set) + len(fn)) \
            if (tp_set or fn) else 0.0
        fpr = len(fp_set) / (len(fp_set) + len(tn)) \
            if (fp_set or tn) else 0.0
        fout.write('ALLHiC\t{}\t1\t{}\t{}\n'.format(tag, tpr, fpr))
    return cr_path, roc_path


# ---------------------------------------------------------------------------
# Scaffold contact-structure fidelity (simulation/get_discordant_HiC_links.py)

def _agp_bin_maps(agp: str, bin_size: int):
    """AGP → (ctg → [(lo, hi, scaffold, bin)], scaffold → bin set).

    Scaffolds whose truth-encoded contigs are predominantly reversed
    are flipped first, and cumulative gap lengths are subtracted, so
    bin indices are comparable across scaffolders
    (simulation/get_discordant_HiC_links.py parse_agp)."""
    rows: 'collections.OrderedDict[str, list]' = collections.OrderedDict()
    with open(agp) as f:
        for line in f:
            if not line.strip() or line.startswith('#'):
                continue
            cols = line.split()
            rows.setdefault(cols[0], []).append(cols)

    ctg_bins: Dict[str, List[Tuple[int, int, str, int]]] = \
        collections.defaultdict(list)
    scaf_bins: Dict[str, set] = collections.defaultdict(set)
    for scaffold, cols_list in rows.items():
        fwd = rev = 0
        for cols in cols_list:
            if cols[4] != 'W':
                continue
            span = int(cols[2]) - int(cols[1]) + 1
            if cols[8] in cols[5].split('_'):
                fwd += span
            else:
                rev += span
        if rev > fwd:
            flipped = []
            scaffold_end = int(cols_list[-1][2])
            for k, cols in enumerate(reversed(cols_list)):
                s, e = int(cols[1]), int(cols[2])
                cols = list(cols)
                cols[1] = str(scaffold_end - e + 1)
                cols[2] = str(scaffold_end - s + 1)
                cols[3] = str(k + 1)
                if cols[4] == 'W':
                    cols[8] = '+' if cols[8] == '-' else '-'
                flipped.append(cols)
            cols_list = flipped

        # track the cumulative gap length actually seen so far in this
        # scaffold rather than deriving it from the component order —
        # robust to consecutive W rows or trailing gaps after the flip
        # renumbering (equals the reference's (order-1)//2*gap_len under
        # strict W/U alternation)
        cum_gap = 0
        for cols in cols_list:
            if cols[4] in ('U', 'N'):
                cum_gap += int(cols[5])
                continue
            start = int(cols[1]) - cum_gap
            end = int(cols[2]) - cum_gap
            ctg, orient = cols[5], cols[8]
            for b in range(-(-start // bin_size) - 1,
                           -(-end // bin_size)):
                scaf_bins[scaffold].add(b)
                lo = max(start, b * bin_size + 1)
                hi = min(end, (b + 1) * bin_size)
                if orient == '+':
                    ctg_bins[ctg].append(
                        (lo - start + 1, hi - start + 1, scaffold, b))
                else:
                    ctg_bins[ctg].append(
                        (end - hi + 1, end - lo + 1, scaffold, b))
    return ctg_bins, scaf_bins


def get_discordant_hic_links(truth_agp: str,
                             agps: Sequence[Tuple[str, str]], bam: str,
                             bin_size: int = 500000, outdir: str = '.',
                             out: TextIO = sys.stdout
                             ) -> Tuple[str, str]:
    """Compare binned Hi-C contact structure of scaffolding results
    against the truth AGP (simulation/get_discordant_HiC_links.py,
    generalized from the paper's fixed HapHiC/fastsort/YaHS trio to any
    `(tag, agp)` list). One BAM pass bins every read1 pair under the
    truth map and under each result map; intra-scaffold links outside
    the truth's per-bin-distance [min, max] envelope and inter-scaffold
    link-count histogram surplus vs truth are reported. Writes stat.txt
    and summary.txt."""
    from haphic_tpu_torch.io.bam import _PyBam

    maps = [('Truth', _agp_bin_maps(truth_agp, bin_size))]
    maps += [(tag, _agp_bin_maps(agp, bin_size)) for tag, agp in agps]
    link_dicts = {tag: collections.defaultdict(int) for tag, _ in maps}

    def locate(ctg_bins, ctg, pos):
        for lo, hi, scaffold, b in ctg_bins.get(ctg, ()):
            if lo <= pos <= hi:
                return scaffold, b
        return None

    reader = _PyBam(bam)
    names = reader.ref_names
    for ref, pos, mref, mpos, flag, _mapq in reader.records(1 << 16):
        sel = (flag & 0x40).astype(bool) & (ref >= 0) & (mref >= 0)
        for r, p, mr, mp in zip(ref[sel].tolist(),
                                pos[sel].tolist(),
                                mref[sel].tolist(),
                                mpos[sel].tolist()):
            a, b = names[r], names[mr]
            for tag, (ctg_bins, _sb) in maps:
                x = locate(ctg_bins, a, p + 1)
                y = locate(ctg_bins, b, mp + 1)
                if x is None or y is None:
                    continue
                link_dicts[tag][tuple(sorted((x, y)))] += 1

    # stat.txt + per-tag intra (by bin distance) / inter accumulators
    intra: Dict[int, Dict[str, List[int]]] = collections.defaultdict(dict)
    inter: Dict[str, List[int]] = collections.defaultdict(list)
    stat_path = os.path.join(outdir, 'stat.txt')
    with open(stat_path, 'w') as fstat:
        for tag, _ in maps:
            for ((s1, b1), (s2, b2)), n in link_dicts[tag].items():
                kind = 'intra' if s1 == s2 else 'inter'
                if s1 == s2:
                    intra[b2 - b1].setdefault(tag, []).append(n)
                else:
                    inter[tag].append(n)
                fstat.write('{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                    s1, b1, s2, b2, n, kind, tag))

    truth_inter_hist: Dict[int, int] = collections.defaultdict(int)
    for n in inter['Truth']:
        truth_inter_hist[n] += 1

    summary_path = os.path.join(outdir, 'summary.txt')
    with open(summary_path, 'w') as fsum:
        def emit(line=''):
            fsum.write(line + '\n')
            out.write(line + '\n')

        for tag, (_cb, scaf_bins) in maps[1:]:
            intra_nlinks = intra_bad_links = intra_bad_bins = 0
            for dist, by_tag in intra.items():
                truth_list = by_tag.get('Truth', [])
                mine = by_tag.get(tag, [])
                intra_nlinks += sum(mine)
                lo = min(truth_list) if truth_list else None
                hi = max(truth_list) if truth_list else None
                for n in mine:
                    if lo is None or not lo <= n <= hi:
                        intra_bad_links += n
                        intra_bad_bins += 1

            counts: Dict[int, int] = collections.defaultdict(int)
            for n in inter[tag]:
                counts[n] += 1
            inter_bad_links = inter_bad_bins = 0
            for n in set(truth_inter_hist) | set(counts):
                d = counts[n] - truth_inter_hist[n]
                if d > 0:
                    inter_bad_bins += d
                    inter_bad_links += d * n
            inter_nlinks = sum(inter[tag])

            nb = sum(len(s) for s in scaf_bins.values())
            intra_nbins = sum(
                len(s) + len(s) * (len(s) - 1) // 2
                for s in scaf_bins.values())
            inter_nbins = nb + nb * (nb - 1) // 2 - intra_nbins

            emit('\n###### {} ######'.format(tag))
            for label, n_links, n_bins, bad_links, bad_bins in (
                    ('intra', intra_nlinks, intra_nbins,
                     intra_bad_links, intra_bad_bins),
                    ('inter', inter_nlinks, inter_nbins,
                     inter_bad_links, inter_bad_bins)):
                emit('\tTotal number of {}-scaffold Hi-C links: {}'
                     .format(label, n_links))
                emit('\tTotal number of {}-scaffold bins: {}'
                     .format(label, n_bins))
                emit('\tNumber of differential {}-scaffold Hi-C links:'
                     ' {} ({} %)'.format(
                         label, bad_links,
                         bad_links / n_links * 100 if n_links else 0))
                emit('\tNumber of differential {}-scaffold bins: {}'
                     ' ({} %)'.format(
                         label, bad_bins,
                         bad_bins / n_bins * 100 if n_bins else 0))
    return stat_path, summary_path


# ---------------------------------------------------------------------------
# Correction comparison vs other tools (simulation/correction_analysis.py)

def _agp_break_points(agp: str, anno: set, lens: Dict[str, int]
                      ) -> Tuple[Dict[str, List[int]], set, set]:
    """Per-contig break points recovered from a corrected AGP. Handles
    both naming styles: `<ctg>_break<N>` parts (AutoHiC / 3D-DNA
    lineage) and `<ctg>_<start>_<end>` parts (ALLHiC corrector);
    unsuffixed contigs in ``anno`` count as unbroken."""
    corrections: Dict[str, List[int]] = {}
    broken: set = set()
    unbroken: set = set()
    # `<ctg>_break<N>` parts carry only their own length, so break
    # coordinates must be accumulated in break-index order, not AGP
    # file order (scaffolding may reorder the parts): collect
    # {base: {N: part_len}} first, then cumulate after sorting by N.
    break_parts: Dict[str, Dict[int, int]] = {}
    with open(agp) as f:
        for line in f:
            if not line.strip() or line.startswith('#'):
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            ctg = cols[5]
            if ctg in anno:
                corrections.setdefault(ctg, [])
                unbroken.add(ctg)
                continue
            parts = ctg.rsplit('_', 1)
            if len(parts) == 2 and parts[0] in anno and \
                    parts[1].startswith('break'):
                base = parts[0]
                broken.add(base)
                idx_str = parts[1][len('break'):]
                idx = int(idx_str) if idx_str.isdigit() else 0
                part_len = int(cols[7])
                break_parts.setdefault(base, {})
                break_parts[base][idx] = max(
                    break_parts[base].get(idx, 0), part_len)
                continue
            parts = ctg.rsplit('_', 2)
            if len(parts) == 3 and parts[0] in anno and \
                    parts[1].isdigit() and parts[2].isdigit():
                base, end = parts[0], int(parts[2])
                broken.add(base)
                if end < lens[base]:
                    corrections.setdefault(base, []).append(end)
    for base, by_idx in break_parts.items():
        offset = 0
        pts = corrections.setdefault(base, [])
        for idx in sorted(by_idx):
            offset += by_idx[idx]
            if offset < lens[base]:
                pts.append(offset)
        pts.sort()
    return corrections, broken, unbroken


def correction_analysis(raw_fasta: str, bam: str, ctg_anno: str,
                        agps: Sequence[Tuple[str, str]],
                        hap_prefixes: Sequence[str],
                        resolution: int = 10000, outdir: str = '.'
                        ) -> Tuple[str, str]:
    """Chimeric-contig correction comparison across tools
    (simulation/correction_analysis.py, generalized from the paper's
    fixed AutoHiC/ALLHiC pair on GenBank haplotype accessions to any
    `(tag, corrected_agp)` list and any haplotype name prefixes).

    ``ctg_anno`` lists contigs under `<type>:` headers (e.g.
    `chimeric:` / `nonchimeric:`). For every annotated contig the BAM
    pass accumulates intra-contig spanning coverage and a stacked
    per-haplotype inter-contig Hi-C link profile at ``resolution``;
    each tool's AGP contributes its recovered break points. Writes
    correction_analysis.txt (plot table) and venn.txt."""
    import numpy as np
    from haphic_tpu_torch.io.bam import _PyBam

    lens: Dict[str, int] = {}
    for name, seq in iter_fasta(raw_fasta):
        lens[name] = len(seq)

    anno: Dict[str, str] = {}
    ctg_type = ''
    with open(ctg_anno) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.endswith(':'):
                ctg_type = line[:-1]
            elif line in lens:
                anno[line] = ctg_type
    anno_set = set(anno)

    results = [(tag, _agp_break_points(agp, anno_set, lens))
               for tag, agp in agps]

    nhaps = len(hap_prefixes)
    cov = {c: np.zeros(lens[c] // resolution + 1, np.int64)
           for c in anno}
    links = {c: np.zeros((nhaps + 1, lens[c] // resolution + 1),
                         np.int64) for c in anno}

    def hap_index(name: str) -> int:
        for k, pre in enumerate(hap_prefixes):
            if name.startswith(pre):
                return k
        return nhaps

    reader = _PyBam(bam)
    names = reader.ref_names
    for ref, pos, mref, mpos, flag, _mapq in reader.records(1 << 16):
        sel = (flag & 0x40).astype(bool) & (ref >= 0) & (mref >= 0)
        for r, p, mr, mp in zip(ref[sel].tolist(), pos[sel].tolist(),
                                mref[sel].tolist(),
                                mpos[sel].tolist()):
            a, b = names[r], names[mr]
            if a == b:
                if a in cov:
                    lo, hi = sorted((p, mp))
                    cov[a][lo // resolution:hi // resolution + 1] += 1
            else:
                if a in links:
                    links[a][hap_index(b), p // resolution] += 1
                if b in links:
                    links[b][hap_index(a), mp // resolution] += 1

    table_path = os.path.join(outdir, 'correction_analysis.txt')
    with open(table_path, 'w') as fo:
        max_cov = {c: int(cov[c].max()) if len(cov[c]) else 0
                   for c in cov}
        for ctg, arr in cov.items():
            for n, c in enumerate(arr.tolist()):
                fo.write('{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                    ctg, n * resolution + 1, (n + 1) * resolution, 0,
                    c, 'Spanning_coverage', 'Spanning_coverage'))
        hap_labels = ['Hap{}'.format(k + 1) for k in range(nhaps)] + \
            ['Other_chrom']
        for ctg, arr in links.items():
            if not max_cov[ctg]:
                continue
            totals = arr.sum(axis=0)
            for n in range(arr.shape[1]):
                coef = totals[n] / max_cov[ctg]
                if not coef:
                    continue
                lo = 0.0
                stack = arr[:, n] / coef
                for k, label in enumerate(hap_labels):
                    hi = max_cov[ctg] if k == nhaps else lo + stack[k]
                    fo.write('{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                        ctg, n * resolution + 1, (n + 1) * resolution,
                        lo, hi, 'nHiC_links', label))
                    lo = hi
        for tag, (corrections, _broken, _unbroken) in results:
            for ctg, break_points in corrections.items():
                for bp in break_points:
                    fo.write('{}\t{}\tNA\t{}\tNA\tBreakpoint\t{}\n'
                             .format(ctg, bp, max_cov.get(ctg, 0),
                                     tag))

    venn_path = os.path.join(outdir, 'venn.txt')
    with open(venn_path, 'w') as fo:
        fo.write('Contig\tType\t{}\n'.format(
            '\t'.join(tag for tag, _ in results)))
        for ctg, t in anno.items():
            row = ['yes' if ctg in broken else 'no'
                   for _, (_c, broken, _u) in results]
            fo.write('{}\t{}\t{}\n'.format(ctg, t, '\t'.join(row)))
    return table_path, venn_path


def mock_delta_chrs_only(query_agp: str, query_fasta: str,
                         ref_fasta: str, ref_chrom_pattern: str,
                         outdir: str = '.') -> str:
    """mock_delta restricted to reference chromosomes matching
    ``ref_chrom_pattern`` and to scaffolds holding ≥2 contigs
    (simulation/mock_delta_chrs_only.py). Emits `<base>.chrs.nogaps`
    FASTAs for both sides and mock.delta."""
    pattern = re.compile(ref_chrom_pattern)
    alignments: 'collections.OrderedDict[str, list]' = \
        collections.OrderedDict()
    per_ref: Dict[str, List[Tuple[str, int, int]]] = \
        collections.defaultdict(list)
    offsets: Dict[str, int] = collections.defaultdict(int)
    ref_chrom_set: set = set()
    with open(query_agp) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            scaf = cols[0]
            if cols[4] == 'W':
                off = offsets[scaf]
                s, e = int(cols[1]) - off, int(cols[2]) - off
                ctg, ctg_len, aln_ori = cols[5], int(cols[7]), cols[8]
                ref_chrom, order, ctg_ori = ctg.rsplit('_', 2)
                orient = '+' if aln_ori == ctg_ori else '-'
                alignments.setdefault(scaf, []).append(
                    (s, e, ctg, orient))
                per_ref[ref_chrom].append((ctg, ctg_len,
                                           int(order[3:])))
                if pattern.match(ref_chrom):
                    ref_chrom_set.add(ref_chrom)
            elif cols[4] in ('U', 'N'):
                offsets[scaf] += int(cols[5])

    scaffold_set = {s for s, alns in alignments.items()
                    if len(alns) >= 2}

    # only matching chromosomes / retained scaffolds hit the FASTAs
    base, ext = os.path.splitext(os.path.basename(ref_fasta))
    ref_chrs = os.path.join(outdir,
                            '{}.chrs.nogaps{}'.format(base, ext))
    ref_lens: Dict[str, int] = {}
    with open(ref_chrs, 'w') as fo:
        for name, seq in iter_fasta(ref_fasta):
            if name not in ref_chrom_set:
                continue
            seq = seq.upper().replace('N', '')
            fo.write('>{}\n{}\n'.format(name, seq))
            ref_lens[name] = len(seq)
    base, ext = os.path.splitext(os.path.basename(query_fasta))
    query_chrs = os.path.join(outdir,
                              '{}.chrs.nogaps{}'.format(base, ext))
    query_lens: Dict[str, int] = {}
    with open(query_chrs, 'w') as fo:
        for name, seq in iter_fasta(query_fasta):
            if name not in scaffold_set:
                continue
            seq = seq.upper().replace('N', '')
            fo.write('>{}\n{}\n'.format(name, seq))
            query_lens[name] = len(seq)

    ctg_pos: Dict[str, Tuple[str, int, int]] = {}
    for ref_chrom, ctgs in per_ref.items():
        if ref_chrom not in ref_chrom_set:
            continue
        start = 1
        for ctg, ctg_len, _order in sorted(ctgs, key=lambda x: x[2]):
            ctg_pos[ctg] = (ref_chrom, start, start + ctg_len - 1)
            start += ctg_len

    path = os.path.join(outdir, 'mock.delta')
    with open(path, 'w') as f:
        f.write('{} {}\nNUCMER\n'.format(os.path.abspath(ref_chrs),
                                         os.path.abspath(query_chrs)))

        def emit(scaf, chrom, orient, cs, ce, ss, se):
            f.write('>{} {} {} {}\n'.format(chrom, scaf,
                                            ref_lens[chrom],
                                            query_lens[scaf]))
            if orient == '+':
                f.write('{} {} {} {} 0 0 0\n0\n'.format(cs, ce, ss, se))
            else:
                f.write('{} {} {} {} 0 0 0\n0\n'.format(ce, cs, se, ss))

        for scaf, alns in alignments.items():
            if scaf not in scaffold_set:
                continue
            last_se = last_ce = 0
            last_chrom = last_ori = ''
            m_cs = m_ss = 0
            for s, e, ctg, orient in alns:
                if ctg.rsplit('_', 2)[0] not in ref_chrom_set:
                    continue
                chrom, cs, ce = ctg_pos[ctg]
                if orient == '-':
                    cs, ce = ce, cs
                    contiguous = last_ce == cs + 1
                else:
                    contiguous = last_ce == cs - 1
                if last_chrom == '' or (chrom == last_chrom and
                                        contiguous and
                                        last_se == s - 1 and
                                        last_ori == orient):
                    if last_chrom == '':
                        m_cs, m_ss = cs, s
                        last_chrom, last_ori = chrom, orient
                    last_ce, last_se = ce, e
                    continue
                emit(scaf, last_chrom, last_ori, m_cs, last_ce, m_ss,
                     last_se)
                m_cs, m_ss = cs, s
                last_ce, last_se = ce, e
                last_chrom, last_ori = chrom, orient
            if last_chrom:
                emit(scaf, last_chrom, last_ori, m_cs, last_ce, m_ss,
                     last_se)
    return path

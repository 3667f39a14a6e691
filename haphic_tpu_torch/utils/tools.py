"""Aux utilities — functional equivalents of the reference's utils/
scripts (SURVEY.md §2 #33). Each is exposed both as a function and via
``haphic-tpu util <name>``.

Covered (reference file in parentheses):
  mock_agp        (utils/mock_agp_file.py)       FASTA → trivial AGP
  groups_to_clusters (utils/groups_to_clusters.py)
  combine_groups  (utils/combine_groups.py)
  convert_gfa_ids (utils/convert_gfa_ids.py)     GFA ids → post-curation
  gfa_depth_to_bedgraph (utils/gfa_depth_to_bedGraph.py)
  find_telomeres  (utils/find_telomeres.py)
  fasta_count_N   (utils/fasta_count_N.py)
  fastq_length_filtering (utils/fastq_length_filtering.py)
  reverse_bed     (utils/reverse_bed.py)
  split_clm       (simulation/split_clm.py — also assign.split_clm_file)
  global_chaining (utils/global_chaining.py)   PAF weighted-LIS chains
  prepare_clusters (utils/prepare_clusters.py)
  mock_blast      (utils/mock_blast_file.py)
  remove_singletons (utils/remove_singletons.py — reference is a stub)
"""

from __future__ import annotations

import collections
import gzip
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, TextIO

from haphic_tpu_torch.io.fasta import iter_fasta, revcomp


def mock_agp(fasta: str, out: TextIO = sys.stdout) -> None:
    """FASTA → one-line-per-contig AGP (for `haphic plot` on contigs)."""
    for name, seq in iter_fasta(fasta):
        L = len(seq)
        out.write('{0}\t1\t{1}\t1\tW\t{0}\t1\t{1}\t+\n'.format(name, L))


def groups_to_clusters(group_files: Sequence[str],
                       out: TextIO = sys.stdout) -> None:
    out.write('#Group\tnContigs\tContigs\n')
    for n, path in enumerate(group_files, 1):
        ctgs = []
        with open(path) as f:
            for line in f:
                if line.strip() and not line.startswith('#'):
                    ctgs.append(line.split()[0])
        out.write('group{}\t{}\t{}\n'.format(n, len(ctgs), ' '.join(ctgs)))


def combine_groups(list_file: str, out: TextIO = sys.stdout) -> None:
    """Group files listed in ``list_file`` → one clusters.txt, group
    name = file basename before the first dot."""
    group_dict: Dict[str, List[str]] = collections.defaultdict(list)
    with open(list_file) as f:
        for line in f:
            gf = line.strip()
            if not gf:
                continue
            with open(gf) as fin:
                for l in fin:
                    if l.strip() and not l.startswith('#'):
                        group_dict[gf.split('.')[0]].append(l.split()[0])
    out.write('#Group\tnContigs\tContigs\n')
    for g, ctgs in group_dict.items():
        out.write('{}\t{}\t{}\n'.format(g, len(ctgs), ' '.join(ctgs)))


def convert_gfa_ids(gfa: str, liftover_agp: str,
                    out: TextIO = sys.stdout) -> None:
    """Rename GFA segment ids using a liftover AGP (post-curation):
    contigs split into several fragments get '_'-joined new ids."""
    id_map: Dict[str, List] = collections.defaultdict(list)
    with open(liftover_agp) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            if cols[4] == 'W':
                id_map[cols[5]].append((cols[0], int(cols[6])))

    def new_id(old: str) -> str:
        assert old in id_map, old
        frags = sorted(id_map[old], key=lambda x: x[1])
        return '_'.join(c for c, _ in frags) if len(frags) > 1 \
            else frags[0][0]

    opener = gzip.open if gfa.endswith('.gz') else open
    with opener(gfa, 'rt') as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.rstrip('\n').split('\t')
            if cols[0] == 'S':
                cols[1] = new_id(cols[1])
            elif cols[0] == 'L' and len(cols) >= 4:
                cols[1] = new_id(cols[1])
                cols[3] = new_id(cols[3])
            elif cols[0] == 'A' and len(cols) >= 2:
                cols[1] = new_id(cols[1])
            out.write('\t'.join(cols) + '\n')


def gfa_depth_to_bedgraph(gfas: Sequence[str], agp: str,
                          depth_tag: str = 'rd', scale: float = 1.0,
                          out: TextIO = sys.stdout) -> None:
    """Per-contig GFA read depth → bedGraph over scaffold coordinates."""
    pat = re.compile(r'.+{}:[if]:([\d.]+)'.format(depth_tag))
    depth: Dict[str, int] = {}
    for gfa in gfas:
        opener = gzip.open if gfa.endswith('.gz') else open
        with opener(gfa, 'rt') as f:
            for line in f:
                if not line.startswith('S\t'):
                    continue
                seg = line.split()[1]
                m = pat.match(line)
                if not m:
                    raise RuntimeError(
                        'Cannot find the read depth for segment '
                        '{}'.format(seg))
                depth[seg] = int(float(m.groups()[0])) + 1
    with open(agp) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            d = depth.get(cols[5].rsplit(':', 1)[0], depth.get(cols[5]))
            if d is None:
                continue
            out.write('{}\t{}\t{}\t{}\n'.format(
                cols[0], int(cols[1]) - 1, cols[2], d * scale))


def find_telomeres(genome: str, repeat: str = 'CCCTAAA',
                   contigs: Optional[Sequence[str]] = None,
                   out: TextIO = sys.stdout) -> None:
    """Tandem-telomere-repeat scan (parity: utils/find_telomeres.py)."""
    fwd2 = repeat * 2
    rev2 = revcomp(repeat) * 2
    rev2_rev = rev2[::-1]
    out.write('Seq_ID\tSeq_len\tNumber_of_{0}/{1}\tNumber_of_{0}/{1}'
              '_per_Mb\tLeftmost_{0}_pos\tRightmost_{1}_pos\t'
              'Leftmost_relative_pos\tRightmost_relative_pos\n'
              .format(fwd2, rev2))
    wanted = set(contigs) if contigs else None
    for name, seq in iter_fasta(genome):
        if wanted is not None and name not in wanted:
            continue
        seq = seq.upper()
        L = len(seq)
        n = seq.count(fwd2) + seq.count(rev2)
        if fwd2 in seq:
            sp = seq.index(fwd2) + 1
            rsp = '{:.4f}'.format(sp / L)
        else:
            sp, rsp = 'NA', 'NA'
        if rev2 in seq:
            ep = L - (seq[::-1].index(rev2_rev) + 1)
            rep = '{:.4f}'.format(ep / L)
        else:
            ep, rep = 'NA', 'NA'
        out.write('{}\t{}\t{}\t{:.4f}\t{}\t{}\t{}\t{}\n'.format(
            name, L, n, n / L * 1e6, sp, ep, rsp, rep))


def fasta_count_N(fasta: str, out: TextIO = sys.stdout) -> int:
    """Count N-runs; returns the total number of Ns."""
    count: Dict[str, int] = collections.defaultdict(int)
    with open(fasta) as f:
        for line in f:
            s = line.strip()
            if s and not line.startswith('>'):
                for ns in re.findall(r'N+', s):
                    count[ns] += 1
    total = sum(len(ns) * num for ns, num in count.items())
    out.write('{}\n'.format(dict(count)))
    out.write('total_Ns: {}\n'.format(total))
    return total


def fastq_length_filtering(out_fq: str, in_fqs: Sequence[str],
                           length: int = 50000) -> int:
    """Keep reads >= length; gzipped in/out. Returns #kept."""
    kept = 0
    with gzip.open(out_fq, 'wb') as fout:
        for in_fq in in_fqs:
            opener = gzip.open if in_fq.endswith('.gz') else \
                (lambda p, m: open(p, 'rb'))
            with opener(in_fq, 'rb') as f:
                while True:
                    l1 = f.readline()
                    if not l1:
                        break
                    l2 = f.readline()
                    l3 = f.readline()
                    l4 = f.readline()
                    if len(l2.rstrip()) >= length:
                        fout.write(l1 + l2 + l3 + l4)
                        kept += 1
    return kept


def reverse_bed(bed: str, genome: str, out: TextIO = sys.stdout) -> None:
    """Mirror BED intervals (and strands) for reverse-complemented
    sequences (parity: utils/reverse_bed.py)."""
    lens: Dict[str, int] = {n: len(s) for n, s in iter_fasta(genome)}

    def flip(sym: str) -> str:
        return {'+': '-', '-': '+', '.': '.'}[sym]

    with open(bed) as f:
        for line in f:
            if not line.strip():
                continue
            cols = line.rstrip('\n').split('\t')
            L = lens[cols[0]]
            start, end = int(cols[1]), int(cols[2])
            cols[1], cols[2] = str(L - end), str(L - start)
            if len(cols) >= 6 and cols[5] in '+-.':
                cols[5] = flip(cols[5])
            out.write('\t'.join(cols) + '\n')


# ---------------------------------------------------------------------------
# PAF global chaining (parity: utils/global_chaining.py)

def _weighted_lis_signed(alns, forward: bool):
    """Max-weight increasing subsequence over signed query midpoints.

    ``alns`` is sorted by reference midpoint; each item is
    (line_no, aln_len, signed_qry_mid, ref_mid, matches, block, div).
    Only alignments whose signed midpoint matches the requested strand
    participate. Duplicate midpoints keep the longer alignment (and move
    to the end of the candidate order, matching the reference's
    list-remove/append behavior, utils/global_chaining.py:92-103).
    Returns (total chained length, chained alignments in chain order).
    """
    order: List[float] = []
    best_aln: Dict[float, tuple] = {}
    best_len: Dict[float, int] = {}
    for aln in alns:
        aln_len, mid = aln[1], aln[2]
        if (mid < 0) if forward else (mid > 0):
            continue
        if mid in best_aln:
            if best_len[mid] < aln_len:
                best_aln[mid], best_len[mid] = aln, aln_len
                order.remove(mid)
                order.append(mid)
        else:
            order.append(mid)
            best_aln[mid], best_len[mid] = aln, aln_len
    if not order:
        return 0, []
    n = len(order)
    dp = [best_len[m] for m in order]
    prev: List[Optional[int]] = [None] * n
    best = 0
    for i in range(n):
        for j in range(i):
            if order[i] > order[j] and dp[i] < dp[j] + best_len[order[i]]:
                dp[i] = dp[j] + best_len[order[i]]
                prev[i] = j
        if dp[i] >= dp[best]:
            best = i
    chain = []
    k: Optional[int] = best
    while k is not None:
        chain.append(best_aln[order[k]])
        k = prev[k]
    chain.reverse()
    return dp[best], chain


class _UnionFind:
    def __init__(self):
        self.parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        p = self.parent.setdefault(x, x)
        while p != self.parent[p]:
            self.parent[p] = self.parent[self.parent[p]]
            p = self.parent[p]
        self.parent[x] = p
        return p

    def union(self, a: str, b: str) -> None:
        self.parent[self.find(a)] = self.find(b)


def global_chaining(paf: str, mapq: int = 0, min_len: int = 100000,
                    min_aln_len: int = 10000, div: str = 'de',
                    min_identity: float = 90.0, min_cov_ratio: float = 0.0,
                    min_sb_ratio: float = 0.2,
                    perform_clustering: bool = False,
                    out: TextIO = sys.stderr) -> None:
    """Chain minimap2 PAF alignments per query-reference pair with a
    weighted LIS, emit a chained-pair table on ``out`` and write
    ``all_chained.paf`` (plus ``cluster<N>_chained.paf`` per connected
    component when ``perform_clustering``). Functional parity:
    utils/global_chaining.py (filters: MAPQ, sequence length, alignment
    length, divergence tag presence, coverage ratio, secondary/best
    ratio, gap-compressed identity)."""
    div_re = re.compile(r'.+{}:f:([0-9.]+)'.format(div))
    qry_aln: Dict[str, Dict[str, list]] = collections.defaultdict(dict)
    qlen: Dict[str, int] = {}
    rlen: Dict[str, int] = {}
    with open(paf) as f:
        for n, line in enumerate(f):
            if not line.strip():
                continue
            cols = line.split()
            if int(cols[11]) < mapq:
                continue
            q, ql, r, rl = cols[0], int(cols[1]), cols[5], int(cols[6])
            if min(ql, rl) < min_len:
                continue
            qs, qe, rs, re_ = (int(cols[2]), int(cols[3]),
                               int(cols[7]), int(cols[8]))
            if re_ - rs < min_aln_len:
                continue
            m = div_re.match(line)
            if m is None:
                continue
            sign = 1 if cols[4] == '+' else -1
            rec = (n, re_ - rs + 1, sign * ((qe - qs) / 2 + qs),
                   (re_ - rs) / 2 + rs, int(cols[9]), int(cols[10]),
                   float(m.group(1)))
            qlen.setdefault(q, ql)
            rlen.setdefault(r, rl)
            qry_aln[q].setdefault(r, []).append(rec)

    out.write('Query\tQuery_len\tReference\tReference_len\tOrientation\t'
              'Aln_len\tAln_num\tPercent_identity\t'
              'Gap_compressed_Percent_identity\n')
    chained_lines: set = set()
    pair_lines: Dict[frozenset, set] = collections.defaultdict(set)
    uf = _UnionFind()
    for q, per_ref in qry_aln.items():
        all_lis = []
        for r, alns in per_ref.items():
            if (sum(a[1] for a in alns) / min(qlen[q], rlen[r])
                    < min_cov_ratio):
                continue
            alns.sort(key=lambda a: a[3])
            sf, cf = _weighted_lis_signed(alns, forward=True)
            sr, cr = _weighted_lis_signed(alns, forward=False)
            s, chain, orient = ((sf, cf, '+') if sf >= sr
                                else (sr, cr, '-'))
            info = (s, chain, r, orient)
            if all_lis and s > all_lis[0][0]:
                all_lis.insert(0, info)
            else:
                all_lis.append(info)
        if not all_lis:
            continue
        kept = [all_lis[0]] + [x for x in all_lis[1:]
                               if x[0] >= min_sb_ratio * all_lis[0][0]]
        for s, chain, r, orient in kept:
            if s / min(qlen[q], rlen[r]) < min_cov_ratio:
                continue
            matches = sum(a[4] for a in chain)
            block = sum(a[5] for a in chain)
            div_sum = sum(a[4] * a[6] for a in chain)
            gci = (1 - div_sum / matches) * 100
            if gci < min_identity:
                continue
            for a in chain:
                chained_lines.add(a[0])
                pair_lines[frozenset({q, r})].add(a[0])
            uf.union(q, r)
            out.write('{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                q, qlen[q], r, rlen[r], orient, s, len(chain),
                matches / block * 100, gci))

    def write_filtered(lines: set, prefix: str) -> None:
        with open(paf) as f, \
                open('{}_chained.paf'.format(prefix), 'w') as fo:
            for n, line in enumerate(f):
                if n in lines:
                    fo.write(line)

    write_filtered(chained_lines, 'all')
    if perform_clustering:
        comps: Dict[str, set] = collections.defaultdict(set)
        for name in uf.parent:
            comps[uf.find(name)].add(name)
        for n, members in enumerate(sorted(comps.values(),
                                           key=lambda s: sorted(s)), 1):
            lines: set = set()
            for key, ls in pair_lines.items():
                if key <= members:
                    lines |= ls
            write_filtered(lines, 'cluster{}'.format(n))


def prepare_clusters(wrk_dir: str, for_manual: bool = False,
                     out_path: str = 'user-prepared.clusters.txt') -> None:
    """Collect group files from `03.rescue/` (or `05.rescue_manual/`)
    subdirectories of a legacy work dir into one clusters.txt
    (parity: utils/prepare_clusters.py)."""
    import os
    rescue_dir = '05.rescue_manual' if for_manual else '03.rescue'
    clusters: Dict[str, List[str]] = collections.defaultdict(list)
    for root, _dirs, files in os.walk(wrk_dir):
        if os.path.basename(root) != rescue_dir:
            continue
        for fname in sorted(files):
            if not fname.startswith('group'):
                continue
            name = '{}_{}'.format(root.split(os.sep)[-2],
                                  os.path.splitext(fname)[0])
            with open(os.path.join(root, fname)) as f:
                for line in f:
                    if line.strip() and not line.startswith('#'):
                        clusters[name].append(line.split()[0])
    with open(out_path, 'w') as fo:
        fo.write('#Group\tnContigs\tContigs\n')
        for name, ctgs in clusters.items():
            fo.write('{}\t{}\t{}\n'.format(name, len(ctgs),
                                           ' '.join(ctgs)))


def mock_blast(fasta: str, tour: str, out_prefix: Optional[str] = None,
               run_jcvi: bool = False) -> str:
    """Emit a mock BLAST tabular file + .sizes files for a jcvi dotplot
    of a tour against the truth-encoded source chromosome (parity:
    utils/mock_blast_file.py — contig ids follow the simulation's
    `<chr>_<n>_<start>_<end>_<orient>_<len±>` truth encoding). Returns
    the jcvi command (executed only when ``run_jcvi``)."""
    import os
    import subprocess

    ref_len: Dict[str, int] = collections.defaultdict(int)
    for name, seq in iter_fasta(fasta):
        ref_len[name.split('_')[0]] += len(seq)

    last = ''
    with open(tour) as f:
        for line in f:
            if line.strip():
                last = line
    ctgs = last.split()
    qname = out_prefix or os.path.splitext(os.path.basename(tour))[0]

    chr_len: Dict[str, int] = collections.defaultdict(int)
    for ctg in ctgs:
        parts = ctg.split('_')
        chr_len[parts[0]] += int(parts[-1][:-1])
    sname = sorted(chr_len.items(), key=lambda x: x[1])[-1][0]

    total = 0
    blast_path = 'blast_{}_{}.out'.format(qname, sname)
    with open(blast_path, 'w') as fo:
        for ctg in ctgs:
            parts = ctg.split('_')
            strand = '+' if parts[-2] == parts[-1][-1] else '-'
            length = int(parts[-1][:-1])
            if parts[0] == sname:
                sstart, send = int(parts[2]), int(parts[3])
                if strand == '-':
                    sstart, send = send, sstart
                fo.write('{}\t{}\t100\t{}\t0\t0\t{}\t{}\t{}\t{}\t0\t10000\n'
                         .format(qname, sname, length, total + 1,
                                 total + length, sstart, send))
            total += length
    with open('subject.sizes', 'w') as fo:
        fo.write('{}\t{}\n'.format(sname, ref_len[sname]))
    with open('query.sizes', 'w') as fo:
        fo.write('{}\t{}\n'.format(qname, total))
    cmd = ('python3 -m jcvi.graphics.blastplot {} --qsizes query.sizes '
           '--ssizes subject.sizes --style whitegrid'.format(blast_path))
    if run_jcvi:
        subprocess.run(cmd.split(), check=True)
    return cmd


def remove_singletons(bam: str, out: TextIO = sys.stdout) -> int:
    """Emit names of properly paired reads (both mates mapped) from a
    name-sorted BAM — the reads to KEEP (use `samtools view -N`).
    The reference script (utils/remove_singletons.py) is an unfinished
    stub; this implements the documented intent. Returns #kept names."""
    from haphic_tpu_torch.io.bam import _PyBam
    reader = _PyBam(bam)
    kept = 0
    pending_name: Optional[str] = None
    pending_mapped = 0
    for qname, flag, refid, _pos, _q, _cig, _aux in reader.detail_records():
        if flag & 0x900:           # secondary/supplementary
            continue
        if qname != pending_name:
            if pending_name is not None and pending_mapped >= 2:
                out.write(pending_name + '\n')
                kept += 1
            pending_name, pending_mapped = qname, 0
        if not flag & 0x4 and refid >= 0:
            pending_mapped += 1
    if pending_name is not None and pending_mapped >= 2:
        out.write(pending_name + '\n')
        kept += 1
    return kept

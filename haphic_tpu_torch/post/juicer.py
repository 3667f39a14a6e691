"""Juicebox curation round-trip: `juicer pre` / `juicer post` equivalents.

The reference bundles YaHS's C `juicer` binary (reference utils/juicer,
invoked by juicebox.sh — scripts/HapHiC_build.py:182-200 — and by the
curation docs, README.md:410-431). This module re-implements the
contract:

  pre  : scaffolds.raw.agp + Hi-C alignments (+ contig fai) →
         out_JBAT.txt (juicer_tools "short" pairs in assembly coords),
         out_JBAT.assembly (JBAT fragment tiling),
         out_JBAT.liftover.agp (fragment → raw contig mapping),
         and a 'PRE_C_SIZE: assembly <n>' log line consumed by
         juicebox.sh's awk pipeline.
  post : reviewed .assembly (+ liftover AGP + contig FASTA) → final
         AGP (+ FASTA), honoring JBAT edits incl. ':::fragment_N' /
         ':::debris' splits.

The hot path (BAM decode) rides the native C++ BGZF reader
(haphic_tpu_torch.io.bam); coordinate lifting reuses the vectorized AGP
segment index from haphic_tpu_torch.post.plot.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from haphic_tpu_torch.io.fasta import revcomp
from haphic_tpu_torch.post.plot import AgpIndex, parse_agp

logger = logging.getLogger(__name__)


class AssemblySpace:
    """JBAT 'assembly' coordinate system over an AGP.

    Fragments are the AGP W-lines in object order; the assembly axis is
    the concatenation of the *objects* (scaffolds) in AGP order (gaps
    included), so the Juicebox heatmap shows the scaffolding.
    """

    def __init__(self, agp: AgpIndex):
        self.agp = agp
        sizes = agp.group_sizes.astype(np.int64)
        self.group_offset = np.concatenate(
            [[0], np.cumsum(sizes)])[:-1]
        self.total = int(sizes.sum())

    def map_positions(self, ctg: np.ndarray, pos: np.ndarray
                      ) -> np.ndarray:
        """(agp ctg id, 1-based raw pos) → 1-based assembly coordinate
        (-1 = unplaced)."""
        agp = self.agp
        key = ctg * agp.KEY + pos
        idx = np.searchsorted(agp.seg_key, key, side='right') - 1
        idx = np.clip(idx, 0, max(len(agp.seg_key) - 1, 0))
        ok = (agp.seg_ctg[idx] == ctg) & (pos >= agp.seg_raw_start[idx]) \
            & (pos <= agp.seg_raw_end[idx])
        gpos = np.where(
            agp.seg_fwd[idx],
            agp.seg_group_start[idx] + (pos - agp.seg_raw_start[idx]),
            agp.seg_group_start[idx] + (agp.seg_raw_end[idx] - pos))
        out = self.group_offset[agp.seg_group[idx]] + gpos
        return np.where(ok, out, -1)


def _fragment_rows(agp: AgpIndex):
    """AGP W-lines in (group, group_start) order: the JBAT fragments."""
    order = np.lexsort((agp.seg_group_start, agp.seg_group))
    return order


def write_assembly_files(agp: AgpIndex, out_prefix: str
                         ) -> Tuple[str, str]:
    """Write .assembly + .liftover.agp describing the fragment tiling."""
    order = _fragment_rows(agp)
    asm_path = out_prefix + '.assembly'
    lift_path = out_prefix + '.liftover.agp'
    frag_names: List[str] = []
    with open(asm_path, 'w') as fa, open(lift_path, 'w') as fl:
        lines_per_group: Dict[int, List[str]] = {}
        for fid, t in enumerate(order, 1):
            ctg = agp.ctg_names[int(agp.seg_ctg[t])]
            s = int(agp.seg_raw_start[t])
            e = int(agp.seg_raw_end[t])
            frag_len = e - s + 1
            name = ctg if (s == 1 and self_len(agp, t) == frag_len) \
                else '{}:{}-{}'.format(ctg, s, e)
            frag_names.append(name)
            fa.write('>{} {} {}\n'.format(name, fid, frag_len))
            # the fragment's own axis is the raw contig forward axis;
            # orientation lives ONLY in the tour-line sign below
            fl.write('{}\t1\t{}\t1\tW\t{}\t{}\t{}\t+\n'.format(
                name, frag_len, ctg, s, e))
            g = int(agp.seg_group[t])
            sign = '' if agp.seg_fwd[t] else '-'
            lines_per_group.setdefault(g, []).append(sign + str(fid))
        for g in sorted(lines_per_group):
            fa.write(' '.join(lines_per_group[g]) + '\n')
    return asm_path, lift_path


def self_len(agp: AgpIndex, t: int) -> int:
    """Length of the raw contig owning segment t, if derivable from the
    AGP itself (max raw_end over the contig's segments)."""
    c = agp.seg_ctg[t]
    return int(agp.seg_raw_end[agp.seg_ctg == c].max())


def _link_file_type(path: str, file_type: Optional[str] = None) -> str:
    """Input-mode dispatch matching the reference binary's surface
    (reference utils/juicer pre accepts BED|BAM|BIN|PA5 with
    --file-type overriding the extension); '.pairs[.gz]' is accepted
    additionally (the format the rest of this pipeline emits)."""
    if file_type:
        t = file_type.lower()
        if t not in ('bed', 'bam', 'bin', 'pa5', 'pairs'):
            raise RuntimeError('unknown --file-type ' + file_type)
        return t
    base = path[:-3] if path.endswith('.gz') else path
    for ext in ('bam', 'bed', 'pa5', 'bin'):
        if base.endswith('.' + ext):
            return ext
    if base.endswith('.pairs'):
        return 'pairs'
    raise RuntimeError(
        'unknown link file format for {}: extension .bam, .bed, .pa5, '
        '.bin or .pairs expected (or pass file_type)'.format(path))


class _TextLinkReader:
    """Chunked reader for the juicer pre text link formats.

    * ``pa5``: 5 columns ``read ctg1 pos1 ctg2 pos2`` (1-based
      positions, '#' comments), the minimal pairs flavor the
      reference binary calls PA5.
    * ``bed``: bedtools-bamtobed output — one line per read,
      ``ctg start end name [score strand]``; mates are CONSECUTIVE
      lines (read1 then read2). The 5' position is used (start+1 on
      '+', end on '-'; start+1 when no strand column).

    Yields AlignChunk-compatible batches (0-based positions, contig
    ids resolved against ``names``; -1 = unknown contig).
    """

    def __init__(self, path: str, names, fmt: str,
                 chunk_size: int = 1 << 18):
        self.path = path
        self.fmt = fmt
        self.chunk = chunk_size
        self.id_of = {n: i for i, n in enumerate(names)}

    def _open(self):
        if self.path.endswith('.gz'):
            import gzip
            return gzip.open(self.path, 'rt')
        return open(self.path)

    def __iter__(self):
        from haphic_tpu_torch.io.pairs import AlignChunk
        id_of = self.id_of
        ref, pos, mref, mpos = [], [], [], []
        pend = None                     # pending BED mate
        with self._open() as f:
            for line in f:
                if not line or line[0] == '#':
                    continue
                cols = line.split()
                if self.fmt == 'pa5':
                    if len(cols) < 5:
                        raise RuntimeError(
                            'malformed PA5 line (5 columns expected): '
                            + line.strip()[:80])
                    ref.append(id_of.get(cols[1], -1))
                    pos.append(int(cols[2]) - 1)
                    mref.append(id_of.get(cols[3], -1))
                    mpos.append(int(cols[4]) - 1)
                else:
                    if len(cols) < 4:
                        raise RuntimeError(
                            'malformed BED line (4+ columns expected): '
                            + line.strip()[:80])
                    strand = cols[5] if len(cols) > 5 else '+'
                    p = (int(cols[2]) - 1 if strand == '-'
                         else int(cols[1]))
                    rec = (id_of.get(cols[0], -1), p)
                    if pend is None:
                        pend = rec
                        continue
                    ref.append(pend[0])
                    pos.append(pend[1])
                    mref.append(rec[0])
                    mpos.append(rec[1])
                    pend = None
                if len(ref) >= self.chunk:
                    yield AlignChunk(np.asarray(ref, np.int32),
                                     np.asarray(pos, np.int64),
                                     np.asarray(mref, np.int32),
                                     np.asarray(mpos, np.int64))
                    ref, pos, mref, mpos = [], [], [], []
        if pend is not None:
            raise RuntimeError('odd number of BED records: every read '
                               'pair needs two consecutive lines')
        if ref:
            yield AlignChunk(np.asarray(ref, np.int32),
                             np.asarray(pos, np.int64),
                             np.asarray(mref, np.int32),
                             np.asarray(mpos, np.int64))


def juicer_pre(agp_path: str, alignments: str, out_prefix: str = 'out_JBAT',
               outdir: str = '.', mapq: int = 1,
               assembly_mode: bool = True, threads: int = 8,
               log_path: Optional[str] = None,
               file_type: Optional[str] = None) -> str:
    """Emit juicer_tools 'short'-format pairs in assembly coordinates.

    Returns the pairs txt path. Logs 'PRE_C_SIZE: assembly <total>'
    (juicebox.sh greps this for the chrom.sizes of juicer_tools pre).
    ``file_type`` mirrors the reference binary's --file-type
    (BED|BAM|BIN|PA5, extension-inferred otherwise).
    """
    agp = parse_agp(agp_path)
    space = AssemblySpace(agp)
    prefix = os.path.join(outdir, out_prefix)
    txt_path = prefix + '.txt'

    if assembly_mode:
        write_assembly_files(agp, prefix)

    names = sorted(agp.ctg_names)
    remap = np.asarray([agp.ctg_id[c] for c in names], np.int64)
    fmt = _link_file_type(alignments, file_type)
    if fmt == 'bam':
        from haphic_tpu_torch.io.bam import BamReader
        reader = BamReader(alignments, names, threads=threads,
                           min_mapq=mapq)
    elif fmt in ('bed', 'pa5'):
        reader = _TextLinkReader(alignments, names, fmt)
    elif fmt == 'bin':
        # YaHS's .bin is its scaffolder's private intermediate dump;
        # nothing else in this toolchain produces one. Match the
        # reference binary's surface with an actionable error.
        raise RuntimeError(
            'BIN link files are a YaHS-internal intermediate and are '
            'not supported here; pass the original .bam/.bed/.pa5/'
            '.pairs alignments instead')
    else:
        from haphic_tpu_torch.io.pairs import PairsReader
        reader = PairsReader(alignments, names)

    n_out = 0
    with open(txt_path, 'w') as out:
        for chunk in reader:
            ok = (chunk.ref >= 0) & (chunk.mref >= 0)
            a = space.map_positions(remap[chunk.ref[ok]],
                                    chunk.pos[ok] + 1)
            b = space.map_positions(remap[chunk.mref[ok]],
                                    chunk.mpos[ok] + 1)
            keep = (a > 0) & (b > 0)
            a, b = a[keep], b[keep]
            lo = np.minimum(a, b)
            hi = np.maximum(a, b)
            n_out += len(lo)
            buf = '\n'.join('0 assembly {} 0 1 assembly {} 1'
                            .format(x, y)
                            for x, y in zip(lo.tolist(), hi.tolist()))
            if buf:
                out.write(buf + '\n')
    msg = 'PRE_C_SIZE: assembly {}'.format(space.total)
    logger.info(msg)
    line = '[I::juicer_pre] {}\n'.format(msg)
    if log_path:
        with open(log_path, 'a') as f:
            f.write(line)
    else:
        import sys
        sys.stderr.write(line)
    logger.info('%d pairs written to %s', n_out, txt_path)
    return txt_path


def parse_review_assembly(path: str):
    """Parse a (possibly JBAT-edited) .assembly: fragment defs + tours.

    Returns (frags, tours): frags = [(name, length)] indexed by id-1;
    tours = [[signed_id, ...]] per output scaffold."""
    frags: List[Tuple[str, int]] = []
    tours: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            if line.startswith('>'):
                cols = line.split()
                frags.append((cols[0][1:], int(cols[2])))
            else:
                tours.append([int(x) for x in line.split()])
    return frags, tours


def _liftover_map(lift_path: str) -> Dict[str, Tuple[str, int, int, str]]:
    out: Dict[str, Tuple[str, int, int, str]] = {}
    with open(lift_path) as f:
        for line in f:
            cols = line.split()
            if len(cols) < 9 or cols[4] != 'W':
                continue
            out[cols[0]] = (cols[5], int(cols[6]), int(cols[7]), cols[8])
    return out


def _resolve_fragment(name: str, length: int,
                      lift: Dict[str, Tuple[str, int, int, str]],
                      consumed: Dict[str, int]
                      ) -> Tuple[str, int, int, str]:
    """Map a (possibly JBAT-split) fragment back to raw coordinates.

    JBAT names splits '<orig>:::fragment_N' (and debris
    '<orig>:::fragment_N:::debris'); the N-th split consumes the next
    ``length`` bases of the original fragment, in display orientation.
    """
    base = name.split(':::')[0]
    if name == base:
        return lift[base]
    ctg, s, e, ori = lift[base]
    off = consumed.get(base, 0)
    consumed[base] = off + length
    if ori == '+':
        return ctg, s + off, s + off + length - 1, ori
    return ctg, e - off - length + 1, e - off, ori


def juicer_post(review_assembly: str, liftover_agp: str,
                contigs_fasta: Optional[str] = None,
                out_prefix: str = 'out_JBAT.FINAL', outdir: str = '.',
                Ns: int = 100, max_width: int = 60) -> str:
    """Reviewed .assembly → final AGP (+ FASTA when the contig FASTA is
    given). Returns the AGP path."""
    frags, tours = parse_review_assembly(review_assembly)
    lift = _liftover_map(liftover_agp)
    prefix = os.path.join(outdir, out_prefix)
    agp_path = prefix + '.agp'

    consumed: Dict[str, int] = {}
    resolved: List[Tuple[str, int, int, str]] = []
    for name, length in frags:
        resolved.append(_resolve_fragment(name, length, lift, consumed))

    seqs = None
    if contigs_fasta:
        from haphic_tpu_torch.io.fasta import iter_fasta
        seqs = {n: s for n, s in iter_fasta(contigs_fasta)}

    fa_out = open(prefix + '.fa', 'w') if seqs is not None else None
    with open(agp_path, 'w') as agp:
        for n_scaf, tour in enumerate(tours, 1):
            scaf = 'scaffold_{}'.format(n_scaf)
            acc = 0
            part = 0
            chunks: List[str] = []
            for k, signed in enumerate(tour):
                fid = abs(signed) - 1
                name, length = frags[fid]
                ctg, s, e, base_ori = resolved[fid]
                flip = signed < 0
                ori = base_ori if not flip else \
                    ('-' if base_ori == '+' else '+')
                if k:
                    part += 1
                    agp.write('{}\t{}\t{}\t{}\tU\t{}\tscaffold\tyes\t'
                              'proximity_ligation\n'.format(
                                  scaf, acc + 1, acc + Ns, part, Ns))
                    acc += Ns
                    if fa_out:
                        chunks.append('N' * Ns)
                part += 1
                agp.write('{}\t{}\t{}\t{}\tW\t{}\t{}\t{}\t{}\n'.format(
                    scaf, acc + 1, acc + (e - s + 1), part, ctg, s, e,
                    ori))
                acc += e - s + 1
                if fa_out:
                    sub = seqs[ctg][s - 1:e]
                    chunks.append(sub if ori == '+' else revcomp(sub))
            if fa_out:
                fa_out.write('>{}\n'.format(scaf))
                seq = ''.join(chunks)
                for i in range(0, len(seq), max_width):
                    fa_out.write(seq[i:i + max_width] + '\n')
    if fa_out:
        fa_out.close()
    return agp_path

"""Final scaffold construction: tours → FASTA + AGP + juicebox script.

Byte-compatible with the reference builder (scripts/HapHiC_build.py):
  * `{prefix}.agp`    — SALSA-style AGP over (possibly corrected) contigs
  * `{prefix}.raw.agp`— YaHS-style AGP mapping `ctg:start-end` names back
                        to raw contig coordinates (needed for `juicer pre`)
  * `{prefix}.fa`     — scaffold sequences, N-gap joined, revcomp via
                        translate table (scripts/HapHiC_build.py:126-129)
  * `juicebox.sh`     — curation round-trip script
                        (scripts/HapHiC_build.py:182-200)
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from haphic_tpu_torch.io.fasta import Assembly, revcomp

logger = logging.getLogger(__name__)

Tour = List[Tuple[str, str]]          # [(ctg, '+'/'-')]


def group_name_of_tour_file(tour_file: str) -> str:
    """'group1_1234bp.tour' → 'group1' (scripts/HapHiC_build.py:35-38)."""
    base = os.path.basename(tour_file)
    return os.path.splitext(base)[0].rsplit('_', 1)[0]


def parse_tours(tour_files: Sequence[str], known_ctgs: Set[str]
                ) -> Dict[str, Tour]:
    """Last non-empty line of each .tour file is the final ordering
    (parity: scripts/HapHiC_build.py:29-57)."""
    seen: Set[str] = set()
    tours: Dict[str, Tour] = {}
    for tf in tour_files:
        group = group_name_of_tour_file(tf)
        tours[group] = []
        last = ''
        with open(tf) as f:
            for line in f:
                if line.strip():
                    last = line.strip()
        for tok in last.split():
            ctg, ori = tok[:-1], tok[-1]
            if ctg not in known_ctgs:
                raise RuntimeError(
                    'CANNOT find ctg {} in FASTA file'.format(ctg))
            if ctg in seen:
                raise RuntimeError('Contig {} is repeated'.format(ctg))
            seen.add(ctg)
            tours[group].append((ctg, ori))
    return tours


def parse_corrected_ctgs(path: Optional[str]) -> Set[str]:
    out: Set[str] = set()
    if path:
        with open(path) as f:
            for line in f:
                if line.strip():
                    out.add(line.rstrip())
    return out


def _agp_w_line(group: str, start: int, end: int, n: int, ctg: str,
                cstart: int, cend: int, ori: str) -> str:
    return '{}\t{}\t{}\t{}\tW\t{}\t{}\t{}\t{}\n'.format(
        group, start, end, n, ctg, cstart, cend, ori)


def _agp_gap_line(group: str, start: int, end: int, n: int, Ns: int) -> str:
    return ('{}\t{}\t{}\t{}\tU\t{}\tscaffold\tyes\tproximity_ligation\n'
            .format(group, start, end, n, Ns))


def build_final_scaffolds(tours: Dict[str, Tour], asm: Assembly,
                          corrected_ctgs: Set[str],
                          prefix: str = 'scaffolds', Ns: int = 100,
                          max_width: int = 60,
                          sort_by_input: bool = False,
                          outdir: str = '.') -> Tuple[str, str, str]:
    """Write `{prefix}.fa`, `{prefix}.agp`, `{prefix}.raw.agp`
    (parity: scripts/HapHiC_build.py:73-179). Returns the three paths."""
    logger.info('Building final scaffolds...')

    anchored = {c for tour in tours.values() for c, _ in tour}

    if sort_by_input:
        order_list: Iterable[str] = list(tours.keys())
    else:
        scored = [(g, sum(asm.length_of(c) for c, _ in tour)
                   + (len(tour) - 1) * Ns)
                  for g, tour in tours.items()]
        scored.sort(key=lambda x: x[1], reverse=True)
        order_list = [g for g, _ in scored]

    # unanchored contigs in FASTA input order, sorted by length desc
    unanchored = [(c, asm.length_of(c)) for c in asm.names_by_input_order()
                  if c not in anchored]
    unanchored.sort(key=lambda x: x[1], reverse=True)

    fa_path = os.path.join(outdir, '{}.fa'.format(prefix))
    agp_path = os.path.join(outdir, '{}.agp'.format(prefix))
    raw_path = os.path.join(outdir, '{}.raw.agp'.format(prefix))

    def raw_coords(ctg: str, ctg_len: int) -> Tuple[str, int, int]:
        if ctg in corrected_ctgs:
            assert ':' in ctg
            raw_ctg, pos_range = ctg.rsplit(':', 1)
            s, e = pos_range.split('-')
            return raw_ctg, int(s), int(e)
        return ctg, 1, ctg_len

    with open(fa_path, 'w') as fa_out, open(agp_path, 'w') as agp_out, \
            open(raw_path, 'w') as raw_out:
        for group in order_list:
            tour = tours[group]
            # FASTA
            seqs = [asm.seq_of(c) if o == '+' else revcomp(asm.seq_of(c))
                    for c, o in tour]
            out_seq = ('N' * Ns).join(seqs)
            fa_out.write('>{}\n'.format(group))
            for i in range(0, len(out_seq), max_width):
                fa_out.write(out_seq[i:i + max_width] + '\n')
            # AGP
            n = 0
            acc = 0
            for c, o in tour:
                n += 1
                clen = asm.length_of(c)
                start, end = acc + 1, acc + clen
                acc = end
                agp_out.write(_agp_w_line(group, start, end, n, c, 1, clen, o))
                rc, rs, re_ = raw_coords(c, clen)
                raw_out.write(_agp_w_line(group, start, end, n, rc, rs, re_, o))
                if n < 2 * len(tour) - 1:
                    n += 1
                    start, end = acc + 1, acc + Ns
                    acc = end
                    agp_out.write(_agp_gap_line(group, start, end, n, Ns))
                    raw_out.write(_agp_gap_line(group, start, end, n, Ns))
        for c, clen in unanchored:
            seq = asm.seq_of(c)
            fa_out.write('>{}\n'.format(c))
            for i in range(0, len(seq), max_width):
                fa_out.write(seq[i:i + max_width] + '\n')
            agp_out.write(_agp_w_line(c, 1, clen, 1, c, 1, clen, '+'))
            rc, rs, re_ = raw_coords(c, clen)
            raw_out.write(_agp_w_line(c, 1, clen, 1, rc, rs, re_, '+'))
    return fa_path, agp_path, raw_path


def generate_juicebox_script(raw_fasta: str, alignments: str,
                             prefix: str = 'scaffolds',
                             outdir: str = '.',
                             juicer_bin: Optional[str] = None,
                             juicer_tools_jar: Optional[str] = None) -> str:
    """Write juicebox.sh (parity: scripts/HapHiC_build.py:182-200)."""
    if juicer_bin is None:
        # our juicer pre/post equivalent (haphic_tpu.post.juicer)
        juicer_bin = 'python3 -m haphic_tpu juicer'
    if juicer_tools_jar is None:
        # third-party jar, external even for the reference (SURVEY §2 #32)
        juicer_tools_jar = 'juicer_tools.jar'
    raw_basename = os.path.basename(raw_fasta)
    path = os.path.join(outdir, 'juicebox.sh')
    with open(path, 'w') as f:
        f.write('#!/bin/bash\n\n')
        if not os.path.exists(os.path.join(outdir, raw_basename)):
            f.write('ln -s {} .\n'.format(raw_fasta))
        f.write('samtools faidx {}\n'.format(raw_basename))
        f.write('{} pre -a -q 1 -o out_JBAT {} {}.raw.agp {}.fai '
                '>out_JBAT.log 2>&1\n'.format(
                    juicer_bin, alignments, prefix, raw_basename))
        f.write('(java -Djava.awt.headless=true -jar -Xmx32G {} pre '
                'out_JBAT.txt out_JBAT.hic.part <(cat out_JBAT.log | '
                'grep PRE_C_SIZE '.format(juicer_tools_jar))
        f.write("| awk '{print $2\" \"$3}')) && "
                "(mv out_JBAT.hic.part out_JBAT.hic)\n")
    return path

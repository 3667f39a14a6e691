"""Assembly correction: chimeric-contig detection and breaking.

Semantics parity with the reference correction subsystem
(scripts/HapHiC_cluster.py):
  * coverage profiling  — per-contig spanning coverage of intra-contig
    read pairs at ``correct_resolution`` (:1300-1398), computed here
    with difference-array scatter adds over whole chunks;
  * detect_break_points — median-coverage × ratio cutoff, high-coverage
    runs filtered by length, valleys bounded by two high runs; break at
    every zero-coverage valley, else at the single deepest valley
    (:943-1014);
  * break_and_update    — contigs renamed ``ctg:start-end`` (1-based raw
    coordinates), coverage/link tables split for the next round; links
    spanning a non-zero breakpoint subtract their coverage support
    (:1017-1197);
  * correct_assembly    — up to ``correct_nrounds`` iterations, emits
    corrected_asm.fa + corrected_ctgs.txt (:1200-1297);
  * CoordRemapper       — maps original (ctg, pos) alignments onto the
    broken fragments for the main link pass, replacing the
    *_generator_for_correction variants (:1401-1536).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from haphic_tpu_torch.io.fasta import Assembly, count_RE_sites
from haphic_tpu_torch.io.pairs import AlignChunk

logger = logging.getLogger(__name__)


@dataclass
class CorrectionState:
    """Mutable per-round state keyed by current fragment name."""
    seqs: Dict[str, str]                       # insertion-ordered
    cov: Dict[str, np.ndarray]                 # int32 bins
    links_lo: Dict[str, List[np.ndarray]]      # 0-based sorted pair coords
    links_hi: Dict[str, List[np.ndarray]]
    resolution: int


def accumulate_coverage(chunks, names: List[str], lengths: np.ndarray,
                        resolution: int) -> CorrectionState:
    """One pass over intra-contig read pairs → coverage + positions.
    ``chunks`` yield 0-based positions with assembly ids into ``names``."""
    n = len(names)
    nbins = lengths // resolution + 1
    diff = [np.zeros(int(b) + 1, np.int64) for b in nbins]
    lo_parts: List[List[np.ndarray]] = [[] for _ in range(n)]
    hi_parts: List[List[np.ndarray]] = [[] for _ in range(n)]
    for chunk in chunks:
        sel = (chunk.ref == chunk.mref) & (chunk.ref >= 0)
        if not sel.any():
            continue
        ref = chunk.ref[sel]
        lo = np.minimum(chunk.pos[sel], chunk.mpos[sel])
        hi = np.maximum(chunk.pos[sel], chunk.mpos[sel])
        lob = lo // resolution
        hib = hi // resolution
        order = np.argsort(ref, kind='stable')
        ref, lo, hi = ref[order], lo[order], hi[order]
        lob, hib = lob[order], hib[order]
        uref, starts = np.unique(ref, return_index=True)
        bounds = np.append(starts, len(ref))
        for t, c in enumerate(uref.tolist()):
            s, e = bounds[t], bounds[t + 1]
            np.add.at(diff[c], lob[s:e], 1)
            np.add.at(diff[c], hib[s:e] + 1, -1)
            lo_parts[c].append(lo[s:e])
            hi_parts[c].append(hi[s:e])
    state = CorrectionState(seqs={}, cov={}, links_lo={}, links_hi={},
                            resolution=resolution)
    for c, name in enumerate(names):
        state.cov[name] = np.cumsum(diff[c][:-1]).astype(np.int64)
        state.links_lo[name] = lo_parts[c]
        state.links_hi[name] = hi_parts[c]
    return state


def detect_break_points(state: CorrectionState, lengths: Dict[str, int],
                        median_cov_ratio: float = 0.2,
                        min_region_cutoff: int = 5000,
                        region_len_ratio: float = 0.1
                        ) -> Dict[str, List[Tuple[int, int]]]:
    """Per contig: [(break_bp, cov)] — parity with the reference
    (:943-1014). break_bp are 0-based multiples of the resolution."""
    res = state.resolution
    out: Dict[str, List[Tuple[int, int]]] = {}
    for ctg, cov in state.cov.items():
        if len(cov) == 0:
            continue
        med = float(np.median(cov))
        if not med:
            continue
        cov_cutoff = med * median_cov_ratio
        region_cutoff = max(min_region_cutoff,
                            lengths[ctg] * region_len_ratio)
        high = cov >= cov_cutoff
        if not high.any():
            continue
        # runs of consecutive high bins
        idx = np.nonzero(high)[0]
        run_start = idx[np.r_[True, np.diff(idx) > 1]]
        run_end = idx[np.r_[np.diff(idx) > 1, True]]
        if len(run_start) < 2:
            continue
        # closed-interval length in bp: (end+1-start)*res
        keep = (run_end + 1 - run_start) * res >= region_cutoff
        run_start, run_end = run_start[keep], run_end[keep]
        if len(run_start) < 2:
            continue
        candidates: List[Tuple[int, int]] = []
        any_zero = False
        for t in range(len(run_start) - 1):
            vs, ve = int(run_end[t]) + 1, int(run_start[t + 1])
            valley = cov[vs:ve]
            if len(valley) == 0:
                continue
            if (valley == 0).any():
                any_zero = True
                candidates.append(
                    (int(np.argmax(valley == 0)) + vs, 0))
            else:
                k = int(np.argmin(valley))
                candidates.append((k + vs, int(valley[k])))
        if not candidates:
            continue
        if any_zero:
            out[ctg] = [(b * res, 0) for b, cv in candidates if cv == 0]
        else:
            b, cv = sorted(candidates, key=lambda x: x[1])[0]
            out[ctg] = [(b * res, cv)]
    return out


def _frag_name(ctg: str, unbroken: bool, s1: int, e1: int) -> str:
    """Name a fragment with raw 1-based coordinates. ``s1``/``e1`` are
    1-based inclusive within the *current* fragment."""
    if unbroken:
        return '{}:{}-{}'.format(ctg, s1, e1)
    raw, pos_range = ctg.rsplit(':', 1)
    shift = int(pos_range.split('-')[0]) - 1
    return '{}:{}-{}'.format(raw, s1 + shift, e1 + shift)


@dataclass
class BreakBook:
    """Final fragment layout per original contig for coordinate
    remapping (reference final_break_pos/frag dicts)."""
    frag_source: Dict[str, str] = field(default_factory=dict)
    pos: Dict[str, List[int]] = field(default_factory=dict)    # 0-based
    frag: Dict[str, List[str]] = field(default_factory=dict)


def break_and_update(state: CorrectionState,
                     breaks: Dict[str, List[Tuple[int, int]]],
                     book: BreakBook, unbroken: set,
                     lengths: Dict[str, int], last_round: bool) -> None:
    res = state.resolution
    for ctg, break_points in breaks.items():
        seq = state.seqs[ctg]
        ctg_len = lengths[ctg]
        points = [p for p, _ in break_points]
        boundaries = np.asarray(points + [ctg_len], np.int64)
        starts0 = np.asarray([0] + points, np.int64)

        # fragment names
        is_unbroken = ctg in unbroken
        names = [_frag_name(ctg, is_unbroken, int(s) + 1, int(e))
                 for s, e in zip(starts0, boundaries)]

        # bookkeeping (reference :1118-1196)
        source = book.frag_source.get(ctg, ctg)
        if ctg not in book.frag_source:
            book.frag_source[ctg] = ctg
            book.pos[source] = [0]
            book.frag[source] = [ctg]
        father_index = book.frag[source].index(ctg)
        father_pos = book.pos[source][father_index]
        book.frag[source].pop(father_index)
        book.pos[source].pop(father_index)
        for k, name in enumerate(names):
            book.frag_source[name] = source
            book.frag[source].insert(father_index + k, name)
            book.pos[source].insert(father_index + k,
                                    father_pos + int(starts0[k]))

        if not last_round:
            any_zero = break_points[0][1] == 0
            lo = (np.concatenate(state.links_lo[ctg])
                  if state.links_lo[ctg] else np.zeros(0, np.int64))
            hi = (np.concatenate(state.links_hi[ctg])
                  if state.links_hi[ctg] else np.zeros(0, np.int64))
            cov = state.cov[ctg]
            if not any_zero:
                b = points[0]
                spanning = (lo <= b + res) & (hi >= b)
                # subtract spanning link coverage (reference :1087-1092)
                sl = lo[spanning] // res
                sh = hi[spanning] // res
                d = np.zeros(len(cov) + 1, np.int64)
                np.add.at(d, sl, 1)
                np.add.at(d, sh + 1, -1)
                cov = cov - np.cumsum(d[:-1])
                lo, hi = lo[~spanning], hi[~spanning]
            # assign remaining links to fragments (both ends same frag)
            fi = np.searchsorted(boundaries, lo, side='right')
            fj = np.searchsorted(boundaries, hi, side='right')
            same = fi == fj
            fi, lo2, hi2 = fi[same], lo[same], hi[same]
            for k, name in enumerate(names):
                sel = fi == k
                off = int(starts0[k])
                state.links_lo[name] = [lo2[sel] - off]
                state.links_hi[name] = [hi2[sel] - off]
                state.cov[name] = cov[off // res: int(boundaries[k]) // res] \
                    if k < len(names) - 1 else cov[off // res:]
            del state.cov[ctg]
            del state.links_lo[ctg]
            del state.links_hi[ctg]

        # split sequences
        for k, name in enumerate(names):
            state.seqs[name] = seq[int(starts0[k]):int(boundaries[k])]
            lengths[name] = int(boundaries[k]) - int(starts0[k])
        del state.seqs[ctg]
        del lengths[ctg]


@dataclass
class CoordRemapper:
    """Vectorized (assembly id, 0-based pos) → (new name, new pos).

    Built from the BreakBook; contigs without breaks map to themselves.
    """
    old_names: List[str]
    new_names: List[str]
    new_name2id: Dict[str, int]
    # per old ctg: break positions (ascending, first=0) and new ids
    seg_pos: List[np.ndarray]
    seg_new: List[np.ndarray]

    def __post_init__(self):
        # all segments in one table, ordered by (old contig, start): a
        # record's segment is one searchsorted over (contig << 32) | pos
        self._n_seg = np.asarray([len(sp) for sp in self.seg_pos], np.int64)
        self._first = np.concatenate(([0], np.cumsum(self._n_seg)[:-1]))
        self._pos = np.concatenate(self.seg_pos).astype(np.int64)
        self._new = np.concatenate(self.seg_new).astype(np.int64)
        self._key = (np.repeat(np.arange(len(self.seg_pos), dtype=np.int64),
                               self._n_seg) << 32) + self._pos

    def remap(self, chunk: AlignChunk) -> AlignChunk:
        ref, pos = self._map(chunk.ref, chunk.pos)
        mref, mpos = self._map(chunk.mref, chunk.mpos)
        return AlignChunk(ref=ref, pos=pos, mref=mref, mpos=mpos)

    def _map(self, ref: np.ndarray, pos: np.ndarray):
        """haphic_tpu's per-contig loop in one pass, with the same
        arrays out: positions left of a contig's first segment take its
        last one, as the loop's index -1 does."""
        new_ref = np.full(len(ref), -1, np.int32)
        new_pos = pos.copy()
        sel = (ref >= 0) & (ref < len(self.seg_pos))
        c = ref[sel].astype(np.int64)
        p = pos[sel].astype(np.int64)
        k = np.searchsorted(self._key, (c << 32) + p, side='right') - 1
        k = k - self._first[c]
        k = np.where(k < 0, k + self._n_seg[c], k) + self._first[c]
        new_ref[sel] = self._new[k]
        new_pos[sel] = p - self._pos[k]
        return new_ref, new_pos


@dataclass
class CorrectionResult:
    asm: Assembly
    remapper: Optional[CoordRemapper]
    n_broken: int
    corrected_names: List[str]
    fasta_path: str
    list_path: str


def correct_assembly(asm: Assembly, reader, outdir: str,
                     correct_nrounds: int = 2,
                     correct_resolution: int = 500,
                     median_cov_ratio: float = 0.2,
                     min_region_cutoff: int = 5000,
                     region_len_ratio: float = 0.1,
                     RE: str = 'GATC') -> CorrectionResult:
    """Full correction stage. ``reader`` yields AlignChunks over the
    ORIGINAL assembly (intra-contig pairs used)."""
    state = accumulate_coverage(reader, asm.names, asm.lengths,
                                correct_resolution)
    order = list(asm.names_by_input_order())
    state.seqs = {c: asm.seq_of(c) for c in order}
    lengths: Dict[str, int] = {c: asm.length_of(c) for c in order}

    unbroken = set(asm.names)
    book = BreakBook()
    n_broken = 0
    for nround in range(correct_nrounds):
        breaks = detect_break_points(state, lengths, median_cov_ratio,
                                     min_region_cutoff, region_len_ratio)
        logger.info('Correction round %d, breakpoints detected in %d '
                    'contig(s)', nround + 1, len(breaks))
        if nround == 0:
            n_broken = len(breaks)
        if not breaks:
            break
        before = set(state.seqs.keys())
        break_and_update(state, breaks, book, unbroken, lengths,
                         last_round=(nround + 1 == correct_nrounds))
        unbroken -= set(breaks.keys())
        # fragments untouched this round are never rechecked (:1191-1196)
        for ctg in before - set(breaks.keys()):
            state.cov.pop(ctg, None)

    fasta_path = os.path.join(outdir, 'corrected_asm.fa')
    list_path = os.path.join(outdir, 'corrected_ctgs.txt')
    corrected_names = [c for c in state.seqs if c not in unbroken]
    with open(fasta_path, 'w') as f:
        for ctg, seq in state.seqs.items():
            f.write('>{}\n{}\n'.format(ctg, seq))
    with open(list_path, 'w') as f:
        for c in corrected_names:
            assert ':' in c
            f.write(c + '\n')

    # rebuild the Assembly over the corrected fragments
    names = sorted(state.seqs)
    name2id = {c: i for i, c in enumerate(names)}
    new_asm = Assembly(
        names=names, name2id=name2id,
        lengths=np.asarray([lengths[c] for c in names], np.int64),
        re_sites=np.asarray(
            [count_RE_sites(state.seqs[c], RE) + 1 for c in names],
            np.int64),
        seqs=[state.seqs[c] for c in names],
        input_order={c: i for i, c in enumerate(state.seqs)})

    remapper = None
    if n_broken:
        seg_pos, seg_new = [], []
        for c in asm.names:
            if c in book.pos:
                sp = np.asarray(book.pos[c], np.int64)
                sn = np.asarray([name2id[f] for f in book.frag[c]],
                                np.int64)
            else:
                sp = np.zeros(1, np.int64)
                sn = np.asarray([name2id[c]], np.int64)
            seg_pos.append(sp)
            seg_new.append(sn)
        remapper = CoordRemapper(old_names=asm.names, new_names=names,
                                 new_name2id=name2id, seg_pos=seg_pos,
                                 seg_new=seg_new)
    logger.info('%d contigs broken into %d fragments', n_broken,
                len(corrected_names))
    return CorrectionResult(asm=new_asm, remapper=remapper,
                            n_broken=n_broken,
                            corrected_names=corrected_names,
                            fasta_path=fasta_path, list_path=list_path)

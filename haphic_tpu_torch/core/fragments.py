"""Fragment (contig / bin) table construction.

Reimplements the semantics of stat_fragments
(scripts/HapHiC_cluster.py:188-296) with a columnar layout: every
fragment gets a dense integer id ordered by (contig id, bin number), so
that mapping an alignment coordinate to its fragment is a single
vectorized ``offset[ctg] + (coord-1)//bin_size`` — no string keys in the
ingest hot loop.

Determinism parity notes:
  * auto bin_size = clamp(total_len/nchrs/30, 100 kb, 2 Mb)
    (reference line :216);
  * the Nx subset is selected on fragments sorted by length descending
    *after* a seeded shuffle (random.seed(12345)) of the fragment list in
    FASTA input order (reference lines :269-288) — we reproduce that
    exactly, including the "add one more fragment" rule and whitelist
    re-adds;
  * bin RE-site counts use flanking regions only when the fragment is
    longer than 2*flank, and always carry a +1 pseudo-count
    (reference lines :192-199).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np

from haphic_tpu_torch.io.fasta import Assembly, count_RE_sites


@dataclass
class Fragments:
    """Columnar fragment table.

    ctg_of_frag  int32[m]: owning contig id
    bin_no       int32[m]: 1-based bin number (1 for unsplit contigs)
    frag_start   int64[m]: 0-based start offset within the contig
    frag_len     int64[m]
    frag_re      int64[m]: flank RE sites (+1 pseudo-count)
    frag_offset  int64[n_ctg+1]: first fragment id of each contig
    split_ctg    bool[n_ctg]: contig was split into bins
    nx_mask      bool[m]: fragment selected by the Nx filter (and whitelist)
    bin_size     effective bin size in bp (0 disables splitting)
    names        lazily generated "{ctg}" or "{ctg}_bin{k}" strings
    """

    asm: Assembly
    ctg_of_frag: np.ndarray
    bin_no: np.ndarray
    frag_start: np.ndarray
    frag_len: np.ndarray
    frag_re: np.ndarray
    frag_offset: np.ndarray
    split_ctg: np.ndarray
    nx_mask: np.ndarray
    bin_size: int
    _names: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.frag_len)

    @property
    def any_split(self) -> bool:
        return bool(self.split_ctg.any())

    @property
    def names(self) -> List[str]:
        if self._names is None:
            ctg_names = self.asm.names
            out = []
            for c, b in zip(self.ctg_of_frag, self.bin_no):
                if self.split_ctg[c]:
                    out.append('{}_bin{}'.format(ctg_names[c], b))
                else:
                    out.append(ctg_names[c])
            self._names = out
        return self._names

    def name_of(self, frag_id: int) -> str:
        c = int(self.ctg_of_frag[frag_id])
        if self.split_ctg[c]:
            return '{}_bin{}'.format(self.asm.names[c], int(self.bin_no[frag_id]))
        return self.asm.names[c]

    def id_of(self, name: str) -> int:
        if '_bin' in name:
            ctg, b = name.rsplit('_bin', 1)
            if ctg in self.asm.name2id and self.split_ctg[self.asm.name2id[ctg]]:
                return int(self.frag_offset[self.asm.name2id[ctg]]) + int(b) - 1
        return int(self.frag_offset[self.asm.name2id[name]])

    def frag_of(self, ctg_ids: np.ndarray, coords: np.ndarray) -> np.ndarray:
        """Vectorized (ctg, 1-based coord) → fragment id."""
        if self.bin_size <= 0:
            return self.frag_offset[ctg_ids].astype(np.int64)
        nb = (coords - 1) // self.bin_size
        nb = np.where(self.split_ctg[ctg_ids], nb, 0)
        return self.frag_offset[ctg_ids] + nb

    def coord_in_frag(self, ctg_ids: np.ndarray, coords: np.ndarray) -> np.ndarray:
        """Vectorized 1-based coordinate within the owning fragment.

        Matches convert_frags (scripts/HapHiC_cluster.py:1662-1670):
        ``bin_coord = coord - (nbins-1)*bin_size`` with nbins=ceil(coord/bin).
        """
        if self.bin_size <= 0:
            return coords
        nb = (coords - 1) // self.bin_size
        nb = np.where(self.split_ctg[ctg_ids], nb, 0)
        return coords - nb * self.bin_size


def effective_bin_size(total_len: int, nchrs: int, bin_size_kbp: int) -> int:
    """bin_size semantics (reference lines :210-221): 0 → disabled,
    <0 → auto clamp(total/nchrs/30, 100 kb, 2 Mb), >0 → kbp→bp."""
    if bin_size_kbp == 0:
        return 0
    if bin_size_kbp < 0:
        return max(min(int(total_len / nchrs / 30), 2_000_000), 100_000)
    return bin_size_kbp * 1000


def _flank_re(seq: str, length: int, flank_bp: int, RE: str) -> int:
    if not flank_bp or length <= 2 * flank_bp:
        return count_RE_sites(seq, RE) + 1
    return (count_RE_sites(seq[:flank_bp], RE)
            + count_RE_sites(seq[length - flank_bp:], RE) + 1)


def build_fragments(asm: Assembly, RE: str = 'GATC', nchrs: int = 0,
                    flank_kbp: int = 0, Nx: int = 100, bin_size_kbp: int = 0,
                    whitelist: Optional[Set[str]] = None) -> Fragments:
    """Construct the fragment table + Nx mask.

    ``flank_kbp`` / ``bin_size_kbp`` follow the reference CLI units (kbp).
    """
    whitelist = whitelist or set()
    flank_bp = flank_kbp * 1000
    n_ctg = len(asm)
    bin_size = effective_bin_size(asm.total_len, max(nchrs, 1), bin_size_kbp)

    if bin_size:
        nbins = np.maximum((asm.lengths + bin_size - 1) // bin_size, 1)
        split_ctg = asm.lengths > bin_size
        nbins = np.where(split_ctg, nbins, 1)
    else:
        nbins = np.ones(n_ctg, dtype=np.int64)
        split_ctg = np.zeros(n_ctg, dtype=bool)

    frag_offset = np.zeros(n_ctg + 1, dtype=np.int64)
    np.cumsum(nbins, out=frag_offset[1:])
    m = int(frag_offset[-1])

    ctg_of_frag = np.repeat(np.arange(n_ctg, dtype=np.int32), nbins)
    bin_no = (np.arange(m, dtype=np.int64) - frag_offset[ctg_of_frag] + 1).astype(np.int32)
    frag_start = (bin_no.astype(np.int64) - 1) * (bin_size if bin_size else 0)
    frag_len = np.where(
        bin_no.astype(np.int64) < nbins[ctg_of_frag],
        bin_size if bin_size else 0,
        asm.lengths[ctg_of_frag] - frag_start)

    # RE sites: per-fragment flank counting (needs sequences for split
    # contigs or when flank is active)
    frag_re = np.zeros(m, dtype=np.int64)
    for c in range(n_ctg):
        lo, hi = int(frag_offset[c]), int(frag_offset[c + 1])
        ctg_len = int(asm.lengths[c])
        if not split_ctg[c]:
            if not flank_bp or ctg_len <= 2 * flank_bp:
                frag_re[lo] = asm.re_sites[c]  # already has +1
            else:
                frag_re[lo] = _flank_re(asm.seq_of(asm.names[c]), ctg_len, flank_bp, RE)
        else:
            seq = asm.seq_of(asm.names[c])
            for k in range(lo, hi):
                s = int(frag_start[k])
                e = s + int(frag_len[k])
                frag_re[k] = _flank_re(seq[s:e], e - s, flank_bp, RE)

    # ---- Nx selection, reproducing the reference's seeded shuffle ----
    # fragment listing order = FASTA input order, bins in ascending order
    # (reference builds `frags` while iterating fa_dict, lines :228-257)
    input_frags: List[int] = []
    for ctg in asm.names_by_input_order():
        c = asm.name2id[ctg]
        input_frags.extend(range(int(frag_offset[c]), int(frag_offset[c + 1])))
    rng = random.Random()
    rng.seed(12345)
    rng.shuffle(input_frags)
    # stable sort by length descending keeps the shuffled relative order
    order = sorted(input_frags, key=lambda fid: int(frag_len[fid]), reverse=True)

    total_len = asm.total_len
    nx_mask = np.zeros(m, dtype=bool)
    len_sum = 0
    n_selected = 0
    for fid in order:
        len_sum += int(frag_len[fid])
        if len_sum / total_len * 100 < Nx or Nx == 100:
            nx_mask[fid] = True
            n_selected += 1
    if Nx != 100 and n_selected < m:
        # add one more fragment so the cumulative length reaches >= Nx
        nx_mask[order[n_selected]] = True

    if whitelist:
        for fid in range(m):
            if asm.names[int(ctg_of_frag[fid])] in whitelist:
                nx_mask[fid] = True

    return Fragments(asm=asm, ctg_of_frag=ctg_of_frag, bin_no=bin_no,
                     frag_start=frag_start, frag_len=frag_len.astype(np.int64),
                     frag_re=frag_re, frag_offset=frag_offset,
                     split_ctg=split_ctg, nx_mask=nx_mask, bin_size=bin_size)

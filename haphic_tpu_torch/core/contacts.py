"""Vectorized Hi-C link aggregation.

Replaces the reference's per-read Python dict updates
(parse_alignments / parse_alignments_for_ctgs,
scripts/HapHiC_cluster.py:1596-1752) with columnar numpy segment
reductions over alignment chunks. One pass over the data produces:

  * full links      — inter-contig pair counts (→ full_links.pkl)
  * flank links     — fragment-pair counts gated by the Nx subset and the
                      flanking-region rule (→ the MCL adjacency matrix)
  * per-fragment link totals (→ density filtering)
  * HT links        — contig half (head/tail) pair counts (→ HT_links.pkl
                      and fast sorting)
  * CLM records     — the 4 orientation distances per read pair
                      (→ paired_links.clm and the tour optimizer)
  * coord pairs     — first `max_read_pairs` coordinate pairs per contig
                      pair (→ allelic / concentrated link detection)

Pair canonicalisation: contig ids are assigned in lexicographic name
order (see haphic_tpu_torch.io.fasta), so the reference's name-sort of each
read pair (scripts/HapHiC_cluster.py:1629,1707) is an integer min/max.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from haphic_tpu_torch.core.fragments import Fragments
from haphic_tpu_torch.io.pairs import AlignChunk


def is_flank(coord: np.ndarray, length: np.ndarray, flank_bp: int) -> np.ndarray:
    """Vectorized flanking-region test
    (parity: scripts/HapHiC_cluster.py:299-307). 1-based coords."""
    if not flank_bp:
        return np.ones(coord.shape, dtype=bool)
    return (coord <= flank_bp) | (coord > length - flank_bp)


@dataclass
class COO:
    """Symmetric pair counts stored once with i <= j (canonical order)."""
    i: np.ndarray
    j: np.ndarray
    w: np.ndarray

    def as_dict(self, name_of) -> Dict[Tuple[str, str], float]:
        out: Dict[Tuple[str, str], float] = {}
        for a, b, c in zip(self.i.tolist(), self.j.tolist(), self.w.tolist()):
            out[(name_of(a), name_of(b))] = int(c) if float(c).is_integer() else c
        return out


@dataclass
class CLMData:
    """Raveled CLM records: for each kept read pair, its contig-pair id
    and the four orientation distances (reference semantics,
    scripts/HapHiC_cluster.py:395-401, 0-based coords):

        d[0] (+ +) = len_i - p_i + p_j
        d[1] (+ -) = len_i - p_i + len_j - p_j
        d[2] (- +) = p_i + p_j
        d[3] (- -) = p_i + len_j - p_j
    """
    pair_i: np.ndarray      # int32[R] contig id (name-first)
    pair_j: np.ndarray      # int32[R]
    d: np.ndarray           # int64[4, R]
    # first occurrence position of each unique pair in the original
    # alignment stream — the reference's clm_dict iterates pairs in
    # insertion order (scripts/HapHiC_cluster.py:383), which we reproduce
    # for byte-identical CLM output:
    u_keys: np.ndarray = None       # int64[P] unique pair keys (sorted)
    u_first_seen: np.ndarray = None  # int64[P]

    def __len__(self) -> int:
        return self.pair_i.shape[0]


@dataclass
class CoordPairs:
    """First `max_read_pairs` (coord_i, coord_j) per contig pair, in file
    order — parity with record_coord_pairs
    (scripts/HapHiC_cluster.py:454-471). 1-based coords."""
    pair_i: np.ndarray
    pair_j: np.ndarray
    ci: np.ndarray
    cj: np.ndarray
    total_counts_i: np.ndarray  # unique pair table (aligned with boundaries)
    total_counts: np.ndarray    # total observed read pairs per unique pair
    # boundaries into the (sorted) record arrays per unique pair:
    starts: np.ndarray
    counts: np.ndarray
    upair_i: np.ndarray
    upair_j: np.ndarray
    # per-record global stream-order keys (set only for sharded ingest;
    # lets merge_link_data re-apply the per-pair cap in true file order)
    okey: Optional[np.ndarray] = None


@dataclass
class LinkData:
    n_ctg: int
    n_frag: int
    full: COO                       # inter-contig counts
    flank: COO                      # fragment-pair counts (MCL input)
    frag_links: np.ndarray          # int64[n_frag]
    ht: COO                         # HT node ids = ctg*2 + is_tail
    clm: Optional[CLMData] = None
    coords: Optional[CoordPairs] = None
    ctg_pair_to_frag: Optional[COO] = None  # (ctg pair key → frag pair key) map


def _compact_counts(raws: List[np.ndarray], acc):
    """Collapse raw key appends (weight 1 each) into/with a
    (unique keys, counts) accumulator."""
    if not raws:
        return acc if acc is not None else (np.zeros(0, np.int64),
                                            np.zeros(0, np.int64))
    keys = np.concatenate(raws)
    if acc is None:
        uk, cnt = np.unique(keys, return_counts=True)
        return uk, cnt.astype(np.int64)
    allk = np.concatenate([acc[0], keys])
    allw = np.concatenate([acc[1], np.ones(len(keys), np.int64)])
    order = np.argsort(allk, kind='stable')
    allk, allw = allk[order], allw[order]
    uk, start = np.unique(allk, return_index=True)
    return uk, np.add.reduceat(allw, start)


class LinkAccumulator:
    """Streaming accumulator over :class:`AlignChunk`s.

    Parameters mirror the reference CLI:
      flank_kbp          --flank (kbp)
      need_coords        remove_allelic_links or remove_concentrated_links
      max_read_pairs     --max_read_pairs
      track_ctg_pair_to_frag  bins + remove_allelic_links

    Memory is bounded: every ``compact_bytes`` of raw appends the
    count-type key lists collapse to (unique, count) runs, coord pairs
    re-cap to max_read_pairs per pair, and CLM records spill to a temp
    file — peak RSS scales with unique pairs, not read pairs.
    """

    def __init__(self, frags: Fragments, flank_kbp: int = 0,
                 need_coords: bool = False, max_read_pairs: int = 200,
                 keep_clm: bool = True,
                 compact_bytes: int = 512 << 20):
        self.frags = frags
        self.asm = frags.asm
        self.flank_bp = flank_kbp * 1000
        self.need_coords = need_coords
        self.max_read_pairs = max_read_pairs
        self.keep_clm = keep_clm
        self._full: List[np.ndarray] = []        # int64 keys
        self._flank: List[np.ndarray] = []       # int64 frag keys
        self._ht: List[np.ndarray] = []          # int64 HT keys
        self._clm_key: List[np.ndarray] = []
        self._clm_d: List[np.ndarray] = []
        self._clm_seq: List[int] = []            # chunk seq per append
        self._clm_lens: List[int] = []           # records per append
        self._coord_key: List[np.ndarray] = []
        self._coord_ci: List[np.ndarray] = []
        self._coord_cj: List[np.ndarray] = []
        self._coord_okey: List[np.ndarray] = []  # per-record order keys
        self._coord_seq: List[int] = []
        self._pair_frag: List[np.ndarray] = []   # stacked (ctgkey, fragkey)
        self.track_ctg_pair_to_frag = False
        # ---- bounded-memory machinery -------------------------------
        # The reference streams dict updates so its RSS tracks unique
        # pairs, not read pairs (scripts/HapHiC_cluster.py:1596-1752).
        # Columnar appends are O(read pairs); to stay sublinear the
        # accumulator periodically (a) collapses full/flank/HT key lists
        # into (unique key, count) runs, (b) caps coord pairs to the
        # first max_read_pairs per pair, and (c) spills raw CLM records
        # (which the CLM file needs in full) to a temp file.
        self.compact_bytes = compact_bytes
        self._raw_bytes = 0
        self._full_acc = None                    # (keys, counts)
        self._flank_acc = None
        self._ht_acc = None
        self._coord_totals_acc = None            # pre-cap totals
        self._clm_spill = None                   # tempfile handle
        self._clm_spilled_records = 0
        self._coord_seq_counter = 0

    def consume(self, chunk: AlignChunk, seq: Optional[int] = None) -> None:
        """Accumulate one alignment chunk. ``seq`` is the chunk's global
        ordinal in the full alignment stream — pass it when shards of
        the stream are processed by different hosts so that CLM/coord
        insertion-order keys stay globally consistent (two records from
        the same chunk always live on the same shard, so chunk ordinal +
        within-chunk offset is an exact global order)."""
        asm, frags = self.asm, self.frags
        n = len(asm)
        ref, mref = chunk.ref, chunk.mref
        pos, mpos = chunk.pos, chunk.mpos

        valid = (ref >= 0) & (mref >= 0)
        if frags.any_split:
            # skip intra-contig links on unsplit contigs (reference
            # line :1699)
            valid &= (ref != mref) | frags.split_ctg[np.clip(ref, 0, n - 1)]
        else:
            valid &= ref != mref
        if not valid.any():
            return
        ref, mref = ref[valid], mref[valid]
        pos, mpos = pos[valid], mpos[valid]

        # name-sort of the two endpoints (1-based coords)
        ci1, cj1 = ref.astype(np.int64), mref.astype(np.int64)
        pi1, pj1 = pos + 1, mpos + 1
        swap = (ci1 > cj1) | ((ci1 == cj1) & (pi1 > pj1))
        ci = np.where(swap, cj1, ci1)
        cj = np.where(swap, ci1, cj1)
        pi = np.where(swap, pj1, pi1)
        pj = np.where(swap, pi1, pj1)

        len_i = asm.lengths[ci]
        len_j = asm.lengths[cj]

        # fragment conversion + flank gating
        fi = frags.frag_of(ci, pi)
        fj = frags.frag_of(cj, pj)
        fci = frags.coord_in_frag(ci, pi)
        fcj = frags.coord_in_frag(cj, pj)
        frag_ok = fi != fj
        # canonical frag order (numeric id; symmetric use only)
        lo = np.minimum(fi, fj)
        hi = np.maximum(fi, fj)
        fc_lo = np.where(fi <= fj, fci, fcj)
        fc_hi = np.where(fi <= fj, fcj, fci)
        flank_sel = (frag_ok
                     & frags.nx_mask[np.clip(fi, 0, len(frags) - 1)]
                     & frags.nx_mask[np.clip(fj, 0, len(frags) - 1)]
                     & is_flank(fc_lo, frags.frag_len[lo], self.flank_bp)
                     & is_flank(fc_hi, frags.frag_len[hi], self.flank_bp))
        m = len(frags)
        self._flank.append((lo[flank_sel] * m + hi[flank_sel]).astype(np.int64))

        if self.track_ctg_pair_to_frag:
            sel = frag_ok & (ci != cj)
            pf = np.stack([(ci[sel] * n + cj[sel]).astype(np.int64),
                           (lo[sel] * m + hi[sel]).astype(np.int64)], axis=1)
            self._pair_frag.append(np.unique(pf, axis=0))

        # inter-contig statistics only (reference line :1736)
        inter = (ci != cj) & frag_ok
        ci, cj, pi, pj = ci[inter], cj[inter], pi[inter], pj[inter]
        len_i, len_j = len_i[inter], len_j[inter]
        key = ci * n + cj
        self._full.append(key)

        if self.keep_clm:
            p0i, p0j = pi - 1, pj - 1
            d = np.stack([
                len_i - p0i + p0j,
                len_i - p0i + len_j - p0j,
                p0i + p0j,
                p0i + len_j - p0j,
            ]).astype(np.int64)
            self._clm_key.append(key)
            self._clm_d.append(d)
            self._clm_lens.append(len(key))
            if seq is not None:
                self._clm_seq.append(seq)
            self._raw_bytes += key.nbytes + d.nbytes

        # HT halves: tail when coord*2 > len (reference :404-416)
        hti = ci * 2 + (pi * 2 > len_i)
        htj = cj * 2 + (pj * 2 > len_j)
        self._ht.append(hti * (2 * n) + htj)

        if self.need_coords:
            self._coord_key.append(key)
            self._coord_ci.append(pi)
            self._coord_cj.append(pj)
            # per-record stream-order key: global when a chunk seq is
            # given, else a process-local running ordinal — both are
            # stable under compaction re-sorts
            base = seq if seq is not None else self._coord_seq_counter
            self._coord_okey.append(
                (np.uint64(base) << np.uint64(32)
                 | np.arange(len(key), dtype=np.uint64)).astype(np.int64))
            self._coord_seq_counter += 1
            if seq is not None:
                self._coord_seq.append(seq)
            self._raw_bytes += key.nbytes * 4

        self._raw_bytes += key.nbytes * 2
        if self._flank:
            self._raw_bytes += self._flank[-1].nbytes
        if self._raw_bytes >= self.compact_bytes:
            self._compact()

    # ---- bounded-memory compaction ----

    def _cap_coords(self) -> None:
        """Sort coord records by (pair, stream order) and keep the first
        max_read_pairs per pair; pre-cap totals accumulate separately
        (only records not yet counted — the head of the lists holds the
        previously capped, already-counted survivors)."""
        if not self._coord_key:
            return
        counted = getattr(self, '_coord_counted', 0)
        self._coord_totals_acc = _compact_counts(
            self._coord_key[counted:], self._coord_totals_acc)
        ckey = np.concatenate(self._coord_key)
        cci = np.concatenate(self._coord_ci)
        ccj = np.concatenate(self._coord_cj)
        okey = np.concatenate(self._coord_okey)
        order = np.lexsort((okey, ckey))
        ckey, cci, ccj, okey = (ckey[order], cci[order], ccj[order],
                                okey[order])
        _, starts, counts = np.unique(ckey, return_index=True,
                                      return_counts=True)
        rank = np.arange(len(ckey)) - np.repeat(starts, counts)
        keep = rank < self.max_read_pairs
        self._coord_key = [ckey[keep]]
        self._coord_ci = [cci[keep]]
        self._coord_cj = [ccj[keep]]
        self._coord_okey = [okey[keep]]
        self._coord_counted = 1

    def _spill_clm(self) -> None:
        if not self._clm_key:
            return
        if self._clm_spill is None:
            import tempfile
            self._clm_spill = tempfile.TemporaryFile(
                prefix='haphic_clm_spill_')
            self._clm_spill_blocks: List[int] = []
        keys = np.concatenate(self._clm_key)
        d = np.concatenate(self._clm_d, axis=1)
        self._clm_spill.write(keys.tobytes())
        self._clm_spill.write(np.ascontiguousarray(d.T).tobytes())
        self._clm_spill_blocks.append(len(keys))
        self._clm_spilled_records += len(keys)
        self._clm_key = []
        self._clm_d = []

    def _compact(self) -> None:
        self._full_acc = _compact_counts(self._full, self._full_acc)
        self._flank_acc = _compact_counts(self._flank, self._flank_acc)
        self._ht_acc = _compact_counts(self._ht, self._ht_acc)
        self._full = []
        self._flank = []
        self._ht = []
        if self.need_coords:
            self._cap_coords()
        if self.keep_clm:
            self._spill_clm()
        if self.track_ctg_pair_to_frag and len(self._pair_frag) > 1:
            # (ctgkey, fragkey) rows are already per-chunk unique;
            # collapse across chunks so the accumulator stays bounded
            self._pair_frag = [np.unique(
                np.concatenate(self._pair_frag, axis=0), axis=0)]
        self._raw_bytes = 0

    def _read_clm_spill(self):
        """(keys, d (4, R)) of all spilled CLM records, in append order."""
        self._clm_spill.seek(0)
        R = self._clm_spilled_records
        out_k = np.empty(R, dtype=np.int64)
        out_d = np.empty((R, 4), dtype=np.int64)
        pos = 0
        for nrec in self._clm_spill_blocks:
            out_k[pos:pos + nrec] = np.frombuffer(
                self._clm_spill.read(8 * nrec), dtype=np.int64)
            out_d[pos:pos + nrec] = np.frombuffer(
                self._clm_spill.read(32 * nrec),
                dtype=np.int64).reshape(nrec, 4)
            pos += nrec
        assert pos == R
        return out_k, out_d.T

    # ---- finalization ----

    def finalize(self) -> LinkData:
        asm, frags = self.asm, self.frags
        n, m = len(asm), len(frags)

        def cat(lst, dtype=np.int64):
            if not lst:
                return np.zeros(0, dtype=dtype)
            return np.concatenate(lst)

        uk, cnt = _compact_counts(self._full, self._full_acc)
        full = COO(i=uk // n, j=uk % n, w=cnt.astype(np.float64))

        ufk, fcnt = _compact_counts(self._flank, self._flank_acc)
        flank = COO(i=ufk // m, j=ufk % m, w=fcnt.astype(np.float64))
        frag_links = np.zeros(m, dtype=np.int64)
        np.add.at(frag_links, flank.i, fcnt)
        np.add.at(frag_links, flank.j, fcnt)

        uhk, hcnt = _compact_counts(self._ht, self._ht_acc)
        ht = COO(i=uhk // (2 * n), j=uhk % (2 * n), w=hcnt.astype(np.float64))

        clm = None
        if self.keep_clm:
            # per-record global stream-order key: chunk ordinal << 32 |
            # offset within the chunk's kept records. Exact across
            # shards because a chunk never spans shards.
            g = None
            if len(self._clm_seq) == len(self._clm_lens):
                parts_g = [np.uint64(s) << np.uint64(32)
                           | np.arange(ln, dtype=np.uint64)
                           for s, ln in zip(self._clm_seq, self._clm_lens)]
                g = (np.concatenate(parts_g) if parts_g
                     else np.zeros(0, dtype=np.uint64)).astype(np.int64)
            mem_keys = cat(self._clm_key)
            mem_d = (np.concatenate(self._clm_d, axis=1)
                     if self._clm_d else np.zeros((4, 0), dtype=np.int64))
            if self._clm_spill is not None:
                sp_keys, sp_d = self._read_clm_spill()
                clm_keys = np.concatenate([sp_keys, mem_keys])
                d = np.concatenate([sp_d, mem_d], axis=1)
                self._clm_spill.close()
                self._clm_spill = None
            else:
                clm_keys, d = mem_keys, mem_d
            u_keys, u_first = np.unique(clm_keys, return_index=True)
            u_first_seen = g[u_first] if g is not None else u_first
            order = np.argsort(clm_keys, kind='stable')
            clm_keys = clm_keys[order]
            d = d[:, order]
            clm = CLMData(pair_i=(clm_keys // n).astype(np.int64),
                          pair_j=(clm_keys % n).astype(np.int64), d=d,
                          u_keys=u_keys, u_first_seen=u_first_seen)

        coords = None
        if self.need_coords:
            ckey = cat(self._coord_key)
            cci = cat(self._coord_ci)
            ccj = cat(self._coord_cj)
            g = cat(self._coord_okey) if self._coord_okey else None
            if g is not None:
                order = np.lexsort((g, ckey))
                g = g[order]
            else:
                order = np.argsort(ckey, kind='stable')
            ckey, cci, ccj = ckey[order], cci[order], ccj[order]
            # true pre-cap totals: compaction may already have capped
            # part of the stream, so merge the not-yet-counted records
            # with the running totals accumulator
            counted = getattr(self, '_coord_counted', 0)
            upk, total = _compact_counts(self._coord_key[counted:],
                                         self._coord_totals_acc)
            _, starts, scount = np.unique(ckey, return_index=True,
                                          return_counts=True)
            # rank within each pair, keep the first max_read_pairs
            rank = np.arange(len(ckey)) - np.repeat(starts, scount)
            keep = rank < self.max_read_pairs
            ckey, cci, ccj = ckey[keep], cci[keep], ccj[keep]
            if g is not None:
                g = g[keep]
            upk2, starts2, cnt2 = np.unique(ckey, return_index=True,
                                            return_counts=True)
            assert np.array_equal(upk, upk2)
            coords = CoordPairs(
                pair_i=(ckey // n).astype(np.int64),
                pair_j=(ckey % n).astype(np.int64),
                ci=cci, cj=ccj,
                total_counts_i=upk, total_counts=total,
                starts=starts2, counts=cnt2,
                upair_i=(upk // n).astype(np.int64),
                upair_j=(upk % n).astype(np.int64),
                okey=g)

        p2f = None
        if self.track_ctg_pair_to_frag and self._pair_frag:
            pf = np.unique(np.concatenate(self._pair_frag, axis=0), axis=0)
            p2f = COO(i=pf[:, 0], j=pf[:, 1], w=np.ones(len(pf)))

        self._full = self._flank = self._ht = None  # free
        self._clm_key = self._clm_d = None
        self._coord_key = self._coord_ci = self._coord_cj = None

        return LinkData(n_ctg=n, n_frag=m, full=full, flank=flank,
                        frag_links=frag_links, ht=ht, clm=clm,
                        coords=coords, ctg_pair_to_frag=p2f)


def aggregate(chunks: Iterable[AlignChunk], frags: Fragments,
              flank_kbp: int = 0, need_coords: bool = False,
              max_read_pairs: int = 200, keep_clm: bool = True,
              track_ctg_pair_to_frag: bool = False,
              compact_bytes: int = 512 << 20) -> LinkData:
    acc = LinkAccumulator(frags, flank_kbp=flank_kbp, need_coords=need_coords,
                          max_read_pairs=max_read_pairs, keep_clm=keep_clm,
                          compact_bytes=compact_bytes)
    acc.track_ctg_pair_to_frag = track_ctg_pair_to_frag
    for chunk in chunks:
        acc.consume(chunk)
    return acc.finalize()

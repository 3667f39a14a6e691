"""FASTA ingest and restriction-site counting.

Feature parity with the reference parser (scripts/HapHiC_cluster.py:56-113)
but organised around an `Assembly` value object holding *columnar* metadata
(names, lengths, RE-site counts as numpy arrays) so that every downstream
stage can index contigs by dense integer ids instead of strings.

Contig ids are assigned in *lexicographic name order*. The reference sorts
read-pair endpoints by contig name everywhere
(scripts/HapHiC_cluster.py:1629, :1707); with name-ordered ids the same
canonical ordering is a cheap integer min/max on device.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_COMPLEMENT = bytes.maketrans(b'ATCGNatcgn', b'TAGCNtagcn')


def revcomp(seq: str) -> str:
    """Reverse-complement (parity: scripts/HapHiC_build.py:126-129)."""
    return seq.encode()[::-1].translate(_COMPLEMENT).decode()


def expand_RE_sites(sites: List[str]) -> List[str]:
    """Expand each 'N' in RE motifs to A/T/C/G.

    Same semantics as the recursive expansion in the reference
    (scripts/HapHiC_cluster.py:56-72): one N replaced per pass, in
    A/T/C/G order, until no N remains.
    """
    out = []
    pending = list(sites)
    while pending:
        site = pending.pop(0)
        idx = site.find('N')
        if idx < 0:
            out.append(site)
        else:
            for base in 'ATCG':
                pending.append(site[:idx] + base + site[idx + 1:])
    return out


def parse_RE(RE: str) -> List[str]:
    """Split a comma-separated RE motif string and expand Ns
    (parity: scripts/HapHiC_cluster.py:75-78)."""
    sites = [s.strip().upper() for s in RE.split(',') if s.strip()]
    return expand_RE_sites(sites)


def count_RE_sites(seq: str, RE: str = 'GATC') -> int:
    """Count (possibly overlapping motif families, non-overlapping per
    motif) restriction sites, reference-compatible
    (scripts/HapHiC_cluster.py:75-84). No +1 pseudo-count here."""
    return sum(seq.count(site) for site in parse_RE(RE))


@dataclass
class Assembly:
    """Columnar contig table (+ optional sequences).

    names       list[str], lexicographically sorted
    name2id     dict[str,int]
    lengths     int64[n]
    re_sites    int64[n]  (includes the +1 pseudo-count, as the
                reference stores in fa_dict[ctg][2],
                scripts/HapHiC_cluster.py:109-111)
    seqs        optional list[str | None] aligned with names
    input_order dict[str,int] original FASTA order (AGP/unanchored output
                in the reference follows fa_dict insertion order,
                scripts/HapHiC_build.py:146-150)
    """

    names: List[str]
    name2id: Dict[str, int]
    lengths: np.ndarray
    re_sites: np.ndarray
    seqs: Optional[List[Optional[str]]] = None
    input_order: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.names)

    @property
    def total_len(self) -> int:
        return int(self.lengths.sum())

    def length_of(self, name: str) -> int:
        return int(self.lengths[self.name2id[name]])

    def re_of(self, name: str) -> int:
        return int(self.re_sites[self.name2id[name]])

    def seq_of(self, name: str) -> str:
        assert self.seqs is not None, 'sequences were dropped'
        seq = self.seqs[self.name2id[name]]
        assert seq is not None
        return seq

    def drop_seqs(self) -> None:
        self.seqs = None

    def names_by_input_order(self) -> List[str]:
        return sorted(self.names, key=lambda c: self.input_order[c])

    def pos_int_type(self) -> str:
        """int32/int64 decision for positions
        (parity: scripts/HapHiC_cluster.py:116-147)."""
        max_len = int(self.lengths.max()) if len(self.names) else 0
        return 'int64' if max_len > 2 ** 31 - 1 else 'int32'

    def dist_int_type(self) -> str:
        if len(self.names) < 2:
            top2 = int(self.lengths.max()) if len(self.names) else 0
        else:
            srt = np.sort(self.lengths)
            top2 = int(srt[-1] + srt[-2])
        return 'int64' if top2 > 2 ** 31 - 1 else 'int32'


def iter_fasta(path: str):
    """Yield (name, sequence) from a (optionally gzipped) FASTA file."""
    opener = gzip.open if path.endswith('.gz') else open
    name = None
    chunks: List[str] = []
    with opener(path, 'rt') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith('>'):
                if name is not None:
                    yield name, ''.join(chunks)
                name = line.split()[0][1:]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, ''.join(chunks)


def read_fasta(path: str, RE: str = 'GATC', keep_seqs: bool = True,
               keep_letter_case: bool = False) -> Assembly:
    """Parse a FASTA into an :class:`Assembly`.

    Parity notes (scripts/HapHiC_cluster.py:87-113):
      * sequences are uppercased unless ``keep_letter_case``;
      * RE-site counts carry a +1 pseudo-count;
      * the first whitespace-delimited token after '>' is the name.
    """
    raw: Dict[str, str] = {}
    order: Dict[str, int] = {}
    for i, (name, seq) in enumerate(iter_fasta(path)):
        raw[name] = seq if keep_letter_case else seq.upper()
        order[name] = i

    names = sorted(raw)
    name2id = {c: i for i, c in enumerate(names)}
    lengths = np.array([len(raw[c]) for c in names], dtype=np.int64)
    # count on uppercase so softmasked input still matches motifs
    re_sites = np.array(
        [count_RE_sites(raw[c] if not keep_letter_case else raw[c].upper(), RE) + 1
         for c in names], dtype=np.int64)
    seqs: Optional[List[Optional[str]]] = [raw[c] for c in names] if keep_seqs else None
    return Assembly(names=names, name2id=name2id, lengths=lengths,
                    re_sites=re_sites, seqs=seqs, input_order=order)


def write_fasta(path: str, records, max_width: int = 60) -> None:
    """Write (name, seq) records wrapped at ``max_width``
    (parity: scripts/HapHiC_build.py:158-168)."""
    with open(path, 'w') as f:
        for name, seq in records:
            f.write('>{}\n'.format(name))
            for i in range(0, len(seq), max_width):
                f.write(seq[i:i + max_width])
                f.write('\n')

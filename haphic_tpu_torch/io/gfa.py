"""GFA ingest: read depth + haplotype phasing info from hifiasm GFAs.

Parity: scripts/HapHiC_cluster.py:150-185. Returns columnar arrays keyed
by the Assembly's contig ids plus a name-keyed dict for contigs that are
in the GFA but not the FASTA (the reference tolerates those with a
warning).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from haphic_tpu_torch.io.fasta import Assembly

logger = logging.getLogger(__name__)


def read_gfas(gfa_list: List[str], asm: Assembly
              ) -> Dict[str, Tuple[int, int]]:
    """Parse S-lines of one or more GFA files.

    Returns ``{ctg: (hap_index, read_depth)}`` where ``hap_index`` is the
    position of the GFA file in ``gfa_list`` (phasing information) —
    mirrors the reference's read_depth_dict.

    Raises RuntimeError on FASTA/GFA length mismatch or missing contigs,
    exactly like the reference (scripts/HapHiC_cluster.py:164-177).
    """
    depth: Dict[str, Tuple[int, int]] = {}
    for n, gfa in enumerate(gfa_list):
        with open(gfa) as f:
            for line in f:
                if not line.startswith('S\t'):
                    continue
                cols = line.rstrip('\n').split('\t')
                ctg = cols[1]
                ctg_len = int(cols[3].split(':')[-1])
                read_depth = int(cols[4].split(':')[-1])
                if ctg in asm.name2id and ctg_len != asm.length_of(ctg):
                    raise RuntimeError(
                        'The contig {} in gfa file {} has a different length than '
                        'the one in the fasta file. Maybe the gfa file(s) does not '
                        'match the fasta file.'.format(ctg, gfa))
                depth[ctg] = (n, read_depth)

    for ctg in asm.names:
        if ctg not in depth:
            raise RuntimeError(
                'Can not find contig {} in the gfa file(s). Maybe the gfa '
                'file(s) does not match the fasta file.'.format(ctg))

    if len(depth) > len(asm.names):
        logger.warning(
            'The number of contigs in the gfa file(s) (%d) is greater than that '
            'in the fasta file (%d).', len(depth), len(asm.names))
    return depth


def depth_arrays(depth: Dict[str, Tuple[int, int]], names: List[str]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Columnarize a read-depth dict over ``names`` → (hap[n], depth[n])."""
    hap = np.zeros(len(names), dtype=np.int32)
    dep = np.zeros(len(names), dtype=np.int64)
    for i, name in enumerate(names):
        h, d = depth[name]
        hap[i] = h
        dep[i] = d
    return hap, dep

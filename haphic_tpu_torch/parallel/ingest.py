"""Rank-sharded alignment ingest: port of haphic_tpu/parallel/ingest.py.

The reference parses all read pairs in one Python process
(scripts/HapHiC_cluster.py:1596-1752, htslib decoder threads only). With
N ranks (parallel/mesh.py):

  1. every rank streams the SAME alignment file but consumes only the
     chunks whose global ordinal = its rank (mod N): deterministic,
     seek-free sharding that works for pairs, bgzipped pairs and BAM
     readers alike;
  2. each rank aggregates its shard with the vectorized LinkAccumulator
     (core/contacts.py), passing the chunk ordinal so CLM/coord
     insertion-order keys are globally exact;
  3. the partial link tensors are exchanged once (all_gather_object of
     each rank's LinkData over the mesh's group: O(nnz), nothing scales
     with read count) and merged on every rank with `merge_link_data`,
     which reproduces the single-process result: COO counts and CLM
     byte order exactly; coord-pair sampling keeps the first
     max_read_pairs per pair in true stream order.

The merges are the JAX package's numpy, with the port's imports.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import (CLMData, COO, CoordPairs,
                                            LinkAccumulator, LinkData)
from haphic_tpu_torch.core.fragments import Fragments
from haphic_tpu_torch.io.pairs import AlignChunk
from haphic_tpu_torch.parallel.mesh import all_gather_object

logger = logging.getLogger(__name__)


def strided_chunks(chunks: Iterable[AlignChunk], n_shards: int,
                   shard_id: int) -> Iterator[Tuple[int, AlignChunk]]:
    """(global ordinal, chunk) for this shard of the stream."""
    for seq, chunk in enumerate(chunks):
        if seq % n_shards == shard_id:
            yield seq, chunk


def aggregate_shard(chunks: Iterable[AlignChunk], frags: Fragments,
                    n_shards: int, shard_id: int, flank_kbp: int = 0,
                    need_coords: bool = False, max_read_pairs: int = 200,
                    keep_clm: bool = True,
                    track_ctg_pair_to_frag: bool = False) -> LinkData:
    """One rank's share of the alignment pass."""
    acc = LinkAccumulator(frags, flank_kbp=flank_kbp,
                          need_coords=need_coords,
                          max_read_pairs=max_read_pairs, keep_clm=keep_clm)
    acc.track_ctg_pair_to_frag = track_ctg_pair_to_frag
    for seq, chunk in strided_chunks(chunks, n_shards, shard_id):
        acc.consume(chunk, seq=seq)
    return acc.finalize()


def _merge_coo(parts: List[COO], stride: int) -> COO:
    keys = np.concatenate([p.i * stride + p.j for p in parts]) \
        if parts else np.zeros(0, np.int64)
    w = np.concatenate([p.w for p in parts]) if parts else np.zeros(0)
    order = np.argsort(keys, kind='stable')
    keys, w = keys[order], w[order]
    uk, start = np.unique(keys, return_index=True)
    sw = np.add.reduceat(w, start) if len(w) else w
    return COO(i=uk // stride, j=uk % stride, w=sw)


def _merge_clm(parts: List[CLMData], n: int) -> Optional[CLMData]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    keys = np.concatenate([p.pair_i * n + p.pair_j for p in parts])
    d = np.concatenate([p.d for p in parts], axis=1)
    order = np.argsort(keys, kind='stable')
    keys, d = keys[order], d[:, order]
    # first-seen = min global order key per pair across shards
    uk_list = np.concatenate([p.u_keys for p in parts])
    uf_list = np.concatenate([p.u_first_seen for p in parts])
    o2 = np.lexsort((uf_list, uk_list))
    uk_list, uf_list = uk_list[o2], uf_list[o2]
    uk, first = np.unique(uk_list, return_index=True)
    return CLMData(pair_i=(keys // n).astype(np.int64),
                   pair_j=(keys % n).astype(np.int64), d=d,
                   u_keys=uk, u_first_seen=uf_list[first])


def _merge_coords(parts: List[CoordPairs], n: int,
                  max_read_pairs: int) -> Optional[CoordPairs]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    ckey = np.concatenate([p.pair_i * n + p.pair_j for p in parts])
    cci = np.concatenate([p.ci for p in parts])
    ccj = np.concatenate([p.cj for p in parts])
    have_okey = all(p.okey is not None for p in parts)
    if have_okey:
        okey = np.concatenate([p.okey for p in parts])
        order = np.lexsort((okey, ckey))
        okey = okey[order]
    else:
        order = np.argsort(ckey, kind='stable')
        okey = None
    ckey, cci, ccj = ckey[order], cci[order], ccj[order]

    # true totals (pre-cap) per pair, summed across shards
    tkey = np.concatenate([p.total_counts_i for p in parts])
    tcnt = np.concatenate([p.total_counts for p in parts])
    o2 = np.argsort(tkey, kind='stable')
    tkey, tcnt = tkey[o2], tcnt[o2]
    upk, tstart = np.unique(tkey, return_index=True)
    total = np.add.reduceat(tcnt, tstart) if len(tcnt) else tcnt

    # re-apply the per-pair cap in global stream order
    _, starts, counts = np.unique(ckey, return_index=True,
                                  return_counts=True)
    rank = np.arange(len(ckey)) - np.repeat(starts, counts)
    keep = rank < max_read_pairs
    ckey, cci, ccj = ckey[keep], cci[keep], ccj[keep]
    if okey is not None:
        okey = okey[keep]
    upk2, starts2, cnt2 = np.unique(ckey, return_index=True,
                                    return_counts=True)
    assert np.array_equal(upk, upk2)
    return CoordPairs(pair_i=(ckey // n).astype(np.int64),
                      pair_j=(ckey % n).astype(np.int64),
                      ci=cci, cj=ccj,
                      total_counts_i=upk, total_counts=total,
                      starts=starts2, counts=cnt2,
                      upair_i=(upk // n).astype(np.int64),
                      upair_j=(upk % n).astype(np.int64),
                      okey=okey)


def merge_link_data(parts: List[LinkData],
                    max_read_pairs: int = 200) -> LinkData:
    """Merge per-shard LinkData into the single-process result."""
    assert parts
    n = parts[0].n_ctg
    m = parts[0].n_frag
    full = _merge_coo([p.full for p in parts], n)
    flank = _merge_coo([p.flank for p in parts], m)
    ht = _merge_coo([p.ht for p in parts], 2 * n)
    frag_links = np.sum([p.frag_links for p in parts], axis=0)
    clm = _merge_clm([p.clm for p in parts], n)
    coords = _merge_coords([p.coords for p in parts], n, max_read_pairs)
    p2f_parts = [p.ctg_pair_to_frag for p in parts
                 if p.ctg_pair_to_frag is not None]
    p2f = None
    if p2f_parts:
        pf = np.unique(np.concatenate(
            [np.stack([p.i, p.j], axis=1) for p in p2f_parts], axis=0),
            axis=0)
        p2f = COO(i=pf[:, 0], j=pf[:, 1], w=np.ones(len(pf)))
    return LinkData(n_ctg=n, n_frag=m, full=full, flank=flank,
                    frag_links=frag_links, ht=ht, clm=clm, coords=coords,
                    ctg_pair_to_frag=p2f)


# ---------------------------------------------------------------------------
# exchange between ranks
# ---------------------------------------------------------------------------


def exchange_link_data(local: LinkData, mesh,
                       max_read_pairs: int = 200) -> LinkData:
    """Gather every rank's partial LinkData and merge. Each rank ends up
    with the identical, complete link tensors, including coord pairs
    (allelic/concentrated pruning evidence, reference record_coord_pairs
    scripts/HapHiC_cluster.py:454-471) and the ctg-pair -> frag-pair
    map."""
    if mesh.world == 1:
        return local
    c = local.coords
    if c is not None and c.okey is None:
        # the merge re-applies the per-pair cap in stream order
        # (okey); a rank whose stride got no chunk has no records and no
        # keys, and an empty key array stands in
        assert len(c.ci) == 0, \
            'coords exchange requires stream-order keys (okey)'
        local = replace(local, coords=replace(c, okey=np.zeros(0, np.int64)))
    return merge_link_data(all_gather_object(mesh, local),
                           max_read_pairs=max_read_pairs)


def distributed_aggregate(chunks: Iterable[AlignChunk], frags: Fragments,
                          mesh, flank_kbp: int = 0,
                          need_coords: bool = False,
                          max_read_pairs: int = 200, keep_clm: bool = True,
                          track_ctg_pair_to_frag: bool = False) -> LinkData:
    """Rank-sharded alignment pass over ``mesh``: shard by rank,
    aggregate locally, exchange and merge. Drop-in replacement for
    core.contacts.aggregate in a multi-process run."""
    local = aggregate_shard(chunks, frags, mesh.world, mesh.rank,
                            flank_kbp=flank_kbp, need_coords=need_coords,
                            max_read_pairs=max_read_pairs,
                            keep_clm=keep_clm,
                            track_ctg_pair_to_frag=track_ctg_pair_to_frag)
    return exchange_link_data(local, mesh, max_read_pairs=max_read_pairs)

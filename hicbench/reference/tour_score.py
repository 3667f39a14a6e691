"""The plain reference of the sort stage's objective: the score of a
tour of one group, written from the CLM's statement (HapHiC_cluster.py's
CLM lines; ALLHiC's objective), in plain torch, imports nothing of the
program.

A CLM record is one read pair between contigs a < b with the distance
d[c] that the pair would span were the two contigs adjacent in the
orientation combination c = 2 o_a + o_b, a first ((+,+), (+,-), (-,+),
(-,-)). In a tour the pair spans d[c] + G, G the length of the contigs
strictly between a and b; where b comes first, the tour read backwards
puts a first with both orientations flipped: c = 2 (1 - o_a) + (1 -
o_b). The score is

    score(tour) = sum_r w_r / max(d[c_r] + G_r, 1)

over the group's raw records (w_r = 1 each, duplicates not collapsed).
Positions and lengths are exact int64; the division and the sum are in
``dtype`` (float64; the control takes bfloat16).
"""

from __future__ import annotations

import torch


def score(order, ori, lengths, a, b, d, w=None, dtype=torch.float64):
    """The score of one tour.

    order   int64 [k]: the group's local contig ids in tour order
    ori     int64 [k]: their orientations, 0 (+) or 1 (-)
    lengths int64 [k]: length of each local contig id
    a, b    int64 [R]: each record's contigs, local ids, a < b
    d       int64 [4, R]: each record's four distances
    w       [R] or None (1 each)
    """
    k = lengths.numel()
    dev = lengths.device
    slot = torch.empty(k, dtype=torch.int64, device=dev)
    slot[order] = torch.arange(k, device=dev)
    o = torch.empty(k, dtype=torch.int64, device=dev)
    o[order] = ori.to(torch.int64)
    span = lengths[order]
    start = torch.empty(k, dtype=torch.int64, device=dev)
    start[order] = torch.cumsum(span, 0) - span
    a_first = slot[a] < slot[b]
    gap = torch.where(a_first, start[b] - start[a] - lengths[a],
                      start[a] - start[b] - lengths[b])
    combo = torch.where(a_first, 2 * o[a] + o[b],
                        2 * (1 - o[a]) + (1 - o[b]))
    dist = torch.gather(d, 0, combo[None])[0] + gap
    num = torch.ones((), dtype=dtype, device=dev) if w is None \
        else w.to(dtype)
    return (num / dist.clamp(min=1).to(dtype)).sum()

"""The plain reference of the dense MCL sweep, in plain PyTorch.

The algorithm of HapHiC's ``mcl`` (scripts/HapHiC_cluster.py:1987-2095)
as the port states it (``haphic_tpu_torch/cluster/mcl.py``), written
here from that statement and importing nothing of the program:

    pre     A + I column-normalised, raised to the expansion power once
    it 0    inflate (x^r on positive entries, column L1-normalise) and
            prune (keep x >= pruning and the first argmax row of each
            column, renormalise)
    it >= 1 expand (matrix power), inflate, prune; from it 2 on the
            matrix has converged when max(|new - old| - 1e-5 |old|)
            <= 1e-8, which freezes it with n_iters = it + 1
    result  attractors are rows with a non-zero diagonal; each one's
            cluster is the columns that are non-zero in its row; None
            unless the clusters are an exact partition.

FP32, with TF32 off unless ``tf32`` (the control: the nearest precision
below the configuration's FP32).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

RTOL = 1e-5
CONVERGED = 1e-8


def adjacency(ci, cj, cw, n: int, device) -> torch.Tensor:
    i = torch.as_tensor(np.asarray(ci, np.int64), device=device)
    j = torch.as_tensor(np.asarray(cj, np.int64), device=device)
    w = torch.as_tensor(np.asarray(cw, np.float32), device=device)
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    a.index_put_((i, j), w, accumulate=True)
    a.index_put_((j, i), w, accumulate=True)
    a += torch.eye(n, dtype=torch.float32, device=device)
    return a


def colnorm(m: torch.Tensor) -> torch.Tensor:
    s = m.sum(dim=-2, keepdim=True)
    return m * torch.where(s > 0, 1.0 / s, torch.zeros_like(s))


def inflate(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    pos = m > 0
    p = torch.where(pos, torch.exp(r * torch.log(
        torch.where(pos, m, torch.ones_like(m)))), torch.zeros_like(m))
    return colnorm(p)


def prune(m: torch.Tensor, pruning: float) -> torch.Tensor:
    keep = m >= pruning
    keep.scatter_(-2, torch.argmax(m, dim=-2, keepdim=True), True)
    return colnorm(torch.where(keep, m, torch.zeros_like(m)))


def power(m: torch.Tensor, e: int) -> torch.Tensor:
    out = m
    for _ in range(e - 1):
        out = torch.matmul(out, m)
    return out


def clusters(nz: np.ndarray) -> Optional[List[tuple]]:
    """The partition a final matrix's nonzero pattern ``nz`` (n, n)
    gives, or None."""
    n = nz.shape[0]
    found = {tuple(np.flatnonzero(nz[a]).tolist())
             for a in np.flatnonzero(np.diagonal(nz))}
    members = [x for c in found for x in c]
    if len(members) != n or len(set(members)) != n:
        return None
    return sorted(found)


def sweep(ci, cj, cw, n: int, inflations: Sequence[float], expansion: int,
          max_iter: int, pruning: float, device, batch: int = 6,
          tf32: bool = False):
    """(partitions, n_iters) of every inflation."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        pre = power(colnorm(adjacency(ci, cj, cw, n, device)), expansion)
        parts, iters = [], []
        for s in range(0, len(inflations), batch):
            r = torch.tensor(list(inflations[s:s + batch]),
                             dtype=torch.float32,
                             device=device).view(-1, 1, 1)
            B = r.shape[0]
            m = prune(inflate(pre.expand(B, n, n), r), pruning)
            n_it = [max_iter] * B
            active = list(range(B))
            for it in range(1, max_iter):
                if not active:
                    break
                sel = torch.tensor(active, device=device)
                old = m[sel]
                new = prune(inflate(power(old, expansion), r[sel]), pruning)
                m[sel] = new
                if it >= 2:
                    stat = ((new - old).abs() - RTOL * old.abs()).amax(
                        dim=(-2, -1)).tolist()
                    for b, st in zip(list(active), stat):
                        if st <= CONVERGED:
                            n_it[b] = it + 1
                            active.remove(b)
                del old, new
            nz = (m != 0).cpu().numpy()
            del m
            parts += [clusters(nz[b]) for b in range(B)]
            iters += n_it
        return parts, iters
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def labels(part, n: int) -> Optional[np.ndarray]:
    if part is None:
        return None
    lab = np.empty(n, dtype=np.int64)
    for c, members in enumerate(part):
        lab[list(members)] = c
    return lab


def moved(got, want, n: int) -> int:
    """Fragments outside their best-matching reference cluster: n less
    the sum over ``got``'s clusters of the largest overlap with one of
    ``want``'s; n where exactly one side is no partition."""
    a, b = labels(got, n), labels(want, n)
    if a is None or b is None:
        return 0 if a is None and b is None else n
    pair = a * (int(b.max()) + 1) + b
    keys, counts = np.unique(pair, return_counts=True)
    best = np.zeros(int(a.max()) + 1, dtype=np.int64)
    np.maximum.at(best, keys // (int(b.max()) + 1), counts)
    return int(n - best.sum())

"""The plain reference of the sparse top-K MCL sweep, in plain PyTorch.

The algorithm as the port states it for its sparse engine
(``haphic_tpu_torch/cluster/sparse_mcl.py``, its docstring: HipMCL's
selection pruning on HapHiC's ``mcl``, scripts/HapHiC_cluster.py:
1987-2095) and as ``reference/mcl_dense.py`` states the dense sweep,
written here from those statements and importing nothing of the
program. Every column holds at most K entries:

    input   A + I, column-normalised; each column's K largest entries
            kept (ties to the lower row) and renormalised
    pre     e - 1 times: C <- A C, column by column: the product
            column, inflation 1, the L1 normalisation, the K cap, no
            threshold
    it 0    inflate (x^r, L1-normalise) and prune only
    it >= 1 each column: the exact product column (M^e)[:, j] (for
            e > 2, the e - 2 first products as in pre), x^r, the L1
            normalisation over the whole column, the K largest entries
            (ties to the lower row), the prune (keep x >= pruning and
            the column's first argmax), the renormalisation; from it 2
            on, the inflation has converged when max(|new - old| -
            1e-5 |old|) over the union of the old and new columns'
            supports is <= 1e-8, which freezes it with n_iters = it + 1
    result  attractors are the rows with a nonzero diagonal; each
            one's cluster the columns nonzero in its row; None unless
            the clusters are an exact partition.

Values are f32; each product column is summed in f64 (a product of two
f32 values is exact there) and rounded to f32 once; x^r is taken in f64
of that f32 value and rounded to f32.

How it computes: each inflation's iterate as an (n + 1, W) table of
row ids (n: none) and values, its entries first in each row of the
table; the active inflations stacked and taken in blocks of columns of
at most ``CANDIDATES`` products: for each entry (a, j) of a column j,
every entry of column a (exactly the column's products, none from
padding), summed by (column, row) key, then each column's operations on
its summed entries. The control, ``bf16``, rounds the input and every
iterate to bfloat16 after each step (the pre-expansion's, iteration 0's
and each later one's).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

RTOL = 1e-5
CONVERGED = 1e-8
CANDIDATES = 1 << 27        # products a block, about 9 GB of temporaries

Table = Tuple[torch.Tensor, torch.Tensor]   # (ncols, W) int64 ids, f32


def _table(cols: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
           ncols: int, n: int) -> Table:
    """(ncols, W) ids and f32 values from entries sorted by column."""
    counts = torch.bincount(cols, minlength=ncols)
    W = max(1, int(counts.max())) if cols.numel() else 1
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cols.numel(), device=cols.device) - start[cols]
    idx = torch.full((ncols, W), n, dtype=torch.int64, device=cols.device)
    val = torch.zeros((ncols, W), dtype=torch.float32, device=cols.device)
    idx[cols, slot] = rows
    val[cols, slot] = vals.to(torch.float32)
    return idx, val


def initial(ci, cj, cw, n: int, K: int, device) -> Table:
    """A + I column-normalised, each column's K largest entries (ties
    to the lower row) renormalised: an (n + 1, W) table, column n
    empty."""
    i = torch.as_tensor(np.asarray(ci, np.int64), device=device)
    j = torch.as_tensor(np.asarray(cj, np.int64), device=device)
    w = torch.as_tensor(np.asarray(cw, np.float64), device=device)
    off = i != j
    diag = torch.arange(n, device=device)
    rows = torch.cat([i, j[off], diag])
    cols = torch.cat([j, i[off], diag])
    vals = torch.cat([w, w[off], torch.ones(n, dtype=torch.float64,
                                            device=device)])
    # repeated pairs summed, the entries ordered by (column, row)
    key, at = torch.unique(cols * n + rows, sorted=True, return_inverse=True)
    vals = torch.zeros(key.numel(), dtype=torch.float64,
                       device=device).index_add_(0, at, vals)
    cols, rows = key // n, key % n
    vals = vals / torch.zeros(n, dtype=torch.float64, device=device
                              ).index_add_(0, cols, vals)[cols]
    # by column, then value descending, then row: two stable sorts of
    # the (column, row)-ordered entries
    o = torch.sort(-vals, stable=True).indices
    o = o[torch.sort(cols[o], stable=True).indices]
    cols, rows, vals = cols[o], rows[o], vals[o]
    counts = torch.bincount(cols, minlength=n)
    rank = torch.arange(cols.numel(), device=device) - \
        (torch.cumsum(counts, 0) - counts)[cols]
    keep = rank < K
    cols, rows, vals = cols[keep], rows[keep], vals[keep]
    vals = vals / torch.zeros(n, dtype=torch.float64, device=device
                              ).index_add_(0, cols, vals)[cols]
    return _table(cols, rows, vals, n + 1, n)


def _power(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x^r in f32 of the f64 sums x, rounded to f32 first: taken in f64,
    so that equal entries stay equal wherever they lie (a vectorised f32
    power can differ by an ulp by position); 0 stays 0."""
    return torch.pow(x.to(torch.float32).to(torch.float64),
                     r.to(torch.float64)).to(torch.float32)


def _columns(col: torch.Tensor, row: torch.Tensor, val: torch.Tensor,
             c: int, r: torch.Tensor, pruning: Optional[float], K: int,
             n: int, old: Optional[Table], bf16: bool):
    """The next c columns from their candidates: entries (col, row)
    with f64 values, summed by (column, row). ``r`` (c,) the
    inflations; ``pruning`` None: no threshold; ``old`` the (c, Wo)
    columns before. Returns the (c, W) table and, with ``old``, each
    column's statistic (c,) f64 (-inf for an empty pair)."""
    dev = col.device
    key, at = torch.unique(col * n + row, sorted=True, return_inverse=True)
    x = torch.zeros(key.numel(), dtype=torch.float64,
                    device=dev).index_add_(0, at, val)
    del at
    col, row = key // n, key % n
    p = _power(x, r[col])
    del x, key
    nz = p > 0
    col, row, p = col[nz], row[nz], p[nz]

    def colsum(v):
        return torch.zeros(c, dtype=torch.float64, device=dev).index_add_(
            0, col, v.to(torch.float64))

    def scaled(v):
        s = colsum(v)
        return v * torch.where(s > 0, 1.0 / s, 0.0).to(torch.float32)[col]

    p = scaled(p)
    # the cap: the K largest, ties to the lower row (the entries are in
    # (column, row) order; two stable sorts put each column's in value
    # order, ties by row)
    counts = torch.bincount(col, minlength=c)
    if bool((counts > K).any()):
        o = torch.sort(-p, stable=True).indices
        o = o[torch.sort(col[o], stable=True).indices]
        rank = torch.empty_like(o)
        rank[o] = torch.arange(o.numel(), device=dev) - \
            (torch.cumsum(counts, 0) - counts)[col[o]]
        keep = rank < K
        col, row, p = col[keep], row[keep], p[keep]
    if pruning is not None:
        mx = torch.zeros(c, dtype=p.dtype, device=dev).scatter_reduce_(
            0, col, p, 'amax', include_self=False)
        first = torch.full((c,), n, dtype=row.dtype,
                           device=dev).scatter_reduce_(
            0, col, torch.where(p == mx[col], row, n), 'amin')
        keep = (p >= pruning) | (row == first[col])
        col, row, p = col[keep], row[keep], p[keep]
        p = scaled(p)
    if bf16:
        p = p.to(torch.bfloat16).to(torch.float32)
        keep = p > 0
        col, row, p = col[keep], row[keep], p[keep]
    stat = None
    if old is not None:
        oj, ok = torch.nonzero(old[1] > 0, as_tuple=True)
        o_val = old[1][oj, ok].to(torch.float64)
        key, at = torch.unique(torch.cat([col * n + row,
                                          oj * n + old[0][oj, ok]]),
                               return_inverse=True)
        new_v = torch.zeros(key.numel(), dtype=torch.float64, device=dev)
        old_v = torch.zeros_like(new_v)
        new_v[at[:p.numel()]] = p.to(torch.float64)
        old_v[at[p.numel():]] = o_val
        stat = torch.full((c,), -torch.inf, dtype=torch.float64,
                          device=dev).scatter_reduce_(
            0, key // n, (new_v - old_v).abs() - RTOL * old_v, 'amax')
    return _table(col, row, p, c, n), stat


def _stack(tables: List[Table], n: int) -> Table:
    """The tables one under another, at the widest one's width."""
    W = max(t[0].shape[1] for t in tables)
    pad = [(torch.nn.functional.pad(i, (0, W - i.shape[1]), value=n),
            torch.nn.functional.pad(v, (0, W - v.shape[1])))
           for i, v in tables]
    return (torch.cat([i for i, _ in pad]), torch.cat([v for _, v in pad]))


def _step(src: List[Table], cols: List[Table], r: Sequence[float],
          pruning: Optional[float], K: int, n: int, bf16: bool,
          expand: bool = True, old: Optional[List[Table]] = None):
    """Each table of ``cols`` (one an inflation) multiplied by its
    ``src`` (with ``expand``; else its own entries), inflated by its
    ``r``, capped, pruned. Returns the new tables and, with ``old``,
    each inflation's statistic (a float)."""
    N = n + 1
    B = len(cols)
    C_i, C_v = _stack(cols, n)
    dev = C_i.device
    base = (torch.arange(B * N, device=dev) // N) * N
    if expand:
        S_i, S_v = _stack(src, n)
        s_cnt = (S_v > 0).sum(dim=1)
        ref = C_i + base[:, None]               # the referenced columns
        per_col = torch.where(C_v > 0, s_cnt[ref], 0).sum(dim=1)
    else:
        per_col = (C_v > 0).sum(dim=1)
    if old is not None:
        O_i, O_v = _stack(old, n)
    rr = torch.tensor(list(r), dtype=torch.float32, device=dev)
    # blocks of whole columns of at most CANDIDATES products (one column
    # at the least)
    cum = torch.cumsum(per_col, 0).cpu().numpy()
    bounds = [0]
    while bounds[-1] < B * N:
        done = int(cum[bounds[-1] - 1]) if bounds[-1] else 0
        nxt = int(np.searchsorted(cum, done + CANDIDATES, side='right'))
        bounds.append(min(B * N, max(nxt, bounds[-1] + 1)))
    parts, stats = [], []
    for g0, g1 in zip(bounds[:-1], bounds[1:]):
        jj, kk = torch.nonzero(C_v[g0:g1] > 0, as_tuple=True)
        v = C_v[g0:g1][jj, kk].to(torch.float64)
        if expand:
            a = ref[g0:g1][jj, kk]
            cnt = s_cnt[a]
            e = torch.repeat_interleave(torch.arange(a.numel(), device=dev),
                                        cnt)
            off = torch.arange(e.numel(), device=dev) - \
                (torch.cumsum(cnt, 0) - cnt)[e]
            col, row = jj[e], S_i[a[e], off]
            val = S_v[a[e], off].to(torch.float64) * v[e]
            del a, cnt, e, off
        else:
            col, row, val = jj, C_i[g0:g1][jj, kk], v
        t, st = _columns(col, row, val, g1 - g0,
                         rr[torch.arange(g0, g1, device=dev) // N], pruning,
                         K, n, None if old is None else
                         (O_i[g0:g1], O_v[g0:g1]), bf16)
        del col, row, val
        parts.append(t)
        stats.append(st)
    idx, val = _stack(parts, n)
    out = [(idx[k * N:(k + 1) * N], val[k * N:(k + 1) * N])
           for k in range(B)]
    if old is None:
        return out, None
    stat = torch.cat(stats).view(B, N).amax(dim=1).tolist()
    return out, stat


def partition(t: Table, n: int) -> Optional[List[tuple]]:
    """The clusters of a final iterate, or None unless they are an
    exact partition of the n columns."""
    idx, val = (x.cpu().numpy() for x in t)
    cols = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
    rows, vals = idx.ravel(), val.ravel()
    real = (rows < n) & (vals != 0) & (cols < n)
    rows, cols = rows[real], cols[real]
    attractor = np.zeros(n, dtype=bool)
    attractor[rows[rows == cols]] = True
    sel = attractor[rows]
    rows, cols = rows[sel], cols[sel]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    cuts = np.flatnonzero(np.diff(rows)) + 1
    found = {tuple(c.tolist()) for c in np.split(cols, cuts) if c.size}
    members = [x for c in found for x in c]
    if len(members) != n or len(set(members)) != n:
        return None
    return sorted(found)


def sweep(ci, cj, cw, n: int, inflations: Sequence[float], expansion: int,
          max_iter: int, pruning: float, K: int, device,
          bf16: bool = False):
    """(partitions, n_iters) of every inflation, the inflations
    independent of each other."""
    K = max(1, min(K, n))
    A = initial(ci, cj, cw, n, K, device)
    if bf16:
        A = (A[0], A[1].to(torch.bfloat16).to(torch.float32))
    pre = A
    for _ in range(expansion - 1):
        pre = _step([A], [pre], [1.0], None, K, n, bf16)[0][0]
    B = len(inflations)
    M, _ = _step([pre] * B, [pre] * B, inflations, pruning, K, n, bf16,
                 expand=False)
    n_iters = [max_iter] * B
    active = list(range(B))
    for it in range(1, max_iter):
        if not active:
            break
        src = [M[b] for b in active]
        cols = src
        for _ in range(expansion - 2):
            cols, _ = _step(src, cols, [1.0] * len(active), None, K, n,
                            bf16)
        new, stat = _step(src, cols, [inflations[b] for b in active],
                          pruning, K, n, bf16, old=src)
        for b, t in zip(list(active), new):
            M[b] = t
        if it >= 2:
            for b, st in zip(list(active), stat):
                if st <= CONVERGED:
                    n_iters[b] = it + 1
                    active.remove(b)
    return [partition(t, n) for t in M], n_iters

"""The sparse MCL engine's input ELL, built on the card: the CUDA
kernel's wrapper and its plain torch version.

Counterpart of ``coo_to_ell`` in haphic_tpu/cluster/sparse_mcl.py (:411),
host numpy in the JAX package; the port's ``cluster.sparse_mcl.coo_to_ell``
is one call of ``ell_build`` on either device. Shapes:

    i, j   int64 (E,)   the links' rows and columns, ids in [0, n)
    w      f64 (E,)     their weights
    -> idx int32 (n+1, K), val f32 (n+1, K), overflow, wide

the symmetric matrix of the links (each off-diagonal link mirrored), a
self-loop of weight 1 on each of the n columns, duplicates summed, each
column divided by its sum, the K largest entries of a column wider than
K kept and divided by their own sum (``overflow`` counts those columns),
each column's entries in ascending row order padded with (n, 0); column
n empty. ``wide`` counts the columns of more than ``SMEM_MAX`` entries
before duplicates are summed: the kernel takes those through global
memory, the others in shared memory. The result is numpy's, bit for bit:
the order rules are in csrc/ell_build.cu's note.

``ell_build`` launches the CUDA kernel (csrc/ell_build.cu) on CUDA
tensors and runs ``ell_build_plain``, the kernel's stages in torch ops
(each column's entries by (row, entry), numpy's pairwise run sums, the
sums in order), on CPU tensors; nothing else picks the plain version.
On the card the wrapper reads six numbers from the card between its two
calls (the entries' total, the wide columns' scratch) and the overflow
count after them.

What bounds it: bytes. The links read once and the ELL written once at
3.35 TB/s; their upload from the host comes before, at the host link's
rate, apart (both in tools/kernelkit.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from haphic_tpu_torch.kernels import build as kbuild

SMEM_MAX = 4096            # widest column in shared memory (the .cu's)
PW_BLOCK = 128             # numpy's pairwise block
INFO = 6                   # numbers ell_build_count writes for the host


def _check(i, j, w, n: int, K: int):
    if i.dim() != 1 or j.shape != i.shape or w.shape != i.shape:
        raise ValueError('i, j, w: want three (E,) tensors, got {}, {}, {}'
                         .format(tuple(i.shape), tuple(j.shape),
                                 tuple(w.shape)))
    if i.dtype != torch.int64 or j.dtype != torch.int64 or \
            w.dtype != torch.float64:
        raise ValueError('i, j, w: want int64, int64, float64, got {}, {}, '
                         '{}'.format(i.dtype, j.dtype, w.dtype))
    if not (i.device == j.device == w.device):
        raise ValueError('i, j, w on {}, {}, {}: want one device'.format(
            i.device, j.device, w.device))
    if not (i.is_contiguous() and j.is_contiguous() and w.is_contiguous()):
        raise ValueError('i, j, w: want contiguous tensors')
    if not 0 <= n < 2 ** 31 - 1 or K < 1:
        raise ValueError('n = {}, K = {}: want 0 <= n < 2^31 - 1, K >= 1'
                         .format(n, K))
    if 2 * i.numel() + n >= 2 ** 32:
        raise ValueError('{} links and n = {}: the entries must number '
                         'under 2^32'.format(i.numel(), n))


def _bad_ids(what: str, n: int):
    return ValueError('{}: ids outside [0, n = {})'.format(what, n))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _pairwise(a: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of each row of ``a`` (R, m) f64, in numpy's
    order: from 0.0 one by one under 8 terms, by 8 accumulators up to
    128, past 128 the first h = m // 2 - (m // 2) % 8 terms plus the
    rest."""
    m = a.shape[1]
    if m > PW_BLOCK:
        h = m // 2
        h -= h % 8
        return _pairwise(a[:, :h]) + _pairwise(a[:, h:])
    if m < 8:
        r = torch.zeros(a.shape[0], dtype=a.dtype)
        for t in range(m):
            r = r + a[:, t]
        return r
    r = a[:, :8]
    m8 = m - m % 8
    for t in range(8, m8, 8):
        r = r + a[:, t:t + 8]
    res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + \
        ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    for t in range(m8, m):
        res = res + a[:, t]
    return res


def _run_sums(v: torch.Tensor, starts: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Each run's sum as np.add.reduceat gives it: its first term plus
    numpy's pairwise sum of the rest (a run of one: its term)."""
    out = v[starts].clone()
    for length in torch.unique(lengths).tolist():
        if length < 2:
            continue
        sel = torch.nonzero(lengths == length)[:, 0]
        first = starts[sel]
        rest = v[first[:, None] + torch.arange(1, length)]
        out[sel] = v[first] + _pairwise(rest)
    return out


def _in_order(keys: torch.Tensor, cols: torch.Tensor,
              n: int) -> torch.Tensor:
    """Each column's sum of ``keys`` one by one from 0.0, in the order the
    entries come; ``cols`` grouped by column, ascending."""
    counts = torch.bincount(cols, minlength=n + 1)
    pos = torch.arange(cols.numel()) - (torch.cumsum(counts, 0)
                                        - counts)[cols]
    order = torch.sort(pos, stable=True).indices
    total = torch.zeros(n + 1, dtype=torch.float64)
    at = 0
    # the t-th term of every column that has one, t = 0, 1, ...
    for many in torch.bincount(pos).tolist() if cols.numel() else []:
        sel = order[at:at + many]
        at += many
        total[cols[sel]] = total[cols[sel]] + keys[sel]
    return total


def _by_column(cols: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by column, stable over ``first``'s
    order (a permutation)."""
    return first[torch.sort(cols[first], stable=True).indices]


def ell_build_plain(i: torch.Tensor, j: torch.Tensor, w: torch.Tensor,
                    n: int, K: int) -> Tuple[torch.Tensor, torch.Tensor,
                                             int, int]:
    """The kernel's stages in torch ops, on CPU tensors."""
    _check(i, j, w, n, K)
    if bool(((i < 0) | (i >= n) | (j < 0) | (j >= n)).any()):
        raise _bad_ids('ell_build_plain', n)
    off = i != j
    loops = torch.arange(n)
    # the entries in numpy's order: links, mirrors, self-loops
    rows = torch.cat([i, j[off], loops])
    cols = torch.cat([j, i[off], loops])
    vals = torch.cat([w, w[off], torch.ones(n, dtype=torch.float64)])
    width = torch.bincount(cols, minlength=n + 1)
    # each column's bucket by (row, entry): the entries come in order
    o = _by_column(cols, torch.sort(rows, stable=True).indices)
    rows, cols, vals = rows[o], cols[o], vals[o]
    # the runs of one (column, row), each summed as np.add.reduceat
    new = torch.ones(rows.numel(), dtype=torch.bool)
    new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    starts = torch.nonzero(new)[:, 0]
    lengths = torch.diff(starts, append=torch.tensor([rows.numel()]))
    seg = _run_sums(vals, starts, lengths)
    ru, cu = rows[starts], cols[starts]
    # the column's sum in row order (np.add.at), and the division
    total = _in_order(seg, cu, n)
    seg = seg / torch.where(total > 0, total, 1.0)[cu]
    distinct = torch.bincount(cu, minlength=n + 1)
    capped = distinct > K
    # rank: value descending (NaN last), ties to the lower row
    o2 = _by_column(cu, torch.sort(-seg, stable=True).indices)
    c2, r2, v2 = cu[o2], ru[o2], seg[o2]
    rank = torch.arange(c2.numel()) - (torch.cumsum(distinct, 0)
                                       - distinct)[c2]
    keep = rank < K
    c2, r2, v2 = c2[keep], r2[keep], v2[keep]
    if bool(capped.any()):
        ksum = _in_order(v2, c2, n)
        v2 = torch.where(capped[c2],
                         v2 / torch.where(ksum > 0, ksum, 1.0)[c2], v2)
    # the kept entries in row order
    o3 = _by_column(c2, torch.sort(r2, stable=True).indices)
    c3, r3, v3 = c2[o3], r2[o3], v2[o3]
    kept = torch.bincount(c3, minlength=n + 1)
    slot = torch.arange(c3.numel()) - (torch.cumsum(kept, 0) - kept)[c3]
    idx = torch.full((n + 1, K), n, dtype=torch.int32)
    val = torch.zeros((n + 1, K), dtype=torch.float32)
    idx[c3, slot] = r3.to(torch.int32)
    val[c3, slot] = v3.to(torch.float32)
    return (idx, val, int(capped.sum()),
            int((width > SMEM_MAX).sum()))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fns():
    lib = kbuild.load('ell_build')
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    count, fill = lib.ell_build_count, lib.ell_build_fill
    count.argtypes = [vp, vp, i64, i32, vp, vp, vp, vp, vp]
    fill.argtypes = [vp, vp, vp, i64, i32, i32, i64] + [vp] * 13
    count.restype = fill.restype = i32
    return count, fill


def _raise_if(err: int, what: str):
    if err != 0:
        raise RuntimeError('ell_build kernel {} failed: CUDA error {}'
                           .format(what, err))


def ell_build(i: torch.Tensor, j: torch.Tensor, w: torch.Tensor, n: int,
              K: int) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(idx, val, overflow, wide) of the links ``i``, ``j``, ``w`` for a
    matrix of n columns at K: the CUDA kernel on CUDA tensors (idx, val
    on the card), the plain version on CPU tensors."""
    dev = w.device
    if dev.type == 'cpu':
        return ell_build_plain(i, j, w, n, K)
    _check(i, j, w, n, K)
    if dev.type != 'cuda':
        raise ValueError('unsupported device {}'.format(dev))
    count, fill = _fns()
    E = i.numel()

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cursor, start = empty(n + 1, torch.int32), empty(n + 2, torch.int32)
        woff, info = empty(n + 1, torch.int64), empty(INFO, torch.int64)
        _raise_if(count(i.data_ptr(), j.data_ptr(), E, n, cursor.data_ptr(),
                        start.data_ptr(), woff.data_ptr(), info.data_ptr(),
                        stream), 'count')
        total, wide, scratch, pmax, bad, widest = info.tolist()
        if bad:
            raise _bad_ids('ell_build', n)
        if widest >= 2 ** 31:
            raise ValueError('a column of {} entries: want under 2^31'
                             .format(widest))
        bucket = empty(total, torch.int32)
        wide_bufs = [empty(scratch, t) for t in (
            torch.int64, torch.float64, torch.float64, torch.int32,
            torch.int32)]
        idx, val = empty((n + 1, K), torch.int32), empty((n + 1, K),
                                                         torch.float32)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        _raise_if(fill(i.data_ptr(), j.data_ptr(), w.data_ptr(), E, n, K,
                       pmax, start.data_ptr(), cursor.data_ptr(),
                       bucket.data_ptr(), woff.data_ptr(),
                       *[b.data_ptr() for b in wide_bufs], idx.data_ptr(),
                       val.data_ptr(), overflow.data_ptr(), stream), 'fill')
        capped = int(overflow.item())
    ell_build.launches += 1
    return idx, val, capped, int(wide)


ell_build.launches = 0

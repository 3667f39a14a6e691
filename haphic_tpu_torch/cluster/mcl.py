"""Markov clustering on the card (torch).

Port of haphic_tpu/cluster/mcl.py. The whole inflation sweep is batched
on the leading axis, as there:

    expand  — batched f32 torch.matmul (TF32 off, see runtime.py)
    inflate — element-wise power on positive entries, then a column
              L1-normalise
    prune   — keep entries >= pruning plus the FIRST argmax row of each
              column, then renormalise
    converge— numpy.allclose semantics (|a-b| <= atol + rtol*|b|),
              checked from the third iteration, per-inflation freeze

Inflate, prune and the convergence statistic are one column pass,
kernels/mcl_column.py: a hand-written CUDA kernel on the card, its plain
torch version on the CPU.

Semantics parity notes (vs the reference `mcl`,
scripts/HapHiC_cluster.py:1987-2062):
  * iteration 0 skips expansion (the sweep pre-expands once);
  * prune restores the per-column argmax entry of the post-inflation
    matrix before re-normalising;
  * convergence is only checked from the third iteration (n > 1).

Matrices are not padded: PyTorch has no compile cache to reuse, so the
JAX package's power-of-two bucketing (_bucket_pad) and COO padding have
no counterpart here. A converged inflation freezes: it leaves the batch,
so later iterations compute only the active ones.

Reading the final matrices, ``run_mcl_partitions`` turns each batch's
final matrices into (B, n) cluster labels with kernels/mcl_interpret.py
(in place of the JAX package's packed pattern, ``_pack_nz``: the
hand-written CUDA kernel on the card, its plain torch version on the
CPU); only the labels cross to the host, and ``partition_from_labels``
builds each partition from its row with one stable sort: the same lists
as ``interpret_result``, which the numpy route below DEVICE_MIN_N keeps.
``run_mcl`` returns the whole matrices.

Tracing (``haphic_tpu_torch.trace``, off by default): on the torch route
``run_mcl_partitions`` is the span ``mcl.sweep`` (host and device); in
it the device spans ``mcl.densify`` (the matrix to the card),
``mcl.pre_expand``, and per batch ``mcl.batch``: on the host the batch's
whole turn (its iterations, its labels and its interpretation), on the
device its iterations alone. In the batch, ``mcl.pattern`` (host and
device: the labels, n_iters and converged to the host) and
``mcl.interpret`` (host: the partitions from the labels). ``mcl.expand``
(device) is every ``_matpower``, ``mcl.column`` (device) every
``mcl_column``. One counter is always on: ``run_mcl_partitions.syncs``
counts the points where the host waits for the card's stream: each copy
between host and card (a Python scalar written into a card tensor
included) and each boolean-mask index of a tensor.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from haphic_tpu_torch import trace
from haphic_tpu_torch.kernels.mcl_column import _colnorm, mcl_column
from haphic_tpu_torch.kernels.mcl_interpret import mcl_labels
from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)


def _matpower(m: torch.Tensor, e: int) -> torch.Tensor:
    out = m
    for _ in range(e - 1):
        out = torch.matmul(out, m)
    return out


def _mcl_batched(pre_expanded: torch.Tensor, inflations: torch.Tensor,
                 expansion: int, max_iter: int, pruning: float):
    """Run MCL for a batch of inflations from the pre-expanded matrix.

    pre_expanded: (n, n) column-normalised and expanded once
    inflations:   (B,) f32 on the same device
    Returns (final (B,n,n), n_iters (B,) int32, converged (B,) bool),
    on the device.
    """
    B = inflations.shape[0]
    n = pre_expanded.shape[-1]
    dev = pre_expanded.device
    # iteration 0: inflate + prune only
    with trace.device_span('mcl.column', dev, B=B, n=n, with_old=False):
        m, _ = mcl_column(pre_expanded[None].expand(B, n, n), inflations,
                          pruning)
    conv_at = torch.full((B,), max_iter, dtype=torch.int32,
                         device=m.device)
    converged = torch.zeros((B,), dtype=torch.bool, device=m.device)
    active = torch.arange(B, device=m.device)
    it = 1
    while it < max_iter and active.numel():
        whole = active.numel() == B
        cur = m if whole else m[active]
        with trace.device_span('mcl.expand', dev, B=cur.shape[0], n=n,
                               e=expansion):
            x = _matpower(cur, expansion)
        with trace.device_span('mcl.column', dev, B=cur.shape[0], n=n,
                               with_old=it >= 2):
            new, stat = mcl_column(x, inflations[active], pruning,
                                   old=cur if it >= 2 else None)
        # the expansion lives no longer than the column pass
        del x
        if whole:
            m = new
        else:
            m[active] = new
        # the last iterate and the copy of the active ones are not needed
        # past here: freed now, not when the next iteration rebinds them
        del cur, new
        if it >= 2:
            # five waits for the card: the three boolean-mask indexings,
            # and the copies to the card of the two Python scalars
            # written through them
            run_mcl_partitions.syncs += 5
            conv = stat <= 1e-8
            conv_at[active[conv]] = it + 1
            converged[active[conv]] = True
            active = active[~conv]
        it += 1
    return m, conv_at, converged


@dataclass
class MCLResult:
    matrices: np.ndarray      # (B, m, m) final matrices
    n_iters: np.ndarray       # (B,)
    converged: np.ndarray     # (B,)


# Below this n the sweep runs in numpy on the host. The value and its
# environment variable follow the JAX package so that the port routes
# work the same way; it changes only on H100 measurements (PERF.md).
DEVICE_MIN_N = int(os.environ.get('HAPHIC_DEVICE_MIN_N', 1024))


def _run_mcl_numpy(a: np.ndarray, inflations: np.ndarray, expansion: int,
                   max_iter: int, pruning: float) -> MCLResult:
    """Small-problem host path: identical semantics to `_mcl_batched`,
    in numpy (fp32), serial over inflations."""
    m = a.shape[0]

    def colnorm(x):
        s = x.sum(axis=0, keepdims=True)
        with np.errstate(divide='ignore'):
            inv = np.where(s > 0, 1.0 / s, 0.0)
        return x * inv

    def prune(x):
        argmax_rows = np.argmax(x, axis=0)
        keep = x >= pruning
        keep[argmax_rows, np.arange(x.shape[1])] = True
        return colnorm(np.where(keep, x, 0.0))

    def inflate(x, infl):
        with np.errstate(divide='ignore'):
            p = np.where(x > 0, np.exp(
                infl * np.log(np.where(x > 0, x, 1.0))), 0.0)
        return colnorm(p)

    pre = colnorm(a.astype(np.float32))
    pre = np.linalg.matrix_power(pre, expansion)

    B = len(inflations)
    mats = np.empty((B, m, m), dtype=np.float32)
    iters = np.empty((B,), dtype=np.int32)
    conv = np.empty((B,), dtype=bool)
    for b, infl in enumerate(inflations):
        mat = prune(inflate(pre, float(infl)))
        it, done = max_iter, False
        for i in range(1, max_iter):
            new = prune(inflate(
                np.linalg.matrix_power(mat, expansion), float(infl)))
            if i >= 2:
                d = np.abs(new - mat) - 1e-5 * np.abs(mat)
                if d.max() <= 1e-8:
                    mat, it, done = new, i + 1, True
                    break
            mat = new
        mats[b], iters[b], conv[b] = mat, it, done
    return MCLResult(matrices=mats, n_iters=iters, converged=conv)


def densify_coo(ci, cj, cw, m: int, device) -> torch.Tensor:
    """Symmetric dense (m, m) f32 adjacency with self loops, built on
    the device from the upper-triangle COO (counterpart of the JAX
    package's _densify_coo; twin of sweep.build_adjacency)."""
    dev = torch.device(device)
    i = torch.as_tensor(np.asarray(ci, np.int64), device=dev)
    j = torch.as_tensor(np.asarray(cj, np.int64), device=dev)
    w = torch.as_tensor(np.asarray(cw, np.float32), device=dev)
    a = torch.zeros((m, m), dtype=torch.float32, device=dev)
    a.index_put_((i, j), w, accumulate=True)
    a.index_put_((j, i), w, accumulate=True)
    diag = torch.arange(m, device=dev)
    a[diag, diag] += 1.0
    return a


def _coo_to_dense_np(ci, cj, cw, m):
    """Host twin of densify_coo (for the numpy small-n path)."""
    a = np.zeros((m, m), np.float32)
    np.add.at(a, (ci, cj), cw.astype(np.float32))
    np.add.at(a, (cj, ci), cw.astype(np.float32))
    np.fill_diagonal(a, a.diagonal() + 1.0)
    return a


def _batch_size(B: int, n: int, budget: int = 6 << 30) -> int:
    # ~4 live (B, n, n) f32 buffers in the loop
    return max(1, min(B, int(budget // max(4 * n * n * 4, 1))))


def _sweep(a: torch.Tensor, inflations, expansion, max_iter, pruning):
    """Yield (start, end, final matrices, n_iters, converged) per
    inflation batch, all on the device. The host span ``mcl.batch``
    stays open while the caller holds the batch."""
    n = a.shape[0]
    with trace.device_span('mcl.pre_expand', a.device, n=n):
        c = _colnorm(a)
        with trace.device_span('mcl.expand', a.device, B=1, n=n,
                               e=expansion):
            p = _matpower(c, expansion)
        del c
    # the copy waits for the pre-expansion
    infl = torch.as_tensor(np.asarray(inflations, np.float32),
                           device=a.device)
    run_mcl_partitions.syncs += 1
    B = infl.shape[0]
    chunk = _batch_size(B, n)
    for s in range(0, B, chunk):
        e = min(B, s + chunk)
        with trace.span('mcl.batch', B=e - s, n=n):
            with trace.device_span('mcl.batch', a.device, B=e - s, n=n):
                mm, ii, cc = _mcl_batched(p, infl[s:e], expansion,
                                          max_iter, float(pruning))
            yield s, e, mm, ii, cc


def run_mcl(adjacency: np.ndarray, inflations: Sequence[float],
            expansion: int = 2, max_iter: int = 200, pruning: float = 1e-4,
            device_min_n: Optional[int] = None,
            device=None) -> MCLResult:
    """Run the full inflation sweep and return the final matrices.

    ``adjacency`` is the dense symmetric link matrix *with self loops*
    (reference dict_to_matrix(add_self_loops=True)). Problems smaller
    than ``device_min_n`` (default DEVICE_MIN_N) run in numpy on the
    host.
    """
    dev = resolve_device(device)
    m = adjacency.shape[0]
    min_n = DEVICE_MIN_N if device_min_n is None else device_min_n
    if m < min_n:
        return _run_mcl_numpy(adjacency, np.asarray(inflations, np.float32),
                              expansion, max_iter, pruning)
    a = torch.as_tensor(adjacency.astype(np.float32), device=dev)
    run_mcl_partitions.syncs += 1
    B = len(inflations)
    mats = np.empty((B, m, m), dtype=np.float32)
    iters = np.empty((B,), dtype=np.int32)
    conv = np.empty((B,), dtype=bool)
    for s, e, mm, ii, cc in _sweep(a, inflations, expansion, max_iter,
                                   pruning):
        mats[s:e] = mm.cpu().numpy()
        iters[s:e] = ii.cpu().numpy()
        conv[s:e] = cc.cpu().numpy()
        run_mcl_partitions.syncs += 3
    return MCLResult(matrices=mats, n_iters=iters, converged=conv)


def run_mcl_partitions(adjacency: Optional[np.ndarray],
                       inflations: Sequence[float],
                       expansion: int = 2, max_iter: int = 200,
                       pruning: float = 1e-4,
                       device_min_n: Optional[int] = None,
                       coo=None, device=None):
    """Inflation sweep returning per-inflation cluster partitions
    (lists as interpret_result) plus (n_iters, converged). Only each
    final matrix's labels go to the host (module docstring).

    ``coo``: optional (ci, cj, cw, m) upper-triangle links — the matrix
    is then densified on the device and ``adjacency`` may be None."""
    dev = resolve_device(device)
    if coo is not None:
        ci, cj, cw, m = coo
        m = int(m)
    else:
        m = adjacency.shape[0]
    min_n = DEVICE_MIN_N if device_min_n is None else device_min_n
    if m < min_n:
        if coo is not None:
            adjacency = _coo_to_dense_np(ci, cj, cw, m)
        res = _run_mcl_numpy(adjacency,
                             np.asarray(inflations, np.float32),
                             expansion, max_iter, pruning)
        parts = [interpret_result(res.matrices[b])
                 for b in range(len(res.n_iters))]
        logger.info('MCL sweep on the host (numpy, n=%d < %d)', m, min_n,
                    extra={'metrics': {'mcl_route': 'host',
                                       'mcl_engine': 'dense', 'n': m,
                                       'n_iters': res.n_iters.tolist()}})
        return parts, res.n_iters, res.converged
    B = len(inflations)
    with trace.span('mcl.sweep', device=dev, n=m, B=B):
        with trace.device_span('mcl.densify', dev, n=m):
            if coo is not None:
                a = densify_coo(ci, cj, cw, m, dev)
                run_mcl_partitions.syncs += 3      # the links' copies
            else:
                a = torch.as_tensor(adjacency.astype(np.float32),
                                    device=dev)
                run_mcl_partitions.syncs += 1
        parts = []
        iters = np.empty((B,), dtype=np.int32)
        conv = np.empty((B,), dtype=bool)
        batches = []
        for s, e, mm, ii, cc in _sweep(a, inflations, expansion, max_iter,
                                       pruning):
            with trace.span('mcl.pattern', device=dev):
                labels = mcl_labels(mm).cpu().numpy()
                del mm
                iters[s:e] = ii.cpu().numpy()
                conv[s:e] = cc.cpu().numpy()
                run_mcl_partitions.syncs += 3
            batches.append(e - s)
            with trace.span('mcl.interpret'):
                parts.extend(partition_from_labels(x) for x in labels)
        logger.info('MCL sweep on %s (n=%d, %d inflations in batches %s)',
                    dev, m, B, batches,
                    extra={'metrics': {'mcl_route': dev.type,
                                       'mcl_engine': 'dense', 'n': m,
                                       'batches': batches,
                                       'n_iters': iters.tolist()}})
    return parts, iters, conv


# host waits for the card's stream on the torch route (module docstring)
run_mcl_partitions.syncs = 0


def partition_from_labels(labels: np.ndarray) -> Optional[list]:
    """The partition of one matrix from its row of ``mcl_labels``, equal
    to ``interpret_result`` of the matrix: None for a row of -1, else the
    columns grouped by label, each group an ascending tuple, the groups
    ordered by their least member (for disjoint tuples, sorted order)."""
    if labels[0] < 0:
        return None
    order = np.argsort(labels, kind='stable')
    lab = labels[order]
    start = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
    end = np.r_[start[1:], len(order)]
    by = np.argsort(order[start])          # a group's first is its least
    cols = order.tolist()
    return [tuple(cols[lo:hi])
            for lo, hi in zip(start[by].tolist(), end[by].tolist())]


def interpret_result(matrix: np.ndarray, tol: float = 0.0
                     ) -> Optional[list]:
    """Extract clusters from a converged MCL matrix.

    Attractors are rows with a non-zero diagonal; each attractor's
    cluster is the set of columns with non-zero entries in its row.
    Returns None when the clusters do not form an exact partition
    (parity: scripts/HapHiC_cluster.py:2065-2095).
    """
    m = matrix.shape[0]
    nz = matrix > tol if tol else matrix != 0
    attractors = np.nonzero(np.diagonal(nz))[0]
    clusters = set()
    for a in attractors:
        clusters.add(tuple(np.nonzero(nz[a])[0].tolist()))
    seen = set()
    for cluster in clusters:
        for node in cluster:
            if node in seen:
                return None
            seen.add(node)
    if len(seen) != m:
        return None
    return sorted(clusters)

"""Sparse Markov clustering on the card (torch): the scale path past
dense n².

Port of haphic_tpu/cluster/sparse_mcl.py. The reference clusters up to
~262k fragments (Ginkgo, reference README.md:317) with scipy CSC + MKL
SpGEMM (scripts/HapHiC_cluster.py:2017-2062); a dense (B, n, n)
formulation is ~274 GB per matrix at that n. This module keeps a *fixed
top-K per column* ELL layout — the "selection pruning" strategy of
HipMCL (Azad et al., "HipMCL: a high-performance parallel implementation
of the Markov clustering algorithm") — which bounds every shape:

    idx: int32 (n+1, K)   row ids of the ≤K entries of each column,
                          sorted ascending, sentinel n for padding
    val: f32   (n+1, K)   matching values (0 at sentinels)

Row and column n are always empty, so gathers through sentinel ids
land on an empty column. Memory is O(n·K) — 262k fragments at K=128 is
~270 MB per inflation instead of ~274 GB dense.

One MCL iteration per column j, written over tensors (B, chunk, L) —
inflations, columns, candidates (L = K² after expansion, K in the first
iteration, 2K in the convergence merge):
  expand   gather the K columns referenced by column j -> K² candidate
           (row, val·val) products
  dedupe   stable sort by row id + segmented run-sum (cumsum/cummax)
  inflate  val^inflation, exact column L1 normalization (pre-cap, so
           the normalizer sees the full expanded column)
  cap      the K largest entries — the only approximation vs the
           reference; exact when K ≥ the column's true support
  prune    threshold + keep-column-max + renormalize
           (reference prune semantics, scripts/HapHiC_cluster.py:1987)
  converge numpy.allclose semantics over the union of the old and new
           columns' row ids

The input ELL (``coo_to_ell``: the links' COO, mirrored, with self-loops,
duplicates summed, columns normalized and capped at K) is one call of
kernels.ell_build.ell_build: the hand-written CUDA kernel on the card,
its plain torch version on the CPU, both bit-equal to the JAX package's
host numpy.

Expand through prune are one call of kernels.sparse_column.sparse_column
per column chunk, and the convergence statistic one call of
kernels.col_allclose.col_allclose a step, over all the step's columns:
each the hand-written CUDA kernel on the card, and on the CPU its plain
version, the torch composition described below (the functions _expand,
_dedupe_sorted and _inflate_cap_prune live in kernels/sparse_column.py,
the statistic's sort and run sums in kernels/col_allclose.py).

Where JAX vmaps the per-column functions and streams columns through a
lax.scan, the port loops over fixed column chunks on the host, writing
into preallocated (B, n+1, K) outputs. The loop waits for the card once
a chunk, in sparse_column's check of the ELL order of the chunk's
columns (a bool of a tensor on the card). col_allclose checks the order
of the old and the new columns in its kernel, into a flag on the card
that the host loop reads with the iteration's statistic (``bad``).
Converged inflations leave the computed batch (as in the port's dense
sweep) but stay in the K-shrink statistic.

With a mesh (parallel/mesh.py) the column axis is sharded: N = n+1 is
padded with sentinel columns to a multiple of the world, each rank
holds its contiguous block of every iterate, all-gathers the whole
iterate once per step (the only bulk traffic) and computes its own
columns against it; the convergence statistic and the widest support
are max-reduced, so every rank takes the same convergence and K-shrink
decisions. The math is per column, so the iterates are the meshless
run's, bit for bit.

Where the plain version would differ from JAX unless careful (the
kernel keeps the same order and tie rules, and sums each run in f64 in
one pass; csrc/sparse_column.cu):
  * lax.sort with num_keys=1 is stable: every sort by row id is
    torch.sort(stable=True), payloads gathered by its indices;
  * lax.top_k puts the lower position first among equal values;
    torch.topk makes no promise about ties on CUDA, so the cap is a
    stable descending sort sliced at K;
  * run sums keep JAX's cumsum/cummax formulas (a scatter-add segment
    sum would round differently, and the convergence statistic is held
    to 1e-8), with the prefix sums in f64: XLA's f32 prefixes carry
    ~1e-7 of absolute error into every run, and PyTorch's would too, in
    another order on the CPU (f64 accumulation, rounded per prefix) than
    on the card (f32 parallel scan). In f64 each run is rounded once, on
    both, so the port agrees with XLA to XLA's own rounding.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from haphic_tpu_torch import trace
from haphic_tpu_torch.kernels.col_allclose import (
    col_allclose, col_allclose_plain, raise_if_unordered)
from haphic_tpu_torch.kernels.ell_build import ell_build
from haphic_tpu_torch.kernels.sparse_column import sparse_column
from haphic_tpu_torch.parallel.mesh import all_gather_cols, all_reduce_max
from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_K = 128

# the convergence statistic's plain version, under its JAX name
_col_allclose_stat = col_allclose_plain


# ---------------------------------------------------------------------------
# batched sweep
# ---------------------------------------------------------------------------


def _first_iteration(idx0: torch.Tensor, val0: torch.Tensor,
                     inflations: torch.Tensor, n: int, K: int,
                     pruning: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iteration 0: inflate + prune only, per inflation (the sweep
    pre-expands once, reference scripts/HapHiC_cluster.py:2144-2149).
    idx0/val0: (N, K), N = n+1; returns (B, N, K) idx/val."""
    B = inflations.shape[0]
    shape = (B,) + tuple(idx0.shape)
    i0, v0 = sparse_column(None, None, idx0.expand(shape),
                           val0.expand(shape), inflations, n, K, pruning,
                           expand=False)
    # sentinel column n stays empty
    i0[:, n] = n
    v0[:, n] = 0.0
    return i0, v0


def _sweep_cols(A_i, A_v, infl, n: int, K: int, chunk: int,
                pruning: float, expansion: int, c0: int = 0,
                c1: Optional[int] = None,
                bad: Optional[torch.Tensor] = None):
    """Expand→inflate→cap→prune for columns [c0, c1) of A (default: all
    of them) against the whole of A, in fixed column chunks. A_i/A_v:
    (B, N, K) per-inflation matrices; infl (B,). Returns (new_i, new_v,
    stat): (B, c1 - c0, K) columns and stat (B,) the per-inflation max
    allclose statistic over them, left on the card. The math is per
    column, so the chunk size and the block do not change the
    results. The statistic is taken once, over all the columns, after
    the chunk loop (one col_allclose launch a call). ``bad``:
    col_allclose's order flag, read by the caller (None: col_allclose
    reads its own)."""
    B, N = A_i.shape[0], A_i.shape[1]
    c1 = N if c1 is None else c1
    new_i = A_i.new_empty((B, c1 - c0, A_i.shape[2]))
    new_v = A_v.new_empty((B, c1 - c0, A_v.shape[2]))
    ones = torch.ones_like(infl)
    for s in range(c0, c1, chunk):
        e = min(c1, s + chunk)
        ci, cv = A_i[:, s:e], A_v[:, s:e]
        di, dv = ci, cv
        for _ in range(expansion - 2):
            # higher expansion powers: re-expand the capped column
            # (entries beyond K² fold through the cap)
            di, dv = sparse_column(A_i, A_v, di, dv, ones, n, K, 0.0,
                                   expand=True)
        ni, nv = sparse_column(A_i, A_v, di, dv, infl, n, K, pruning,
                               expand=True)
        del di, dv
        new_i[:, s - c0:e - c0] = ni
        new_v[:, s - c0:e - c0] = nv
    if c1 <= c0:
        return new_i, new_v, torch.full((B,), -torch.inf, device=A_v.device)
    # a max is exact in any order: one launch for every chunk's columns
    stat = col_allclose(A_i[:, c0:c1], A_v[:, c0:c1], new_i, new_v, n,
                        bad=bad)
    return new_i, new_v, stat.amax(dim=-1)


def _sweep_step(idx: torch.Tensor, val: torch.Tensor,
                inflations: torch.Tensor, active: np.ndarray, n: int,
                K: int, chunk: int, pruning: float, expansion: int,
                bad: Optional[torch.Tensor] = None):
    """One MCL iteration for the whole inflation batch on one card.
    Returns (new_idx, new_val, stat, max_nnz), all on the card, where
    stat is the per-inflation allclose statistic vs the input (≤1e-8 ⇒
    converged; -inf for frozen inflations, which the caller never
    reads). Frozen inflations (active=False, a host bool array) are not
    computed and pass through unchanged; the inputs are not modified.
    ``bad`` as in _sweep_cols."""
    sel = torch.as_tensor(np.flatnonzero(active), device=idx.device)
    ni, nv, st = _sweep_cols(idx[sel], val[sel], inflations[sel], n, K,
                             chunk, pruning, expansion, bad=bad)
    ni[:, n] = n
    nv[:, n] = 0.0
    new_idx, new_val = idx.clone(), val.clone()
    new_idx[sel] = ni
    new_val[sel] = nv
    stat = torch.full((idx.shape[0],), -torch.inf, device=val.device)
    stat[sel] = st
    # widest column support across the WHOLE batch, frozen inflations
    # included: the host loop shrinks K to it, and a max over the active
    # ones only would cut a frozen inflation's support
    max_nnz = (new_val > 0).sum(dim=-1).amax()
    return new_idx, new_val, stat, max_nnz


def _sharded_sweep_step(mesh, idx: torch.Tensor, val: torch.Tensor,
                        inflations: torch.Tensor, active: np.ndarray,
                        n: int, K: int, chunk: int, pruning: float,
                        expansion: int, bad: Optional[torch.Tensor] = None):
    """The multi-card twin of _sweep_step (the JAX package's
    _sharded_sweep_step, haphic_tpu/cluster/sparse_mcl.py:250-289).
    idx/val: this rank's (B, M, K) block of columns [rank·M, rank·M +
    M) of the padded iterate. The active inflations' blocks are
    all-gathered into the whole iterate A, this rank's columns go
    through _sweep_cols against it, and the statistic and the widest
    support are max-reduced over the ranks (one collective), so every
    rank gets the same (stat, max_nnz) and takes the same decisions; the
    order flag ``bad`` (as in _sweep_cols), where given, is reduced in the
    same collective. Returns (new_idx, new_val) blocks and (stat,
    max_nnz) reduced."""
    B, M = idx.shape[0], idx.shape[1]
    sel = torch.as_tensor(np.flatnonzero(active), device=idx.device)
    A_i = all_gather_cols(mesh, idx[sel])
    A_v = all_gather_cols(mesh, val[sel])
    c0 = mesh.rank * M
    ni, nv, st = _sweep_cols(A_i, A_v, inflations[sel], n, K, chunk,
                             pruning, expansion, c0, c0 + M, bad)
    del A_i, A_v
    if c0 <= n < c0 + M:
        ni[:, n - c0] = n
        nv[:, n - c0] = 0.0
    new_idx, new_val = idx.clone(), val.clone()
    new_idx[sel] = ni
    new_val[sel] = nv
    stat = torch.full((B,), -torch.inf, device=val.device)
    stat[sel] = st
    max_nnz = (new_val > 0).sum(dim=-1).amax()
    parts = [stat.double(), max_nnz.double().view(1)]
    if bad is not None:
        parts.append(bad.double())
    red = all_reduce_max(mesh, torch.cat(parts))
    if bad is not None:
        bad.copy_(red[B + 1:])
    return new_idx, new_val, red[:B], red[B]


def _run_sweep_batch(idx0: torch.Tensor, val0: torch.Tensor,
                     infl: torch.Tensor, n: int, K: int, chunk: int,
                     max_iter: int, pruning: float, expansion: int,
                     mesh=None):
    """Host convergence loop for one inflation batch. With ``mesh``,
    idx0/val0 are padded to a multiple of the world and each rank
    iterates its block of the columns (_sharded_sweep_step); the final
    iterates are gathered to every rank, without the padding.

    The working K shrinks to the next power of two over the actual
    widest column support whenever that halves — iteration cost is
    O(K²), and supports collapse rapidly as MCL concentrates, so the
    long convergence tail runs at a fraction of the initial width
    (entries are idx-sorted with sentinels last, so shrinking is a pure
    slice). At most three shrinks run, to a floor of K=16, as in the
    JAX package (where each is a fresh compile).

    Returns (idx, val, n_iters, converged, k_steps): numpy (B, n+1,
    K_full) idx/val padded back to the caller's K, and the K of each
    shrink level, starting with K_full."""
    B = infl.shape[0]
    K_full = K
    k_steps = [K]
    idx, val = _first_iteration(idx0, val0, infl, n, K, float(pruning))
    if mesh is not None:
        M = idx.shape[1] // mesh.world
        idx = idx[:, mesh.rank * M:(mesh.rank + 1) * M].contiguous()
        val = val[:, mesh.rank * M:(mesh.rank + 1) * M].contiguous()
    active = np.ones(B, dtype=bool)
    conv_at = np.full(B, max_iter, dtype=np.int32)
    n_shrinks = 0
    # col_allclose's order flag, set on the card, read with the decisions
    bad = torch.zeros(1, dtype=torch.int32, device=idx.device)
    t0 = time.time()
    for it in range(1, max_iter):
        cur_chunk = min(chunk, _auto_chunk(B, K, n))
        if mesh is None:
            idx, val, stat, max_nnz = _sweep_step(
                idx, val, infl, active, n, K, cur_chunk, float(pruning),
                expansion, bad=bad)
        else:
            idx, val, stat, max_nnz = _sharded_sweep_step(
                mesh, idx, val, infl, active, n, K, cur_chunk,
                float(pruning), expansion, bad=bad)
        # the iteration's decisions in one read from the card: stat,
        # max_nnz (<= K, exact in f64) and the order flag together;
        # sparse_column's order check also waits for it, once a chunk
        got = torch.cat([stat.double(), max_nnz.double().view(1),
                         bad.double()]).cpu()
        raise_if_unordered(int(got[B + 1]), n)
        stat_h, nz = got[:B].numpy(), int(got[B])
        if it >= 2:
            newly = active & (stat_h <= 1e-8)
            conv_at[newly] = it + 1
            active &= ~newly
        if not active.any():
            break
        if K > 16 and n_shrinks < 3:
            newK = max(16, 1 << max(nz - 1, 1).bit_length())
            if newK <= K // 2:
                logger.info('sparse MCL: support collapsed to %d, '
                            'shrinking K %d -> %d', nz, K, newK)
                K = newK
                k_steps.append(K)
                n_shrinks += 1
                idx = idx[:, :, :K].contiguous()
                val = val[:, :, :K].contiguous()
    logger.info('sparse MCL batch inflations=%s: %s iterations in %.1fs',
                infl.cpu().numpy().round(2).tolist(), conv_at.tolist(),
                time.time() - t0)
    # pad back to the caller's K so batches stack uniformly
    if K < K_full:
        pad = K_full - K
        idx = torch.nn.functional.pad(idx, (0, pad), value=n)
        val = torch.nn.functional.pad(val, (0, pad))
    if mesh is not None:
        idx = all_gather_cols(mesh, idx)[:, :n + 1]
        val = all_gather_cols(mesh, val)[:, :n + 1]
    return (idx.cpu().numpy(), val.cpu().numpy(), conv_at,
            np.logical_not(active), k_steps)


def _pre_expand(base_i: torch.Tensor, base_v: torch.Tensor,
                cur_i: torch.Tensor, cur_v: torch.Tensor, n: int, K: int,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exact-normalization left-multiply by the base matrix:
    C ← A @ C capped at top-K (inflation 1, no threshold). Iterating
    this from C = A yields A^e for any expansion e — squaring the
    iterate would instead give A^(2^(e-1)). All (N, K)."""
    out_i = torch.empty_like(cur_i)
    out_v = torch.empty_like(cur_v)
    one = torch.ones(1, device=cur_v.device)
    for s in range(0, cur_i.shape[0], chunk):
        ni, nv = sparse_column(base_i[None], base_v[None],
                               cur_i[None, s:s + chunk],
                               cur_v[None, s:s + chunk], one, n, K, 0.0,
                               expand=True)
        out_i[s:s + chunk] = ni[0]
        out_v[s:s + chunk] = nv[0]
    out_i[n] = n
    out_v[n] = 0.0
    return out_i, out_v


# ---------------------------------------------------------------------------
# host wrappers
# ---------------------------------------------------------------------------


def coo_to_ell(i: np.ndarray, j: np.ndarray, w: np.ndarray, n: int,
               K: int, device=None):
    """Symmetric COO (upper or mixed triangle) -> column-normalized ELL
    (n+1, K). Columns with more than K entries keep the K largest
    (logged). Mirrors dict_to_matrix(add_self_loops=True) + the sweep's
    initial L1 normalization (scripts/HapHiC_cluster.py:310-373,2143).

    Returns (idx, val, overflow) where overflow is the number of input
    columns wider than K (0 ⇒ the ELL layout is exact). The links go to
    ``device`` (the CPU by default) and ell_build builds the ELL there:
    idx and val are tensors on ``device``, bit-equal to the JAX package's
    numpy arrays. ``coo_to_ell.wide_columns``: the last call's columns of
    more than ell_build.SMEM_MAX entries (the kernel takes those through
    global memory). The span ``sparse.ell`` (``haphic_tpu_torch.trace``)
    covers the call."""
    dev = torch.device('cpu' if device is None else device)
    with trace.span('sparse.ell', device=dev, links=len(i), n=n, K=K):
        links = [torch.as_tensor(np.ascontiguousarray(x, dtype=t),
                                 device=dev)
                 for x, t in ((i, np.int64), (j, np.int64),
                              (w, np.float64))]
        idx, val, overflow, coo_to_ell.wide_columns = ell_build(
            *links, n, K)
    if overflow:
        logger.info('sparse MCL: %d/%d columns exceed K=%d entries; '
                    'keeping the K largest per column', overflow, n, K)
    return idx, val, overflow


coo_to_ell.wide_columns = 0


@dataclass
class SparseMCLResult:
    idx: np.ndarray          # (B, n+1, K)
    val: np.ndarray
    n: int
    n_iters: np.ndarray      # (B,)
    converged: np.ndarray    # (B,)
    K: int = 0               # top-K cap used (selection pruning width)
    overflow_cols: int = 0   # columns of the INPUT matrix wider than K
    # per inflation batch: its size and the K of each shrink level
    batches: List[int] = field(default_factory=list)
    k_steps: List[List[int]] = field(default_factory=list)
    sweep_s: float = 0.0     # wall seconds on the card, results fetched

    def csr(self, b: int):
        """Final matrix of inflation b as scipy CSR (rows x cols)."""
        from scipy.sparse import coo_matrix
        idx = self.idx[b, :self.n].ravel()
        cols = np.repeat(np.arange(self.n), self.idx.shape[-1])
        vals = self.val[b, :self.n].ravel()
        keep = (idx < self.n) & (vals > 0)
        return coo_matrix((vals[keep], (idx[keep], cols[keep])),
                          shape=(self.n, self.n)).tocsr()

    def interpret(self, b: int) -> Optional[list]:
        """Cluster extraction, parity with the dense interpret_result
        (scripts/HapHiC_cluster.py:2065-2095)."""
        csr = self.csr(b)
        m = self.n
        diag = csr.diagonal() != 0
        attractors = np.nonzero(diag)[0]
        clusters = set()
        for a in attractors:
            row = csr.getrow(a)
            clusters.add(tuple(np.sort(row.indices[row.data != 0]).tolist()))
        seen = set()
        for cluster in clusters:
            for node in cluster:
                if node in seen:
                    return None
                seen.add(node)
        if len(seen) != m:
            return None
        return sorted(clusters)


def _auto_chunk(B: int, K: int, n: int, budget_bytes: int = 2 << 30) -> int:
    # the JAX package's budget: a column's K² candidates, idx+val, per
    # inflation. On the CPU it bounds the plain version's candidate lists
    # and their sorts. On the card the kernel keeps the candidates in
    # shared memory and in a workspace of one hash slice a resident CTA
    # (csrc/sparse_column.cu, sparse_column_workspace), whatever the
    # chunk; there the chunk sets the launches and order checks a step.
    # Chunking does not change results, and the budget changes only on a
    # card measurement
    per_col = B * K * K * 8
    c = max(1, budget_bytes // max(per_col, 1))
    # never pad columns beyond the next power of two over the real count
    n_cap = 1 << max(3, (n + 1 - 1).bit_length())
    return int(min(2048, n_cap, max(8, 1 << (int(c).bit_length() - 1))))


def run_mcl_sparse(i: np.ndarray, j: np.ndarray, w: np.ndarray, n: int,
                   inflations: Sequence[float], K: int = DEFAULT_K,
                   expansion: int = 2, max_iter: int = 200,
                   pruning: float = 1e-4, device=None,
                   mesh=None) -> SparseMCLResult:
    """Sparse MCL inflation sweep over a symmetric COO link matrix, on
    ``device`` ("cuda" by default; raises without a card).

    ``K`` bounds the per-column support (selection pruning). With
    K ≥ max column support of every iterate the result is exact; smaller
    K approximates (validated against the dense path in tests).

    With ``mesh`` (parallel/mesh.py) every rank calls this with the same
    arguments and the column axis is sharded over the ranks, on
    ``mesh.device``; every rank returns the whole result, bit-equal to
    the meshless run's."""
    dev = resolve_device(device if mesh is None else mesh.device)
    t0 = time.time()
    if K > n:
        K = max(1, n)
    infl = np.asarray(inflations, dtype=np.float32)
    B = len(infl)
    # idx0/val0 are tensors on dev, taken below by torch.as_tensor
    # without a copy
    idx0, val0, overflow_cols = coo_to_ell(i, j, w, n, K, device=dev)

    # Small independent inflation batches beat one lockstep batch:
    # every iteration costs O(batch · n · K²), and a batch stops as
    # soon as ITS inflations converge. The K shrink is taken over a
    # batch, so the grouping is the JAX package's.
    per = 4 * (n + 1) * K * 8
    inflation_batch = max(1, min(B, 4, int((6 << 30) // max(per, 1))))
    chunk = _auto_chunk(inflation_batch, K, n)

    base_i = torch.as_tensor(idx0, device=dev)
    base_v = torch.as_tensor(val0, device=dev)
    cur_i, cur_v = base_i, base_v
    for _ in range(expansion - 1):
        cur_i, cur_v = _pre_expand(base_i, base_v, cur_i, cur_v, n, K,
                                   chunk)
    if mesh is not None:
        # the sharded column axis must divide by the world: sentinel
        # columns (idx = n, val = 0) compute empty columns, as column n
        pad = (-(n + 1)) % mesh.world
        cur_i = torch.nn.functional.pad(cur_i, (0, 0, 0, pad), value=n)
        cur_v = torch.nn.functional.pad(cur_v, (0, 0, 0, pad))
    infl_t = torch.as_tensor(infl, device=dev)

    out_idx = np.empty((B, n + 1, K), dtype=np.int32)
    out_val = np.empty((B, n + 1, K), dtype=np.float32)
    iters = np.empty((B,), dtype=np.int32)
    conv = np.empty((B,), dtype=bool)
    batches, k_steps = [], []
    for s in range(0, B, inflation_batch):
        e = min(B, s + inflation_batch)
        (out_idx[s:e], out_val[s:e], iters[s:e], conv[s:e],
         ks) = _run_sweep_batch(cur_i, cur_v, infl_t[s:e], n, K, chunk,
                                max_iter, pruning, expansion, mesh=mesh)
        batches.append(e - s)
        k_steps.append(ks)
    return SparseMCLResult(idx=out_idx, val=out_val, n=n, n_iters=iters,
                           converged=conv, K=K,
                           overflow_cols=overflow_cols, batches=batches,
                           k_steps=k_steps, sweep_s=time.time() - t0)

"""Sparse MCL column step: the CUDA kernel's wrapper and its plain torch
version.

    python -m haphic_tpu_torch.kernels.sparse_column [--seed 0] [--reps 3]

Counterpart of the jitted XLA column pass of
haphic_tpu/cluster/sparse_mcl.py: ``_sweep_cols`` (:164), which vmaps
``_expand_col`` (:103), ``_dedupe_sorted`` (:62) and
``_inflate_cap_prune`` (:77) over the columns, and the same pass in
``_pre_expand`` (:380) and ``_first_iteration`` (:149). Shapes:

    A_i, A_v   int32 / f32 (B, N, KA)   the whole iterate (N >= n+1)
    ci, cv     int32 / f32 (B, C, Kc)   the columns to compute
    infl       f32 (B,)                 inflation per matrix
    -> out_i, out_v  int32 / f32 (B, C, K)

``sparse_column`` computes, per (b, column), the column's candidates
(with ``expand`` the Kc·KA products of the columns it references, else
its own Kc entries), their run sums by row id, inflation, the exact
column normalization, the top-K cap, the prune and the renormalization,
written in ascending id and padded with (n, 0). It launches the CUDA
kernel (csrc/sparse_column.cu) on CUDA tensors and runs
``sparse_column_plain``, the torch composition ``_expand`` then
``_inflate_cap_prune`` (moved here from cluster/sparse_mcl.py), on CPU
tensors; nothing else picks the plain version. The convergence
statistic stays in torch (``sparse_mcl._col_allclose_stat``).

What bounds it: each input read once and each output written once, 2 ·
B · N · K · 8 bytes a sweep step, so bytes (0.06 ms at B = 4, N =
24,001, K = 128 on an H100). The kernel sorts every column's candidates
in shared memory instead, one CTA a column (see the .cu).

Run as a module, it times one ``sparse_mcl._sweep_step`` on the card at
the sparse smoke run's shape (B = 4, n + 1 = 24,001, K = 128) on a
seeded column-stochastic iterate, through the kernel and through the
plain version, with CUDA events, then the column work alone (every
chunk's ``sparse_column`` call, and the plain version's), and prints
one JSON line: kernel ms, plain ms, step ms both ways, bound ms and the
largest difference of the two iterates.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import subprocess
import sys
from typing import Tuple

import numpy as np
import torch

from haphic_tpu_torch.kernels import build as kbuild

# candidates a column may have for the shared-memory path (the .cu's
# SC_SMEM_CANDIDATES); past it the kernel works in a global workspace
SMEM_CANDIDATES = 16384
# entries above this must be kept by both versions (tests' KEPT)
KEPT = 1e-6
RTOL, ATOL = 1e-5, 1e-7
# H100 SXM HBM bytes/s (NVIDIA data sheet)
HBM_BPS = 3.35e12


# ---------------------------------------------------------------------------
# the plain version: per-column functions over the last axis of (..., L)
# ---------------------------------------------------------------------------


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """x[..., 1:] followed by ``fill``."""
    return torch.cat([x[..., 1:], x.new_full(x.shape[:-1] + (1,), fill)],
                     dim=-1)


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """``fill`` followed by x[..., :-1]."""
    return torch.cat([x.new_full(x.shape[:-1] + (1,), fill), x[..., :-1]],
                     dim=-1)


def _sort_by_id(ids: torch.Tensor, *payloads: torch.Tensor):
    """Stable sort by id along the last axis, payloads following
    (lax.sort with num_keys=1 is stable: equal ids keep their order, so
    the run sums below add in JAX's order)."""
    ids, order = torch.sort(ids, dim=-1, stable=True)
    return (ids,) + tuple(torch.gather(p, -1, order) for p in payloads)


def _dedupe_sorted(ci: torch.Tensor, cv: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-sum runs of equal ids in an id-sorted candidate list.
    Non-last members of each run become sentinels (id n, value 0).

    The running sum is kept in f64 and each run rounded to f32 once: a
    run is the difference of two prefix sums of the whole column (up to
    ~1), so f32 prefixes (XLA's, or PyTorch's on CUDA) put ~1e-7 of
    absolute error on every entry, a tenth of a 1e-3 entry's value."""
    s = torch.cumsum(cv, dim=-1, dtype=torch.float64)
    is_last = ci != _shift_left(ci, n + 1)
    z = torch.where(is_last, s, 0.0)
    # s is nondecreasing (cv >= 0), so the last run end before each
    # position is a running max
    prev_end = torch.cummax(_shift_right(z, 0.0), dim=-1).values
    run = (s - prev_end).to(cv.dtype)
    real = is_last & (ci < n)
    return torch.where(real, ci, n), torch.where(real, run, 0.0)


def _inflate_cap_prune(didx: torch.Tensor, dval: torch.Tensor, infl,
                       pruning: float, n: int, K: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inflate -> exact colnorm -> top-K cap -> threshold+keep-max ->
    renormalize -> sort by row id. Works on any deduped candidate list
    (K² after expansion, K for the no-expand first iteration).
    ``infl`` is a float or a tensor that broadcasts against (..., 1)."""
    pos = dval > 0
    p = torch.where(pos, torch.exp(infl * torch.log(
        torch.where(pos, dval, 1.0))), 0.0)
    tot = p.sum(dim=-1, keepdim=True)
    p = p * torch.where(tot > 0, 1.0 / tot, 0.0)
    if p.shape[-1] > K:
        # lax.top_k order: descending, lower position first among ties
        tv, tpos = torch.sort(p, dim=-1, descending=True, stable=True)
        tv = tv[..., :K]
        ti = torch.gather(didx, -1, tpos[..., :K])
    else:
        tv, ti = p, didx
    mx = tv.amax(dim=-1, keepdim=True)
    keep = (tv >= pruning) | ((tv == mx) & (tv > 0))
    tv = torch.where(keep, tv, 0.0)
    t2 = tv.sum(dim=-1, keepdim=True)
    tv = tv * torch.where(t2 > 0, 1.0 / t2, 0.0)
    ti = torch.where(tv > 0, ti, n).to(torch.int32)
    return _sort_by_id(ti, tv)


def _expand(A_i: torch.Tensor, A_v: torch.Tensor, col_i: torch.Tensor,
            col_v: torch.Tensor, n: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates of (A @ A)[:, j] for every column j of the block: the
    K referenced columns of A scaled by the column's values, flattened
    and deduped. A_i/A_v: (B, N, K); col_i/col_v: (B, C, K) ->
    (B, C, K²)."""
    B, C, Kc = col_i.shape
    K = A_i.shape[-1]
    b = torch.arange(B, device=A_i.device).view(B, 1, 1)
    cols = col_i.long()
    gi = A_i[b, cols].reshape(B, C, Kc * K)
    gv = (A_v[b, cols] * col_v[..., None]).reshape(B, C, Kc * K)
    gi, gv = _sort_by_id(gi, gv)
    return _dedupe_sorted(gi, gv, n)


def sparse_column_plain(A_i, A_v, ci, cv, infl, n: int, K: int,
                        pruning: float, expand: bool):
    """The same function in plain torch ops: ``_expand`` (with
    ``expand``) then ``_inflate_cap_prune``."""
    if expand:
        di, dv = _expand(A_i, A_v, ci, cv, n)
    else:
        di, dv = ci, cv
    return _inflate_cap_prune(di, dv, infl.view(-1, 1, 1), pruning, n, K)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn():
    lib = kbuild.load('sparse_column')
    fn = lib.sparse_column_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [ctypes.c_int64, vp] + [i32] * 7 + \
        [ctypes.c_float, i32] + [vp] * 5
    fn.restype = ctypes.c_int
    return fn


def _candidates(ci, A_i, expand: bool) -> int:
    """Candidates a column has: Kc·KA with ``expand``, else Kc."""
    return ci.shape[2] * (A_i.shape[2] if expand else 1)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _check(A_i, A_v, ci, cv, infl, n: int, K: int, expand: bool):
    if ci.dim() != 3:
        raise ValueError('ci: want (B, C, Kc), got {}'.format(
            tuple(ci.shape)))
    B, C, Kc = ci.shape
    want = [('ci', ci, torch.int32, (B, C, Kc)),
            ('cv', cv, torch.float32, (B, C, Kc)),
            ('infl', infl, torch.float32, (B,))]
    if expand:
        if A_i is None or A_v is None or A_i.dim() != 3:
            raise ValueError('expand needs A_i/A_v of shape (B, N, KA)')
        want += [('A_i', A_i, torch.int32, (B,) + tuple(A_i.shape[1:])),
                 ('A_v', A_v, torch.float32, (B,) + tuple(A_i.shape[1:]))]
        if A_i.shape[1] <= n:
            raise ValueError('A has {} columns; column n = {} must be one '
                             'of them'.format(A_i.shape[1], n))
    for name, t, dtype, shape in want:
        if t.device != ci.device:
            raise ValueError('{} is on {}, ci on {}'.format(
                name, t.device, ci.device))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('{}: want {} {}, got {} {}'.format(
                name, dtype, shape, t.dtype, tuple(t.shape)))
    if expand and not (A_i.is_contiguous() and A_v.is_contiguous()):
        raise ValueError('A_i and A_v must be contiguous')
    if not infl.is_contiguous():
        raise ValueError('infl must be contiguous')
    # the columns: any batch stride, each (C, Kc) block row-major
    for name, t in (('ci', ci), ('cv', cv)):
        if (Kc > 1 and t.stride(2) != 1) or (C > 1 and t.stride(1) != Kc):
            raise ValueError('{}: each (C, Kc) block must be row-major, '
                             'strides {}'.format(name, t.stride()))
    if B > 1 and ci.stride(0) != cv.stride(0):
        raise ValueError('ci and cv must share a batch stride')
    L = _candidates(ci, A_i, expand)
    if not 1 <= K <= L or L > (1 << 30):
        raise ValueError('K = {} must be within 1..{} candidates'.format(
            K, L))
    if not 0 <= n < (1 << 31) - 1:
        raise ValueError('n = {} out of range'.format(n))


def sparse_column(A_i, A_v, ci, cv, infl, n: int, K: int, pruning: float,
                  expand: bool):
    """(out_i, out_v), each (B, C, K): the next iterate of the columns
    (ci, cv) against A. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. With ``expand`` False, A_i/A_v are unused
    (may be None)."""
    _check(A_i, A_v, ci, cv, infl, n, K, expand)
    dev = ci.device
    if dev.type == 'cpu':
        return sparse_column_plain(A_i, A_v, ci, cv, infl, n, K, pruning,
                                   expand)
    if dev.type != 'cuda':
        raise ValueError('unsupported device {}'.format(dev))
    B, C, Kc = ci.shape
    out_i = torch.empty((B, C, K), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, C, K), dtype=torch.float32, device=dev)
    if C == 0:
        return out_i, out_v
    P2 = _pow2(_candidates(ci, A_i, expand))
    ws_k = ws_v = None
    if P2 > SMEM_CANDIDATES:
        # the global-memory path: a slice of P2 keys and values a column
        ws_k = torch.empty(B * C * P2, dtype=torch.int64, device=dev)
        ws_v = torch.empty(B * C * P2, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    N, KA = (A_i.shape[1], A_i.shape[2]) if expand else (0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(ptr(A_i) if expand else None,
                    ptr(A_v) if expand else None, ci.data_ptr(),
                    cv.data_ptr(), ci.stride(0), infl.data_ptr(), B, N, KA,
                    C, Kc, n, K, float(pruning), int(bool(expand)),
                    ptr(ws_k), ptr(ws_v), out_i.data_ptr(),
                    out_v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError('sparse_column kernel launch failed: CUDA '
                           'error {}'.format(err))
    sparse_column.launches += 1
    return out_i, out_v


sparse_column.launches = 0


# ---------------------------------------------------------------------------
# comparing two iterates, and the bound
# ---------------------------------------------------------------------------


def compare(a_i, a_v, b_i, b_v, n: int) -> dict:
    """Two (..., K) iterates entry by entry, matched by row id (each id
    once a column, sentinels n ignored; an id on one side only counts as
    0 on the other): the largest absolute difference, the entries
    outside ``RTOL``·|b| + ``ATOL``, and the entries above ``KEPT`` on
    one side only. Rows are columns of the iterates, so the merge is
    along the last axis."""
    ids = torch.cat([a_i, b_i], dim=-1)
    va = torch.cat([a_v, torch.zeros_like(b_v)], dim=-1)
    vb = torch.cat([torch.zeros_like(a_v), b_v], dim=-1)
    ids, va, vb = _sort_by_id(ids, va, vb)
    same_next = ids == _shift_left(ids, -1)
    first = ids != _shift_right(ids, -1)
    ga = va + torch.where(same_next, _shift_left(va, 0.0), 0.0)
    gb = vb + torch.where(same_next, _shift_left(vb, 0.0), 0.0)
    real = first & (ids < n)
    diff = torch.where(real, (ga - gb).abs(), 0.0)
    out = (diff > RTOL * gb.abs() + ATOL) & real
    kept = ((ga > KEPT) != (gb > KEPT)) & real
    return {'max_abs_err': float(diff.max()) if diff.numel() else 0.0,
            'outside_tol': int(out.sum()), 'kept_differ': int(kept.sum())}


@contextlib.contextmanager
def plain_columns(module):
    """Inside the block, ``module`` (cluster/sparse_mcl.py) calls the
    plain version in place of the kernel's wrapper: for comparing and
    timing the two on the card."""
    module.sparse_column = sparse_column_plain
    try:
        yield
    finally:
        module.sparse_column = sparse_column


def step_columns(fn, A_i, A_v, infl, n: int, K: int, chunk: int,
                 pruning: float, expansion: int = 2):
    """``fn`` (``sparse_column`` or ``sparse_column_plain``) over every
    column of A in chunks of ``chunk``, as a sweep step
    (sparse_mcl._sweep_cols) calls it; returns the (B, N, K) result."""
    ones = torch.ones_like(infl)
    parts = []
    for s in range(0, A_i.shape[1], chunk):
        di, dv = A_i[:, s:s + chunk], A_v[:, s:s + chunk]
        for _ in range(expansion - 2):
            di, dv = fn(A_i, A_v, di, dv, ones, n, K, 0.0, True)
        parts.append(fn(A_i, A_v, di, dv, infl, n, K, pruning, True))
    return tuple(torch.cat([p[t] for p in parts], dim=1) for t in (0, 1))


def bound_ms(B: int, N: int, K: int) -> Tuple[float, str]:
    """The least time of one sweep step's column work on an H100: the
    larger of its bytes (the iterate read once, the next written once)
    at 3.35 TB/s and its multiplies (B·N·K², FP32) at 67 TFLOP/s."""
    t_bytes = 2 * B * N * K * 8 / HBM_BPS * 1e3
    t_ops = B * N * K * K / 67e12 * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else \
        'operations'


# ---------------------------------------------------------------------------
# the card timing entry
# ---------------------------------------------------------------------------


def seeded_iterate(seed: int, B: int, n: int, K: int):
    """A column-stochastic (B, n+1, K) ELL iterate on the host, shaped
    like the sparse smoke run's: fragments in chromosomes of 1000, each
    column K distinct rows of its own chromosome (one the diagonal)
    with random weights; column n empty."""
    block = 1000
    rng = np.random.default_rng(seed)
    idx = np.full((B, n + 1, K), n, dtype=np.int32)
    val = np.zeros((B, n + 1, K), dtype=np.float32)
    j = np.arange(n)
    start = j // block * block
    size = np.minimum(block, n - start)
    kk = min(K, int(size.min()))
    for b in range(B):
        off = np.argsort(rng.random((n, block), dtype=np.float32),
                         axis=1)[:, :kk]
        rows = start[:, None] + off % size[:, None]
        rows[:, 0] = j
        rows.sort(axis=1)
        # distinct rows: the modulo may fold two offsets together
        dup = np.zeros_like(rows, dtype=bool)
        dup[:, 1:] = rows[:, 1:] == rows[:, :-1]
        w = rng.exponential(1.0, (n, kk)).astype(np.float32) * ~dup
        w /= w.sum(axis=1, keepdims=True)
        rows = np.where(dup, n, rows)
        order = np.argsort(rows, axis=1, kind='stable')
        idx[b, :n, :kk] = np.take_along_axis(rows, order, 1)
        val[b, :n, :kk] = np.take_along_axis(w, order, 1)
    return idx, val


def _nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    # the package's module, not __main__: sparse_mcl calls its wrapper
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.kernels import sparse_column as kcol
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write('sparse_column: CUDA is not available\n')
        return 1
    dev = torch.device('cuda')
    # the sparse smoke run's first step: n = 24,000 fragments, the first
    # inflation batch of 4, the default K
    n, B, K = 24000, 4, sp.DEFAULT_K
    idx, val = kcol.seeded_iterate(args.seed, B, n, K)
    idx, val = torch.as_tensor(idx, device=dev), torch.as_tensor(
        val, device=dev)
    infl = torch.as_tensor(np.linspace(1.2, 2.0, B, dtype=np.float32),
                           device=dev)
    active = np.ones(B, dtype=bool)
    chunk = sp._auto_chunk(B, K, n)

    def step():
        return sp._sweep_step(idx, val, infl, active, n, K, chunk, 1e-4, 2)

    kbuild.build(['sparse_column'])
    kcol.sparse_column.launches = 0
    got = step()
    torch.cuda.synchronize()
    launches = kcol.sparse_column.launches
    ms = _time_ms(step, args.reps)
    with kcol.plain_columns(sp):
        want = step()
        plain_ms = _time_ms(step, args.reps)
    cmp = kcol.compare(got[0], got[1], want[0], want[1], n)
    stat_err = float((got[2] - want[2]).abs().max())
    # the column work alone, kernel against plain, on the step's input
    kernel_ms, col_plain_ms = (
        _time_ms(functools.partial(kcol.step_columns, fn, idx, val, infl, n,
                                   K, chunk, 1e-4), args.reps)
        for fn in (kcol.sparse_column, kcol.sparse_column_plain))
    bms, by = kcol.bound_ms(B, n + 1, K)
    print(json.dumps({
        'kernel': 'sparse_column', 'nvidia_smi': _nvidia_smi(),
        'device': torch.cuda.get_device_name(0), 'B': B, 'n_plus_1': n + 1,
        'K': K, 'chunk': chunk, 'launches_per_step': launches,
        'ms': kernel_ms, 'plain_ms': col_plain_ms,
        'step_ms': ms, 'plain_step_ms': plain_ms, 'bound_ms': bms,
        'bound_by': by, 'stat_max_abs_err': stat_err,
        'max_nnz': int(got[3]), **cmp}), flush=True)
    ok = launches > 0 and cmp['outside_tol'] == 0 and \
        cmp['kept_differ'] == 0
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())

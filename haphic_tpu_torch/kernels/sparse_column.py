"""Sparse MCL column step: the CUDA kernel's wrapper and its plain torch
version.

    python -m haphic_tpu_torch.kernels.sparse_column [--seed 0] [--reps 3]
        [--phases] [--iterate build/chip_smoke/sparse_step.pt]

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
statistic is a kernel of its own (kernels/col_allclose.py). On both
devices the columns of ci, and with ``expand`` those of A_i, must be in
ELL order (ascending distinct ids below n, then sentinels n), or it
raises ValueError: the kernel's dedupe relies on it.

What bounds it: each input read once and each output written once, 2 ·
B · N · K · 8 bytes a sweep step, so bytes (0.06 ms at B = 4, N =
24,001, K = 128 on an H100). The kernel dedupes each column's
candidates in a shared-memory hash table instead, one persistent CTA
at a time a column (see the .cu).

Run as a module, it times one ``sparse_mcl._sweep_step`` on the card at
the sparse smoke run's shape (B = 4, n + 1 = 24,001, K = 128) on a
seeded column-stochastic iterate, or with ``--iterate`` on the smoke
run's own first step as chip_smoke.py saves it, through the kernel and
through the plain version, with CUDA events, then the column work alone
(every chunk's ``sparse_column`` call, and the plain version's), and
prints one JSON line: kernel ms, plain ms, step ms both ways, bound ms
and the largest difference of the two iterates. With ``--phases`` it
builds the kernel's timing build (-DSC_PHASE_CLOCKS, its own library)
and prints instead the column work's cycles by phase (``phases``) and
the step's column shapes (``column_stats``).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import weakref
from typing import Tuple

import numpy as np
import torch

from haphic_tpu_torch.kernels import build as kbuild

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


def _bind(lib: ctypes.CDLL):
    """(launch, workspace bytes) of a build of csrc/sparse_column.cu."""
    fn = lib.sparse_column_launch
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [vp] * 4 + [i64, vp] + [i32] * 7 + \
        [ctypes.c_float, i32, vp, i64] + [vp] * 3
    fn.restype = ctypes.c_int
    ws = lib.sparse_column_workspace
    ws.argtypes = [i32] * 8
    ws.restype = i64
    return fn, ws


@functools.lru_cache(maxsize=None)
def _fn():
    return _bind(kbuild.load('sparse_column'))


def _candidates(ci, A_i, expand: bool) -> int:
    """Candidates a column has: Kc·KA with ``expand``, else Kc."""
    return ci.shape[2] * (A_i.shape[2] if expand else 1)


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
    # the ELL order the kernel relies on; A_i once while it is unchanged
    # (the same A serves every chunk of a sweep step)
    _check_order('ci', ci, n)
    if expand:
        ref, version, last_n = _checked_A[0]
        if ref() is not A_i or version != A_i._version or last_n != n:
            _check_order('A_i', A_i, n)
            _checked_A[0] = (weakref.ref(A_i), A_i._version, n)


# the last A_i that passed _check_order: (a weak reference, its version
# counter, n)
_checked_A = [(lambda: None, None, None)]


def _check_order(name: str, ids: torch.Tensor, n: int):
    """Raises ValueError unless every column (the last axis) of ``ids``
    holds ascending distinct real ids (0 <= id < n), then only sentinels
    n: the order of every call site's iterate, on which the kernel's
    dedupe and the plain version's sort agree."""
    a, b = ids[..., :-1], ids[..., 1:]
    bad = ((ids < 0) | (ids > n)).any() | ((b <= a) & (b != n)).any()
    if bool(bad):
        raise ValueError('{}: each column must hold ascending distinct row '
                         'ids below n = {}, then only the sentinel n'.format(
                             name, n))


def _launch(fns, A_i, A_v, ci, cv, infl, n: int, K: int, pruning: float,
            expand: bool):
    """One launch of a build's (launch, workspace bytes) on checked CUDA
    tensors; returns (out_i, out_v)."""
    launch, ws_bytes = fns
    dev = ci.device
    B, C, Kc = ci.shape
    out_i = torch.empty((B, C, K), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, C, K), dtype=torch.float32, device=dev)
    if C == 0:
        return out_i, out_v
    N, KA = (A_i.shape[1], A_i.shape[2]) if expand else (0, 0)
    with torch.cuda.device(dev):
        # a slice a persistent CTA, for the columns past its shared memory
        nbytes = ws_bytes(B, N, KA, C, Kc, n, K, int(bool(expand)))
        if nbytes < 0:
            raise RuntimeError('sparse_column kernel plan failed: CUDA '
                               'error {}'.format(-nbytes))
        ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        err = launch(A_i.data_ptr() if expand else None,
                     A_v.data_ptr() if expand else None, ci.data_ptr(),
                     cv.data_ptr(), ci.stride(0), infl.data_ptr(), B, N, KA,
                     C, Kc, n, K, float(pruning), int(bool(expand)),
                     ws.data_ptr() if nbytes else None, nbytes,
                     out_i.data_ptr(),
                     out_v.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError('sparse_column kernel launch failed: CUDA '
                           'error {}'.format(err))
    return out_i, out_v


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
    out = _launch(_fn(), A_i, A_v, ci, cv, infl, n, K, pruning, expand)
    sparse_column.launches += 1
    return out


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


def column_stats(A_i, A_v, n: int, K: int, chunk: int) -> dict:
    """The column shapes of one sweep step (expansion 2) over every
    column of A, each as p50 / p99 / max: real sources (ids < n), real
    candidates (the entries of id < n of those sources' columns),
    distinct ids with a positive run sum; and the columns the cap cuts
    (more than K of those)."""
    B = A_i.shape[0]
    lens = (A_i < n).sum(dim=-1)
    src, cand, dist = [], [], []
    for s in range(0, A_i.shape[1], chunk):
        ci, cv = A_i[:, s:s + chunk], A_v[:, s:s + chunk]
        src.append((ci < n).sum(dim=-1))
        cand.append(torch.gather(lens, 1, ci.reshape(B, -1).long())
                    .view(ci.shape).sum(dim=-1))
        di, dv = _expand(A_i, A_v, ci, cv, n)
        dist.append(((di < n) & (dv > 0)).sum(dim=-1))
        del di, dv

    def pct(parts):
        x = torch.cat(parts, dim=1).flatten().cpu().numpy()
        return [float(np.percentile(x, 50)), float(np.percentile(x, 99)),
                int(x.max())]
    d = torch.cat(dist, dim=1)
    return {'columns': int(d.numel()), 'real_sources': pct(src),
            'real_candidates': pct(cand), 'distinct_ids': pct(dist),
            'cap_cuts': int((d > K).sum())}


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


def _phases_fn():
    """The timing build of csrc/sparse_column.cu (-DSC_PHASE_CLOCKS),
    its own library beside the main one: (launch, read the cycles, the
    phase names)."""
    path = kbuild.library_path('sparse_column').replace(
        'libsparse_column-', 'libsparse_column_phases-')
    if not os.path.exists(path):
        nvcc = kbuild.nvcc_path()
        if nvcc is None:
            raise RuntimeError('nvcc not found (set CUDA_HOME)')
        os.makedirs(kbuild.BUILD_DIR, exist_ok=True)
        tmp = '{}.{}.tmp'.format(path, os.getpid())
        subprocess.run([nvcc] + kbuild.NVCC_FLAGS + [
            '-DSC_PHASE_CLOCKS', '-o', tmp,
            os.path.join(kbuild.CSRC, 'sparse_column.cu')], check=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    read = lib.sparse_column_phase_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    names = lib.sparse_column_phase_names
    names.argtypes, names.restype = [], ctypes.c_char_p
    return _bind(lib), read, names().decode().split(',')


def phases(A_i, A_v, infl, n: int, K: int, chunk: int, pruning: float,
           expansion: int, reps: int) -> dict:
    """One sweep step's column work (step_columns) through the timing
    build: each phase's clock64() cycles, summed over the columns, a
    column's mean and its share; the column work's ms through the
    timing build and through the main build."""
    launch, read, names = _phases_fn()

    def timed(*args):
        _check(*args[:5], args[5], args[6], args[8])
        return _launch(launch, *args)
    buf = (ctypes.c_uint64 * (len(names) + 1))()
    run = functools.partial(step_columns, timed, A_i, A_v, infl, n, K,
                            chunk, pruning, expansion)
    run()
    torch.cuda.synchronize()
    for attempt in range(2):      # zero, then the counts of one step
        if attempt:
            run()
            torch.cuda.synchronize()
        err = read(ctypes.addressof(buf))
        if err != 0:
            raise RuntimeError('reading the phase cycles: CUDA error '
                               '{}'.format(err))
    cycles = list(buf)[:len(names)]
    cols, total = buf[len(names)], sum(cycles)
    return {'columns_timed': cols, 'cycles_per_column': total / max(cols, 1),
            'phases': {k: {'cycles_per_column': c / max(cols, 1),
                           'share': c / max(total, 1)}
                       for k, c in zip(names, cycles)},
            'timing_build_ms': _time_ms(run, reps),
            'ms': _time_ms(functools.partial(
                step_columns, sparse_column, A_i, A_v, infl, n, K, chunk,
                pruning, expansion), reps)}


def main(argv=None) -> int:
    # the package's module, not __main__: sparse_mcl calls its wrapper
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.kernels import sparse_column as kcol
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--phases', action='store_true',
                    help='the timing build: cycles by phase, and the '
                    "step's column statistics")
    ap.add_argument('--iterate', help='a sweep step saved by chip_smoke.py '
                    '(build/chip_smoke/sparse_step.pt) in place of the '
                    'seeded iterate')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write('sparse_column: CUDA is not available\n')
        return 1
    dev = torch.device('cuda')
    if args.iterate:
        st = torch.load(args.iterate, map_location=dev)
        idx, val, infl = st['idx'], st['val'], st['infl']
        active = st['active'].cpu().numpy()
        n, K, chunk = st['n'], st['K'], st['chunk']
        pruning, expansion = st['pruning'], st['expansion']
    else:
        # the sparse smoke run's first step: n = 24,000 fragments, the
        # first inflation batch of 4, the default K
        n, B, K = 24000, 4, sp.DEFAULT_K
        idx, val = kcol.seeded_iterate(args.seed, B, n, K)
        idx, val = torch.as_tensor(idx, device=dev), torch.as_tensor(
            val, device=dev)
        infl = torch.as_tensor(np.linspace(1.2, 2.0, B, dtype=np.float32),
                               device=dev)
        active = np.ones(B, dtype=bool)
        chunk = sp._auto_chunk(B, K, n)
        pruning, expansion = 1e-4, 2

    def step():
        return sp._sweep_step(idx, val, infl, active, n, K, chunk, pruning,
                              expansion)

    # the column work alone: the active inflations' columns
    sel = torch.as_tensor(np.flatnonzero(active), device=dev)
    A_i, A_v, fa = idx[sel], val[sel], infl[sel]
    B = A_i.shape[0]
    head = {'kernel': 'sparse_column', 'nvidia_smi': _nvidia_smi(),
            'device': torch.cuda.get_device_name(0),
            'iterate': args.iterate or 'seeded {}'.format(args.seed),
            'B': B, 'n_plus_1': n + 1, 'K': K, 'chunk': chunk}
    kbuild.build(['sparse_column'])
    if args.phases:
        print(json.dumps(dict(
            head, **kcol.phases(A_i, A_v, fa, n, K, chunk, pruning,
                                expansion, args.reps),
            columns=kcol.column_stats(A_i, A_v, n, K, chunk))), flush=True)
        return 0
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
    kernel_ms, col_plain_ms = (
        _time_ms(functools.partial(kcol.step_columns, fn, A_i, A_v, fa, n, K,
                                   chunk, pruning, expansion), args.reps)
        for fn in (kcol.sparse_column, kcol.sparse_column_plain))
    bms, by = kcol.bound_ms(B, n + 1, K)
    print(json.dumps(dict(
        head, launches_per_step=launches, ms=kernel_ms,
        plain_ms=col_plain_ms, step_ms=ms, plain_step_ms=plain_ms,
        bound_ms=bms, bound_by=by, stat_max_abs_err=stat_err,
        max_nnz=int(got[3]), **cmp)), flush=True)
    ok = launches > 0 and cmp['outside_tol'] == 0 and \
        cmp['kept_differ'] == 0
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())

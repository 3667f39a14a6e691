"""Sparse MCL column step: the CUDA kernel's wrapper and its plain torch
version.

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
24,001, K = 128 on an H100; tools/kernelkit.py). The kernel dedupes
each column's candidates in a shared-memory hash table instead, one
persistent CTA at a time a column (see the .cu). Its timing build
(-DSC_PHASE_CLOCKS) is tools/sparse_column_phases.py's.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Tuple

import torch

from haphic_tpu_torch.kernels import build as kbuild


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
    """(launch, workspace bytes) of a build of csrc/sparse_column.cu (the
    main build, or tools/sparse_column_phases.py's timing build)."""
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

"""Sparse MCL convergence statistic: the CUDA kernel's wrapper and its
plain torch version.

Counterpart of ``_col_allclose_stat`` in haphic_tpu/cluster/sparse_mcl.py
(:114), which JAX vmaps over the columns of each chunk in ``_sweep_cols``
(:199-201). Shapes:

    old_i, old_v   int32 / f32 (B, C, Ko)   the columns before the step
    new_i, new_v   int32 / f32 (B, C, Kn)   the same columns after it
    -> stat        f32 (B, C)

``col_allclose`` computes, per (b, column), the max over the real row ids
(< n) of either column of |new − old| − 1e-5·old, a side that lacks the
id counting as 0 (numpy.allclose's test with b = old), or −inf where
neither column has a real id. It launches the CUDA kernel
(csrc/col_allclose.cu) on CUDA tensors and runs ``col_allclose_plain``,
the torch composition of the JAX function (a stable sort of the two
columns by id, f64 prefix sums, the run sums by cummax; moved here from
cluster/sparse_mcl.py), on CPU tensors; nothing else picks the plain
version. Each (C, K) block must be row-major, with any batch stride
(``old`` is a slice of the whole iterate), and Ko may differ from Kn.

Every column must be in ELL order (ascending distinct ids below n, then
sentinels n): the kernel's merge relies on it. On the CPU the
wrapper checks it with sparse_column's check and raises ValueError. On
the card the kernel checks it as it reads the ids and sets a flag on the
card; the wrapper reads the flag and raises, or, where the caller passes
its own flag (``bad``), leaves it to the caller to read with its next
read from the card (``raise_if_unordered``), so that a sweep step does
not wait for the card. A sweep step (cluster/sparse_mcl._sweep_cols)
calls it once, on all of the step's columns: one launch a step.

What bounds it: the bytes of the real entries of both columns, the
first sentinel of each column that has one and the f32 written, at most
(Ko + Kn)·8 + 4 bytes a column (tools/kernelkit.py counts them on the
step's own ids). The kernel gives each column pair a group of 8, 16 or
32 lanes, stages the pair in shared memory and merges the two columns
there (see the .cu).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels.sparse_column import (
    _check_order, _shift_left, _shift_right, _sort_by_id)

RTOL = 1e-5               # numpy.allclose's, as the kernel has it
CPU_CHUNK = 2048          # columns a plain-version call on CPU tensors


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def col_allclose_plain(old_idx, old_val, new_idx, new_val, n: int,
                       rtol: float = RTOL) -> torch.Tensor:
    """max over rows of |new - old| - rtol·|old| for each column pair
    (numpy.allclose semantics of the dense path, b = old). Inputs
    (..., K); returns (...)."""
    ci = torch.cat([old_idx, new_idx], dim=-1)
    dv = torch.cat([-old_val, new_val], dim=-1)
    ov = torch.cat([old_val, torch.zeros_like(new_val)], dim=-1)
    ci, dv, ov = _sort_by_id(ci, dv, ov)
    # f64 prefixes, as in _dedupe_sorted: a run of an unchanged entry
    # then differences to exactly 0 on the CPU and the card alike
    s_d = torch.cumsum(dv, dim=-1, dtype=torch.float64)
    s_o = torch.cumsum(ov, dim=-1, dtype=torch.float64)
    is_last = ci != _shift_left(ci, n + 1)
    # cumsum of ov is nondecreasing; dv's is not -> recover run sums by
    # differencing consecutive last positions
    zo = torch.where(is_last, s_o, 0.0)
    o_run = s_o - torch.cummax(_shift_right(zo, 0.0), dim=-1).values
    pos = torch.arange(ci.shape[-1], device=ci.device).expand_as(ci)
    idx_pos = torch.where(is_last, pos, -1)
    prev_last = _shift_right(torch.cummax(idx_pos, dim=-1).values, -1)
    d_prev = torch.where(prev_last >= 0, torch.gather(
        s_d, -1, prev_last.clamp(min=0)), 0.0)
    stat = torch.abs(s_d - d_prev) - rtol * o_run
    return torch.where(is_last & (ci < n), stat, -torch.inf).amax(
        dim=-1).to(old_val.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn():
    fn = kbuild.load('col_allclose').col_allclose_launch
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [vp, vp, i64, vp, vp, i64] + [i32] * 5 + [vp] * 3
    fn.restype = ctypes.c_int
    return fn


def _check(old_i, old_v, new_i, new_v, n: int, bad):
    if old_i.dim() != 3 or new_i.dim() != 3:
        raise ValueError('old_i / new_i: want (B, C, K), got {} / {}'.format(
            tuple(old_i.shape), tuple(new_i.shape)))
    B, C, Ko = old_i.shape
    Kn = new_i.shape[2]
    if old_i.device.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device {}'.format(old_i.device))
    want = [('old_i', old_i, torch.int32, (B, C, Ko)),
            ('old_v', old_v, torch.float32, (B, C, Ko)),
            ('new_i', new_i, torch.int32, (B, C, Kn)),
            ('new_v', new_v, torch.float32, (B, C, Kn))]
    for name, t, dtype, shape in want:
        if t.device != old_i.device:
            raise ValueError('{} is on {}, old_i on {}'.format(
                name, t.device, old_i.device))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('{}: want {} {}, got {} {}'.format(
                name, dtype, shape, t.dtype, tuple(t.shape)))
    if Ko < 1 or Kn < 1:
        raise ValueError('Ko = {} and Kn = {} must be at least 1'.format(
            Ko, Kn))
    if not 0 <= n < (1 << 31) - 1:
        raise ValueError('n = {} out of range'.format(n))
    # any batch stride, each (C, K) block row-major, ids and values alike
    for name, t, K in (('old_i', old_i, Ko), ('old_v', old_v, Ko),
                       ('new_i', new_i, Kn), ('new_v', new_v, Kn)):
        if (K > 1 and t.stride(2) != 1) or (C > 1 and t.stride(1) != K):
            raise ValueError('{}: each (C, K) block must be row-major, '
                             'strides {}'.format(name, t.stride()))
    if B > 1 and (old_i.stride(0) != old_v.stride(0)
                  or new_i.stride(0) != new_v.stride(0)):
        raise ValueError('ids and values must share a batch stride')
    if bad is not None and (bad.dtype != torch.int32 or bad.numel() != 1
                            or bad.device != old_i.device):
        raise ValueError('bad: want one int32 on {}, got {} {} on {}'.format(
            old_i.device, bad.dtype, tuple(bad.shape), bad.device))


def raise_if_unordered(bad: int, n: int):
    """Raises the wrapper's ValueError where ``bad``, the value of a flag
    that ``col_allclose`` set on the card, says a column was out of ELL
    order."""
    if bad:
        raise ValueError('old_i or new_i: each column must hold ascending '
                         'distinct row ids below n = {}, then only the '
                         'sentinel n'.format(n))


def _launch(old_i, old_v, new_i, new_v, n: int, bad: torch.Tensor
            ) -> torch.Tensor:
    """One launch on checked CUDA tensors (none when there is no column),
    setting ``bad`` to 1 where a column is out of ELL order; returns the
    (B, C) statistic."""
    B, C, Ko = old_i.shape
    Kn = new_i.shape[2]
    dev = old_i.device
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B * C == 0:
        return out
    with torch.cuda.device(dev):
        err = _fn()(old_i.data_ptr(), old_v.data_ptr(), old_i.stride(0),
                    new_i.data_ptr(), new_v.data_ptr(), new_i.stride(0), B,
                    C, Ko, Kn, n, out.data_ptr(), bad.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError('col_allclose kernel launch failed: CUDA error '
                           '{}'.format(err))
    col_allclose.launches += 1
    return out


def col_allclose(old_i, old_v, new_i, new_v, n: int,
                 bad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, C) f32: each column pair's convergence statistic. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors. Raises
    ValueError where a column is out of ELL order; on the card, where
    ``bad`` (one int32 on the card) is given, the kernel sets it to 1
    instead and the caller raises (``raise_if_unordered``)."""
    _check(old_i, old_v, new_i, new_v, n, bad)
    if old_i.device.type == 'cpu':
        _check_order('old_i', old_i, n)
        _check_order('new_i', new_i, n)
        # in column chunks, to bound the sort's memory: the statistic is
        # per column
        C = old_i.shape[1]
        if C <= CPU_CHUNK:
            return col_allclose_plain(old_i, old_v, new_i, new_v, n)
        return torch.cat([col_allclose_plain(
            *(t[:, s:s + CPU_CHUNK] for t in (old_i, old_v, new_i, new_v)),
            n) for s in range(0, C, CPU_CHUNK)], dim=1)
    flag = bad if bad is not None else torch.zeros(
        1, dtype=torch.int32, device=old_i.device)
    out = _launch(old_i, old_v, new_i, new_v, n, flag)
    if bad is None:
        raise_if_unordered(int(flag), n)
    return out


col_allclose.launches = 0

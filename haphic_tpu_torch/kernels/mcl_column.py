"""Dense MCL column pass: the CUDA kernel's wrapper and its plain torch
version.

Counterpart of the jitted XLA column pass of haphic_tpu/cluster/mcl.py
``_mcl_batched`` (:86): its inline ``inflate`` (:99), ``_prune`` (:70)
with ``_colnorm`` (:57), and ``_allclose`` (:79). Shapes:

    e      f32 (B, n, n)   the expanded iterate; its batch stride may be
                           0 (iteration 0 passes one matrix for every b)
    infl   f32 (B,)        inflation per matrix
    old    f32 (B, n, n)   the iterate before the expansion, or None
    -> new f32 (B, n, n), stat f32 (B,) (None without old)

``mcl_column`` computes, per (b, column), the inflation p = exp(infl ·
log x) of the positive entries, the column normalization q (times the
f32 reciprocal of the column sum), the prune (q >= pruning, or the first
row of the column's largest q) and the renormalization; with ``old``,
``stat`` is the max over the matrix of |new − old| − 1e-5·|old|, and the
matrix has converged where ``stat <= 1e-8`` (numpy.allclose's rtol and
atol). It launches the CUDA kernel (csrc/mcl_column.cu) on CUDA tensors
and runs ``mcl_column_plain``, the torch composition ``_inflate`` then
``_prune`` then the statistic (moved here from cluster/mcl.py), on CPU
tensors; nothing else picks the plain version.

What bounds it: e read once, old read once when given and new written
once, (8 or 12) · B · n² bytes, so bytes (1.376 ms at B = 6, n = 8000
with old on an H100; one logf and one expf an entry are 0.011 ms at 67
TFLOP/s). The kernel moves just those bytes: one thread-block cluster a
strip of columns holds the strip in its shared memory (see the .cu).
``plan(n)`` picks the strip's width, the cluster's size and each CTA's
rows from n alone, up to ``N_MAX``; past it the wrapper raises on a
CUDA tensor. The bound's arithmetic is in tools/kernelkit.py.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from haphic_tpu_torch.kernels import build as kbuild

RTOL, ATOL = 1e-5, 1e-8          # _allclose's; also the kernel's values
THREADS = 256                  # a CTA's threads (csrc MC_THREADS)
HEAD = 6144                    # a CTA's shared bytes before its slab (MC_HEAD)
SMEM_MAX = 232448              # shared bytes a CTA may opt into on an H100
SLAB_TARGET = 64 << 10         # a slab this small leaves three CTAs an SM
SLAB_WIDE = 100 << 10          # and this one two
# four (n, n) f32 buffers (the iterate, its expansion, the pass's output
# and the gemm's) take 78.4 GB at this n: the 80 GB card holds no larger
# dense iteration
N_MAX = 70000


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _colnorm(m: torch.Tensor) -> torch.Tensor:
    s = m.sum(dim=-2, keepdim=True)
    return m * torch.where(s > 0, 1.0 / s, torch.zeros_like(s))


def _prune(m: torch.Tensor, pruning: float) -> torch.Tensor:
    # keep entries >= pruning, and always the per-column (first) argmax
    keep = m >= pruning
    keep.scatter_(-2, torch.argmax(m, dim=-2, keepdim=True), True)
    return _colnorm(torch.where(keep, m, torch.zeros_like(m)))


def _inflate(m: torch.Tensor, infl: torch.Tensor) -> torch.Tensor:
    # 0**p = 0; power on strictly positive entries only
    pos = m > 0
    p = torch.where(pos, torch.exp(infl * torch.log(
        torch.where(pos, m, torch.ones_like(m)))), torch.zeros_like(m))
    return _colnorm(p)


def _stat(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    d = (new - old).abs() - RTOL * old.abs()
    return d.amax(dim=(-2, -1))


def mcl_column_plain(e: torch.Tensor, infl: torch.Tensor, pruning: float,
                     old: Optional[torch.Tensor] = None):
    """The same function in plain torch ops: ``_inflate``, ``_prune``,
    then with ``old`` the statistic."""
    new = _prune(_inflate(e, infl.view(-1, 1, 1)), pruning)
    return new, None if old is None else _stat(new, old)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """How the kernel cuts an (n, n) matrix: strips of ``width`` columns,
    one cluster of ``cluster`` CTAs a (matrix, strip), CTA rank k holding
    the rows [k * rows, (k + 1) * rows) of the strip in ``smem`` bytes of
    shared memory (HEAD, then the slab)."""
    width: int
    cluster: int
    rows: int
    smem: int


def _plan(width: int, cluster: int, n: int) -> Plan:
    rows = -(-n // cluster)
    return Plan(width, cluster, rows, HEAD + rows * width * 4)


def plan(n: int) -> Plan:
    """The kernel's plan for n, a function of n alone, so that the order
    of every sum, and with it every column's bits, depends on n only.

    The widest strip (32, then 16 columns: a row's segment is 128 or 64
    bytes) and the smallest cluster (1, 2, 4, 8 or 16 CTAs; 16 is a
    non-portable size) whose slab fits SLAB_TARGET, so that three CTAs
    share an SM and one's loads overlap another's exchange and write
    (n <= 16,384). Failing that, 16 columns in clusters of 16 while
    their slab fits SLAB_WIDE, two CTAs an SM (n <= 25,600): 32-byte
    segments cost more than the third CTA saves. Then 8 columns in
    clusters of 16, up to 140 KB a CTA at N_MAX. The choices at n =
    3000, 8000, 12,000 and 19,999 are measured in PERF.md."""
    if not 1 <= n <= N_MAX:
        raise ValueError('mcl_column: n = {} is outside the kernel\'s plan '
                         '(1 <= n <= N_MAX = {}: four (n, n) f32 buffers '
                         'must fit on the card)'.format(n, N_MAX))
    for width in (32, 16):
        for cluster in (1, 2, 4, 8, 16):
            pl = _plan(width, cluster, n)
            if pl.smem - HEAD <= SLAB_TARGET:
                return pl
    pl = _plan(16, 16, n)
    return pl if pl.smem - HEAD <= SLAB_WIDE else _plan(8, 16, n)


def stat_parts(n: int, pl: Plan) -> int:
    """The statistic's partials a matrix: one a CTA."""
    return -(-n // pl.width) * pl.cluster


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn():
    """The launch of csrc/mcl_column.cu."""
    fn = kbuild.load('mcl_column').mcl_column_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ctypes.c_int64, vp, vp, ci, ci, ci, ci, ci, ci,
                   ctypes.c_float, vp, vp, vp]
    fn.restype = ci
    return fn


def _check(e, infl, old):
    if e.dim() != 3 or e.shape[1] != e.shape[2] or min(e.shape) < 1:
        raise ValueError('e: want (B, n, n) with B, n >= 1, got {}'.format(
            tuple(e.shape)))
    B, n = e.shape[0], e.shape[2]
    want = [('e', e, (B, n, n)), ('infl', infl, (B,))]
    if old is not None:
        want.append(('old', old, (B, n, n)))
    for name, t, shape in want:
        if t.device != e.device:
            raise ValueError('{} is on {}, e on {}'.format(name, t.device,
                                                           e.device))
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError('{}: want float32 {}, got {} {}'.format(
                name, shape, t.dtype, tuple(t.shape)))
    # e: each matrix row-major, the batch stride that of a contiguous
    # tensor or 0 (one matrix for every b)
    if (n > 1 and (e.stride(2) != 1 or e.stride(1) != n)) \
            or (B > 1 and e.stride(0) not in (0, n * n)):
        raise ValueError('e: want each (n, n) matrix row-major and a batch '
                         'stride of 0 or n * n, strides {}'.format(e.stride()))
    if not infl.is_contiguous() or (old is not None
                                    and not old.is_contiguous()):
        raise ValueError('infl and old must be contiguous')


def _launch(e, infl, pruning: float, old, pl: Plan):
    """One launch on checked CUDA tensors with plan ``pl``; returns (new,
    stat)."""
    launch = _fn()
    B, n = e.shape[0], e.shape[2]
    dev = e.device
    new = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    part = None if old is None else torch.empty(
        (B, stat_parts(n, pl)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(e.data_ptr(), e.stride(0), infl.data_ptr(),
                     None if old is None else old.data_ptr(), B, n,
                     pl.width, pl.cluster, pl.rows, pl.smem,
                     float(pruning), new.data_ptr(),
                     None if part is None else part.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError('mcl_column kernel launch failed: CUDA error '
                           '{}'.format(err))
    return new, None if part is None else part.amax(dim=1)


def mcl_column(e: torch.Tensor, infl: torch.Tensor, pruning: float,
               old: Optional[torch.Tensor] = None):
    """(new, stat): the pruned, renormalized inflation of the columns of
    ``e`` and, with ``old``, each matrix's convergence statistic. The
    CUDA kernel on CUDA tensors (``plan(n)``, which raises past N_MAX),
    the plain version on CPU tensors."""
    _check(e, infl, old)
    dev = e.device
    if dev.type == 'cpu':
        return mcl_column_plain(e, infl, pruning, old)
    if dev.type != 'cuda':
        raise ValueError('unsupported device {}'.format(dev))
    out = _launch(e, infl, pruning, old, plan(e.shape[2]))
    mcl_column.launches += 1
    return out


mcl_column.launches = 0

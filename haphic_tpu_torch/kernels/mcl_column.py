"""Dense MCL column pass: the CUDA kernel's wrapper and its plain torch
version.

    python -m haphic_tpu_torch.kernels.mcl_column [--seed 0] [--reps 3]
        [--B 6] [--n 8000] [--plans 16x16,32x8]

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
CUDA tensor.

Run as a module, it takes one later iteration of a seeded block matrix,
by default at the dense smoke run's first inflation batch (B = 6, n =
8000): the column pass through the kernel and through the plain
version, and the whole iteration (the expansion product, then the pass)
both ways, timed with CUDA events, and prints one JSON line: the plan,
the ms of each, the bytes the pass moves and the rate it reached, the
bound and how the two results differ; ``--plans`` also times other
(width x cluster) plans on the same input, each held to the plain
version.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import subprocess
import sys
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from haphic_tpu_torch.kernels import build as kbuild

RTOL, ATOL = 1e-5, 1e-8          # _allclose's; also the kernel's values
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 (non-tensor)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
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
    """(launch, active_clusters) of csrc/mcl_column.cu."""
    lib = kbuild.load('mcl_column')
    fn = lib.mcl_column_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ctypes.c_int64, vp, vp, ci, ci, ci, ci, ci, ci,
                   ctypes.c_float, vp, vp, vp]
    fn.restype = ci
    act = lib.mcl_column_active_clusters
    act.argtypes, act.restype = [ci, ci, ci, ctypes.POINTER(ci)], ci
    return fn, act


def active_clusters(pl: Plan) -> int:
    """Clusters of plan ``pl`` the current card holds at once."""
    count = ctypes.c_int(0)
    err = _fn()[1](pl.width, pl.cluster, pl.smem, ctypes.byref(count))
    if err != 0:
        raise RuntimeError('mcl_column: occupancy query failed: CUDA error '
                           '{}'.format(err))
    return count.value


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
    launch = _fn()[0]
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


@contextlib.contextmanager
def plain_columns(module):
    """Inside the block, ``module`` (cluster/mcl.py) calls the plain
    version in place of the kernel's wrapper: for comparing and timing
    the two on the card."""
    module.mcl_column = mcl_column_plain
    try:
        yield
    finally:
        module.mcl_column = mcl_column


# ---------------------------------------------------------------------------
# comparing two results, and the bound
# ---------------------------------------------------------------------------


def compare(got, want, q, pruning: float) -> dict:
    """Two (B, n, n) results of the pass on the same input, ``q`` the
    plain version's normalized inflation of it (``_inflate``). Counts the
    entries kept on one side only (``near_threshold`` of them with q
    within 1e-5·pruning of pruning, ``kept_differ`` the others) and the
    columns whose argmax rows differ (``argmax_near_tie`` of them with
    their two largest q within 1e-6 relative, ``argmax_differ`` the
    others). A column with a near-threshold entry or a near tie on one
    side only is renormalized by another sum, so its values are not held
    to the tolerance (``columns_excused``); over the other columns, the
    largest absolute difference and the entries outside RTOL·|want| +
    ATOL (NaN on both sides agrees, on one side only is outside)."""
    one_side = (got != 0) != (want != 0)
    near = (q - pruning).abs() <= 1e-5 * pruning
    near_flip = one_side & near
    arg_differ = torch.argmax(got, dim=-2) != torch.argmax(want, dim=-2)
    if q.shape[-2] > 1:
        top2 = torch.topk(q, 2, dim=-2).values
        tie = (top2[:, 0] - top2[:, 1]) <= 1e-6 * top2[:, 0]
    else:                                   # one row: no tie
        tie = torch.zeros_like(arg_differ)
    excused = (near_flip.any(dim=-2) | (arg_differ & tie))[:, None, :]
    # a NaN on both sides agrees (a column sum whose reciprocal overflows
    # gives NaN in both versions); a NaN on one side is infinitely far
    one_nan = got.isnan() != want.isnan()
    diff = (got - want).abs().masked_fill(
        excused | (got == want) | (got.isnan() & want.isnan()), 0.0)
    diff = diff.masked_fill(one_nan, float('inf'))
    outside = ((diff > RTOL * want.abs() + ATOL) | one_nan).sum()
    return {'max_abs_err': float(diff.max()) if diff.numel() else 0.0,
            'outside_tol': int(outside),
            'near_threshold': int(near_flip.sum()),
            'kept_differ': int((one_side & ~near).sum()),
            'argmax_near_tie': int((arg_differ & tie).sum()),
            'argmax_differ': int((arg_differ & ~tie).sum()),
            'columns_excused': int(excused.sum())}


def pass_bytes(B: int, n: int, with_old: bool) -> int:
    """The bytes one pass must move, and the kernel moves: e read once,
    old read once when given, new written once."""
    return (12 if with_old else 8) * B * n * n


def bound_ms(B: int, n: int, with_old: bool) -> Tuple[float, str]:
    """The least time of one pass on an H100: the larger of its bytes
    (``pass_bytes``) at 3.35 TB/s and its operations (one logf and one
    expf an entry) at 67 TFLOP/s."""
    t_bytes = pass_bytes(B, n, with_old) / HBM_BPS * 1e3
    t_ops = 2 * B * n * n / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else \
        'operations'


# ---------------------------------------------------------------------------
# the card timing entry
# ---------------------------------------------------------------------------


def seeded_iterate(seed: int, B: int, n: int, infl: torch.Tensor,
                   pruning: float, expansion: int, dev) -> torch.Tensor:
    """A (B, n, n) iterate after two MCL iterations of a seeded block
    matrix shaped like the dense smoke run's: fragments in chromosomes of
    1000, each linked to 50 random others of its own chromosome and to
    one of another, plus self loops."""
    from haphic_tpu_torch.cluster import mcl as tmcl
    block = 1000
    rng = np.random.default_rng(seed)
    j = np.repeat(np.arange(n), 51)
    start = j // block * block
    size = np.minimum(block, n - start)
    i = start + rng.integers(0, 1 << 30, j.size) % size
    i[50::51] = rng.integers(0, n, n)
    w = rng.exponential(20.0, j.size).astype(np.float32)
    keep = i < j
    a = tmcl.densify_coo(i[keep], j[keep], w[keep], n, dev)
    pre = tmcl._matpower(tmcl._colnorm(a), expansion)
    del a
    m = mcl_column(pre[None].expand(B, n, n), infl, pruning)[0]
    del pre
    return mcl_column(tmcl._matpower(m, expansion), infl, pruning)[0]


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
    from haphic_tpu_torch.cluster import mcl as tmcl
    from haphic_tpu_torch.kernels import mcl_column as kmc
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--B', type=int, default=6,
                    help='matrices (inflations) in the batch')
    ap.add_argument('--n', type=int, default=8000, help='fragments')
    ap.add_argument('--plans', default='',
                    help='other plans to time beside plan(n), as '
                         'WIDTHxCLUSTER,... (e.g. 32x8,32x16)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write('mcl_column: CUDA is not available\n')
        return 1
    dev = torch.device('cuda')
    # by default the dense smoke run's first inflation batch: n = 8000
    # fragments, 6 of the 20 default inflations (1.1, 1.2, ...)
    B, n, pruning, expansion = args.B, args.n, 1e-4, 2
    pl = kmc.plan(n)
    infl = torch.as_tensor(np.linspace(1.1, 1.6, B, dtype=np.float32),
                           device=dev)
    kbuild.build(['mcl_column'])
    m = kmc.seeded_iterate(args.seed, B, n, infl, pruning, expansion, dev)
    e = tmcl._matpower(m, expansion)
    kmc.mcl_column.launches = 0
    got, stat = kmc.mcl_column(e, infl, pruning, old=m)
    want, want_stat = kmc.mcl_column_plain(e, infl, pruning, old=m)
    torch.cuda.synchronize()
    q = kmc._inflate(e, infl.view(-1, 1, 1))
    cmp = kmc.compare(got, want, q, pruning)
    del got
    times = {}
    for name, fn in (('ms', kmc.mcl_column),
                     ('plain_ms', kmc.mcl_column_plain)):
        times[name] = _time_ms(lambda: fn(e, infl, pruning, old=m),
                               args.reps)
        times[name + '_no_old'] = _time_ms(lambda: fn(e, infl, pruning),
                                           args.reps)
        times['iteration_' + name] = _time_ms(
            lambda: fn(tmcl._matpower(m, expansion), infl, pruning, old=m),
            args.reps)
    rates = {}
    for with_old, key in ((True, 'ms'), (False, 'ms_no_old')):
        suffix = '' if with_old else '_no_old'
        nbytes = pass_bytes(B, n, with_old)
        bms, by = kmc.bound_ms(B, n, with_old)
        rates.update({'bytes' + suffix: nbytes, 'bound_ms' + suffix: bms,
                      'bound_by' + suffix: by,
                      'tb_s' + suffix: nbytes / times[key] / 1e9})
    # other plans on the same input, each against the plain version
    others = []
    for spec in filter(None, args.plans.split(',')):
        w, c = (int(x) for x in spec.split('x'))
        other = kmc._plan(w, c, n)
        ocmp = kmc.compare(kmc._launch(e, infl, pruning, m, other)[0],
                           want, q, pruning)
        oms = _time_ms(lambda: kmc._launch(e, infl, pruning, m, other),
                       args.reps)
        others.append(dict(other._asdict(), ms=oms,
                           tb_s=rates['bytes'] / oms / 1e9,
                           active_clusters=kmc.active_clusters(other),
                           outside_tol=ocmp['outside_tol'],
                           kept_differ=ocmp['kept_differ'],
                           argmax_differ=ocmp['argmax_differ']))
    del want, q
    print(json.dumps(dict(
        kernel='mcl_column', nvidia_smi=_nvidia_smi(),
        device=torch.cuda.get_device_name(0), seed=args.seed, B=B, n=n,
        plan=pl._asdict(), active_clusters=kmc.active_clusters(pl),
        **rates, **times, other_plans=others,
        stat=stat.tolist(), plain_stat=want_stat.tolist(),
        stat_max_abs_err=float((stat - want_stat).abs().max()), **cmp)),
        flush=True)
    ok = cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0 \
        and cmp['argmax_differ'] == 0 \
        and float((stat - want_stat).abs().max()) <= 1e-7 \
        and all(o['outside_tol'] == 0 and o['kept_differ'] == 0
                and o['argmax_differ'] == 0 for o in others)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())

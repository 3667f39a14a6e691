"""The measurement kit of the port's CUDA kernels: what chip_smoke.py, the
A/B tools, tools/trace_ga.py, tools/sparse_column_phases.py and the
kernel tests share, kept out of the program (haphic_tpu_torch/kernels
holds each kernel's wrapper, checks, launch, plain version and launch
counter, and nothing else).

- the card: ``nvidia_smi`` (its name and power limit), ``time_ms`` (a
  function's ms a call by CUDA events) and the H100 SXM peaks;
- torch.profiler's device kernels of a few calls (``kernel_events``,
  ``check_kernels``, ``device_ms``, ``one_kernel_a_call``);
- each kernel's bound: the least time of a call on an H100, the larger
  of its bytes at HBM_BPS and its operations at the FP32 (FP64) peak;
- seeded inputs shaped like the smoke runs', the loops over a sweep
  step's columns (``step_columns``, ``step_stats``, ``column_stats``),
  the comparators that hold a kernel's result to its plain version's,
  and ``col_allclose_plain_stat``, the statistic's plain version with
  the wrapper's arguments, which stands in for the wrapper under
  ``unittest.mock.patch.object(sparse_mcl, 'col_allclose', ...)``.

The package is imported inside the functions, so that a tool that puts
a checkout first on ``sys.path`` measures that checkout's kernels.
``hicbench/peaks.py`` keeps its own frozen copies of the bounds: the
benchmark's yardstick must not move with this kit.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

# H100 SXM (NVIDIA data sheet): HBM bytes/s, FP32 and FP64 (non-tensor)
# operations/s, and the host link's bytes/s one way (PCIe 5.0 x16)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
HOST_BPS = 64e9


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    """The first card's name and power limit, as nvidia-smi reads them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """``fn``'s ms a call by CUDA events over ``reps`` calls, after one
    call to warm up."""
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


def _bound(t_bytes: float, t_ops: float) -> Tuple[float, str]:
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else \
        'operations'


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------
#
# On an H100 the profiler's CUDA trace recorded every launch of every
# window in a fresh process (tools/profiler_capture.py), but 9 of 10 in
# every window late in the smoke's long process, and once none of 3; the
# cause is not known. So a launch count is proven by the wrappers'
# counters, and ``one_kernel_a_call`` takes a window that recorded too
# few kernels again.


def kernel_events(fn, calls: int):
    """[(name, start us, end us)] of the device kernels that the profiler
    records over ``calls`` calls of ``fn`` (after one call to warm up),
    in start order; memory copies and sets are left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if getattr(e.device_type, 'name', '') == 'CUDA'
              and 'memcpy' not in e.name.lower()
              and 'memset' not in e.name.lower()]
    return sorted(events, key=lambda e: e[1])


def check_kernels(events, calls: int, name: str):
    """Raises RuntimeError where ``events`` (kernel_events of ``calls``
    calls) hold more than one kernel a call or a kernel not named
    ``name``."""
    names = sorted({e[0] for e in events})
    if len(events) > calls or not all(name in n for n in names):
        raise RuntimeError('{} calls ran {} device kernels, want one {} a '
                           'call: {}'.format(calls, len(events), name, names))


def device_ms(events) -> float:
    """The mean device ms of the kernels of ``events``."""
    return sum(e[2] - e[1] for e in events) / 1e3 / len(events)


def one_kernel_a_call(fn, calls: int, name: str, windows: int = 3) -> float:
    """The mean device ms of ``fn``'s kernel, after checking that the
    profiler recorded one kernel a call, each one named ``name``, over
    ``calls`` calls. A window that recorded fewer is taken again, up to
    ``windows`` windows; one that recorded more, or another kernel,
    fails at once. Raises RuntimeError if no window recorded one kernel
    a call."""
    counts = []
    for _ in range(windows):
        events = kernel_events(fn, calls)
        check_kernels(events, calls, name)
        if len(events) == calls:
            return device_ms(events)
        counts.append(len(events))
    raise RuntimeError('the profiler recorded {} {} kernels in {} windows '
                       'of {} calls each'.format(counts, name, windows,
                                                 calls))


# ---------------------------------------------------------------------------
# the bounds
# ---------------------------------------------------------------------------


def mcl_column_pass_bytes(B: int, n: int, with_old: bool) -> int:
    """The bytes one dense column pass must move, and the kernel moves: e
    read once, old read once when given, new written once."""
    return (12 if with_old else 8) * B * n * n


def mcl_column_bound_ms(B: int, n: int, with_old: bool) -> Tuple[float, str]:
    """One dense column pass: its bytes (``mcl_column_pass_bytes``) and
    its operations (one logf and one expf an entry, FP32)."""
    return _bound(mcl_column_pass_bytes(B, n, with_old) / HBM_BPS * 1e3,
                  2 * B * n * n / FP32_FLOPS * 1e3)


def sparse_column_bound_ms(B: int, N: int, K: int) -> Tuple[float, str]:
    """One sparse sweep step's column work: its bytes (the iterate read
    once, the next written once) and its multiplies (B·N·K², FP32)."""
    return _bound(2 * B * N * K * 8 / HBM_BPS * 1e3,
                  B * N * K * K / FP32_FLOPS * 1e3)


def col_allclose_bound_ms(old_i: torch.Tensor, new_i: torch.Tensor, n: int
                          ) -> Tuple[float, str]:
    """The statistic of these column pairs (ids (B, C, Ko) and (B, C, Kn)
    in ELL order): its bytes (each real entry of either column, id and
    value, 8 bytes; the first sentinel id of each column that has one, 4
    bytes; one f32 written a pair) and its operations (a subtraction, an
    absolute value, a multiply and a subtraction in f64 on each real
    entry, at the FP64 peak)."""
    real = int((old_i < n).sum()) + int((new_i < n).sum())
    ends = int((old_i[..., -1] >= n).sum()) + int((new_i[..., -1] >= n).sum())
    return _bound((8 * real + 4 * ends + 4 * old_i.shape[0]
                   * old_i.shape[1]) / HBM_BPS * 1e3,
                  4 * real / FP64_FLOPS * 1e3)


def ell_build_least_bytes(E: int, n: int, K: int) -> int:
    """The links read once (24 bytes a link) and the ELL written once (8
    bytes a slot)."""
    return 24 * E + 8 * (n + 1) * K


def ell_build_bound_ms(E: int, n: int, K: int) -> float:
    """The ELL build: bytes (``ell_build_least_bytes``)."""
    return ell_build_least_bytes(E, n, K) / HBM_BPS * 1e3


def ell_build_upload_ms(E: int) -> float:
    """The links' 24 bytes each over the host's link, one way."""
    return 24 * E / HOST_BPS * 1e3


def mcl_labels_least_bytes(m: torch.Tensor) -> int:
    """The bytes the labels of ``m`` (B, n, n) need: each attractor's row
    read once (the check cannot do with less), the diagonal read and the
    labels written."""
    B, n = m.shape[0], m.shape[2]
    A = int((torch.diagonal(m, dim1=-2, dim2=-1) != 0).sum())
    return 4 * (A * n + 2 * B * n)


def mcl_labels_bound_ms(m: torch.Tensor) -> float:
    """The labels: bytes (``mcl_labels_least_bytes``)."""
    return mcl_labels_least_bytes(m) / HBM_BPS * 1e3


# per (tour, record) pair: unpack two table entries (4), compare the
# slots (1), the gap (3), its conversion (1), the combination (3) and
# its distance's selection (3), the add, the clamp, the division and
# the sum (4)
RESCORE_OPS_PER_PAIR = 19


def rescore_bound_ms(G: int, P: int, k: int, R: int, caches: bool
                     ) -> Tuple[float, str]:
    """One rescoring. Bytes: order and ori (8 B a slot) and lengths (8 B
    a contig) read, each record's pa, pb, la, lb, d[4], w (36 B) read,
    the scores written; in caches mode also L_slot and startsx (8 B a
    slot) and the six caches and the contribution (28 B a pair) written.
    Operations: RESCORE_OPS_PER_PAIR FP32 operations a (tour, record)
    pair."""
    nbytes = 8 * G * P * k + 8 * G * k + 36 * G * R + 4 * G * P
    if caches:
        nbytes += 4 * G * P * (2 * k + 1) + 28 * G * P * R
    return _bound(nbytes / HBM_BPS * 1e3,
                  RESCORE_OPS_PER_PAIR * G * P * R / FP32_FLOPS * 1e3)


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------


def mcl_column_iterate(seed: int, B: int, n: int, infl: torch.Tensor,
                       pruning: float, expansion: int, dev) -> torch.Tensor:
    """A (B, n, n) iterate after two MCL iterations of a seeded block
    matrix shaped like the dense smoke run's: fragments in chromosomes of
    1000, each linked to 50 random others of its own chromosome and to
    one of another, plus self loops. The iterations take the column
    pass's plain version, so that two checkouts' kernels get the same
    input."""
    from haphic_tpu_torch.cluster import mcl as tmcl
    from haphic_tpu_torch.kernels.mcl_column import mcl_column_plain
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
    m = mcl_column_plain(pre[None].expand(B, n, n), infl, pruning)[0]
    del pre
    return mcl_column_plain(tmcl._matpower(m, expansion), infl, pruning)[0]


def sparse_column_iterate(seed: int, B: int, n: int, K: int):
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


# ---------------------------------------------------------------------------
# the sparse sweep step's column work
# ---------------------------------------------------------------------------


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


def step_stats(fn, old_i, old_v, new_i, new_v, n: int,
               chunk: Optional[int] = None, **kw) -> torch.Tensor:
    """``fn`` (``col_allclose``, its kernel's ``_launch`` alone, or
    ``col_allclose_plain``) over every column pair, with the keyword
    arguments ``kw``: in one call, as a sweep step
    (sparse_mcl._sweep_cols) calls it, or in chunks of ``chunk`` columns;
    returns the (B, N) statistic."""
    if chunk is None or chunk >= old_i.shape[1]:
        return fn(old_i, old_v, new_i, new_v, n, **kw)
    return torch.cat([
        fn(old_i[:, s:s + chunk], old_v[:, s:s + chunk],
           new_i[:, s:s + chunk], new_v[:, s:s + chunk], n, **kw)
        for s in range(0, old_i.shape[1], chunk)], dim=1)


def column_stats(A_i, A_v, n: int, K: int, chunk: int) -> dict:
    """The column shapes of one sweep step (expansion 2) over every
    column of A, each as p50 / p99 / max: real sources (ids < n), real
    candidates (the entries of id < n of those sources' columns),
    distinct ids with a positive run sum; and the columns the cap cuts
    (more than K of those)."""
    from haphic_tpu_torch.kernels.sparse_column import _expand
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


def col_allclose_plain_stat(old_i, old_v, new_i, new_v, n: int, bad=None):
    """The statistic's plain version with the wrapper's arguments, on any
    device (``bad`` is left clear)."""
    from haphic_tpu_torch.kernels.col_allclose import col_allclose_plain
    return col_allclose_plain(old_i, old_v, new_i, new_v, n)


# ---------------------------------------------------------------------------
# the comparators
# ---------------------------------------------------------------------------


def mcl_column_compare(got, want, q, pruning: float) -> dict:
    """Two (B, n, n) results of the dense column pass on the same input,
    ``q`` the plain version's normalized inflation of it (``_inflate``).
    Counts the entries kept on one side only (``near_threshold`` of them
    with q within 1e-5·pruning of pruning, ``kept_differ`` the others)
    and the columns whose argmax rows differ (``argmax_near_tie`` of them
    with their two largest q within 1e-6 relative, ``argmax_differ`` the
    others). A column with a near-threshold entry or a near tie on one
    side only is renormalized by another sum, so its values are not held
    to the tolerance (``columns_excused``); over the other columns, the
    largest absolute difference and the entries outside RTOL·|want| +
    ATOL (the pass's own, numpy.allclose's; NaN on both sides agrees, on
    one side only is outside)."""
    from haphic_tpu_torch.kernels.mcl_column import ATOL, RTOL
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


# the sparse column step's agreement: entries above KEPT must be kept by
# both versions (tests' KEPT), the others within RTOL·|b| + ATOL
SPARSE_KEPT = 1e-6
SPARSE_RTOL, SPARSE_ATOL = 1e-5, 1e-7


def sparse_column_compare(a_i, a_v, b_i, b_v, n: int) -> dict:
    """Two (..., K) sparse iterates entry by entry, matched by row id
    (each id once a column, sentinels n ignored; an id on one side only
    counts as 0 on the other): the largest absolute difference, the
    entries outside SPARSE_RTOL·|b| + SPARSE_ATOL, and the entries above
    SPARSE_KEPT on one side only. Rows are columns of the iterates, so
    the merge is along the last axis."""
    from haphic_tpu_torch.kernels.sparse_column import (
        _shift_left, _shift_right, _sort_by_id)
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
    out = (diff > SPARSE_RTOL * gb.abs() + SPARSE_ATOL) & real
    kept = ((ga > SPARSE_KEPT) != (gb > SPARSE_KEPT)) & real
    return {'max_abs_err': float(diff.max()) if diff.numel() else 0.0,
            'outside_tol': int(out.sum()), 'kept_differ': int(kept.sum())}


def col_allclose_compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Two (B, C) statistics of the same columns: the columns that are
    −inf on one side only (``inf_differ``), and over the others the
    largest absolute difference (a NaN on both sides agrees, on one side
    only is infinitely far)."""
    ninf = (got == -torch.inf) != (want == -torch.inf)
    both = (got == -torch.inf) & (want == -torch.inf)
    diff = (got.double() - want.double()).abs().masked_fill(
        both | (got.isnan() & want.isnan()), 0.0)
    diff = diff.masked_fill(got.isnan() != want.isnan(), torch.inf)
    diff = diff.masked_fill(ninf, 0.0)
    return {'max_abs_err': float(diff.max()) if diff.numel() else 0.0,
            'inf_differ': int(ninf.sum())}

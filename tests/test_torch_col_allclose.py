"""The sparse MCL convergence statistic (haphic_tpu_torch.kernels.
col_allclose) against the JAX package's _col_allclose_stat, on the CPU,
where the wrapper runs its plain version.

The column pairs are tests/test_torch_kernels.py's: every kind (equal
columns, equal ids, disjoint ids, a partial overlap, old only, new only,
sentinels only) at Ko, Kn in {1, 5, 16, 128} and unequal widths, values
from 1e-12 to 1. Against JAX the tolerance is the sweep test's (rtol
1e-5, atol 1e-7, tests/test_torch_sparse_mcl.py): JAX takes the run
sums as differences of f32 prefix sums, the port of f64 ones. Against a
numpy reference that takes each id's difference in f64 directly, the
plain version agrees to 1e-12 on f64 inputs, and on f32 ones it gives
that f64 result rounded once. The wrapper raises ValueError on what the
kernel does not take, on both devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haphic_tpu.cluster import sparse_mcl as jsp

from haphic_tpu_torch.cluster import sparse_mcl as tsp
from haphic_tpu_torch.kernels import col_allclose as kca

from .kit import kernelkit as kit
from .test_torch_kernels import STAT_KINDS, STAT_WIDTHS, _stat_case
from .test_torch_sparse_mcl import INFLATIONS, RTOL, ATOL, _ell

torch.set_num_threads(1)

B, C, N_ROWS = 2, 21, 400


def _case(Ko, Kn):
    return _stat_case(Ko * 131 + Kn, B, C, Ko, Kn, N_ROWS)


def _jax_stat(oi, ov, ni, nv, n):
    """jax.vmap of _col_allclose_stat over every column pair."""
    f = jax.vmap(lambda a, b, c, d: jsp._col_allclose_stat(a, b, c, d, n))
    flat = [jnp.asarray(x.reshape((-1,) + x.shape[2:]))
            for x in (oi, ov, ni, nv)]
    return np.asarray(f(*flat)).reshape(oi.shape[:2])


def _reference(oi, ov, ni, nv, n):
    """Per column, max over the union of real ids of |new - old| -
    1e-5·old, each id's values taken in f64 (a side without the id
    counting 0); -inf without a real id."""
    out = np.full(oi.shape[:2], -np.inf)
    for b, c in np.ndindex(*oi.shape[:2]):
        old = {int(i): float(v) for i, v in zip(oi[b, c], ov[b, c]) if i < n}
        new = {int(i): float(v) for i, v in zip(ni[b, c], nv[b, c]) if i < n}
        for r in set(old) | set(new):
            o = old.get(r, 0.0)
            out[b, c] = max(out[b, c], abs(new.get(r, 0.0) - o) - 1e-5 * o)
    return out


def _kinds():
    return np.arange(B * C).reshape(B, C) % len(STAT_KINDS)


@pytest.mark.parametrize('Ko,Kn', STAT_WIDTHS)
def test_col_allclose_matches_jax(Ko, Kn):
    oi, ov, ni, nv = _case(Ko, Kn)
    got = kca.col_allclose(*(torch.as_tensor(x) for x in (oi, ov, ni, nv)),
                           N_ROWS)
    want = _jax_stat(oi, ov, ni, nv, N_ROWS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, C)
    got = got.numpy()
    # the same -inf columns: the sentinel-only ones, and only those
    empty = _kinds() == STAT_KINDS.index('sentinel_only')
    assert np.array_equal(got == -np.inf, empty)
    assert np.array_equal(want == -np.inf, empty)
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('Ko,Kn', STAT_WIDTHS)
def test_col_allclose_plain_matches_f64_reference(Ko, Kn):
    oi, ov, ni, nv = _case(Ko, Kn)
    ref = _reference(oi, ov, ni, nv, N_ROWS)
    ti, tn = torch.as_tensor(oi), torch.as_tensor(ni)
    # f64 values: the plain version's arithmetic alone
    got64 = kca.col_allclose_plain(ti, torch.as_tensor(ov).double(), tn,
                                   torch.as_tensor(nv).double(), N_ROWS)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), ref, rtol=0, atol=1e-12)
    # f32, as the sweep calls it: that f64 result rounded once
    got32 = kca.col_allclose_plain(ti, torch.as_tensor(ov), tn,
                                   torch.as_tensor(nv), N_ROWS)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, got64.float())


def _bad_inputs(kind):
    oi, ov, ni, nv = (torch.as_tensor(x) for x in _case(8, 8))
    if kind == 'int64_ids':
        return oi.long(), ov, ni, nv
    if kind == 'f64_values':
        return oi, ov, ni, nv.double()
    if kind == 'mixed_devices':
        return oi, ov, ni.to('meta'), nv.to('meta')
    if kind == 'other_device':
        return tuple(t.to('meta') for t in (oi, ov, ni, nv))
    if kind == 'columns_differ':
        return oi, ov, ni[:, 1:], nv[:, 1:]
    if kind == 'no_entries':
        return oi[..., :0], ov[..., :0], ni, nv
    if kind == 'column_major':
        return (oi.transpose(1, 2).contiguous().transpose(1, 2),
                ov.transpose(1, 2).contiguous().transpose(1, 2), ni, nv)
    if kind == 'batch_strides_differ':
        return oi, ov.transpose(0, 1).contiguous().transpose(0, 1), ni, nv
    # ELL order broken in column (0, 3)
    side = oi if kind.startswith('old') else ni
    bad = side.clone()
    col = bad[0, 3]
    real = int((col < N_ROWS).sum())
    if kind.endswith('unsorted'):
        col[[0, real - 1]] = col[[real - 1, 0]].clone()
    elif kind.endswith('repeated'):
        col[real - 1] = col[0]
    else:                               # a real id after a sentinel
        col[-1] = min(set(range(N_ROWS)) - set(col.tolist()))
    return (bad, ov, ni, nv) if kind.startswith('old') else (oi, ov, bad, nv)


@pytest.mark.parametrize('kind', [
    'int64_ids', 'f64_values', 'mixed_devices', 'other_device',
    'columns_differ', 'no_entries', 'column_major', 'batch_strides_differ',
    'old_unsorted', 'old_repeated', 'old_after_sentinel', 'new_unsorted',
    'new_repeated', 'new_after_sentinel'])
def test_col_allclose_raises_on_bad_input(kind):
    args = _bad_inputs(kind)
    with pytest.raises(ValueError):
        kca.col_allclose(*args, N_ROWS)


def test_broken_columns_have_room_to_break():
    """Column (0, 3) of the bad-input case is a partial overlap with at
    least two real ids on each side, so each order fault above is one."""
    oi, _, ni, _ = _case(8, 8)
    assert STAT_KINDS[3] == 'partial'
    assert (oi[0, 3] < N_ROWS).sum() >= 2 and (ni[0, 3] < N_ROWS).sum() >= 2
    assert (oi[0, 3] == N_ROWS).any() and (ni[0, 3] == N_ROWS).any()


def test_sweep_cols_takes_its_statistic_from_the_wrapper(monkeypatch):
    """_col_allclose_stat stays the plain version under its JAX name, and
    _sweep_cols's per-inflation statistic is the max of col_allclose over
    each chunk's old and new columns, bit for bit, with the kit's plain
    stand-in in the wrapper's place too."""
    assert tsp._col_allclose_stat is kca.col_allclose_plain
    n, K, chunk = 96, 32, 40
    idx0, val0 = (torch.as_tensor(x) for x in _ell(n, K, 3))
    infl = torch.as_tensor(np.asarray(INFLATIONS[:3], np.float32))
    si, sv = tsp._first_iteration(idx0, val0, infl, n, K, 1e-4)
    ni, nv, stat = tsp._sweep_cols(si, sv, infl, n, K, chunk, 1e-4, 2)
    want = kit.step_stats(kca.col_allclose, si, sv, ni, nv, n, chunk)
    assert torch.equal(stat, want.amax(dim=1))
    with monkeypatch.context() as m:
        m.setattr(tsp, 'col_allclose', kit.col_allclose_plain_stat)
        again = tsp._sweep_cols(si, sv, infl, n, K, chunk, 1e-4, 2)
    assert tsp.col_allclose is kca.col_allclose
    assert all(torch.equal(a, b) for a, b in zip((ni, nv, stat), again))
    # with the host loop's order flag: the same bits, the flag left clear
    bad = torch.zeros(1, dtype=torch.int32)
    flagged = tsp._sweep_cols(si, sv, infl, n, K, chunk, 1e-4, 2, bad=bad)
    assert all(torch.equal(a, b) for a, b in zip((ni, nv, stat), flagged))
    assert int(bad) == 0


@pytest.mark.parametrize('chunk', [7, 40, 97, 4096])
def test_sweep_cols_launches_the_statistic_once_whatever_the_chunk(
        monkeypatch, chunk):
    """_sweep_cols calls col_allclose once a call, on all of its columns,
    whatever the column chunk of its loop (counted through the module's
    attribute on the CPU path), and its statistic has the bits of the
    chunk-by-chunk maximum; for a block of columns [c0, c1) too."""
    n, K = 96, 32
    idx0, val0 = (torch.as_tensor(x) for x in _ell(n, K, 3))
    infl = torch.as_tensor(np.asarray(INFLATIONS[:3], np.float32))
    si, sv = tsp._first_iteration(idx0, val0, infl, n, K, 1e-4)
    calls = []

    def counting(*args, **kw):
        calls.append(args[0].shape[1])
        return kca.col_allclose(*args, **kw)
    monkeypatch.setattr(tsp, 'col_allclose', counting)
    ni, nv, stat = tsp._sweep_cols(si, sv, infl, n, K, chunk, 1e-4, 2)
    assert calls == [n + 1]
    chunked = kit.step_stats(kca.col_allclose, si, sv, ni, nv, n, chunk)
    assert torch.equal(stat, chunked.amax(dim=1))
    calls.clear()
    bi, bv, bstat = tsp._sweep_cols(si, sv, infl, n, K, chunk, 1e-4, 2,
                                    c0=20, c1=71)
    assert calls == [51]
    assert torch.equal(bi, ni[:, 20:71]) and torch.equal(bv, nv[:, 20:71])
    assert torch.equal(bstat, chunked[:, 20:71].amax(dim=1))


def test_sweep_cols_on_an_empty_block():
    """No columns: no statistic call, and -inf for every inflation."""
    n, K = 40, 8
    idx0, val0 = (torch.as_tensor(x) for x in _ell(n, K, 4))
    infl = torch.as_tensor(np.asarray(INFLATIONS[:2], np.float32))
    si, sv = tsp._first_iteration(idx0, val0, infl, n, K, 1e-4)
    n0 = kca.col_allclose.launches
    ni, nv, stat = tsp._sweep_cols(si, sv, infl, n, K, 16, 1e-4, 2, c0=5,
                                   c1=5)
    assert ni.shape == (2, 0, K) and nv.shape == (2, 0, K)
    assert torch.equal(stat, torch.full((2,), -torch.inf))
    assert kca.col_allclose.launches == n0


def test_cpu_wrapper_takes_the_plain_version_in_column_chunks():
    """On CPU tensors the wrapper runs the plain version CPU_CHUNK
    columns at a time: the same bits as one plain call."""
    oi, ov, ni, nv = (torch.as_tensor(x) for x in _stat_case(
        21, 2, 2 * kca.CPU_CHUNK + 3, 4, 4, 900))
    assert torch.equal(kca.col_allclose(oi, ov, ni, nv, 900),
                       kca.col_allclose_plain(oi, ov, ni, nv, 900))


def test_compare_counts_inf_columns_and_the_largest_difference():
    got = torch.tensor([[0.5, -torch.inf, -torch.inf, 1.0, float('nan')]])
    want = torch.tensor([[0.25, -torch.inf, 2.0, 1.0, float('nan')]])
    assert kit.col_allclose_compare(got, want) == {'max_abs_err': 0.25,
                                                   'inf_differ': 1}
    got[0, 3] = float('nan')
    assert kit.col_allclose_compare(got, want)['max_abs_err'] == float('inf')


@pytest.mark.parametrize('layout', ['full', 'partial'])
def test_bound_counts_the_real_entries(layout):
    """The bound's bytes: 8 a real entry of either column, 4 for the
    first sentinel of each column that has one, 4 written a pair; at
    full columns (Ko + Kn)·8 + 4 a pair."""
    B, C, Ko, Kn, n = 2, 3, 4, 6, 50
    oi = torch.arange(Ko, dtype=torch.int32).repeat(B, C, 1)
    ni = torch.arange(Kn, dtype=torch.int32).repeat(B, C, 1)
    if layout == 'full':
        nbytes = B * C * ((Ko + Kn) * 8 + 4)
    else:
        oi[0, 0, 1:] = n                   # 1 real, then sentinels
        oi[1, 2] = n                       # no real id
        ni[0, 1, 5:] = n                   # 5 real
        real = B * C * (Ko + Kn) - 3 - Ko - 1
        nbytes = 8 * real + 4 * 3 + 4 * B * C
    ms, by = kit.col_allclose_bound_ms(oi, ni, n)
    assert by == 'bytes'
    assert abs(ms - nbytes / 3.35e12 * 1e3) < 1e-15


def test_bound_at_full_smoke_columns():
    """At the smoke's step with every column full (B = 4, N = 24,001,
    K = 128), the largest the bound can be: 0.0588 ms."""
    ids = torch.arange(128, dtype=torch.int32).expand(4, 24001, 128)
    ms, by = kit.col_allclose_bound_ms(ids, ids, 24000)
    assert by == 'bytes' and 0.0588 <= ms < 0.0589


@pytest.mark.parametrize('kind', ['int64', 'two', 'other_device'])
def test_col_allclose_raises_on_a_bad_flag(kind):
    args = [torch.as_tensor(x) for x in _case(5, 5)]
    bad = {'int64': torch.zeros(1, dtype=torch.int64),
           'two': torch.zeros(2, dtype=torch.int32),
           'other_device': torch.zeros(1, dtype=torch.int32,
                                       device='meta')}[kind]
    with pytest.raises(ValueError):
        kca.col_allclose(*args, N_ROWS, bad=bad)


@pytest.mark.parametrize('kind', ['old_unsorted', 'new_after_sentinel'])
def test_col_allclose_raises_at_once_on_the_cpu_with_a_flag(kind):
    """On the CPU the order is checked at once, a flag given or not; the
    flag stays clear."""
    bad = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        kca.col_allclose(*_bad_inputs(kind), N_ROWS, bad=bad)
    assert int(bad) == 0


def test_raise_if_unordered():
    kca.raise_if_unordered(0, 10)
    with pytest.raises(ValueError, match='n = 10'):
        kca.raise_if_unordered(1, 10)

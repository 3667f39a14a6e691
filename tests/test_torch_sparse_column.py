"""The sparse MCL column step (haphic_tpu_torch.kernels.sparse_column)
against the JAX package's per-column composition, on the CPU, where the
wrapper runs its plain version.

Inputs are the 4-block matrices of tests/test_sparse_mcl.py, through
JAX's own pre-expansion and first iteration. Tolerances are those of
tests/test_torch_sparse_mcl.py (rtol=1e-5, atol=1e-7 on the dense
reconstruction, equal sets of entries above 1e-6): both run f32, but
the run sums, the column sums and exp/log round differently. Within the
port, on the CPU, a column's bits do not depend on its chunk or column
block, and every call site of cluster/sparse_mcl.py computes bit for bit
the composition it computed before the kernel existed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haphic_tpu.cluster import sparse_mcl as jsp

from haphic_tpu_torch.cluster import sparse_mcl as tsp
from haphic_tpu_torch.kernels import sparse_column as kcol

from .test_torch_sparse_mcl import INFLATIONS, _assert_close, _ell

torch.set_num_threads(1)

PRUNING = 1e-4


def _state(n, K, seed):
    """JAX's pre-expanded, first-iterated iterate of a 4-block matrix,
    (B, n+1, K) for the first three INFLATIONS, as numpy."""
    idx0, val0 = _ell(n, K, seed)
    infl = np.asarray(INFLATIONS[:3], np.float32)
    ji, jv = jnp.asarray(idx0), jnp.asarray(val0)
    pi, pv = jsp._pre_expand(ji, jv, ji, jv, n, K, 32)
    si, sv = jsp._first_iteration(pi, pv, jnp.asarray(infl), n, K, PRUNING)
    return np.array(si), np.array(sv), infl


def _jax_cols(si, sv, infl, n, K, expansion):
    """JAX's _sweep_cols over every column (the vmapped per-column
    composition, haphic_tpu/cluster/sparse_mcl.py:164-204)."""
    a_i, a_v = jnp.asarray(si), jnp.asarray(sv)
    wi, wv, _ = jsp._sweep_cols(a_i, a_v, a_i, a_v, jnp.asarray(infl), n,
                                K, 32, PRUNING, expansion)
    return np.asarray(wi), np.asarray(wv)


def _torch_cols(si, sv, infl, n, K, expansion):
    """The same through sparse_column, composed as _sweep_cols does."""
    A_i, A_v = torch.as_tensor(si), torch.as_tensor(sv)
    f = torch.as_tensor(infl)
    di, dv = A_i, A_v
    for _ in range(expansion - 2):
        di, dv = kcol.sparse_column(A_i, A_v, di, dv, torch.ones_like(f), n,
                                    K, 0.0, True)
    return kcol.sparse_column(A_i, A_v, di, dv, f, n, K, PRUNING, True)


def _case_step(n, K, seed, expansion):
    si, sv, infl = _state(n, K, seed)
    return (_torch_cols(si, sv, infl, n, K, expansion),
            _jax_cols(si, sv, infl, n, K, expansion))


def _case_first_iteration(n, K, seed):
    idx0, val0 = _ell(n, K, seed)
    infl = np.asarray(INFLATIONS, np.float32)
    B = len(infl)
    ti, tv = torch.as_tensor(idx0), torch.as_tensor(val0)
    got = kcol.sparse_column(None, None, ti.expand(B, -1, -1),
                             tv.expand(B, -1, -1), torch.as_tensor(infl),
                             n, K, PRUNING, False)
    want = jsp._first_iteration(jnp.asarray(idx0), jnp.asarray(val0),
                                jnp.asarray(infl), n, K, PRUNING)
    return got, want


def _case_pre_expand(n, K, seed):
    idx0, val0 = _ell(n, K, seed)
    ti, tv = torch.as_tensor(idx0)[None], torch.as_tensor(val0)[None]
    got = kcol.sparse_column(ti, tv, ti, tv, torch.ones(1), n, K, 0.0, True)
    ji, jv = jnp.asarray(idx0), jnp.asarray(val0)
    want = jsp._pre_expand(ji, jv, ji, jv, n, K, 8)
    return got, tuple(np.asarray(x)[None] for x in want)


@pytest.mark.parametrize('case', [
    lambda: _case_step(96, 96, 2, 2),
    lambda: _case_step(48, 48, 4, 3),
    lambda: _case_step(96, 16, 2, 2),
    lambda: _case_first_iteration(96, 40, 2),
    lambda: _case_pre_expand(96, 24, 7),
], ids=['expansion2', 'expansion3', 'capped', 'first_iteration',
        'pre_expand'])
def test_sparse_column_matches_jax(case):
    (gi, gv), (wi, wv) = case()
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    assert tuple(gi.shape) == np.asarray(wi).shape
    n = gi.shape[1] - 1
    _assert_close(gi.numpy(), gv.numpy(), np.asarray(wi), np.asarray(wv),
                  n)


def test_capped_case_has_columns_over_K():
    """The capped case's input has columns wider than K, and its
    expanded columns more distinct rows than K."""
    from .test_sparse_mcl import _block_matrix, _to_coo
    i, j, w = _to_coo(_block_matrix(n=96, n_blocks=4, seed=2))
    assert jsp.coo_to_ell(i, j, w, 96, 16)[2] > 0
    si, sv, infl = _state(96, 16, 2)
    A_i, A_v = torch.as_tensor(si), torch.as_tensor(sv)
    di, dv = kcol._expand(A_i, A_v, A_i, A_v, 96)
    assert int(((dv > 0).sum(dim=-1)).max()) > 16


def test_column_block_and_chunk_give_the_slice_bit_for_bit():
    """A column block [c0, c1) and another chunk give the slice of the
    whole, bit for bit."""
    n, K = 96, 48
    si, sv, infl = _state(n, K, 2)
    A_i, A_v = torch.as_tensor(si), torch.as_tensor(sv)
    f = torch.as_tensor(infl)
    whole = kcol.sparse_column(A_i, A_v, A_i, A_v, f, n, K, PRUNING, True)
    part = kcol.sparse_column(A_i, A_v, A_i[:, 30:71], A_v[:, 30:71], f, n,
                              K, PRUNING, True)
    for a, b in zip(whole, part):
        assert torch.equal(a[:, 30:71], b)
    full = tsp._sweep_cols(A_i, A_v, f, n, K, 32, PRUNING, 2)
    other = tsp._sweep_cols(A_i, A_v, f, n, K, 13, PRUNING, 2)
    block = tsp._sweep_cols(A_i, A_v, f, n, K, 8, PRUNING, 2, 40, 80)
    for t in range(2):
        assert torch.equal(full[t], whole[t])
        assert torch.equal(full[t], other[t])
        assert torch.equal(full[t][:, 40:80], block[t])
    assert torch.equal(full[2], other[2])


# the call sites of cluster/sparse_mcl.py as they were written before the
# column step became one call: the plain functions composed by hand


def _sweep_cols_before(A_i, A_v, infl, n, K, chunk, pruning, expansion):
    B, N = A_i.shape[0], A_i.shape[1]
    new_i = A_i.new_empty((B, N, A_i.shape[2]))
    new_v = A_v.new_empty((B, N, A_v.shape[2]))
    maxstat = torch.full((B,), -torch.inf)
    f = infl.view(B, 1, 1)
    for s in range(0, N, chunk):
        e = min(N, s + chunk)
        ci, cv = A_i[:, s:e], A_v[:, s:e]
        di, dv = kcol._expand(A_i, A_v, ci, cv, n)
        for _ in range(expansion - 2):
            di, dv = kcol._inflate_cap_prune(di, dv, 1.0, 0.0, n, K)
            di, dv = kcol._expand(A_i, A_v, di, dv, n)
        ni, nv = kcol._inflate_cap_prune(di, dv, f, pruning, n, K)
        stat = tsp._col_allclose_stat(ci, cv, ni, nv, n)
        maxstat = torch.maximum(maxstat, stat.amax(dim=-1))
        new_i[:, s:e] = ni
        new_v[:, s:e] = nv
    return new_i, new_v, maxstat


def _pre_expand_before(base_i, base_v, cur_i, cur_v, n, K, chunk):
    out_i = torch.empty_like(cur_i)
    out_v = torch.empty_like(cur_v)
    for s in range(0, cur_i.shape[0], chunk):
        di, dv = kcol._expand(base_i[None], base_v[None],
                              cur_i[None, s:s + chunk],
                              cur_v[None, s:s + chunk], n)
        ni, nv = kcol._inflate_cap_prune(di, dv, 1.0, 0.0, n, K)
        out_i[s:s + chunk] = ni[0]
        out_v[s:s + chunk] = nv[0]
    out_i[n] = n
    out_v[n] = 0.0
    return out_i, out_v


def _first_iteration_before(idx0, val0, inflations, n, K, pruning):
    B = inflations.shape[0]
    shape = (B,) + tuple(idx0.shape)
    i0, v0 = kcol._inflate_cap_prune(idx0.expand(shape), val0.expand(shape),
                                     inflations.view(B, 1, 1), pruning, n, K)
    i0[:, n] = n
    v0[:, n] = 0.0
    return i0, v0


@pytest.mark.parametrize('site', ['sweep_cols', 'pre_expand',
                                  'first_iteration'])
def test_call_sites_compute_what_they_computed_before(site):
    n, K = 96, 32
    idx0, val0 = (torch.as_tensor(x) for x in _ell(n, K, 3))
    infl = torch.as_tensor(np.asarray(INFLATIONS[:3], np.float32))
    if site == 'pre_expand':
        got = tsp._pre_expand(idx0, val0, idx0, val0, n, K, 24)
        want = _pre_expand_before(idx0, val0, idx0, val0, n, K, 24)
    elif site == 'first_iteration':
        got = tsp._first_iteration(idx0, val0, infl, n, K, PRUNING)
        want = _first_iteration_before(idx0, val0, infl, n, K, PRUNING)
    else:
        si, sv = _first_iteration_before(idx0, val0, infl, n, K, PRUNING)
        got, want = [], []
        for expansion in (2, 3):
            got += tsp._sweep_cols(si, sv, infl, n, K, 40, PRUNING,
                                   expansion)
            want += _sweep_cols_before(si, sv, infl, n, K, 40, PRUNING,
                                       expansion)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)

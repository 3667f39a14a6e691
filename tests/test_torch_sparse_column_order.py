"""The sparse MCL column step's input contract, on the CPU: every column
of ci, and with ``expand`` every column of A_i, holds ascending distinct
row ids below n, then only the sentinel n (the ELL order of the JAX
package, haphic_tpu/cluster/sparse_mcl.py:13-16). The CUDA kernel's
dedupe relies on it, so kernels.sparse_column checks it on both devices
and raises ValueError otherwise; and every call site of
cluster/sparse_mcl.py passes columns in that order."""

import numpy as np
import pytest
import torch

from haphic_tpu_torch.cluster import sparse_mcl as tsp
from haphic_tpu_torch.kernels import sparse_column as kcol

from .test_torch_sparse_mcl import INFLATIONS, _ell

torch.set_num_threads(1)

N_ROWS, K = 60, 8


def _iterate():
    """A (1, n+1, K) ELL iterate whose column 3 has 4 real entries."""
    rng = np.random.default_rng(0)
    idx = np.full((1, N_ROWS + 1, K), N_ROWS, dtype=np.int32)
    val = np.zeros((1, N_ROWS + 1, K), dtype=np.float32)
    for j in range(N_ROWS):
        m = 4 if j == 3 else int(rng.integers(1, K + 1))
        idx[0, j, :m] = np.sort(rng.choice(N_ROWS, m, replace=False))
        w = rng.exponential(1.0, m)
        val[0, j, :m] = w / w.sum()
    return torch.as_tensor(idx), torch.as_tensor(val)


def _break(idx, how):
    """A copy of ``idx`` with column 3 out of order."""
    bad = idx.clone()
    col = bad[0, 3]
    if how == 'unsorted':
        col[[1, 2]] = col[[2, 1]].clone()
    elif how == 'repeated':
        col[2] = col[1]
    else:                       # a new real id after a sentinel
        col[K - 1] = min(set(range(N_ROWS)) - set(col.tolist()))
    return bad


@pytest.mark.parametrize('how', ['unsorted', 'repeated', 'after_sentinel'])
@pytest.mark.parametrize('where', ['ci', 'ci_expand0', 'A_i'])
def test_sparse_column_raises_on_columns_out_of_order(how, where):
    A_i, A_v = _iterate()
    infl = torch.tensor([2.0])
    bad = _break(A_i, how)
    if where == 'ci':
        args = (A_i, A_v, bad, A_v, True)
    elif where == 'ci_expand0':
        args = (None, None, bad, A_v, False)
    else:
        args = (bad, A_v, A_i, A_v, True)
    a_i, a_v, c_i, c_v, expand = args
    name = 'A_i' if where == 'A_i' else 'ci'
    with pytest.raises(ValueError, match='^{}: .*ascending distinct'.format(
            name)):
        kcol.sparse_column(a_i, a_v, c_i, c_v, infl, N_ROWS, K, 1e-4, expand)
    # the unbroken iterate passes, and an A_i broken in place after it
    # passed is checked again
    kcol.sparse_column(A_i, A_v, A_i, A_v, infl, N_ROWS, K, 1e-4, True)
    if where == 'A_i':
        ci, cv = A_i[:, :1].clone(), A_v[:, :1].clone()
        A_i.copy_(bad)
        with pytest.raises(ValueError, match='^A_i: '):
            kcol.sparse_column(A_i, A_v, ci, cv, infl, N_ROWS, K, 1e-4, True)


@pytest.mark.parametrize('site', ['pre_expand', 'first_iteration',
                                  'sweep_cols2', 'sweep_cols3'])
def test_call_sites_pass_columns_in_ell_order(monkeypatch, site):
    """Every launch of _pre_expand, _first_iteration and _sweep_cols
    (expansion 2 and 3), on tests/test_sparse_mcl.py's block matrices,
    passes ci (and A_i) in ELL order."""
    n, K = 96, 24
    idx0, val0 = (torch.as_tensor(x) for x in _ell(n, K, 3))
    infl = torch.as_tensor(np.asarray(INFLATIONS[:3], np.float32))
    calls = []

    def recording(A_i, A_v, ci, cv, infl, n_, K_, pruning, expand):
        kcol._check_order('ci', ci, n_)
        if expand:
            kcol._check_order('A_i', A_i, n_)
        calls.append(expand)
        return kcol.sparse_column(A_i, A_v, ci, cv, infl, n_, K_, pruning,
                                  expand)
    monkeypatch.setattr(tsp, 'sparse_column', recording)
    if site == 'pre_expand':
        tsp._pre_expand(idx0, val0, idx0, val0, n, K, 24)
        assert calls == [True] * 5
    elif site == 'first_iteration':
        tsp._first_iteration(idx0, val0, infl, n, K, 1e-4)
        assert calls == [False]
    else:
        pi, pv = tsp._pre_expand(idx0, val0, idx0, val0, n, K, 24)
        si, sv = tsp._first_iteration(pi, pv, infl, n, K, 1e-4)
        calls.clear()
        expansion = int(site[-1])
        tsp._sweep_cols(si, sv, infl, n, K, 40, 1e-4, expansion)
        assert calls == [True] * (3 * (expansion - 1))

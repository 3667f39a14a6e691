"""The sparse engine's ELL build (haphic_tpu_torch.kernels.ell_build) on
the CPU: the wrapper's plain version, the kernel's stages in torch ops,
bit-equal to the JAX package's ``coo_to_ell`` (host numpy) on the seeded
cases of tests/ell_cases.py, and the run sums pinned to numpy's order;
``cluster.sparse_mcl.coo_to_ell`` on the CPU is that plain version. The
kernel itself is held to the plain version on the card in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from haphic_tpu.cluster import sparse_mcl as jsp

from haphic_tpu_torch.cluster import sparse_mcl as tsp
from haphic_tpu_torch.kernels import ell_build as keb

from . import ell_cases

torch.set_num_threads(1)


def _tensors(i, j, w):
    return [torch.as_tensor(x) for x in (i, j, w)]


@pytest.mark.parametrize('K', ell_cases.KS)
@pytest.mark.parametrize('case', ell_cases.CASES)
def test_plain_version_bit_equal_to_jax(case, K):
    i, j, w, n = ell_cases.links(case, K)
    want = jsp.coo_to_ell(i, j, w, n, K)
    n0 = keb.ell_build.launches
    idx, val, overflow, wide = keb.ell_build(*_tensors(i, j, w), n, K)
    assert keb.ell_build.launches == n0         # CPU tensors: no launch
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    assert np.array_equal(idx.numpy(), want[0])
    assert np.array_equal(val.numpy().view(np.int32),
                          want[1].view(np.int32))   # -0.0 and 0.0 apart
    assert overflow == want[2]
    assert wide == (1 if case == 'star' else 0)
    # the exact case fits K, the capped, zero and star cases do not
    assert (overflow == 0) == (case == 'exact') or case == 'duplicates'


@pytest.mark.parametrize('length', [2, 5, 8, 9, 20, 128, 129, 130, 300,
                                    1000])
def test_run_sums_follow_numpy_reduceat(length):
    """A run's sum is np.add.reduceat's: its first term plus numpy's
    pairwise sum of the rest, not a plain left-to-right sum (the two
    differ on some of these runs of 9 terms or more)."""
    rng = np.random.default_rng(length)
    runs = 64
    v = rng.random(runs * length) * 10.0 ** rng.uniform(-8, 8,
                                                        runs * length)
    starts = np.arange(0, runs * length, length)
    want = np.add.reduceat(v, starts)
    got = keb._run_sums(torch.as_tensor(v), torch.as_tensor(starts),
                        torch.full((runs,), length)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    if length >= 9:
        seq = np.array([float(sum(v[s:s + length].tolist()))
                        for s in starts])
        assert not np.array_equal(seq, want)


def test_coo_to_ell_takes_the_host_route_on_the_cpu():
    """coo_to_ell on the CPU returns CPU tensors bit-equal to the JAX
    package's numpy arrays on every case (ell_build's plain version, no
    launch; its wide columns counted as the kernel would take them), and
    a run_mcl_sparse call on the CPU launches no kernel."""
    n0 = keb.ell_build.launches
    for case in ell_cases.CASES:
        i, j, w, n = ell_cases.links(case, 8)
        got = tsp.coo_to_ell(i, j, w, n, 8, device='cpu')
        want = jsp.coo_to_ell(i, j, w, n, 8)
        assert all(isinstance(x, torch.Tensor) and x.device.type == 'cpu'
                   for x in got[:2])
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy().view(np.int32),
                              want[1].view(np.int32))
        assert got[2] == want[2]
        assert tsp.coo_to_ell.wide_columns == (1 if case == 'star' else 0)
    i, j, w, n = ell_cases.links('duplicates', 8)
    tsp.run_mcl_sparse(i, j, w, n, [2.0], K=8, max_iter=4, device='cpu')
    assert keb.ell_build.launches == n0


def test_plain_version_rejects_bad_input():
    i, j, w, n = _tensors(*ell_cases.links('exact', 8)[:3]) + [31]
    for args in ((i.int(), j, w), (i, j, w.float()), (i[:-1], j, w),
                 (i, j[::2].clone().repeat(2)[:j.numel() + 1], w)):
        with pytest.raises(ValueError):
            keb.ell_build(*args, n, 8)
    with pytest.raises(ValueError):                # an id past n
        keb.ell_build(i, torch.where(j == j.max(), n, j), w, n, 8)
    with pytest.raises(ValueError):
        keb.ell_build(i, j, w, n, 0)

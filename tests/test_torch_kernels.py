"""The port's hand-written CUDA kernels against their plain torch
versions, on the card. CUDA kernels have no CPU mode, so these tests
carry the `cuda` marker and skip on a host without a card. This file
imports neither JAX nor the JAX package, so it also runs on a card
host without them:

    HAPHIC_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_kernels.py

(HAPHIC_TEST_TPU=1 keeps the repo's conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

from haphic_tpu_torch.kernels import score as kscore


def _score_case(seed, G, P, k, R):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1000, 500000, (G, k)).astype(np.int64)
    pa = rng.integers(0, k, (G, R)).astype(np.int32)
    pb = rng.integers(0, k, (G, R)).astype(np.int32)
    sel = pa == pb
    pb[sel] = (pb[sel] + 1) % k
    d = rng.integers(1, 100000, (G, 4, R)).astype(np.float32)
    w = rng.random((G, R)).astype(np.float32)
    order = np.argsort(rng.random((G, P, k)), axis=2).astype(np.int32)
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)
    return [torch.as_tensor(x) for x in (order, ori, lengths, pa, pb, d, w)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('G,P,k,R', [
    (2, 6, 32, 1000),        # tables of 16 tours per block in smem
    (3, 100, 1024, 9000),    # main-path k_pad, ragged record count
    (1, 3, 5000, 3000),      # one tour per block, large smem
    (1, 2, 20000, 5000),     # tables past shared memory: global reads
    (2, 256, 8, 0),          # P at its limit, no records
], ids=['small', 'main-k', 'smem-1', 'global', 'no-records'])
def test_score_kernel_matches_plain(card, G, P, k, R):
    case = [x.to(card) for x in _score_case(G * k + R, G, P, k, R)]
    n0 = kscore.score_population.launches
    got = kscore.score_population(*case)
    want = kscore.score_population_plain(*case)
    torch.cuda.synchronize()
    assert kscore.score_population.launches == n0 + 1
    assert got.shape == (G, P) and got.dtype == torch.float32
    # the sums run in another order: equal to f32 rounding
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-30)


@pytest.mark.cuda
def test_score_kernel_rejects_bad_input(card):
    case = [x.to(card) for x in _score_case(0, 1, 4, 16, 100)]
    bad = list(case)
    bad[0] = case[0].to(torch.int64)
    with pytest.raises(ValueError):
        kscore.score_population(*bad)
    bad = list(case)
    bad[3] = case[3].cpu()
    with pytest.raises(ValueError):
        kscore.score_population(*bad)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    case = _score_case(1, 2, 5, 16, 300)
    n0 = kscore.score_population.launches
    got = kscore.score_population(*case)
    assert kscore.score_population.launches == n0
    assert torch.equal(got, kscore.score_population_plain(*case))

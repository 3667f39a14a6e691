"""The dense sweep's labels of its final matrices
(haphic_tpu_torch.kernels.mcl_interpret) and the partitions built from
them (cluster.mcl.partition_from_labels), held to interpret_result.

On the CPU the wrapper runs its plain version: with the host's grouping
it must give partitions ``==`` to interpret_result's on converged sweeps,
seeded block matrices and planted cases (overlapping attractor rows, an
uncovered column, identical attractor rows, a non-attractor row that
covers columns, no attractors, n = 1, -0.0 and NaN entries). The tests
marked ``cuda`` hold the kernel's labels to the plain version's and the
sweep's card route to interpret_result; they skip without a card.

Imports nothing of JAX, so that the card tests run beside the others;
test_torch_mcl.py holds the same cases to the JAX package's
interpret_result."""

import numpy as np
import pytest
import torch

from haphic_tpu_torch import trace
from haphic_tpu_torch.cluster import mcl
from haphic_tpu_torch.kernels import mcl_interpret as kmi

torch.set_num_threads(1)

INFLATIONS = [1.4, 2.0, 2.6, 3.2]


def _links(n, block, seed):
    """Upper-triangle COO links: dense blocks of ``block`` fragments,
    a few weak links between blocks."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 4, (n, n)).astype(np.float64)
    same = np.arange(n)[:, None] // block == np.arange(n)[None, :] // block
    w = np.where(same, w * 20, w * (rng.random((n, n)) < 0.05))
    ci, cj = np.nonzero(np.triu(w, 1))
    return ci, cj, w[ci, cj], n


def _block_matrix(n, seed, attractors=(1, 2), stray=0.3):
    """A final matrix shaped like MCL's: a random partition of the n
    columns, in each cluster 1 or 2 attractor rows (equal supports,
    positive values) over the cluster's columns, and, with probability
    ``stray``, a non-attractor row of the cluster with entries there."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), np.float32)
    label = rng.integers(0, max(1, n // 5), n)
    for c in np.unique(label):
        cols = np.flatnonzero(label == c)
        k = min(len(cols), int(rng.choice(attractors)))
        for a in rng.choice(cols, k, replace=False):
            m[a, cols] = rng.random(len(cols)).astype(np.float32) + 0.1
        others = np.setdiff1d(cols, np.flatnonzero(np.diagonal(m)))
        if len(others) and rng.random() < stray:
            r = rng.choice(others)
            m[r, cols] = rng.random(len(cols)).astype(np.float32)
            m[r, r] = 0.0
    return m


# (seed, n, block) of the converged sweeps; (seed, n) of the block matrices
CONVERGED = [(0, 40, 10), (1, 48, 12), (2, 37, 9), (3, 64, 16)]
SEEDED = [(seed, n) for seed in range(6) for n in (1, 2, 17, 60)]


def converged_matrices(seed, n, block):
    """run_mcl's final matrices on the CPU over INFLATIONS, for
    ``_links(n, block, seed)``."""
    ci, cj, cw, _ = _links(n, block, seed)
    adj = mcl._coo_to_dense_np(ci, cj, cw, n)
    return mcl.run_mcl(adj, INFLATIONS, max_iter=60, device='cpu',
                       device_min_n=0).matrices


def seeded_pair(seed, n):
    """A block matrix and its broken twin (a column of one cluster put
    in another), stacked."""
    m = _block_matrix(n, seed)
    broken = m.copy()
    if n > 1:
        a = int(np.flatnonzero(np.diagonal(m))[0])
        j = int(np.flatnonzero(m[a] == 0)[0]) if (m[a] == 0).any() else a
        broken[a, j] = 1.0
    return np.stack([m, broken])


def _planted():
    """(name, matrix): the cases the criterion must get right."""
    cases = []
    m = np.zeros((6, 6), np.float32)
    m[0, [0, 1, 2]] = 1.0
    m[3, [2, 3, 4, 5]] = 1.0
    cases.append(('overlapping-rows', m))
    m = np.zeros((5, 5), np.float32)
    m[0, [0, 1]] = 1.0
    m[2, [2, 3]] = 1.0
    cases.append(('uncovered-column', m))
    m = np.zeros((6, 6), np.float32)
    m[1, [0, 1, 2]] = 0.5
    m[2, [0, 1, 2]] = 0.25
    m[4, [3, 4, 5]] = 1.0
    cases.append(('identical-rows', m))
    m = np.zeros((6, 6), np.float32)
    m[2, [0, 1, 2]] = 1.0
    m[5, [3, 4, 5]] = 1.0
    m[0, [1, 3, 4]] = 1.0           # no diagonal: not an attractor
    cases.append(('stray-row-covers', m))
    m = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
    cases.append(('no-attractors', m))
    cases.append(('n1', np.array([[0.7]], np.float32)))
    cases.append(('n1-zero', np.zeros((1, 1), np.float32)))
    m = np.zeros((4, 4), np.float32)
    m[0, [0, 1]] = 1.0
    m[2, [2, 3]] = 1.0
    m[3, 3] = -0.0                  # -0.0 is zero: row 3 no attractor
    m[3, 0] = 1.0
    cases.append(('negative-zero', m))
    m = np.zeros((4, 4), np.float32)
    m[0, [0, 1]] = 1.0
    m[2, [2, 3]] = 1.0
    m[3, [3]] = np.nan              # NaN is nonzero: row 3 an attractor
    cases.append(('nan-diagonal', m))
    m = np.zeros((4, 4), np.float32)
    m[0, [0, 1]] = 1.0
    m[0, 2] = np.nan                # NaN joins column 2 to cluster 0
    m[2, [2, 3]] = 1.0
    cases.append(('nan-overlap', m))
    m = np.zeros((5, 5), np.float32)
    m[1, [0, 1, 2, 3, 4]] = 1.0
    m[3, [3, 4]] = 1.0              # nested in row 1
    cases.append(('nested-rows', m))
    m = np.zeros((5, 5), np.float32)
    m[0, [0, 3]] = 1.0
    m[3, [0, 3]] = 1.0              # L(3) = 0: row 3 is row 0's twin
    m[1, [1, 2, 4]] = 1.0
    cases.append(('label-below-attractor', m))
    m = np.zeros((5, 5), np.float32)
    m[0, [0, 3]] = 1.0
    m[3, [0, 3, 4]] = 1.0           # L(3) = 0, but row 3 differs
    m[1, [1, 2]] = 1.0
    cases.append(('twin-differs', m))
    cases.append(('identity', np.eye(7, dtype=np.float32)))
    return cases


PLANTED = _planted()


def partitions(mats: np.ndarray):
    """The partitions of the labels route: mcl_labels, then
    partition_from_labels, one a matrix."""
    labels = kmi.mcl_labels(torch.from_numpy(mats)).numpy()
    return [mcl.partition_from_labels(row) for row in labels]


def _want(mats: np.ndarray):
    return [mcl.interpret_result(x) for x in mats]


# ---- on the CPU ----

@pytest.mark.parametrize('seed,n,block', CONVERGED)
def test_converged_sweeps(seed, n, block):
    mats = converged_matrices(seed, n, block)
    want = _want(mats)
    assert any(w is not None for w in want)
    assert partitions(mats) == want


@pytest.mark.parametrize('seed,n', SEEDED)
def test_seeded_block_matrices(seed, n):
    mats = seeded_pair(seed, n)
    want = _want(mats)
    assert want[0] is not None
    assert partitions(mats) == want


@pytest.mark.parametrize('name,m', PLANTED, ids=[c[0] for c in PLANTED])
def test_planted_cases(name, m):
    assert partitions(m[None]) == _want(m[None])


def test_planted_cases_decide_both_ways():
    got = {name: partitions(m[None])[0] for name, m in PLANTED}
    for name in ('overlapping-rows', 'uncovered-column', 'no-attractors',
                 'n1-zero', 'nan-overlap', 'nested-rows', 'twin-differs'):
        assert got[name] is None, name
    assert got['identical-rows'] == [(0, 1, 2), (3, 4, 5)]
    assert got['stray-row-covers'] == [(0, 1, 2), (3, 4, 5)]
    assert got['label-below-attractor'] == [(0, 3), (1, 2, 4)]
    assert got['negative-zero'] == [(0, 1), (2, 3)]
    assert got['nan-diagonal'] is None
    assert got['n1'] == [(0,)]
    assert got['identity'] == [(i,) for i in range(7)]


def test_partition_from_labels_groups_by_least_member():
    lab = np.array([4, 1, 4, 1, 4, 0, 6], np.int32)
    assert mcl.partition_from_labels(lab) == [(0, 2, 4), (1, 3), (5,),
                                              (6,)]
    assert mcl.partition_from_labels(np.full(5, -1, np.int32)) is None


def test_plain_version_labels():
    """The labels themselves: the least attractor row over each column,
    a row of -1 where the matrix is no partition."""
    m = dict(PLANTED)['label-below-attractor']
    got = kmi.mcl_labels(torch.from_numpy(m[None]))
    assert got.dtype == torch.int32
    assert got.tolist() == [[0, 1, 1, 0, 1]]
    bad = dict(PLANTED)['overlapping-rows']
    assert kmi.mcl_labels(torch.from_numpy(bad[None])).tolist() == \
        [[-1] * 6]


@pytest.mark.parametrize('shape,dtype', [((2, 3, 4), torch.float32),
                                         ((3, 3), torch.float32),
                                         ((1, 0, 0), torch.float32),
                                         ((1, 3, 3), torch.float64)])
def test_wrapper_rejects_bad_input(shape, dtype):
    with pytest.raises(ValueError):
        kmi.mcl_labels(torch.zeros(shape, dtype=dtype))


def test_wrapper_rejects_a_strided_batch():
    m = torch.zeros((4, 4, 4))[::2]
    with pytest.raises(ValueError):
        kmi.mcl_labels(m)


@pytest.mark.parametrize('device_min_n', [None, 0],
                         ids=['host-numpy', 'torch-cpu'])
def test_cpu_routes_keep_interpret_result(monkeypatch, device_min_n):
    """Below DEVICE_MIN_N the numpy route reads each matrix with
    interpret_result; the torch route on the CPU reads each batch's
    labels from mcl_labels (its plain version: no launch) and never calls
    interpret_result. Both give interpret_result's partitions."""
    calls, labelled = [], []
    real, real_labels = mcl.interpret_result, mcl.mcl_labels

    def counted(x, *a, **k):
        calls.append(x.shape)
        return real(x, *a, **k)

    def labels(m):
        labelled.append(m.shape[0])
        return real_labels(m)

    monkeypatch.setattr(mcl, 'interpret_result', counted)
    monkeypatch.setattr(mcl, 'mcl_labels', labels)
    n0 = kmi.mcl_labels.launches
    coo = _links(36, 12, 4)
    parts, _, _ = mcl.run_mcl_partitions(None, INFLATIONS, coo=coo,
                                         max_iter=60, device='cpu',
                                         device_min_n=device_min_n)
    assert len(parts) == len(INFLATIONS)
    if device_min_n is None:
        assert len(calls) == len(INFLATIONS) and not labelled
    else:
        assert not calls and sum(labelled) == len(INFLATIONS)
    assert kmi.mcl_labels.launches == n0
    res = mcl.run_mcl(mcl._coo_to_dense_np(*coo), INFLATIONS, max_iter=60,
                      device_min_n=device_min_n, device='cpu')
    assert parts == [real(m) for m in res.matrices]


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _large_cases(n, seed):
    """(B, n, n) final matrices at n: seeded block matrices, each broken
    one way (overlap, an uncovered column, a NaN, a nested row), the
    identity and a matrix of zeros."""
    rng = np.random.default_rng(seed)
    good = [_block_matrix(n, seed + k, stray=0.5) for k in range(3)]
    out = list(good)
    m = good[0].copy()
    att = np.flatnonzero(np.diagonal(m))
    m[att[0], np.flatnonzero(m[att[-1]])[:3]] = 0.5       # overlap
    out.append(m)
    m = good[1].copy()
    j = int(rng.integers(0, n))
    m[:, j] = 0.0
    m[j, j] = 0.0                                          # uncovered
    out.append(m)
    m = good[2].copy()
    att = np.flatnonzero(np.diagonal(m))
    m[att[len(att) // 2], n - 1] = np.nan                  # NaN join
    out.append(m)
    out.append(np.eye(n, dtype=np.float32))
    out.append(np.zeros((n, n), np.float32))
    return np.stack(out)


def _check_kernel(mats: np.ndarray, dev):
    got = kmi.mcl_labels(torch.from_numpy(mats).to(dev))
    torch.cuda.synchronize()
    want = kmi.mcl_labels_plain(torch.from_numpy(mats))
    assert torch.equal(got.cpu(), want)
    return got.cpu().numpy()


@pytest.mark.cuda
def test_kernel_on_planted_cases(card):
    for name, m in PLANTED:
        lab = _check_kernel(m[None], card)
        assert [mcl.partition_from_labels(lab[0])] == _want(m[None]), name


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1200, 1031, 33, 1025])
def test_kernel_equals_plain_version(card, n):
    """n = 1,200; 1,031 and 1,025 are odd and past one check chunk of
    1,024 columns; 33 is one lane past a strip."""
    mats = _large_cases(n, seed=n)
    lab = _check_kernel(mats, card)
    parts = [mcl.partition_from_labels(row) for row in lab]
    assert parts == _want(mats)
    assert sum(p is not None for p in parts) >= 4   # 3 good + identity


@pytest.mark.cuda
def test_kernel_on_converged_sweeps(card):
    ci, cj, cw, n = _links(1200, 200, 7)
    adj = mcl._coo_to_dense_np(ci, cj, cw, n)
    res = mcl.run_mcl(adj, INFLATIONS, device=card)
    _check_kernel(res.matrices, card)
    assert partitions(res.matrices) == _want(res.matrices)


@pytest.mark.cuda
def test_kernel_allocates_no_pattern_and_waits_for_nothing(card):
    B, n = 4, 2000
    mats = torch.from_numpy(_large_cases(n, 3)[:B]).to(card)
    kmi.mcl_labels(mats)                      # the library loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    torch.cuda.set_sync_debug_mode('error')
    try:
        lab = kmi.mcl_labels(mats)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(card) - before
    # (B, n) int32 labels and attractors, (2, B) counts: no (B, n, n)
    assert grown <= 4 * (2 * B * n + 2 * B) + 3 * 512
    assert grown < B * n * n // 64
    assert torch.equal(lab.cpu(), kmi.mcl_labels_plain(mats.cpu()))


@pytest.mark.cuda
def test_sweep_card_route_equals_interpret_result(card, monkeypatch):
    """run_mcl_partitions on the card: partitions equal interpret_result
    of run_mcl's matrices, one labels launch a batch, interpret_result
    never called, the host syncs unchanged (3 a batch)."""
    monkeypatch.setattr(mcl, '_batch_size', lambda B, n: 2)
    coo = _links(1200, 150, 9)
    infl = [1.2, 1.6, 2.0, 2.6, 3.2]
    res = mcl.run_mcl(mcl._coo_to_dense_np(*coo), infl, device=card)
    want = _want(res.matrices)
    real = mcl.interpret_result
    monkeypatch.setattr(mcl, 'interpret_result', None)
    kmi.mcl_labels.launches = 0
    parts, iters, conv = mcl.run_mcl_partitions(None, infl, coo=coo,
                                                device=card)
    monkeypatch.setattr(mcl, 'interpret_result', real)
    assert parts == want
    assert np.array_equal(iters, res.n_iters)
    assert np.array_equal(conv, res.converged)
    assert kmi.mcl_labels.launches == 3          # batches of 2, 2, 1
    assert any(p is not None for p in parts)


@pytest.mark.cuda
def test_launches_fall_inside_the_pattern_span(card, monkeypatch):
    """With tracing on each labels launch lies inside the device span
    ``mcl.pattern``: an event recorded right after the launch lies
    between the span's two events on the device's clock."""
    monkeypatch.setattr(mcl, '_batch_size', lambda B, n: 2)
    after = []
    real = mcl.mcl_labels

    def marked(m):
        out = real(m)
        opened = [r for r in trace._open if r.name == 'mcl.pattern']
        assert len(opened) == 1 and opened[0].events is not None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        after.append((opened[0].id, e))
        return out

    monkeypatch.setattr(mcl, 'mcl_labels', marked)
    trace.enable(False)
    trace.reset()
    trace.enable()
    try:
        mcl.run_mcl_partitions(None, [1.4, 2.0, 2.6], coo=_links(1200, 200,
                                                                  11),
                               device=card)
    finally:
        trace.enable(False)
    torch.cuda.synchronize()
    spans = {r.id: r for r in trace.records() if r.name == 'mcl.pattern'}
    trace.reset()
    assert len(after) == len(spans) == 2
    for sid, e in after:
        e0, e1 = spans[sid].events
        assert e0.elapsed_time(e) >= 0 and e.elapsed_time(e1) >= 0

"""The port's hand-written CUDA kernels (the tour scorer and the GA's
delta generation) against their plain torch versions, on the card.
CUDA kernels have no CPU mode, so these tests carry the `cuda` marker
and skip on a host without a card. This file
imports neither JAX nor the JAX package, so it also runs on a card
host without them:

    HAPHIC_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_kernels.py

(HAPHIC_TEST_TPU=1 keeps the repo's conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

from haphic_tpu_torch.kernels import delta as kdelta
from haphic_tpu_torch.kernels import score as kscore
from haphic_tpu_torch.order import optimize as topt


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
    (2, 6, 32, 1000),        # all 6 tours in one block, in smem
    (3, 100, 1024, 9000),    # main-path k_pad, ragged record count
    (1, 3, 5000, 3000),      # 3 tours (padded to 4), 160 KB of smem
    (1, 2, 20000, 5000),     # tables past shared memory: global reads
    (2, 256, 8, 0),          # P at its limit, no records
    (2, 40, 4096, 20001),    # 4 tours of k=4096 per block, ragged R
], ids=['small', 'main-k', 'smem-1', 'global', 'no-records', 'k4096'])
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


# --- delta generation ------------------------------------------------------

def _delta_case(seed, G, P, k, R, op=None):
    """Records between contigs at most 4 apart (sorted by contig, as
    build_problem sorts them), a random population and the draws of one
    move per individual; ``op`` forces the move kind."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5000, 40000, (G, k)).astype(np.int64)
    pa = rng.integers(0, max(k - 1, 1), (G, R))
    pb = np.minimum(pa + rng.integers(1, 5, (G, R)), k - 1)
    key = np.sort(pa * k + pb, axis=1)
    pa, pb = (key // k).astype(np.int32), (key % k).astype(np.int32)
    d = rng.integers(1, 40000, (G, 4, R)).astype(np.float32)
    w = rng.integers(1, 4, (G, R)).astype(np.float32)
    order = np.argsort(rng.random((G, P, k)), axis=2).astype(np.int32)
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)
    draws = [rng.random((G, P)).astype(np.float32),
             rng.integers(0, 4, (G, P)) if op is None
             else np.full((G, P), op)] + \
        [rng.integers(0, k, (G, P)) for _ in range(3)] + \
        [rng.random((G, P)).astype(np.float32) for _ in range(2)]
    draws = [x.astype(np.int32) if x.dtype.kind == 'i' else x
             for x in draws]
    return lengths, pa, pb, d, w, order, ori, draws


def _delta_inputs(case, dev, mutprob=1.1):
    """(rec, state, move) on ``dev``: the state built by _Records.caches
    as the GA builds it, the moves by _moves_from_draws."""
    lengths, pa, pb, d, w, order, ori, draws = case
    k = order.shape[-1]
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    rec = topt._Records(put(lengths), put(pa), put(pb), put(d), put(w))
    state = (put(order), put(ori)) + rec.caches(put(order), put(ori))
    move = topt._moves_from_draws(*[put(x) for x in draws], k, mutprob)
    return rec, state, move


def _whole_span(move, op, k):
    """The same rows with one move kind spanning the whole tour."""
    do = torch.ones_like(move[0])
    full = lambda v: torch.full_like(move[1], v)  # noqa: E731
    return (do, full(op), full(0), full(k - 1 if op != 2 else k // 3),
            full(k - 1))


def _both(inputs, accept=None, fns=None):
    """Kernel and plain version (or ``fns``) on clones of the same
    state; returns [(delta, acc, state after)] of each."""
    rec, state, move = inputs
    out = []
    for fn in fns or (kdelta.delta_generation,
                      kdelta.delta_generation_plain):
        st = tuple(x.clone() for x in state)
        delta, acc = fn(st, move, rec.la, rec.lb, rec.d, rec.w,
                        topt._DELTA_MIN_GAIN, topt._DELTA_SPAN_GAIN,
                        accept=accept)
        out.append((delta, acc, st))
    torch.cuda.synchronize()
    return out


def _threshold(state, move):
    do, op, i, j, t = move
    spanv = torch.where(op == 2, t - i, j - i).to(torch.float32)
    return state[-1] * (topt._DELTA_MIN_GAIN
                        + topt._DELTA_SPAN_GAIN * spanv)


def _exact_delta(inputs):
    """Per row, the f64 sum of the plain version's f32 per-record terms
    (new - old contribution) and the sum of their magnitudes."""
    rec, state, move = inputs
    new_c = kdelta.record_update(state, move, rec.la, rec.lb, rec.d,
                                 rec.w)[1]
    terms = (new_c - state[10]).double()
    return terms.sum(dim=2), terms.abs().sum(dim=2)


def _check_delta(inputs, kern, plain):
    """Every row: the kernel sums its f32 terms in f64 and rounds once,
    so its delta lies within half an f32 ulp of the exact sum of the
    plain version's terms, plus the two f64 sums' own error (R * 2^-53
    of the terms' magnitudes each). Rows whose |delta| is at most their
    |score|: the deltas within 1e-6 * |score| of the plain version's
    (its f32 sum runs in another order), and equal acceptance wherever
    |delta - thr| exceeds that. Rows with a larger delta, where one f32
    ulp of the delta can exceed 1e-6 * |score|: equal acceptance
    wherever |delta - thr| exceeds the most the two deltas can differ
    by the bounds above."""
    _, state, move = inputs
    scores, R = state[-1], state[4].shape[2]
    exact, mag = _exact_delta(inputs)
    kd = kern[0].abs()
    half_ulp = 0.5 * (torch.nextafter(kd, torch.full_like(kd, np.inf))
                      - kd).double()
    bound = half_ulp + 2.0 * R * 2.0 ** -53 * mag
    assert bool(((kern[0].double() - exact).abs() <= bound).all())
    big = plain[0].abs() > scores.abs()
    tol = 1e-6 * scores.abs()
    assert bool(((kern[0] - plain[0]).abs() <= tol)[~big].all())
    thr = _threshold(state, move)
    big_tol = (plain[0].double() - exact).abs() + bound
    sure = torch.where(
        big, (plain[0].double() - thr.double()).abs() > big_tol,
        (plain[0] - thr).abs() > tol)
    assert torch.equal(kern[1][sure], plain[1][sure])


def _check_commit(inputs, kern, plain):
    """Under one acceptance mask every state field but the scores is
    bit-equal. The kernel's scores are exactly score + its delta on the
    accepted rows, and within 1e-6 * |score| of the plain version's
    where |delta| is at most |score|."""
    for n, (a, b) in enumerate(zip(kern[2][:-1], plain[2][:-1])):
        assert torch.equal(a, b), kdelta.STATE_FIELDS[n]
    scores = inputs[1][-1]
    assert torch.equal(kern[2][-1],
                       torch.where(kern[1], scores + kern[0], scores))
    small = plain[0].abs() <= scores.abs()
    tol = 1e-6 * scores.abs()
    assert bool(((kern[2][-1] - plain[2][-1]).abs() <= tol)[small].all())


@pytest.mark.cuda
@pytest.mark.parametrize('G,P,k,R', [
    (2, 100, 1024, 16384),   # main-path k and P
    (3, 7, 40, 1001),        # ragged R: scalar slot loads
    (1, 5, 2, 300),          # two contigs
    (2, 6, 16, 0),           # no records
    (2, 24, 1000, 70001),    # several tiles a CTA, ragged, scalar loads
    (1, 16, 333, 65540),     # 16-byte loads, R not a multiple of 8 x 4
], ids=['main-k', 'ragged', 'k2', 'no-records', 'tiles-ragged',
        'vec-ragged'])
def test_delta_kernel_matches_plain(card, G, P, k, R):
    inputs = _delta_inputs(_delta_case(G * k + R, G, P, k, R), card)
    n0 = kdelta.delta_generation.launches
    kern, plain = _both(inputs)
    assert kdelta.delta_generation.launches == n0 + 1
    _check_delta(inputs, kern, plain)
    # one acceptance mask for both: the commits are exactly equal
    kern, plain = _both(inputs, accept=plain[1])
    _check_commit(inputs, kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize('op', [0, 1, 2, 3],
                         ids=['swap', 'inversion', 'rotation', 'flip'])
def test_delta_kernel_each_move_kind(card, op):
    inputs = _delta_inputs(_delta_case(op, 2, 32, 64, 4000, op=op), card)
    kern, plain = _both(inputs)
    _check_delta(inputs, kern, plain)
    mask = torch.ones_like(plain[1])
    kern, plain = _both(inputs, accept=mask)
    _check_commit(inputs, kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize('op', [0, 1, 2, 3],
                         ids=['swap', 'inversion', 'rotation', 'flip'])
def test_delta_kernel_whole_span_overflows_shared_memory(card, op):
    """Moves over the whole tour touch every record, 5,000 a CTA. A
    flip changes all their contributions: more new states than a CTA
    keeps in shared memory, so the commit computes the rest again. An
    inversion changes none (delta exactly 0.0) and a swap or a rotation
    only those that cross its edges: the commit computes the others."""
    k = 64
    rec, state, move = _delta_inputs(_delta_case(7 + op, 1, 8, k, 40000),
                                     card)
    inputs = (rec, state, _whole_span(move, op, k))
    kern, plain = _both(inputs)
    _check_delta(inputs, kern, plain)
    if op == 1:
        assert bool((kern[0] == 0.0).all())
    kern, plain = _both(inputs, accept=torch.ones_like(plain[1]))
    _check_commit(inputs, kern, plain)


@pytest.mark.cuda
def test_delta_kernel_no_move_is_exactly_zero(card):
    inputs = _delta_inputs(_delta_case(5, 2, 16, 128, 5000), card,
                           mutprob=-1.0)
    assert not bool(inputs[2][0].any())
    kern, plain = _both(inputs, accept=torch.ones_like(inputs[1][-1],
                                                       dtype=torch.bool))
    assert bool((kern[0] == 0.0).all()) and bool((plain[0] == 0.0).all())
    for a, b in zip(kern[2], inputs[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_delta_kernel_commit_under_given_mask(card):
    inputs = _delta_inputs(_delta_case(6, 3, 24, 256, 12288), card)
    mask = torch.as_tensor(np.random.default_rng(6).random((3, 24)) < 0.5,
                           device=card)
    kern, plain = _both(inputs, accept=mask)
    assert torch.equal(kern[1], mask) and torch.equal(plain[1], mask)
    _check_commit(inputs, kern, plain)


@pytest.mark.cuda
def test_delta_kernel_is_repeatable(card):
    """Two runs on the same input give the same bits: the cluster adds
    its partial sums in rank order, with no float atomics."""
    inputs = _delta_inputs(_delta_case(8, 7, 100, 1024, 49152), card)
    kern = kdelta.delta_generation
    one, two = _both(inputs, fns=(kern, kern))
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    for a, b in zip(one[2], two[2]):
        assert torch.equal(a, b)


def _sim_chromosome_problem(seed, k=8, n_pairs=4000, decay=40000.0):
    """tests/test_optimize.py's simulated chromosome (contigs tiled in a
    random order and orientation, read pairs at exponential-decay
    separation), as the port's TourProblem."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(40000, 120000, size=k).astype(np.int64)
    true_order = rng.permutation(k)
    true_ori = rng.integers(0, 2, size=k)
    starts = np.cumsum(np.concatenate([[0], lengths[true_order][:-1]]))
    start_of = np.zeros(k, np.int64)
    start_of[true_order] = starts
    recs = []
    total_len = int(lengths.sum())
    for _ in range(n_pairs):
        x = rng.integers(0, total_len)
        y = x + int(rng.exponential(decay)) + 1
        if y >= total_len:
            continue
        ca = int(true_order[np.searchsorted(starts, x, side='right') - 1])
        cb = int(true_order[np.searchsorted(starts, y, side='right') - 1])
        if ca == cb:
            continue
        pa_ = x - start_of[ca] if true_ori[ca] == 0 \
            else start_of[ca] + lengths[ca] - 1 - x
        pb_ = y - start_of[cb] if true_ori[cb] == 0 \
            else start_of[cb] + lengths[cb] - 1 - y
        a, b, pa2, pb2 = (ca, cb, pa_, pb_) if ca < cb else (cb, ca, pb_, pa_)
        recs.append((a, b, lengths[a] - pa2 + pb2,
                     lengths[a] - pa2 + lengths[b] - pb2, pa2 + pb2,
                     pa2 + lengths[b] - pb2))
    r = np.asarray(recs, np.int64)
    problem = topt.TourProblem(
        lengths=lengths, pair_a=r[:, 0].astype(np.int32),
        pair_b=r[:, 1].astype(np.int32), d=r[:, 2:].T.astype(np.float32),
        w=np.ones(len(r), np.float32))
    return problem, true_order, true_ori


def _canonical_tour(order, ori):
    fwd = tuple(zip(order.tolist(), ori.tolist()))
    rev = tuple((c, 1 - o) for c, o in fwd[::-1])
    return min(fwd, rev)


@pytest.mark.cuda
def test_device_ga_on_the_card_recovers_true_order(card):
    """tests/test_torch_optimize.py::test_device_ga_recovers_true_order
    (delta window) on the card: the GA runs both kernels."""
    problem, true_order, true_ori = _sim_chromosome_problem(3)
    n0 = kdelta.delta_generation.launches
    res = topt.optimize_tour(problem, npop=32, ngen=600, seed=1,
                             log_every=200, backend='device', device='cuda')
    assert kdelta.delta_generation.launches > n0
    scores = [s for _, s in res.history]
    assert all(b >= a - 1e-6 for a, b in zip(scores, scores[1:]))
    truth = kscore.score_population_plain(
        *[torch.as_tensor(x[None, None]) for x in (
            true_order.astype(np.int32),
            true_ori[true_order].astype(np.int32))],
        torch.as_tensor(problem.lengths[None]),
        *[torch.as_tensor(x[None]) for x in (
            problem.pair_a, problem.pair_b, problem.d, problem.w)])
    assert res.score >= 0.95 * float(truth)
    assert _canonical_tour(res.order, res.ori) == \
        _canonical_tour(true_order, true_ori[true_order])

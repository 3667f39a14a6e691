"""The port's hand-written CUDA kernels (the tour scorer, the GA's
delta generation and its cycle's rescoring, the sparse MCL column step
and its convergence statistic, and the dense MCL column pass) against
their plain torch versions, on the card. CUDA kernels have no CPU mode,
so these tests carry the `cuda` marker and skip on a host without a
card. This file
imports neither JAX nor the JAX package, so it also runs on a card
host without them:

    HAPHIC_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_kernels.py

(add ``-k sparse`` for the sparse column step's tests alone, ``-k
mcl_column`` for the dense column pass's, ``-k rescore`` for the GA
cycle's rescoring).
(HAPHIC_TEST_TPU=1 keeps the repo's conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

from haphic_tpu_torch.kernels import delta as kdelta
from haphic_tpu_torch.kernels import score as kscore
from haphic_tpu_torch.order import optimize as topt

from .kit import kernelkit as kit
from . import ell_cases


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


# --- delta generation from its draws ---------------------------------------

def _span_edges():
    """u_span values at the edges of the geometric span: 0, the eight
    largest f32 values below 1 (the largest, 1 - 2^-24, gives the
    longest span), and every f32 1 - 0.75^n with its two neighbours,
    where the span's floor steps."""
    one, zero = np.float32(1.0), np.float32(0.0)
    vals = [zero, np.float32(2.0 ** -24)]
    u = one
    for _ in range(8):
        u = np.nextafter(u, zero)
        vals.append(u)
    for n in range(1, 60):
        u = np.float32(1.0 - 0.75 ** n)
        if u < one:
            vals += [np.nextafter(u, zero), u, np.nextafter(u, one)]
    vals = np.array(vals, dtype=np.float32)
    return vals[vals < one]


def _from_draws(state, draws, rec, mutprob=1.1, moves_out=None):
    return kdelta.delta_generation_from_draws(
        state, draws, rec.la, rec.lb, rec.d, rec.w, mutprob,
        topt._DELTA_LOCAL_FRAC, topt._DELTA_MIN_GAIN, topt._DELTA_SPAN_GAIN,
        moves_out=moves_out)


@pytest.mark.cuda
@pytest.mark.parametrize('mutprob', [1.1, 0.5], ids=['always', 'half'])
def test_delta_kernel_moves_from_draws_bit_equal(card, mutprob):
    """The draws mode's moves (moves_out) equal _moves_from_draws's on
    the card bit for bit over 1,048,576 rows: seeded draws with e1 =
    k - 1 on every 7th row, and the span's edges planted in u_span twice,
    once on local rows with e1 = 0 (where the span is j - i) and once on
    seeded rows."""
    G, P, k, R = 16, 65536, 64, 8
    rng = np.random.default_rng(23)
    lengths, pa, pb, d, w, order, ori, _ = _delta_case(23, G, 1, k, R)
    order = np.ascontiguousarray(np.broadcast_to(order, (G, P, k)))
    ori = np.ascontiguousarray(np.broadcast_to(ori, (G, P, k)))
    draws = [rng.random((G, P)).astype(np.float32),
             rng.integers(0, 4, (G, P)).astype(np.int32)] + [
        rng.integers(0, k, (G, P)).astype(np.int32) for _ in range(3)] + [
        rng.random((G, P)).astype(np.float32) for _ in range(2)]
    e1, u_local, u_span = [x.reshape(-1) for x in
                           (draws[2], draws[5], draws[6])]
    e1[::7] = k - 1
    edges = _span_edges()
    n = edges.size
    u_span[1:1 + n] = edges
    e1[1:1 + n] = 0
    u_local[1:1 + n] = 0.0
    u_span[1 + n:1 + 2 * n] = edges
    put = lambda x: torch.as_tensor(x, device=card)  # noqa: E731
    rec = topt._Records(put(lengths), put(pa), put(pb), put(d), put(w))
    # the caches of a million tours, by the plain version on the host
    host = topt._Records(*[torch.as_tensor(x)
                           for x in (lengths, pa, pb, d, w)])
    state = tuple(x.to(card) for x in (torch.as_tensor(order),
                                       torch.as_tensor(ori))
                  + host.caches(torch.as_tensor(order),
                                torch.as_tensor(ori)))
    draws = [put(x) for x in draws]
    moves = tuple(torch.empty((G, P), dtype=dt, device=card)
                  for dt in (torch.bool,) + (torch.int32,) * 4)
    _from_draws(state, draws, rec, mutprob, moves_out=moves)
    want = topt._moves_from_draws(*draws, k, mutprob, topt._DELTA_LOCAL_FRAC)
    torch.cuda.synchronize()
    for name, a, b in zip(('do', 'op', 'i', 'j', 't'), moves, want):
        assert torch.equal(a, b), name
    span = (moves[3] - moves[2]).reshape(-1)[1:1 + n]
    assert int(span[0]) == 1 and int(span.max()) == 58   # u_span 0, 1-2^-24


@pytest.mark.cuda
def test_delta_kernel_draws_mode_equals_move_mode(card):
    """At the dense batch's shape (G = 7, P = 100, k = 1024, R =
    196,608), 25 generations from the same draws and state in draws mode
    and in move mode (moves by _moves_from_draws): delta, acceptance and
    all 12 state tensors bit-equal after every generation."""
    rec, state, _ = _delta_inputs(_delta_case(31, 7, 100, 1024, 196608),
                                  card)
    a = tuple(x.clone() for x in state)
    b = tuple(x.clone() for x in state)
    del state
    gen = torch.Generator(device=card)
    gen.manual_seed(31)
    draws_of = topt._Draws(gen, 7)
    accepted = 0
    for _ in range(25):
        draws = topt._move_draws(draws_of, (7, 100), 1024, card)
        move = topt._moves_from_draws(*draws, 1024, 1.1,
                                      topt._DELTA_LOCAL_FRAC)
        da, acc_a = _from_draws(a, draws, rec)
        db, acc_b = kdelta.delta_generation(
            b, move, rec.la, rec.lb, rec.d, rec.w, topt._DELTA_MIN_GAIN,
            topt._DELTA_SPAN_GAIN)
        torch.cuda.synchronize()
        assert torch.equal(da, db) and torch.equal(acc_a, acc_b)
        for n, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), kdelta.STATE_FIELDS[n]
        accepted += int(acc_a.sum())
    assert accepted > 0


@pytest.mark.cuda
def test_dgen_on_the_card_never_syncs(card):
    """25 _dgen calls (the draws and one kernel launch each) under
    torch.cuda.set_sync_debug_mode('error') raise nothing, and each
    launches the delta kernel exactly once; so do 25 calls with the
    move-mode step, whose move arithmetic no longer makes a tensor from
    the host."""
    rec, state, _ = _delta_inputs(_delta_case(32, 3, 100, 1024, 49152),
                                  card)
    gen = torch.Generator(device=card)
    gen.manual_seed(32)
    draws = topt._Draws(gen, 3)
    for step in (None, kdelta.delta_generation):
        state = topt._dgen(draws, rec, state, step)      # loads, caches
        torch.cuda.synchronize()
        n0 = kdelta.delta_generation.launches
        torch.cuda.set_sync_debug_mode('error')
        try:
            for i in range(25):
                state = topt._dgen(draws, rec, state, step)
                assert kdelta.delta_generation.launches == n0 + i + 1
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
    assert bool(torch.isfinite(state[-1]).all())


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


# --- sparse MCL column step ------------------------------------------------

def _ell_case(seed, B, n, K, full=False, equal=False):
    """B random column-stochastic (n+1, K) ELL matrices: each column j < n
    K (``full``) or 1..K distinct random rows, sorted ascending, sentinels
    (n, 0) after them; column n empty. ``equal`` gives every entry of a
    full column the value 1/K, a power of two at K = 2^k, so products and
    run sums are exact and many are equal."""
    rng = np.random.default_rng(seed)
    idx = np.full((B, n + 1, K), n, dtype=np.int32)
    val = np.zeros((B, n + 1, K), dtype=np.float32)
    for b in range(B):
        for j in range(n):
            m = K if full else int(rng.integers(1, K + 1))
            rows = np.sort(rng.choice(n, m, replace=False))
            w = np.full(m, 1.0 / K) if equal else rng.exponential(1.0, m)
            idx[b, j, :m] = rows
            val[b, j, :m] = w / w.sum()
    return idx, val


def _column_step(fn, A_i, A_v, infl, n, K, pruning, expansion):
    """``fn`` (the kernel's wrapper or its plain version) over every
    column of A, as _sweep_cols composes it for ``expansion``."""
    di, dv = A_i, A_v
    for _ in range(expansion - 2):
        di, dv = fn(A_i, A_v, di, dv, torch.ones_like(infl), n, K, 0.0, True)
    return fn(A_i, A_v, di, dv, infl, n, K, pruning, True)


def _check_iterate(out_i, out_v, n, K):
    """Rows ascending, then sentinels (n, 0); values in [0, 1]."""
    assert out_i.dtype == torch.int32 and out_v.dtype == torch.float32
    assert out_i.shape[-1] == K
    real = out_i < n
    assert bool(((out_v > 0) == real).all())
    assert bool((out_i[..., 1:] > out_i[..., :-1])[real[..., 1:]].all())
    assert bool((real[..., 1:] <= real[..., :-1]).all())
    assert bool(((out_v >= 0) & (out_v <= 1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize('B,n,K,expansion,expand', [
    (2, 500, 16, 2, True),       # a few hundred candidates a column
    (4, 3000, 128, 2, True),     # the default K: 16,384, columns over K
    (2, 1000, 192, 2, True),     # 36,864 candidates: the global workspace
    (2, 500, 32, 3, True),       # expansion 3: two launches a column
    (4, 3000, 128, 2, False),    # the first iteration: no expansion
], ids=['small', 'K=128', 'global', 'expansion3', 'expand0'])
def test_sparse_column_kernel_matches_plain(card, B, n, K, expansion,
                                            expand):
    from haphic_tpu_torch.kernels import sparse_column as kcol
    idx, val = _ell_case(B * n + K, B, n, K)
    A_i, A_v = torch.as_tensor(idx, device=card), torch.as_tensor(
        val, device=card)
    infl = torch.linspace(1.2, 3.0, B, device=card)
    n0 = kcol.sparse_column.launches
    if expand:
        got = _column_step(kcol.sparse_column, A_i, A_v, infl, n, K, 1e-4,
                           expansion)
        want = _column_step(kcol.sparse_column_plain, A_i, A_v, infl, n, K,
                            1e-4, expansion)
    else:
        got = kcol.sparse_column(None, None, A_i, A_v, infl, n, K, 1e-4,
                                 False)
        want = kcol.sparse_column_plain(None, None, A_i, A_v, infl, n, K,
                                        1e-4, False)
    torch.cuda.synchronize()
    assert kcol.sparse_column.launches == n0 + (expansion - 1)
    _check_iterate(*got, n, K)
    assert bool((got[0][:, n] == n).all())
    cmp = kit.sparse_column_compare(*got, *want, n)
    assert cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0, cmp


@pytest.mark.cuda
@pytest.mark.parametrize('expand', [True, False], ids=['expand', 'expand0'])
def test_sparse_column_kernel_tie_rule(card, expand):
    """Columns with more distinct rows than K and equal values: the cap
    keeps the lower row id among equal values, as lax.top_k keeps the
    lower position, so the kept rows are the plain version's exactly.
    Expanded: every entry 1/128, so run sums are exact multiples of
    2^-14 and many tie at the cut. Not expanded: 256 entries of 1/256
    capped to 128."""
    from haphic_tpu_torch.kernels import sparse_column as kcol
    B, n = 2, 3000
    Kc = 128 if expand else 256
    idx, val = _ell_case(7, B, n, Kc, full=True, equal=True)
    A_i, A_v = torch.as_tensor(idx, device=card), torch.as_tensor(
        val, device=card)
    infl = torch.tensor([1.5, 2.0], device=card)
    K = 128
    args = (A_i, A_v, A_i, A_v) if expand else (None, None, A_i, A_v)
    got = kcol.sparse_column(*args, infl, n, K, 0.0, expand)
    want = kcol.sparse_column_plain(*args, infl, n, K, 0.0, expand)
    torch.cuda.synchronize()
    # the cap cut every real column
    assert bool((got[0][:, :n] < n).all())
    assert torch.equal(got[0], want[0])
    cmp = kit.sparse_column_compare(*got, *want, n)
    assert cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0, cmp


@pytest.mark.cuda
@pytest.mark.parametrize('K', [128, 192], ids=['smem', 'global'])
def test_sparse_column_kernel_block_chunk_and_repeat_bit_equal(card, K):
    """A column's bits do not depend on the chunk, on the column block
    [c0, c1) or on the run: _sweep_cols on the card at two chunk sizes,
    over two blocks, and twice."""
    from haphic_tpu_torch.cluster import sparse_mcl as tsp
    B, n = 2, 700
    idx, val = _ell_case(11, B, n, K)
    A_i, A_v = torch.as_tensor(idx, device=card), torch.as_tensor(
        val, device=card)
    infl = torch.tensor([1.4, 2.2], device=card)
    whole = tsp._sweep_cols(A_i, A_v, infl, n, K, 256, 1e-4, 2)
    again = tsp._sweep_cols(A_i, A_v, infl, n, K, 256, 1e-4, 2)
    other = tsp._sweep_cols(A_i, A_v, infl, n, K, 96, 1e-4, 2)
    lo = tsp._sweep_cols(A_i, A_v, infl, n, K, 64, 1e-4, 2, 0, 333)
    hi = tsp._sweep_cols(A_i, A_v, infl, n, K, 64, 1e-4, 2, 333, n + 1)
    for a, b in zip(whole[:2], again[:2]):
        assert torch.equal(a, b)
    for a, b in zip(whole[:2], other[:2]):
        assert torch.equal(a, b)
    for t, a in enumerate(whole[:2]):
        assert torch.equal(a, torch.cat([lo[t], hi[t]], dim=1))
    assert torch.equal(whole[2], again[2]) and torch.equal(whole[2],
                                                           other[2])
    assert torch.equal(whole[2], torch.maximum(lo[2], hi[2]))


@pytest.mark.cuda
def test_sparse_mcl_call_sites_launch_the_kernel(card):
    """_pre_expand, _first_iteration and _sweep_step launch the kernel on
    the card (one launch a chunk, one for the first iteration), and the
    engine's partitions and iterations on the card equal the CPU's."""
    from haphic_tpu_torch.cluster import sparse_mcl as tsp
    from haphic_tpu_torch.kernels import sparse_column as kcol
    B, n, K, chunk = 2, 300, 32, 128
    idx, val = _ell_case(5, 1, n, K)
    bi, bv = torch.as_tensor(idx[0], device=card), torch.as_tensor(
        val[0], device=card)
    infl = torch.tensor([1.6, 2.4], device=card)
    chunks = -(-(n + 1) // chunk)
    n0 = kcol.sparse_column.launches
    pi, pv = tsp._pre_expand(bi, bv, bi, bv, n, K, chunk)
    assert kcol.sparse_column.launches == n0 + chunks
    si, sv = tsp._first_iteration(pi, pv, infl, n, K, 1e-4)
    assert kcol.sparse_column.launches == n0 + chunks + 1
    tsp._sweep_step(si, sv, infl, np.ones(B, dtype=bool), n, K, chunk,
                    1e-4, 2)
    assert kcol.sparse_column.launches == n0 + 2 * chunks + 1
    # the engine on the card against the CPU, on a 4-block matrix
    rng = np.random.default_rng(2)
    m = np.zeros((96, 96))
    for blk in range(4):
        w = rng.integers(5, 60, (24, 24)) * (rng.random((24, 24)) < 0.5)
        s = slice(24 * blk, 24 * blk + 24)
        m[s, s] += np.triu(w, 1) + np.triu(w, 1).T
    i, j = np.nonzero(np.triu(m, 1))
    runs = [tsp.run_mcl_sparse(i, j, m[i, j], 96, [1.4, 2.0], K=48,
                               max_iter=80, device=d)
            for d in ('cuda', 'cpu')]
    assert np.array_equal(runs[0].n_iters, runs[1].n_iters)
    assert [runs[0].interpret(b) for b in range(2)] == \
        [runs[1].interpret(b) for b in range(2)]


@pytest.mark.cuda
def test_sparse_column_kernel_rejects_bad_input(card):
    from haphic_tpu_torch.kernels import sparse_column as kcol
    idx, val = _ell_case(3, 1, 50, 8)
    A_i, A_v = torch.as_tensor(idx, device=card), torch.as_tensor(
        val, device=card)
    infl = torch.ones(1, device=card)
    bad = [(A_i.long(), A_v, A_i, A_v, infl),          # int64 ids
           (A_i, A_v, A_i, A_v.double(), infl),        # f64 values
           (A_i, A_v, A_i.cpu(), A_v, infl),           # mixed devices
           (A_i, A_v, A_i, A_v, infl.cpu()),
           (A_i, A_v, A_i[:, :, :4], A_v, infl),       # shapes differ
           (A_i, A_v, A_i.transpose(1, 2), A_v.transpose(1, 2), infl),
           (A_i, A_v, A_i, A_v, torch.ones(2, device=card))]
    for args in bad:
        with pytest.raises(ValueError):
            kcol.sparse_column(*args, 50, 8, 1e-4, True)
    with pytest.raises(ValueError):      # K above the candidates
        kcol.sparse_column(None, None, A_i, A_v, infl, 50, 9, 1e-4, False)
    with pytest.raises(ValueError):      # column n missing from A
        kcol.sparse_column(A_i[:, :50], A_v[:, :50], A_i, A_v, infl, 50, 8,
                           1e-4, True)


def test_sparse_column_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    from haphic_tpu_torch.kernels import sparse_column as kcol
    idx, val = _ell_case(4, 2, 60, 8)
    A_i, A_v = torch.as_tensor(idx), torch.as_tensor(val)
    infl = torch.tensor([1.5, 2.5])
    n0 = kcol.sparse_column.launches
    got = kcol.sparse_column(A_i, A_v, A_i[:, 10:30], A_v[:, 10:30], infl,
                             60, 8, 1e-4, True)
    assert kcol.sparse_column.launches == n0
    want = kcol.sparse_column_plain(A_i, A_v, A_i[:, 10:30], A_v[:, 10:30],
                                    infl, 60, 8, 1e-4, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _check_iterate(*got, 60, 8)


# --- the sparse engine's ELL build (kernels/ell_build.py) ---------------


@pytest.mark.cuda
@pytest.mark.parametrize('K', ell_cases.KS)
@pytest.mark.parametrize('case', ell_cases.CASES)
def test_ell_build_kernel_bit_equal_to_numpy(card, case, K):
    """coo_to_ell on the card (the ell_build kernel) against coo_to_ell on
    the CPU (its plain version, held bit-equal to the JAX package's numpy
    in tests/test_torch_ell_build.py) on the same links: idx, val (to the
    bit), overflow and dtypes; the star's hub the one column through
    global memory; a second call (its buckets filled in another order)
    the same."""
    from haphic_tpu_torch.cluster import sparse_mcl as tsp
    from haphic_tpu_torch.kernels import ell_build as keb
    i, j, w, n = ell_cases.links(case, K)
    want = tsp.coo_to_ell(i, j, w, n, K)
    n0 = keb.ell_build.launches
    got = tsp.coo_to_ell(i, j, w, n, K, device=card)
    again = tsp.coo_to_ell(i, j, w, n, K, device=card)
    torch.cuda.synchronize()
    assert keb.ell_build.launches == n0 + 2
    assert tsp.coo_to_ell.wide_columns == (1 if case == 'star' else 0)
    for idx, val, overflow in (got, again):
        assert idx.device.type == 'cuda' and val.device.type == 'cuda'
        assert idx.dtype == torch.int32 and val.dtype == torch.float32
        assert torch.equal(idx.cpu(), want[0])
        assert torch.equal(val.cpu().view(torch.int32),
                           want[1].view(torch.int32))
        assert overflow == want[2]


@pytest.mark.cuda
def test_run_mcl_sparse_launches_ell_build_once(card):
    """One run_mcl_sparse call on the card builds its ELL by one
    ell_build call; the CPU route calls none, and both sweep alike."""
    from haphic_tpu_torch.cluster import sparse_mcl as tsp
    from haphic_tpu_torch.kernels import ell_build as keb
    i, j, w, n = ell_cases.links('capped', 16)
    n0 = keb.ell_build.launches
    runs = [tsp.run_mcl_sparse(i, j, w, n, [1.6, 2.4], K=16, max_iter=6,
                               device=d) for d in ('cuda', 'cpu')]
    assert keb.ell_build.launches == n0 + 1
    assert np.array_equal(runs[0].n_iters, runs[1].n_iters)


@pytest.mark.cuda
def test_ell_build_kernel_edges_and_bad_input(card):
    """No links (self-loops alone) and one column; ids outside [0, n) and
    wrong dtypes or devices raise ValueError."""
    from haphic_tpu_torch.cluster import sparse_mcl as tsp
    from haphic_tpu_torch.kernels import ell_build as keb
    none = np.zeros(0, np.int64)
    for n, K in ((5, 3), (1, 1)):
        want = tsp.coo_to_ell(none, none, none.astype(float), n, K)
        got = tsp.coo_to_ell(none, none, none.astype(float), n, K,
                             device=card)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    i, j, w, n = (torch.as_tensor(x, device=card) if not isinstance(x, int)
                  else x for x in ell_cases.links('exact', 8))
    for bad_j in (torch.where(j == j.max(), n, j), -j):
        with pytest.raises(ValueError):
            keb.ell_build(i, bad_j, w, n, 8)
    for args in ((i.int(), j, w), (i, j, w.float()), (i, j.cpu(), w),
                 (i[:-1], j, w)):
        with pytest.raises(ValueError):
            keb.ell_build(*args, n, 8)


# --- the sparse column kernel's shapes: dedupe table, spill, cap ---------

def _kernel_vs_plain(card, A_i, A_v, ci, cv, infl, n, K, pruning, expand):
    """The kernel against its plain version (max abs error <= 1e-6, every
    entry within RTOL/ATOL, equal kept sets above KEPT), and the kernel's
    bits again on a second run and over two column blocks."""
    from haphic_tpu_torch.kernels import sparse_column as kcol
    args = [None if t is None else t.to(card) for t in (A_i, A_v, ci, cv,
                                                         infl)]
    A_i, A_v, ci, cv, infl = args
    h = ci.shape[1] // 2
    n0 = kcol.sparse_column.launches
    got = kcol.sparse_column(A_i, A_v, ci, cv, infl, n, K, pruning, expand)
    again = kcol.sparse_column(A_i, A_v, ci, cv, infl, n, K, pruning, expand)
    lo = kcol.sparse_column(A_i, A_v, ci[:, :h], cv[:, :h], infl, n, K,
                            pruning, expand)
    hi = kcol.sparse_column(A_i, A_v, ci[:, h:], cv[:, h:], infl, n, K,
                            pruning, expand)
    want = kcol.sparse_column_plain(A_i, A_v, ci, cv, infl, n, K, pruning,
                                    expand)
    torch.cuda.synchronize()
    assert kcol.sparse_column.launches == n0 + 4
    for t in range(2):
        assert torch.equal(got[t], again[t])
        assert torch.equal(got[t], torch.cat([lo[t], hi[t]], dim=1))
    _check_iterate(*got, n, K)
    cmp = kit.sparse_column_compare(*got, *want, n)
    assert cmp['max_abs_err'] <= 1e-6 and cmp['outside_tol'] == 0 and \
        cmp['kept_differ'] == 0, cmp
    return got, want


def _disjoint_rows(n, rows, K, seed):
    """(1, n+1, K) ELL: row j < rows holds ids [K*j, K*j + K) with random
    column-stochastic values, every other row only sentinels."""
    rng = np.random.default_rng(seed)
    idx = np.full((1, n + 1, K), n, dtype=np.int32)
    val = np.zeros((1, n + 1, K), dtype=np.float32)
    for j in range(rows):
        w = rng.exponential(1.0, K)
        idx[0, j] = np.arange(K * j, K * j + K)
        val[0, j] = w / w.sum()
    return idx, val


def _columns(n, K, sources, seed):
    """(1, C, K) columns: column c's real sources are ``sources[c]``
    (ascending), with random weights, then sentinels."""
    rng = np.random.default_rng(seed)
    ci = np.full((1, len(sources), K), n, dtype=np.int32)
    cv = np.zeros((1, len(sources), K), dtype=np.float32)
    for c, src in enumerate(sources):
        w = rng.exponential(1.0, len(src))
        ci[0, c, :len(src)] = src
        cv[0, c, :len(src)] = w / w.sum()
    return torch.as_tensor(ci), torch.as_tensor(cv)


@pytest.mark.cuda
def test_sparse_column_kernel_16384_distinct_ids(card):
    """The worst case at K = 128: 128 sources with disjoint rows, 16,384
    distinct ids and no duplicates, beside columns with half and a
    quarter of the sources."""
    n, K = 16500, 128
    idx, val = _disjoint_rows(n, K, K, 21)
    ci, cv = _columns(n, K, [np.arange(128), np.arange(64),
                             np.arange(0, 128, 4), np.arange(1, 128, 2)], 22)
    got, _ = _kernel_vs_plain(card, torch.as_tensor(idx),
                              torch.as_tensor(val), ci, cv,
                              torch.tensor([1.7]), n, K, 1e-4, True)
    # the cap cut the 16,384 candidates to 128
    assert bool((got[0][0, 0] < n).all())


@pytest.mark.cuda
def test_sparse_column_kernel_spills_past_the_shared_table(card):
    """A column whose distinct ids pass 3/4 of the 8,192-slot shared
    table (6,144) continues in the global workspace: 53 sources, 52 with
    disjoint rows (6,656 ids; the switch comes at the 49th) and a last one
    that meets ids of both the first (in shared memory) and the 52nd (in
    the global table); beside columns just under and at the switch."""
    n, K, rows = 7000, 128, 52
    idx, val = _disjoint_rows(n, rows, K, 23)
    idx[0, rows] = np.concatenate([np.arange(64, 128),
                                   np.arange((rows - 1) * K,
                                             (rows - 1) * K + 64)])
    w = np.random.default_rng(24).exponential(1.0, K)
    val[0, rows] = w / w.sum()
    ci, cv = _columns(n, K, [np.arange(rows + 1), np.arange(40),
                             np.arange(48), np.arange(49), np.arange(50),
                             [0, rows]], 25)
    _kernel_vs_plain(card, torch.as_tensor(idx), torch.as_tensor(val), ci,
                     cv, torch.tensor([1.3]), n, K, 1e-4, True)


@pytest.mark.cuda
@pytest.mark.parametrize('expand', [True, False], ids=['expand', 'expand0'])
def test_sparse_column_kernel_empty_and_single_entry_columns(card, expand):
    """Columns whose sources are all sentinels, a column with one real
    entry, and a source whose row has one real entry, among ordinary
    columns."""
    n, K = 500, 16
    idx, val = _ell_case(31, 1, n, K)
    idx[0, 7], val[0, 7] = n, 0.0
    idx[0, 7, 0], val[0, 7, 0] = 123, 1.0          # one real entry
    idx[0, 0], val[0, 0] = n, 0.0                  # only sentinels
    idx[0, 300], val[0, 300] = n, 0.0
    idx[0, 300, 0], val[0, 300, 0] = 7, 1.0        # one source: row 7
    A_i, A_v = torch.as_tensor(idx), torch.as_tensor(val)
    got, _ = _kernel_vs_plain(card, A_i if expand else None,
                              A_v if expand else None, A_i, A_v,
                              torch.tensor([2.0]), n, K, 1e-4, expand)
    assert bool((got[0][0, 0] == n).all()) and bool((got[0][0, n] == n).all())
    if expand:
        assert got[0][0, 300, 0] == 123 and got[1][0, 300, 0] == 1.0
        assert bool((got[0][0, 300, 1:] == n).all())
    else:
        assert got[0][0, 7, 0] == 123 and got[1][0, 7, 0] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize('K', [64, 32, 16])
def test_sparse_column_kernel_shrunk_K(card, K):
    """The K the sweep shrinks to, on columns shaped like the sparse smoke
    run's (rows of chromosomes of 1000 fragments)."""
    from haphic_tpu_torch.kernels import sparse_column as kcol
    B, n = 4, 3000
    idx, val = kit.sparse_column_iterate(K, B, n, K)
    A_i, A_v = torch.as_tensor(idx), torch.as_tensor(val)
    _kernel_vs_plain(card, A_i, A_v, A_i, A_v,
                     torch.linspace(1.2, 2.8, B), n, K, 1e-4, True)


@pytest.mark.cuda
def test_sparse_column_kernel_expand0_capped(card):
    """The first iteration's route with Kc = 256 random entries a column
    capped to 128."""
    B, n = 2, 3000
    idx, val = _ell_case(41, B, n, 256, full=True)
    _kernel_vs_plain(card, None, None, torch.as_tensor(idx),
                     torch.as_tensor(val), torch.tensor([1.5, 2.5]), n, 128,
                     1e-4, False)


@pytest.mark.cuda
def test_sparse_column_kernel_ids_past_2_to_the_20(card):
    """Row ids above 2^20 (n = 2^20 + 7): no key packing narrower than the
    ids."""
    n, K = (1 << 20) + 7, 16
    rng = np.random.default_rng(51)
    rows = np.sort(rng.choice(np.arange(n - 400, n), 200, replace=False))
    idx = np.full((1, n + 1, K), n, dtype=np.int32)
    val = np.zeros((1, n + 1, K), dtype=np.float32)
    for j in rows:
        w = rng.exponential(1.0, K)
        idx[0, j] = np.sort(rng.choice(rows, K, replace=False))
        val[0, j] = w / w.sum()
    A_i, A_v = torch.as_tensor(idx), torch.as_tensor(val)
    cols = torch.as_tensor(rows[:64])
    got, _ = _kernel_vs_plain(card, A_i, A_v, A_i[:, cols].contiguous(),
                              A_v[:, cols].contiguous(), torch.tensor([2.0]),
                              n, K, 1e-4, True)
    assert int(got[0][got[0] < n].min()) >= n - 400


# --- the dense MCL column pass ------------------------------------------

def _dense_case(seed, B, n, stride0=False):
    """A (B, n, n) e (with ``stride0`` one matrix expanded over the
    batch), a (B, n, n) old and (B,) inflations, on the host: sparse
    entries with a wide range of values, as an expanded MCL iterate has."""
    rng = np.random.default_rng(seed)
    shape = (1 if stride0 else B, n, n)
    e = (rng.random(shape, dtype=np.float32) ** 8
         * (rng.random(shape) < 0.3)).astype(np.float32)
    old = (rng.random((B, n, n), dtype=np.float32)
           * (rng.random((B, n, n)) < 0.2)).astype(np.float32)
    infl = np.linspace(1.1, 3.0, B, dtype=np.float32)
    return e, old, infl


def _planted(e):
    """Columns with exact sums: 0 all zero; 1 five equal entries (q =
    0.2, below a pruning of 0.25: only the first is kept); 2 four (q =
    0.25, at it: all kept); 3 ten (q = 0.1); 4 two (q = 0.5)."""
    e = e.copy()
    e[:, :, :5] = 0
    e[:, [3, 7, 11, 15, 19], 1] = 1.0
    e[:, 5:9, 2] = 1.0
    e[:, 10:20, 3] = 1.0
    e[:, [2, 9], 4] = 1.0
    return e


def _dense_pair(card, e, old, infl, pruning, stride0=False):
    from haphic_tpu_torch.kernels import mcl_column as kmc
    B, n = infl.shape[0], e.shape[-1]
    te = torch.as_tensor(e, device=card)
    if stride0:
        te = te[0][None].expand(B, n, n)
    to = None if old is None else torch.as_tensor(old, device=card)
    ti = torch.as_tensor(infl, device=card)
    n0 = kmc.mcl_column.launches
    got = kmc.mcl_column(te, ti, pruning, old=to)
    want = kmc.mcl_column_plain(te, ti, pruning, old=to)
    torch.cuda.synchronize()
    assert kmc.mcl_column.launches == n0 + 1
    q = kmc._inflate(te, ti.view(-1, 1, 1))
    return got, want, kit.mcl_column_compare(got[0], want[0], q, pruning)


@pytest.mark.cuda
@pytest.mark.parametrize('B,n,stride0', [
    (1, 1000, False), (6, 1000, False), (1, 4097, False), (6, 4097, False),
    (6, 1000, True), (6, 4097, True),
], ids=['B1-n1000', 'B6-n1000', 'B1-n4097', 'B6-n4097', 'iter0-n1000',
        'iter0-n4097'])
def test_mcl_column_kernel_matches_plain(card, B, n, stride0):
    """The kernel against its plain version: values within rtol 1e-5 /
    atol 1e-8 and equal kept sets and argmax rows (columns with an entry
    within 1e-5·pruning of pruning, or a near tie, excused and counted),
    the statistic within 1e-7 with the same decision. Iteration 0 passes
    one matrix expanded over the batch (batch stride 0) and no old."""
    e, old, infl = _dense_case(B * n, B, n, stride0)
    (new, stat), (pnew, pstat), cmp = _dense_pair(
        card, e, None if stride0 else old, infl, 1e-4, stride0)
    assert cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0 \
        and cmp['argmax_differ'] == 0, cmp
    assert cmp['columns_excused'] <= B * n // 100, cmp
    assert bool(torch.isfinite(new).all())
    if stride0:
        assert stat is None and pstat is None
    else:
        assert float((stat - pstat).abs().max()) <= 1e-7
        assert torch.equal(stat <= 1e-8, pstat <= 1e-8)


@pytest.mark.cuda
def test_mcl_column_kernel_planted_columns(card):
    """Ties keep the first row, an all-zero column stays zero, entries
    exactly at pruning are kept, a column whose largest q lies below
    pruning keeps only its first argmax; these columns' sums are exact,
    so kernel and plain version agree bit for bit there."""
    e, old, infl = _dense_case(7, 3, 300)
    e = _planted(e)
    (new, _), (pnew, _), cmp = _dense_pair(card, e, old, infl, 0.25)
    assert cmp['kept_differ'] == 0 and cmp['argmax_differ'] == 0, cmp
    assert torch.equal(new[:, :, :5], pnew[:, :, :5])
    want = torch.zeros((300, 5), device=card)
    want[3, 1] = want[10, 3] = 1.0
    want[5:9, 2] = 0.25
    want[[2, 9], 4] = 0.5
    assert all(torch.equal(new[b, :, :5], want) for b in range(3))


@pytest.mark.cuda
def test_mcl_column_kernel_batch_independent_and_repeatable(card):
    """A (b, column)'s bits do not depend on the batch it is launched
    in: alone, in a batch of 6 and in a permuted batch the same; a
    repeat launch bit-equal."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    e, old, infl = _dense_case(11, 6, 1000)
    te, to, ti = (torch.as_tensor(x, device=card) for x in (e, old, infl))
    whole = kmc.mcl_column(te, ti, 1e-4, old=to)
    again = kmc.mcl_column(te, ti, 1e-4, old=to)
    assert torch.equal(whole[0], again[0]) and torch.equal(whole[1],
                                                          again[1])
    perm = torch.as_tensor([4, 1, 5, 0, 3, 2], device=card)
    p = kmc.mcl_column(te[perm].contiguous(), ti[perm].contiguous(), 1e-4,
                       old=to[perm].contiguous())
    assert torch.equal(p[0], whole[0][perm]) and torch.equal(
        p[1], whole[1][perm])
    for b in range(6):
        one = kmc.mcl_column(te[b:b + 1], ti[b:b + 1], 1e-4,
                             old=to[b:b + 1])
        assert torch.equal(one[0][0], whole[0][b])
        assert torch.equal(one[1][0], whole[1][b])


@pytest.mark.cuda
def test_mcl_column_launched_every_dense_iteration(card, monkeypatch):
    """_mcl_batched on the card launches the kernel once an iteration,
    and gives the iteration counts and partitions of its run under the
    plain version."""
    from haphic_tpu_torch.cluster import mcl as tmcl
    from haphic_tpu_torch.kernels import mcl_column as kmc
    rng = np.random.default_rng(3)
    n = 1200
    a = np.zeros((n, n), np.float32)
    for blk in range(6):
        s = slice(200 * blk, 200 * blk + 200)
        w = rng.integers(5, 60, (200, 200)) * (rng.random((200, 200)) < 0.3)
        a[s, s] += np.triu(w, 1) + np.triu(w, 1).T
    a += np.eye(n, dtype=np.float32)
    ta = torch.as_tensor(a, device=card)
    pre = tmcl._matpower(tmcl._colnorm(ta), 2)
    infl = torch.tensor([1.4, 2.0, 3.0], device=card)
    n0 = kmc.mcl_column.launches
    m, iters, conv = tmcl._mcl_batched(pre, infl, 2, 200, 1e-4)
    assert kmc.mcl_column.launches - n0 == int(iters.max())
    with monkeypatch.context() as mp:
        mp.setattr(tmcl, 'mcl_column', kmc.mcl_column_plain)
        pm, piters, pconv = tmcl._mcl_batched(pre, infl, 2, 200, 1e-4)
    assert torch.equal(iters, piters) and torch.equal(conv, pconv)
    got = [tmcl.interpret_result((m[b] != 0).cpu().numpy()) for b in range(3)]
    want = [tmcl.interpret_result((pm[b] != 0).cpu().numpy())
            for b in range(3)]
    assert got == want and None not in got


@pytest.mark.cuda
def test_mcl_column_kernel_rejects_bad_input(card):
    from haphic_tpu_torch.kernels import mcl_column as kmc
    e, old, infl = _dense_case(5, 2, 64)
    te, to, ti = (torch.as_tensor(x, device=card) for x in (e, old, infl))
    bad = [(te.double(), ti, to),                      # f64
           (te[:, :, :60], ti, None),                  # not square
           (te, ti[:1], to),                           # infl's length
           (te, ti.cpu(), to),                         # mixed devices
           (te, ti, to.cpu()),
           (te.transpose(1, 2), ti, to),               # column-major
           (te, ti, to[:, :, :60])]                    # old's shape
    for x, f, o in bad:
        with pytest.raises(ValueError):
            kmc.mcl_column(x, f, 1e-4, old=o)


# --- the dense column kernel's plan: every width and cluster size ----------

def _device_case(card, seed, B, n, with_old=True):
    """(e, old, infl) made on the card from ``seed`` (a matrix of 4.9e9
    entries is too slow to make on the host), row block by row block: e
    as _dense_case's, sparse with a wide range of values."""
    g = torch.Generator(device=card).manual_seed(seed)
    e = torch.empty((B, n, n), device=card)
    old = torch.empty((B, n, n), device=card) if with_old else None
    step = max(1, (1 << 26) // n)
    for b in range(B):
        for r in range(0, n, step):
            shape = (min(step, n - r), n)
            x = torch.rand(shape, generator=g, device=card).pow_(8)
            x.mul_(torch.rand(shape, generator=g, device=card) < 0.3)
            e[b, r:r + step] = x
            if with_old:
                x = torch.rand(shape, generator=g, device=card)
                x.mul_(torch.rand(shape, generator=g, device=card) < 0.2)
                old[b, r:r + step] = x
    infl = torch.as_tensor(np.linspace(1.1, 3.0, B, dtype=np.float32),
                           device=card)
    return e, old, infl


def _compare_by_columns(e, infl, pruning, old, got, stat):
    """kit.mcl_column_compare and the statistic's error of a kernel
    result (got, stat) against the plain version computed a block of
    columns at a time (the pass is column by column; the statistic a
    max), so that a matrix of 70,000 rows needs no more than a few of its
    size."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    B, n = e.shape[0], e.shape[2]
    cb = max(1, (1 << 27) // (B * n))
    agg = {}
    want_stat = None
    for c0 in range(0, n, cb):
        sl = slice(c0, c0 + cb)
        q = kmc._inflate(e[:, :, sl], infl.view(-1, 1, 1))
        want = kmc._prune(q, pruning)
        cmp = kit.mcl_column_compare(got[:, :, sl], want, q, pruning)
        for k, v in cmp.items():
            agg[k] = max(agg.get(k, 0), v) if k == 'max_abs_err' \
                else agg.get(k, 0) + v
        if old is not None:
            s = kmc._stat(want, old[:, :, sl])
            want_stat = s if want_stat is None else torch.maximum(want_stat,
                                                                  s)
        del q, want
    stat_err = None if old is None else _stat_err(stat, want_stat)
    return agg, stat_err, want_stat


def _stat_err(stat, want):
    """The statistic's largest error; a NaN (a column sum whose reciprocal
    overflows) must stand on both sides."""
    if not torch.equal(stat.isnan(), want.isnan()):
        return float('inf')
    ok = ~want.isnan()
    return float((stat[ok] - want[ok]).abs().max()) if ok.any() else 0.0


def _assert_agrees(cmp, stat_err, B, n):
    assert cmp['outside_tol'] == 0 and cmp['kept_differ'] == 0 \
        and cmp['argmax_differ'] == 0, cmp
    assert cmp['columns_excused'] <= max(1, B * n // 100), cmp
    assert stat_err is None or stat_err <= 1e-7, stat_err


# n just below and just above each switch of plan(n), with the plan
# (width, cluster) expected there; every n past a switch also leaves the
# last CTA fewer rows than the others (rows not divisible by C)
PLAN_CASES = [(512, 32, 1), (513, 32, 2), (1024, 32, 2), (1025, 32, 4),
              (2048, 32, 4), (2049, 32, 8), (4096, 32, 8), (4097, 32, 16),
              (8192, 32, 16), (8193, 16, 16), (16384, 16, 16),
              (16385, 16, 16), (25600, 16, 16), (25601, 8, 16),
              (70000, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize('n,W,C', PLAN_CASES,
                         ids=['n{}-w{}c{}'.format(*c) for c in PLAN_CASES])
def test_mcl_column_kernel_every_plan(card, n, W, C):
    """Each width and cluster size plan(n) chooses, at n just below and
    just above each switch (B = 1; from n = 16,385 slabs past
    SLAB_TARGET; up to N_MAX = 70,000, 19.6 GB a matrix), against the
    plain version with the statistic."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    pl = kmc.plan(n)
    assert (pl.width, pl.cluster) == (W, C)
    torch.cuda.empty_cache()
    e, old, infl = _device_case(card, n, 1, n)
    n0 = kmc.mcl_column.launches
    got, stat = kmc.mcl_column(e, infl, 1e-4, old=old)
    torch.cuda.synchronize()
    assert kmc.mcl_column.launches == n0 + 1
    cmp, stat_err, _ = _compare_by_columns(e, infl, 1e-4, old, got, stat)
    _assert_agrees(cmp, stat_err, 1, n)
    del e, old, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize('B,n,stride0', [
    (1, 19999, False), (6, 8000, True), (6, 8000, False), (3, 6007, False),
    (4, 1, False), (4, 1, True)],
    ids=['B1-n19999', 'iter0-n8000', 'B6-n8000', 'B3-n6007', 'B4-n1',
         'iter0-n1'])
def test_mcl_column_kernel_main_shapes(card, B, n, stride0):
    """B = 1 at the dense route's largest default n (19,999), the
    pipeline's shape (B = 6, n = 8000) with its stride-0 iteration 0,
    ragged slabs (6007 = 15 * 376 + 367 rows) and one fragment."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    torch.cuda.empty_cache()
    e, old, infl = _device_case(card, B * n + stride0, 1 if stride0 else B,
                                n, with_old=not stride0)
    if stride0:
        infl = torch.as_tensor(np.linspace(1.1, 3.0, B, dtype=np.float32),
                               device=card)
        e = e[0][None].expand(B, n, n)
    got, stat = kmc.mcl_column(e, infl, 1e-4, old=old)
    torch.cuda.synchronize()
    cmp, stat_err, want_stat = _compare_by_columns(e, infl, 1e-4, old, got,
                                                   stat)
    _assert_agrees(cmp, stat_err, B, n)
    assert bool(torch.isfinite(got).all())
    if n == 1:     # one entry a column: 1 where it is positive, else 0
        assert torch.equal(got != 0, e > 0)
        assert float((got - (e > 0).float()).abs().max()) <= 1e-6
    if old is not None:
        assert torch.equal(stat <= 1e-8, want_stat <= 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize('n,W,C', [(3, 32, 8), (5, 8, 16), (1, 16, 16),
                                   (100, 16, 3)],
                         ids=['n3-w32c8', 'n5-w8c16', 'n1-w16c16',
                              'n100-w16c3'])
def test_mcl_column_kernel_plan_past_the_rows(card, n, W, C):
    """Plans plan(n) does not choose, launched as the wrapper launches:
    clusters with more CTAs than rows (CTAs whose slab is empty), and a
    cluster size that is no power of two. Against the plain version;
    with a few rows and inflations up to 3, some column sums are so
    small that their reciprocal overflows, and both versions give the
    same NaN there (torch.argmax's order: NaN first)."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    e, old, infl = _dense_case(n * W + C, 3, n)
    te, to, ti = (torch.as_tensor(x, device=card) for x in (e, old, infl))
    got, stat = kmc._launch(te, ti, 1e-4, to, kmc._plan(W, C, n))
    want, want_stat = kmc.mcl_column_plain(te, ti, 1e-4, old=to)
    torch.cuda.synchronize()
    cmp = kit.mcl_column_compare(got, want,
                                 kmc._inflate(te, ti.view(-1, 1, 1)), 1e-4)
    _assert_agrees(cmp, _stat_err(stat, want_stat), 3, n)


@pytest.mark.cuda
def test_mcl_column_kernel_bit_equal_at_the_pipeline_plan(card):
    """At n = 8000 (32 columns a strip, clusters of 16): a (b, column)'s
    bits alone, in a batch of 6, in a permuted batch and in a repeat
    are the same."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    e, old, infl = _device_case(card, 8000, 6, 8000)
    whole = kmc.mcl_column(e, infl, 1e-4, old=old)
    again = kmc.mcl_column(e, infl, 1e-4, old=old)
    assert torch.equal(whole[0], again[0]) and torch.equal(whole[1],
                                                          again[1])
    perm = torch.as_tensor([4, 1, 5, 0, 3, 2], device=card)
    p = kmc.mcl_column(e[perm].contiguous(), infl[perm].contiguous(), 1e-4,
                       old=old[perm].contiguous())
    assert torch.equal(p[0], whole[0][perm]) and torch.equal(
        p[1], whole[1][perm])
    del p
    for b in (0, 5):
        one = kmc.mcl_column(e[b:b + 1], infl[b:b + 1], 1e-4,
                             old=old[b:b + 1])
        assert torch.equal(one[0][0], whole[0][b])
        assert torch.equal(one[1][0], whole[1][b])


@pytest.mark.cuda
def test_mcl_column_kernel_tie_across_ranks(card):
    """At n = 8000 every CTA holds 500 rows: equal largest entries in
    rows 999 (rank 1) and 1000 (rank 2), and in rows 3999, 4000 and 7999
    (ranks 7, 8 and 15), below the pruning: only the first row of each
    column is kept; equal entries above it are all kept."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    n = 8000
    assert kmc.plan(n).rows == 500
    e, old, infl = _device_case(card, 17, 2, n)
    e[:, :, :3] = 0
    e[:, [999, 1000, 5000], 0] = 1.0     # q = 1/3 each, pruning 0.4
    e[:, [3999, 4000, 7999], 1] = 1.0
    e[:, [999, 1000], 2] = 1.0           # q = 0.5 each: both kept
    got, stat = kmc.mcl_column(e, infl, 0.4, old=old)
    torch.cuda.synchronize()
    want = torch.zeros((n, 3), device=card)
    want[999, 0] = want[3999, 1] = 1.0
    want[[999, 1000], 2] = 0.5
    assert all(torch.equal(got[b, :, :3], want) for b in range(2))
    cmp, stat_err, _ = _compare_by_columns(e, infl, 0.4, old, got, stat)
    _assert_agrees(cmp, stat_err, 2, n)


@pytest.mark.cuda
def test_mcl_column_kernel_raises_past_its_plan(card):
    """n = N_MAX + 1 on the card: a ValueError naming the limit, and no
    launch."""
    from haphic_tpu_torch.kernels import mcl_column as kmc
    n = kmc.N_MAX + 1
    torch.cuda.empty_cache()
    e = torch.empty((1, n, n), device=card)
    infl = torch.ones(1, device=card)
    n0 = kmc.mcl_column.launches
    with pytest.raises(ValueError, match='N_MAX = 70000'):
        kmc.mcl_column(e, infl, 1e-4)
    assert kmc.mcl_column.launches == n0
    del e
    torch.cuda.empty_cache()


# --- the sparse MCL convergence statistic -------------------------------

STAT_KINDS = ('identical', 'same_ids', 'disjoint', 'partial', 'old_only',
              'new_only', 'sentinel_only')
# (Ko, Kn): equal widths at K = 1, 5, 16, 128, and unequal ones
STAT_WIDTHS = [(1, 1), (5, 5), (16, 16), (128, 128), (16, 5), (5, 16),
               (128, 16), (1, 128)]


def _stat_case(seed, B, C, Ko, Kn, n):
    """(old_i, old_v, new_i, new_v) ELL column pairs, (B, C, Ko) and
    (B, C, Kn), numpy. Column g = b·C + c is of kind STAT_KINDS[g % 7]:
    the same ids and values on both sides, the same ids with other
    values, disjoint ids, ids drawn from one small pool (a partial
    overlap), real ids in old only, in new only, or in neither (−inf).
    Values are log-uniform in [1e-12, 1], each side's sum at most 1."""
    rng = np.random.default_rng(seed)
    oi = np.full((B, C, Ko), n, np.int32)
    ov = np.zeros((B, C, Ko), np.float32)
    ni = np.full((B, C, Kn), n, np.int32)
    nv = np.zeros((B, C, Kn), np.float32)

    def vals(m):
        v = 10.0 ** rng.uniform(-12, 0, m)
        return (v / max(1.0, v.sum())).astype(np.float32)
    for b in range(B):
        for c in range(C):
            kind = STAT_KINDS[(b * C + c) % len(STAT_KINDS)]
            mo = int(rng.integers(1, Ko + 1))
            mn = int(rng.integers(1, Kn + 1))
            if kind in ('identical', 'same_ids'):
                mo = mn = min(mo, mn)
                ido = idn = np.sort(rng.choice(n, mo, replace=False))
            elif kind == 'disjoint':
                ids = rng.choice(n, mo + mn, replace=False)
                ido, idn = np.sort(ids[:mo]), np.sort(ids[mo:])
            else:
                pool = min(n, Ko + Kn)
                ido = np.sort(rng.choice(pool, min(mo, pool), replace=False))
                idn = np.sort(rng.choice(pool, min(mn, pool), replace=False))
                if kind in ('new_only', 'sentinel_only'):
                    ido = ido[:0]
                if kind in ('old_only', 'sentinel_only'):
                    idn = idn[:0]
            vo = vals(len(ido))
            vn = vo.copy() if kind == 'identical' else vals(len(idn))
            oi[b, c, :len(ido)], ov[b, c, :len(ido)] = ido, vo
            ni[b, c, :len(idn)], nv[b, c, :len(idn)] = idn, vn
    return oi, ov, ni, nv


def _stat_pair(card, args, n):
    """The kernel (one launch) and the plain version on the same columns
    on the card: (got, want), after checking the −inf columns equal and
    the others within 1e-9 absolute."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    args = [torch.as_tensor(x).to(card) for x in args]
    n0 = kca.col_allclose.launches
    got = kca.col_allclose(*args, n)
    want = kca.col_allclose_plain(*args, n)
    torch.cuda.synchronize()
    assert kca.col_allclose.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == args[0].shape[:2]
    cmp = kit.col_allclose_compare(got, want)
    assert cmp['inf_differ'] == 0 and cmp['max_abs_err'] <= 1e-9, cmp
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize('Ko,Kn', STAT_WIDTHS)
def test_col_allclose_kernel_matches_plain(card, Ko, Kn):
    B, C, n = 3, 70, 4000
    got, _ = _stat_pair(card, _stat_case(Ko * 1000 + Kn, B, C, Ko, Kn, n), n)
    kinds = torch.arange(B * C, device=card).view(B, C) % len(STAT_KINDS)
    sentinel_only = kinds == STAT_KINDS.index('sentinel_only')
    assert bool((got[sentinel_only] == -torch.inf).all())
    assert bool(torch.isfinite(got[~sentinel_only]).all())


@pytest.mark.cuda
def test_col_allclose_kernel_old_as_a_strided_slice(card):
    """old as _sweep_cols passes it, the slice A[:, s:e] of the whole
    (B, N, K) iterate (batch stride N·K), new a slice of a wider block
    too: the same bits as on contiguous copies."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    B, C, K, n, s = 4, 300, 32, 2000, 111
    oi, ov, ni, nv = _stat_case(8, B, C, K, K, n)
    A_i = torch.full((B, C + 400, K), n, dtype=torch.int32, device=card)
    A_v = torch.zeros((B, C + 400, K), device=card)
    A_i[:, s:s + C], A_v[:, s:s + C] = torch.as_tensor(oi), torch.as_tensor(
        ov)
    W_i = torch.full((B, C + 9, K), n, dtype=torch.int32, device=card)
    W_v = torch.zeros((B, C + 9, K), device=card)
    W_i[:, 9:], W_v[:, 9:] = torch.as_tensor(ni), torch.as_tensor(nv)
    got = kca.col_allclose(A_i[:, s:s + C], A_v[:, s:s + C], W_i[:, 9:],
                           W_v[:, 9:], n)
    flat, _ = _stat_pair(card, (oi, ov, ni, nv), n)
    assert torch.equal(got, flat)


@pytest.mark.cuda
def test_col_allclose_kernel_no_columns(card):
    """C = 0: a (B, 0) result and no launch."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    oi, ov, ni, nv = (torch.as_tensor(x, device=card)[:, :0]
                      for x in _stat_case(9, 2, 3, 8, 8, 50))
    n0 = kca.col_allclose.launches
    got = kca.col_allclose(oi, ov, ni, nv, 50)
    assert tuple(got.shape) == (2, 0) and kca.col_allclose.launches == n0


@pytest.mark.cuda
def test_col_allclose_kernel_at_the_smoke_shape(card):
    """B = 4, C = N = 24,001, K = 128: a seeded iterate shaped like the
    sparse smoke run's as old, its sparse_column step as new, in one
    launch; and the chunked statistic (step_stats) the same bits."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    from haphic_tpu_torch.kernels import sparse_column as kcol
    B, n, K = 4, 24000, 128
    idx, val = kit.sparse_column_iterate(3, B, n, K)
    A_i, A_v = torch.as_tensor(idx, device=card), torch.as_tensor(
        val, device=card)
    infl = torch.linspace(1.2, 2.0, B, device=card)
    new = kit.step_columns(kcol.sparse_column, A_i, A_v, infl, n, K, 2048,
                           1e-4)
    got, want = _stat_pair(card, (A_i, A_v) + new, n)
    assert bool((got[:, n] == -torch.inf).all())
    assert bool(torch.isfinite(got[:, :n]).all())
    chunked = kit.step_stats(kca.col_allclose, A_i, A_v, *new, n, 2048)
    assert torch.equal(chunked, got)
    decide = [(x.amax(dim=1) <= 1e-8).tolist() for x in (got, want)]
    assert decide[0] == decide[1]


@pytest.mark.cuda
def test_col_allclose_kernel_repeat_and_block_bit_equal(card):
    """Two launches give the same bits, and a block of columns gives the
    bits of the same columns inside the whole launch (as the mesh's
    column blocks need)."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    B, C, K, n = 2, 500, 64, 3000
    args = [torch.as_tensor(x, device=card)
            for x in _stat_case(12, B, C, K, K, n)]
    whole = kca.col_allclose(*args, n)
    again = kca.col_allclose(*args, n)
    block = kca.col_allclose(*(t[:, 123:401] for t in args), n)
    one = kca.col_allclose(*(t[1:, 7:8] for t in args), n)
    torch.cuda.synchronize()
    assert torch.equal(whole, again)
    assert torch.equal(whole[:, 123:401], block)
    assert torch.equal(whole[1:, 7:8], one)


@pytest.mark.cuda
def test_sweep_step_launches_the_statistic_kernel(card):
    """_sweep_step launches the statistic once a step on the card (over
    all of the step's column chunks), and its per-inflation statistic is
    the max of the kernel's over the step's columns."""
    from haphic_tpu_torch.cluster import sparse_mcl as tsp
    from haphic_tpu_torch.kernels import col_allclose as kca
    B, n, K, chunk = 2, 300, 32, 128
    idx, val = _ell_case(6, B, n, K)
    si, sv = torch.as_tensor(idx, device=card), torch.as_tensor(
        val, device=card)
    infl = torch.tensor([1.6, 2.4], device=card)
    n0 = kca.col_allclose.launches
    ni, nv, stat, _ = tsp._sweep_step(si, sv, infl, np.ones(B, dtype=bool),
                                      n, K, chunk, 1e-4, 2)
    assert -(-(n + 1) // chunk) > 1 and kca.col_allclose.launches == n0 + 1
    want = kca.col_allclose_plain(si, sv, ni, nv, n).amax(dim=1)
    assert torch.equal(stat, want)
    # with the host loop's order flag: the same bits, the flag clear
    flag = torch.zeros(1, dtype=torch.int32, device=card)
    again = tsp._sweep_step(si, sv, infl, np.ones(B, dtype=bool), n, K,
                            chunk, 1e-4, 2, bad=flag)
    assert all(torch.equal(a, b) for a, b in zip((ni, nv, stat), again))
    assert int(flag) == 0


@pytest.mark.cuda
def test_col_allclose_kernel_rejects_bad_input(card):
    from haphic_tpu_torch.kernels import col_allclose as kca
    oi, ov, ni, nv = (torch.as_tensor(x, device=card)
                      for x in _stat_case(13, 2, 20, 8, 8, 100))
    bad_order = ni.clone()
    bad_order[0, 3, :2] = bad_order[0, 3, [1, 0]]
    bad = [(oi.long(), ov, ni, nv), (oi, ov.double(), ni, nv),
           (oi, ov, ni.cpu(), nv), (oi, ov, ni[:, :10], nv[:, :10]),
           (oi.transpose(1, 2), ov.transpose(1, 2), ni, nv)]
    n0 = kca.col_allclose.launches
    for args in bad:
        with pytest.raises(ValueError):
            kca.col_allclose(*args, 100)
    assert kca.col_allclose.launches == n0
    # the order is the kernel's to check: it launches, then the wrapper
    # reads its flag and raises
    with pytest.raises(ValueError):
        kca.col_allclose(oi, ov, bad_order, nv, 100)
    assert kca.col_allclose.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize('kind', [
    'old_unsorted', 'old_repeated', 'old_after_sentinel', 'new_unsorted',
    'new_repeated', 'new_after_sentinel', 'old_negative', 'new_above_n'])
def test_col_allclose_kernel_flags_a_column_out_of_order(card, kind):
    """With the caller's flag the wrapper does not raise: the kernel sets
    the flag to 1 on any column out of ELL order, and leaves it clear on
    the ordered columns, whose results stay the same bits."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    n = 100
    args = [torch.as_tensor(x, device=card)
            for x in _stat_case(17, 2, 20, 8, 8, n)]
    flag = torch.zeros(1, dtype=torch.int32, device=card)
    want = kca.col_allclose(*args, n, bad=flag)
    assert int(flag) == 0
    side = 0 if kind.startswith('old') else 2
    ids = args[side].clone()
    col = ids[0, 3]                        # a partial overlap
    real = int((col < n).sum())
    assert real >= 2 and real < ids.shape[2]
    if kind.endswith('unsorted'):
        col[[0, real - 1]] = col[[real - 1, 0]].clone()
    elif kind.endswith('repeated'):
        col[real - 1] = col[0]
    elif kind.endswith('after_sentinel'):
        col[-1] = min(set(range(n)) - set(col.tolist()))
    elif kind.endswith('negative'):
        col[0] = -1
    else:
        col[-1] = n + 1
    args[side] = ids
    got = kca.col_allclose(*args, n, bad=flag)
    assert int(flag) == 1
    keep = torch.ones_like(got, dtype=torch.bool)
    keep[0, 3] = False
    assert torch.equal(got[keep], want[keep])


@pytest.mark.cuda
@pytest.mark.parametrize('K', [2, 8, 16, 32], ids=lambda k: 'K{}'.format(k))
def test_col_allclose_kernel_lane_groups_at_small_K(card, K):
    """At K <= 16 a column pair takes 8 lanes (Ko + Kn <= 32), at K = 32
    16 lanes: every kind of column pair against the plain version, over
    enough pairs that groups of one warp hold different kinds."""
    B, C, n = 2, 333, 600
    got, _ = _stat_pair(card, _stat_case(K * 7 + 1, B, C, K, K, n), n)
    kinds = torch.arange(B * C, device=card).view(B, C) % len(STAT_KINDS)
    sentinel_only = kinds == STAT_KINDS.index('sentinel_only')
    assert bool((got[sentinel_only] == -torch.inf).all())


@pytest.mark.cuda
def test_col_allclose_kernel_past_the_staging_width(card):
    """Ko + Kn past what a CTA stages in shared memory: the merge reads
    the columns in place, with the same results."""
    B, C, n = 1, 12, 9000
    _stat_pair(card, _stat_case(31, B, C, 2100, 2100, n), n)
    _stat_pair(card, _stat_case(32, B, C, 4000, 300, n), n)


def test_col_allclose_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    from haphic_tpu_torch.kernels import col_allclose as kca
    args = [torch.as_tensor(x) for x in _stat_case(14, 2, 30, 16, 5, 200)]
    n0 = kca.col_allclose.launches
    got = kca.col_allclose(*args, 200)
    assert kca.col_allclose.launches == n0
    assert torch.equal(got, kca.col_allclose_plain(*args, 200))


# --- the GA cycle's rescoring ----------------------------------------------

def _rescore_case(seed, G, P, k, R, pad=0, dev='cuda'):
    """A population and records as rescore takes them (la, lb gathered
    from the lengths); the last ``pad`` records are padding (pa = pb =
    0, d = 0, w = 0), and some distances are negative, so that the
    clamp at 1 is reached."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lengths = torch.randint(1000, 500000, (G, k), generator=g, device=dev)
    pa = torch.randint(0, k, (G, R), generator=g, device=dev,
                       dtype=torch.int32)
    pb = torch.randint(0, k, (G, R), generator=g, device=dev,
                       dtype=torch.int32)
    d = torch.randint(-5000, 100000, (G, 4, R), generator=g,
                      device=dev).float()
    w = torch.rand((G, R), generator=g, device=dev)
    if pad:
        for x in (pa, pb, d, w):
            x[..., R - pad:] = 0
    order = torch.argsort(torch.rand((G, P, k), generator=g, device=dev),
                          dim=2).to(torch.int32)
    ori = torch.randint(0, 2, (G, P, k), generator=g, device=dev,
                        dtype=torch.int32)
    Li = lengths.to(torch.int32)
    la = torch.gather(Li, 1, pa.long())
    lb = torch.gather(Li, 1, pb.long())
    return [order, ori, lengths, pa, pb, la, lb, d, w]


def _check_rescore(args):
    """Kernel against plain version in caches mode: L_slot, startsx, the
    six caches and the contributions bit-equal; each score within half
    an ulp of the exact sum of the plain version's f32 contributions
    plus the f64 sums' own error; scores mode gives the same scores."""
    from haphic_tpu_torch.kernels import rescore as krs
    n0 = krs.rescore.launches
    got = krs.rescore(*args, caches=True)
    want = krs.rescore_plain(*args, caches=True)
    scores = krs.rescore(*args, caches=False)
    torch.cuda.synchronize()
    assert krs.rescore.launches == n0 + 2
    for n, (a, b) in enumerate(zip(got[:-1], want[:-1])):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    c = want[-2].double()
    exact, mag = c.sum(dim=2), c.abs().sum(dim=2)
    del c
    ks = got[-1].abs()
    half = 0.5 * (torch.nextafter(ks, torch.full_like(ks, np.inf))
                  - ks).double()
    bound = half + 2.0 * args[3].shape[1] * 2.0 ** -53 * mag
    assert bool(((got[-1].double() - exact).abs() <= bound).all())
    assert torch.equal(scores, got[-1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize('G,P,k,R,pad', [
    (3, 6, 32, 1000, 50),        # one tile, one chunk, padding records
    (2, 8, 64, 5001, 0),         # R not a multiple of the 2048 chunk
    (1, 4, 500, 3000, 0),        # P = 4 (sim ga_study's truth rescoring)
    (2, 37, 300, 9000, 7),       # tiles of 16, a partial last tile
    (1, 3, 13000, 700, 0),       # tables past shared memory: global path
    (1, 2, 2, 40, 0),            # k = 2
    (3, 21, 2000, 7000, 3),      # tiles of 8 (past k = 1600)
    (2, 5, 7000, 2500, 0),       # tiles of 2, R just above one chunk
    (2, 9, 100, 0, 0),           # no records: scores 0, caches empty
], ids=['small', 'ragged-R', 'P4', 'tiles', 'global', 'k2', 'tile8',
        'tile2', 'no-records'])
def test_rescore_kernel_matches_plain(card, G, P, k, R, pad):
    _check_rescore(_rescore_case(G * k + R, G, P, k, R, pad))


@pytest.mark.cuda
def test_rescore_kernel_at_the_smoke_batch(card):
    """The dense pipeline's largest GA batch: G = 7, P = 100, k_pad =
    1024, R_pad = 196,608."""
    _check_rescore(_rescore_case(5, 7, 100, 1024, 196608, 1000))


@pytest.mark.cuda
def test_rescore_kernel_rows_do_not_depend_on_the_batch(card):
    """A row's scores are the same bits whether its group is launched
    with the others, in a slice of groups or alone, and on a repeat."""
    from haphic_tpu_torch.kernels import rescore as krs
    args = _rescore_case(6, 7, 12, 256, 20000)
    whole = krs.rescore(*args, caches=True)
    part = krs.rescore(*[x[2:5].contiguous() for x in args], caches=True)
    alone = krs.rescore(*[x[4:5].contiguous() for x in args], caches=False)
    again = krs.rescore(*args, caches=True)
    torch.cuda.synchronize()
    for a, b in zip(part, whole):
        assert torch.equal(a, b[2:5])
    assert torch.equal(alone, whole[-1][4:5])
    for a, b in zip(again, whole):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rescore_kernel_division_edge_values(card):
    """Weights and distances outside the range where the kernel divides
    by div.rn's fast path (weights of 0, subnormal, below 2^-32 and
    above 2^64; distances past 2^64 and infinite), beside ordinary
    ones in the same records: the contributions are still the plain
    version's bits."""
    args = _rescore_case(12, 2, 16, 64, 4000)
    w, d = args[8], args[7]
    edge = torch.tensor([0.0, 1e-40, 2.0 ** -33, 2.0 ** -32, 3e-20, 1.0,
                         2.0 ** 64, 3e19, 1e30], device=card)
    w[:, ::7] = edge[torch.arange(w[:, ::7].shape[1], device=card)
                     % len(edge)]
    d[:, :, 3::11] = torch.tensor([1e20, float('inf'), 2.0 ** 64, 5e18],
                                  device=card)[torch.arange(
                                      d[:, :, 3::11].shape[2],
                                      device=card) % 4]
    _check_rescore(args)


@pytest.mark.cuda
def test_rescore_kernel_repeats_leave_no_counter_set(card):
    """Three calls in a row in each mode, and calls of other shapes in
    between, give the same bits: each call's last CTA of a tile sets its
    arrival counter back to 0, so the next call starts from 0."""
    from haphic_tpu_torch.kernels import rescore as krs
    args = _rescore_case(9, 3, 40, 700, 30000, 11)
    other = _rescore_case(10, 5, 8, 300, 5000)
    first = [krs.rescore(*args, caches=c) for c in (False, True)]
    for _ in range(3):
        krs.rescore(*other, caches=True)
        for c, want in zip((False, True), first):
            got = krs.rescore(*args, caches=c)
            got = got if c else (got,)
            want = want if c else (want,)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    dev = args[0].device.index
    assert int(krs._WORK[dev][0].abs().sum()) == 0


@pytest.mark.parametrize('names, ok', [
    (['k<8>', 'k<8>', 'k<8>'], True),
    (['k<8>'], True),                      # the profiler missed two
    ([], True),
    (['k<8>'] * 4, False),                 # more than one a call
    (['k<8>', 'other', 'k<8>'], False),    # another kernel
])
def test_profiling_check_kernels(names, ok):
    """check_kernels on recorded events of 3 calls: fewer than one a call
    passes (the launch counters prove the launches), more, or a kernel
    of another name, raises."""
    events = [(n, 10.0 * i, 10.0 * i + 4.0) for i, n in enumerate(names)]
    if ok:
        kit.check_kernels(events, 3, 'k<')
        if events:
            assert kit.device_ms(events) == pytest.approx(0.004)
    else:
        with pytest.raises(RuntimeError):
            kit.check_kernels(events, 3, 'k<')


@pytest.mark.cuda
@pytest.mark.parametrize('caches', [False, True], ids=['scores', 'caches'])
def test_rescore_kernel_is_one_device_kernel_a_call(card, caches):
    """A call, its plan and workspace set up, runs one kernel on the
    card (torch profiler) in either mode, at the smoke batch's shape:
    the profiler records one kernel a call, the rescoring kernel, and
    the wrapper counts one launch a call."""
    from haphic_tpu_torch.kernels import rescore as krs
    args = _rescore_case(11, 7, 100, 1024, 196608, 1000)
    n0 = krs.rescore.launches
    for _ in range(3):
        krs.rescore(*args, caches=caches)
    assert krs.rescore.launches == n0 + 3
    ms = kit.one_kernel_a_call(
        lambda: krs.rescore(*args, caches=caches), 3, 'rescore_kernel')
    assert ms > 0


@pytest.mark.cuda
def test_rescore_kernel_rejects_bad_input(card):
    from haphic_tpu_torch.kernels import rescore as krs
    args = _rescore_case(7, 1, 4, 16, 100)
    bad = list(args)
    bad[0] = args[0].to(torch.int64)                # dtype
    with pytest.raises(ValueError):
        krs.rescore(*bad, caches=False)
    bad = list(args)
    bad[7] = args[7].cpu()                          # device
    with pytest.raises(ValueError):
        krs.rescore(*bad, caches=True)
    bad = list(args)
    bad[5] = args[5][:, :50]                        # shape
    with pytest.raises(ValueError):
        krs.rescore(*bad, caches=True)
    bad = list(args)
    bad[8] = torch.rand((1, 200), device='cuda')[:, ::2]  # not contiguous
    with pytest.raises(ValueError):
        krs.rescore(*bad, caches=False)


@pytest.mark.cuda
def test_rescore_kernel_in_a_ga_run_on_the_card(card, caplog):
    """A GA run on the card goes through the score kernel, the delta
    kernel and the rescoring kernel, the last two once per delta
    generation and once per rescoring call the GA reports."""
    import logging
    from haphic_tpu_torch.kernels import rescore as krs
    problem, true_order, true_ori = _sim_chromosome_problem(4)
    caplog.set_level(logging.INFO, logger='haphic_tpu_torch')
    n = (kscore.score_population.launches, kdelta.delta_generation.launches,
         krs.rescore.launches)
    res = topt.optimize_tour(problem, npop=32, ngen=300, seed=2,
                             log_every=100, backend='device', device='cuda')
    metrics = [getattr(r, 'metrics', {}) for r in caplog.records]
    gens = sum(m['ga_delta_gens'] for m in metrics if 'ga_delta_gens' in m)
    rescores = sum(m['ga_rescores'] for m in metrics if 'ga_rescores' in m)
    assert kscore.score_population.launches > n[0]
    assert kdelta.delta_generation.launches - n[1] == gens > 0
    assert krs.rescore.launches - n[2] == rescores == 3 * 12
    scores = [s for _, s in res.history]
    assert all(b >= a - 1e-6 * abs(a) for a, b in zip(scores, scores[1:]))
    assert sorted(res.order.tolist()) == list(range(problem.k))

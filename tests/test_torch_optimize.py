"""Parity of the port's tour optimizer (haphic_tpu_torch.order.optimize
and the score kernel's plain version) with the JAX package's, on the
CPU.

Random draws cannot be replayed across frameworks, so the step tests
re-derive the JAX package's draws from its keys and hand them to the
port; end to end, the device GA is held to the JAX package's quality
tests (tests/test_optimize.py)."""

import importlib
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from haphic_tpu.order import optimize as jopt

from haphic_tpu_torch import convert
from haphic_tpu_torch.kernels import delta as tdelta
from haphic_tpu_torch.kernels import score as tscore
from haphic_tpu_torch.order import optimize as topt

from .test_optimize import (_brute_score, _canonical_tour, _random_problem,
                            _sim_chromosome_problem)

# xdist runs several test files at once on the same cores; torch's
# default of one intra-op thread per core then oversubscribes them and
# the many small ops of the GA and MCL loops wait on each other.
torch.set_num_threads(1)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _score_case(seed, G=2, P=6, k=32, R=1024):
    """The shapes of tests/test_optimize.py::test_pallas_score_matches_xla."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1000, 500000, (G, k)).astype(np.int64)
    pa = rng.integers(0, k, (G, R)).astype(np.int32)
    pb = rng.integers(0, k, (G, R)).astype(np.int32)
    sel = pa == pb
    pb[sel] = (pb[sel] + 1) % k
    d = rng.integers(1, 100000, (G, 4, R)).astype(np.float32)
    w = rng.random((G, R)).astype(np.float32)
    order = np.stack([np.stack([rng.permutation(k).astype(np.int32)
                                for _ in range(P)]) for _ in range(G)])
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)
    return order, ori, lengths, pa, pb, d, w


@pytest.mark.parametrize('seed', [9, 10])
def test_plain_scorer_matches_xla_and_pallas(seed):
    case = _score_case(seed)
    args = [jnp.asarray(x) for x in case]
    R = case[3].shape[1]
    xla = np.asarray(jopt._score_batched(*args, R))
    pallas = np.asarray(jopt._score_stacked_pallas(*args, interpret=True))
    got = tscore.score_population(*[_t(x) for x in case]).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5)
    # the plain version with small record chunks sums in another order
    small = tscore.score_population_plain(*[_t(x) for x in case],
                                          chunk=100).numpy()
    np.testing.assert_allclose(small, got, rtol=1e-5)


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_scorer_matches_bruteforce(seed):
    problem = _random_problem(seed)
    rng = np.random.default_rng(seed + 100)
    P = 4
    orders = np.stack([rng.permutation(problem.k) for _ in range(P)]
                      ).astype(np.int32)
    oris = rng.integers(0, 2, size=(P, problem.k)).astype(np.int32)
    pa, pb, d, w, _ = topt._pad_records(convert.problem_from_jax(problem),
                                        64)
    got = tscore.score_population(
        *convert.population_from_jax(orders[None], oris[None]),
        _t(problem.lengths[None]),
        _t(pa[None]), _t(pb[None]), _t(d[None]), _t(w[None]))[0]
    for p in range(P):
        assert float(got[p]) == pytest.approx(
            _brute_score(problem, orders[p], oris[p]), rel=1e-4)


def _cache_setup(P=16, k=32, R=300):
    """Inputs of tests/test_optimize.py::
    test_delta_endpoint_update_matches_rebuild, with int32 endpoint
    lengths as the delta window uses them."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 4096, size=k).astype(np.int32)
    a = rng.integers(0, k - 1, size=R)
    b = a + rng.integers(1, k - np.maximum(a, 1), size=R).clip(1)
    b = np.minimum(b, k - 1)
    order = np.stack([rng.permutation(k) for _ in range(P)]).astype(
        np.int32)
    ori = rng.integers(0, 2, size=(P, k)).astype(np.int32)
    d = rng.integers(1, 100000, (4, R)).astype(np.float32)
    w = rng.random(R).astype(np.float32)
    return lengths, a.astype(np.int32), b.astype(np.int32), order, ori, d, w


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.array_equal(np.squeeze(got, 0), np.asarray(want)), what


def test_delta_caches_match_jax_over_40_generations():
    """_build_caches, _move_scalars, _endpoint_update, _move_src and
    _contrib_from_cache of both packages agree exactly over 40
    generations of the moves JAX's _sample_moves draws."""
    P, k = 16, 32
    lengths, pa, pb, order, ori, d, w = _cache_setup(P, k)
    jl, jpa, jpb = jnp.asarray(lengths), jnp.asarray(pa), jnp.asarray(pb)
    jla, jlb = jl[jpa], jl[jpb]
    jorder, jori = jnp.asarray(order), jnp.asarray(ori)
    tl = _t(lengths[None], torch.int64)
    tpa, tpb = _t(pa[None]), _t(pb[None])
    tla, tlb = _t(lengths[pa][None]), _t(lengths[pb][None])
    td, tw = _t(d[None]), _t(w[None])
    jc = jopt._build_caches(jorder, jori, jl, jpa, jpb)
    torder, tori = _t(order[None]), _t(ori[None])
    tc = topt._build_caches(torder, tori, tl, tpa, tpb)
    for name, g, x in zip(('L_slot', 'startsx', 'posA', 'sA', 'oA', 'posB',
                           'sB', 'oB'), tc, jc):
        _eq(g, x, 'initial ' + name)
    jposA, jsA, joA, jposB, jsB, joB = jc[2:]
    tposA, tsA, toA, tposB, tsB, toB = tc[2:]
    key = jax.random.PRNGKey(7)
    for gen in range(40):
        key, km = jax.random.split(key)
        do, op, i, j, t = jopt._sample_moves(km, P, k, 0.9)
        tm = [_t(np.asarray(x)[None]) for x in (do, op, i, j, t)]
        jsc = jopt._move_scalars(jc[1], i, j, t)
        tsc = topt._move_scalars(tc[1], *tm[2:])
        for name, g, x in zip(('Sx', 'Sy', 'Lx', 'Ly', 'Et'), tsc, jsc):
            _eq(g, x, 'gen {} {}'.format(gen, name))
        jposA, jsA, joA = jopt._endpoint_update(
            jposA, jsA, joA, jla, do, op, i, j, t, *jsc)
        jposB, jsB, joB = jopt._endpoint_update(
            jposB, jsB, joB, jlb, do, op, i, j, t, *jsc)
        tposA, tsA, toA = topt._endpoint_update(
            tposA, tsA, toA, tla, *tm, *tsc)
        tposB, tsB, toB = topt._endpoint_update(
            tposB, tsB, toB, tlb, *tm, *tsc)
        for name, g, x in zip(('posA', 'sA', 'oA', 'posB', 'sB', 'oB'),
                              (tposA, tsA, toA, tposB, tsB, toB),
                              (jposA, jsA, joA, jposB, jsB, joB)):
            _eq(g, x, 'gen {} update {}'.format(gen, name))
        jsrc, jflip = jopt._move_src(do, op, i, j, t, k)
        tsrc, tflip = topt._move_src(*tm, k)
        _eq(tsrc, jsrc, 'gen {} src'.format(gen))
        _eq(tflip, jflip, 'gen {} flip'.format(gen))
        jc_ = jopt._contrib_from_cache(jposA, jsA, joA, jposB, jsB, joB,
                                       jla, jlb, jnp.asarray(d),
                                       jnp.asarray(w))
        tc_ = topt._contrib_from_cache(tposA, tsA, toA, tposB, tsB, toB,
                                       tla, tlb, td, tw)
        _eq(tc_, jc_, 'gen {} contrib'.format(gen))
        # tables follow the move; caches rebuilt from them must agree
        jorder = jnp.take_along_axis(jorder, jsrc, axis=1)
        jori = jnp.take_along_axis(jori, jsrc, axis=1)
        jori = jnp.where(jflip, 1 - jori, jori)
        torder, tori = topt._apply_move(torder, tori, tsrc, tflip)
        _eq(torder, jorder, 'gen {} order'.format(gen))
        _eq(tori, jori, 'gen {} ori'.format(gen))
        jc = jopt._build_caches(jorder, jori, jl, jpa, jpb)
        tc = topt._build_caches(torder, tori, tl, tpa, tpb)
        for name, g, x in zip(('posA', 'sA', 'oA'), (tposA, tsA, toA),
                              jc[2:5]):
            _eq(g, x, 'gen {} rebuild {}'.format(gen, name))


def _jax_draws(key, P, k):
    """The seven draws jopt._sample_moves makes from ``key``."""
    keys = jax.random.split(key, 7)
    return (jax.random.uniform(keys[0], (P,)),
            jax.random.randint(keys[1], (P,), 0, 4),
            jax.random.randint(keys[2], (P,), 0, k),
            jax.random.randint(keys[3], (P,), 0, k),
            jax.random.randint(keys[4], (P,), 0, k),
            jax.random.uniform(keys[5], (P,)),
            jax.random.uniform(keys[6], (P,)))


def _row_sums(x):
    """Row sums of a (P, R) f32 array by torch's reduction. Both
    packages' per-record terms are held bit for bit; the order of a
    float sum is the one thing the two frameworks do not share, so the
    JAX side's scores and deltas are summed by this same reduction (the
    port's, over contiguous rows), and XLA's own sum is held to the
    kernel tolerance instead."""
    return torch.as_tensor(np.array(x)).sum(dim=1).numpy()


def _jax_dgen(state, moves, la, lb, d, w):
    """The body of dgen in jopt._evolve_delta_impl
    (haphic_tpu/order/optimize.py:824-894), assembled from the JAX
    package's own functions; returns (state, acc, delta, xla_delta)."""
    (order, ori, L_slot, startsx, posA, sA, oA, posB, sB, oB,
     scores) = state
    do, op, i, j, t = moves
    k = order.shape[1]
    Sx, Sy, Lx, Ly, Et = jopt._move_scalars(startsx, i, j, t)
    posA2, sA2, oA2 = jopt._endpoint_update(
        posA, sA, oA, la, do, op, i, j, t, Sx, Sy, Lx, Ly, Et)
    posB2, sB2, oB2 = jopt._endpoint_update(
        posB, sB, oB, lb, do, op, i, j, t, Sx, Sy, Lx, Ly, Et)
    old_c = jopt._contrib_from_cache(posA, sA, oA, posB, sB, oB,
                                     la, lb, d, w)
    new_c = jopt._contrib_from_cache(posA2, sA2, oA2, posB2, sB2, oB2,
                                     la, lb, d, w)
    xla_delta = np.asarray((new_c - old_c).sum(axis=1))
    delta = jnp.asarray(_row_sums(new_c - old_c))
    spanv = jnp.where(op == 2, t - i, j - i).astype(jnp.float32)
    thr = scores * (jopt._DELTA_MIN_GAIN + jopt._DELTA_SPAN_GAIN * spanv)
    acc = delta > thr
    new_scores = scores + delta
    a_ = acc[:, None]
    src, flip = jopt._move_src(do, op, i, j, t, k)
    tabs = jnp.stack([order.astype(jnp.float32),
                      ori.astype(jnp.float32),
                      (L_slot >> 12).astype(jnp.float32),
                      (L_slot & 0xfff).astype(jnp.float32)], axis=1)
    g = jopt._permute_tables(tabs, src)
    order2 = g[:, 0].astype(jnp.int32)
    ori2 = g[:, 1].astype(jnp.int32)
    ori2 = jnp.where(flip, 1 - ori2, ori2)
    L2 = (jnp.round(g[:, 2]).astype(jnp.int32) << 12) \
        + jnp.round(g[:, 3]).astype(jnp.int32)
    L_slot = jnp.where(a_, L2, L_slot)
    startsx = jnp.concatenate([jnp.zeros((order.shape[0], 1), jnp.int32),
                               jnp.cumsum(L_slot, axis=1)], axis=1)
    out = (jnp.where(a_, order2, order), jnp.where(a_, ori2, ori), L_slot,
           startsx) + tuple(jnp.where(a_, n, o) for n, o in zip(
               (posA2, sA2, oA2, posB2, sB2, oB2),
               (posA, sA, oA, posB, sB, oB))) + (
        jnp.where(acc, new_scores, scores),)
    return out, np.asarray(acc), np.asarray(delta), xla_delta


def _dgen_parity(gens, seed=7, P=16, k=32):
    """Whole delta generations of both packages on the same moves:
    acceptance, order, ori, L_slot, startsx, the six caches, the carried
    contributions and the scores exact after every generation."""
    lengths, pa, pb, order, ori, d, w = _cache_setup(P, k)
    jl, jpa, jpb = jnp.asarray(lengths), jnp.asarray(pa), jnp.asarray(pb)
    jla, jlb, jd, jw = jl[jpa], jl[jpb], jnp.asarray(d), jnp.asarray(w)
    jc = jopt._build_caches(jnp.asarray(order), jnp.asarray(ori), jl,
                            jpa, jpb)
    c0 = jopt._contrib_from_cache(*jc[2:], jla, jlb, jd, jw)
    jstate = (jnp.asarray(order), jnp.asarray(ori)) + tuple(jc) + (
        jnp.asarray(_row_sums(c0)),)
    rec = topt._Records(_t(lengths[None], torch.int64), _t(pa[None]),
                        _t(pb[None]), _t(d[None]), _t(w[None]))
    tstate = (_t(order[None]), _t(ori[None])) + rec.caches(
        _t(order[None]), _t(ori[None]))
    names = ('order', 'ori', 'L_slot', 'startsx', 'posA', 'sA', 'oA',
             'posB', 'sB', 'oB')
    seen = []

    def step(*args, **kw):
        seen.append(tdelta.delta_generation_plain(*args, **kw))
        return seen[-1]
    key = jax.random.PRNGKey(seed)
    n_acc = 0
    for gen in range(gens):
        key, km = jax.random.split(key)
        jmoves = jopt._sample_moves(km, P, k, 1.1,
                                    local_frac=jopt._DELTA_LOCAL_FRAC)
        tmoves = topt._moves_from_draws(
            *[_t(np.asarray(x)[None]) for x in _jax_draws(km, P, k)], k,
            1.1, topt._DELTA_LOCAL_FRAC)
        for name, g, x in zip(('do', 'op', 'i', 'j', 't'), tmoves, jmoves):
            _eq(g, x, 'gen {} move {}'.format(gen, name))
        jstate, jacc, jdelta, xla_delta = _jax_dgen(jstate, jmoves, jla,
                                                    jlb, jd, jw)
        tstate = topt._delta_step(rec, tstate, tmoves, step)
        tdelta_, tacc = seen[-1]
        _eq(tacc, jacc, 'gen {} acceptance'.format(gen))
        _eq(tdelta_, jdelta, 'gen {} delta'.format(gen))
        assert np.all(np.abs(xla_delta - jdelta)
                      <= 1e-6 * np.abs(np.asarray(jstate[-1])))
        for name, g, x in zip(names, tstate[:10], jstate[:10]):
            _eq(g, x, 'gen {} {}'.format(gen, name))
        _eq(tstate[10], jopt._contrib_from_cache(*jstate[4:10], jla, jlb,
                                                 jd, jw),
            'gen {} contrib'.format(gen))
        _eq(tstate[11], jstate[10], 'gen {} scores'.format(gen))
        n_acc += int(jacc.sum())
    return n_acc


def test_delta_generation_matches_jax_dgen_over_40_generations():
    """The port's whole delta generation (_delta_step with the plain
    delta_generation) against JAX's dgen body over 40 generations at
    P=16, k=32."""
    n_acc = _dgen_parity(40)
    assert 0 < n_acc < 40 * 16


def test_cpu_delta_generation_takes_the_plain_version():
    """On CPU tensors delta_generation runs the plain version and
    launches nothing."""
    lengths, pa, pb, order, ori, d, w = _cache_setup(8, 24, 200)
    rec = topt._Records(_t(lengths[None], torch.int64), _t(pa[None]),
                        _t(pb[None]), _t(d[None]), _t(w[None]))
    gen = torch.Generator()
    n0 = tdelta.delta_generation.launches
    out = []
    for step in (tdelta.delta_generation, tdelta.delta_generation_plain):
        gen.manual_seed(3)
        state = (_t(order[None]), _t(ori[None])) + rec.caches(
            _t(order[None]), _t(ori[None]))
        for _ in range(5):
            state = topt._dgen(topt._Draws(gen, 1), rec, state, step)
        out.append(state)
    assert tdelta.delta_generation.launches == n0
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_delta_step_settings_are_arguments():
    """The step takes the acceptance settings as arguments and reads no
    environment: a minimum gain of 10x the score accepts nothing, and a
    minimum gain of -10x accepts every move, and both leave the state
    consistent with a rebuild from the tours."""
    lengths, pa, pb, order, ori, d, w = _cache_setup(8, 24, 200)
    rec = topt._Records(_t(lengths[None], torch.int64), _t(pa[None]),
                        _t(pb[None]), _t(d[None]), _t(w[None]))
    gen = torch.Generator()
    gen.manual_seed(4)
    move = topt._sample_moves(topt._Draws(gen, 1), (1, 8), 24, 1.1)
    for min_gain, want in ((10.0, False), (-10.0, True)):
        state = (_t(order[None]), _t(ori[None])) + rec.caches(
            _t(order[None]), _t(ori[None]))
        delta, acc = tdelta.delta_generation_plain(
            state, move, rec.la, rec.lb, rec.d, rec.w, min_gain, 0.0)
        assert bool((acc == want).all())
        rebuilt = rec.caches(state[0], state[1])
        for a, b in zip(state[2:-1], rebuilt[:-1]):
            assert torch.equal(a, b)
        np.testing.assert_allclose(state[-1].numpy(), rebuilt[-1].numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize('op', [0, 1, 2, 3],
                         ids=['swap', 'inversion', 'rotation', 'flip'])
def test_untouched_records_keep_their_state(op):
    """The kernel visits only the records touched_records marks: every
    other record keeps its endpoint state and contribution bit for bit
    under every move kind, so its (new - old) is exactly 0.0. For the
    delta it computes only the records changed_records marks: the other
    touched records keep their contribution bit for bit too."""
    P, k = 64, 32
    lengths, pa, pb, order, ori, d, w = _cache_setup(P, k, 400)
    rec = topt._Records(_t(lengths[None], torch.int64), _t(pa[None]),
                        _t(pb[None]), _t(d[None]), _t(w[None]))
    state = (_t(order[None]), _t(ori[None])) + rec.caches(
        _t(order[None]), _t(ori[None]))
    gen = torch.Generator()
    gen.manual_seed(op)
    do, _, i, j, t = topt._sample_moves(topt._Draws(gen, 1), (1, P), k,
                                        0.8)
    move = (do, torch.full_like(i, op), i, j, t)
    scal = topt._move_scalars(state[3], i, j, t)
    new = (topt._endpoint_update(*state[4:7], rec.la, *move, *scal)
           + topt._endpoint_update(*state[7:10], rec.lb, *move, *scal))
    new_c = topt._contrib_from_cache(*new, rec.la, rec.lb, rec.d, rec.w)
    touched = tdelta.touched_records(state[4], state[7], move)
    assert not bool(touched[~do].any())
    assert 0 < int(touched.sum()) < touched.numel()
    for a, b in zip(new + (new_c,), state[4:11]):
        assert torch.equal(a[~touched], b[~touched])
    assert bool(((new_c - state[10])[~touched] == 0.0).all())
    changed = tdelta.changed_records(state[4], state[7], move)
    assert not bool((changed & ~touched).any())
    same = touched & ~changed
    assert bool(same.any()) == (op != 3)
    assert torch.equal(new_c[same], state[10][same])


_GA_SETTINGS = [('HAPHIC_GA_DELTA_LOCAL', '0.9'),
                ('HAPHIC_GA_DELTA_MIN_GAIN', '1e-3'),
                ('HAPHIC_GA_DELTA_SPAN_GAIN', '1e-4'),
                ('HAPHIC_GA_RESET', 'all'),
                ('HAPHIC_GA_RESET', 'none'),
                ('HAPHIC_GA_DELTA_MIN_GAIN', '-1e-3'),
                ('HAPHIC_GA_DELTA_SPAN_GAIN', '0')]
_GA_SETTING_IDS = ['haphic_ga_delta_local', 'haphic_ga_delta_min_gain',
                   'haphic_ga_delta_span_gain', 'haphic_ga_reset_all',
                   'haphic_ga_reset_none',
                   'haphic_ga_delta_min_gain_negative',
                   'haphic_ga_delta_span_gain_zero']


@pytest.fixture
def ga_env(monkeypatch):
    """Sets one GA variable and reloads both optimize modules, which
    read it at load; restores both afterwards."""
    def apply(var, value):
        monkeypatch.setenv(var, value)
        importlib.reload(jopt)
        importlib.reload(topt)
    yield apply
    monkeypatch.undo()
    importlib.reload(jopt)
    importlib.reload(topt)


@pytest.mark.parametrize('var,value', _GA_SETTINGS, ids=_GA_SETTING_IDS)
def test_ga_settings_follow_the_environment(ga_env, var, value):
    """Each GA variable that the JAX package reads changes the port the
    same way: thresholds and the reset rule, and the acceptance of
    delta generations on JAX-derived moves."""
    ga_env(var, value)
    assert topt._DELTA_LOCAL_FRAC == jopt._DELTA_LOCAL_FRAC
    assert topt._DELTA_MIN_GAIN == jopt._DELTA_MIN_GAIN
    assert topt._DELTA_SPAN_GAIN == jopt._DELTA_SPAN_GAIN
    assert topt._GA_RESET == os.environ.get('HAPHIC_GA_RESET', 'half')
    if var != 'HAPHIC_GA_RESET':
        assert float(value) in (topt._DELTA_LOCAL_FRAC,
                                topt._DELTA_MIN_GAIN,
                                topt._DELTA_SPAN_GAIN)
    # reset: one window of one cycle with no crossover and no mutation
    # leaves the selection, the re-seed and the final sort
    P, k = 16, 32
    lengths, pa, pb, order, ori, d, w = _cache_setup(P, k)
    want = jopt._evolve_delta_impl(
        jax.random.PRNGKey(0), jnp.asarray(order), jnp.asarray(ori),
        jnp.asarray(lengths.astype(np.int64)), jnp.asarray(pa),
        jnp.asarray(pb), jnp.asarray(d), jnp.asarray(w), 0.0, 1024, 1,
        xoprob=0.0)
    rec = topt._Records(_t(lengths[None], torch.int64), _t(pa[None]),
                        _t(pb[None]), _t(d[None]), _t(w[None]))
    got = topt._evolve_delta_impl(topt._Draws(torch.Generator(), 1), rec,
                                  _t(order[None]), _t(ori[None]), 0.0, 1,
                                  xoprob=0.0)
    _eq(got[0], want[0], 'order after reset')
    _eq(got[1], want[1], 'ori after reset')
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    distinct = len({tuple(r) for r in np.asarray(want[0]).tolist()})
    assert distinct == {'all': 1, 'none': P // 2}.get(
        os.environ.get('HAPHIC_GA_RESET'), distinct)
    # acceptance of delta generations on JAX-derived moves
    _dgen_parity(5, seed=11)


@pytest.mark.parametrize('mutprob,local_frac', [(0.9, 0.5), (1.1, 0.0),
                                                (0.5, 1.0)])
def test_moves_from_jax_draws(mutprob, local_frac):
    """The port's move arithmetic on JAX's own draws (same key, same
    splits) gives JAX's _sample_moves exactly."""
    P, k = 512, 40
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 7)
    draws = (jax.random.uniform(keys[0], (P,)),
             jax.random.randint(keys[1], (P,), 0, 4),
             jax.random.randint(keys[2], (P,), 0, k),
             jax.random.randint(keys[3], (P,), 0, k),
             jax.random.randint(keys[4], (P,), 0, k),
             jax.random.uniform(keys[5], (P,)),
             jax.random.uniform(keys[6], (P,)))
    want = jopt._sample_moves(key, P, k, mutprob, local_frac=local_frac)
    got = topt._moves_from_draws(*[_t(x) for x in draws], k, mutprob,
                                 local_frac)
    for name, g, x in zip(('do', 'op', 'i', 'j', 't'), got, want):
        assert np.array_equal(g.numpy(), np.asarray(x)), name


def _ox_case(P=16, k=12, seed=0):
    rng = np.random.default_rng(seed)
    order = np.stack([rng.permutation(k) for _ in range(P)]).astype(
        np.int32)
    ori = rng.integers(0, 2, size=(P, k)).astype(np.int32)
    return order, ori


@pytest.mark.parametrize('xoprob', [1.0, 0.3])
def test_ox_crossover_matches_jax(xoprob):
    P, k = 16, 12
    order, ori = _ox_case(P, k)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 4)
    draws = (jax.random.uniform(keys[0], (P,)),
             jax.random.randint(keys[1], (P,), 0, P),
             jax.random.randint(keys[2], (P,), 0, k),
             jax.random.randint(keys[3], (P,), 0, k))
    want = jopt._ox_crossover(key, jnp.asarray(order), jnp.asarray(ori),
                              xoprob)
    got = topt._ox_from_draws(_t(order[None]), _t(ori[None]),
                              *[_t(np.asarray(x)[None]) for x in draws],
                              xoprob)
    _eq(got[0], want[0], 'child')
    _eq(got[1], want[1], 'child ori')
    for p in range(P):
        assert sorted(got[0][0, p].tolist()) == list(range(k))


def test_mutate_matches_jax():
    P, k, mutprob = 16, 12, 0.7
    order, ori = _ox_case(P, k, seed=4)
    key = jax.random.PRNGKey(5)
    want = jopt._mutate(key, jnp.asarray(order), jnp.asarray(ori), mutprob)
    moves = jopt._sample_moves(key, P, k, mutprob)
    tm = [_t(np.asarray(x)[None]) for x in moves]
    got = topt._apply_move(_t(order[None]), _t(ori[None]),
                           *topt._move_src(*tm, k))
    _eq(got[0], want[0], 'order')
    _eq(got[1], want[1], 'ori')


def test_selection_is_stable_parents_win_ties():
    scores = torch.tensor([[1.0, 3.0, 2.0, 3.0, 1.0, 2.0]])
    top_scores, top = topt._top_rows(scores, 3)
    assert top.tolist() == [[1, 3, 2]]
    assert top_scores.tolist() == [[3.0, 3.0, 2.0]]
    s, idx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    assert np.asarray(idx).tolist() == top.tolist()


def test_native_ga_bit_identical_to_jax():
    if jopt.native_lib() is None or topt.native_lib() is None:
        pytest.fail('native tour GA (native/tour_ga.cpp) did not build')
    problems = [_sim_chromosome_problem(s, k=k)[0]
                for s, k in ((3, 8), (4, 5))]
    want = jopt.optimize_tours(problems, npop=16, ngen=300, seed=9,
                               log_every=100, backend='native')
    got = topt.optimize_tours([convert.problem_from_jax(p)
                               for p in problems], npop=16, ngen=300,
                              seed=9, log_every=100, backend='native',
                              device='cpu')
    for g, x in zip(got, want):
        assert np.array_equal(g.order, x.order)
        assert np.array_equal(g.ori, x.ori)
        assert g.score == x.score
        assert g.history == x.history


@pytest.mark.parametrize('delta', [True, False],
                         ids=['delta-window', 'full-rescore'])
def test_device_ga_recovers_true_order(delta, monkeypatch):
    """tests/test_optimize.py::test_ga_recovers_true_order with the
    device backend, for the delta window and the full-rescore window."""
    if not delta:
        monkeypatch.setenv('HAPHIC_GA_NO_DELTA', '1')
    problem, true_order, true_ori = _sim_chromosome_problem(3)
    res = topt.optimize_tour(convert.problem_from_jax(problem), npop=32,
                             ngen=600 if delta else 300, seed=1,
                             log_every=200, backend='device', device='cpu')
    scores = [s for _, s in res.history]
    assert all(b >= a - 1e-6 for a, b in zip(scores, scores[1:]))
    true_score = _brute_score(problem, true_order, true_ori[true_order])
    assert res.score >= 0.95 * true_score
    assert _canonical_tour(res.order, res.ori) == \
        _canonical_tour(true_order, true_ori[true_order])


@pytest.mark.parametrize('delta', [True, False],
                         ids=['delta-window', 'full-rescore'])
def test_ga_logs_its_delta_generations(delta, monkeypatch, caplog):
    """optimize_tours logs, per batch, the delta generations it ran
    (`ga_delta_gens`): one step each, as counted at the step itself."""
    if not delta:
        monkeypatch.setenv('HAPHIC_GA_NO_DELTA', '1')
    calls = []
    plain = tdelta.delta_generation_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    monkeypatch.setattr(tdelta, 'delta_generation_plain', counted)
    caplog.set_level(logging.INFO, logger='haphic_tpu_torch')
    problems = [convert.problem_from_jax(_sim_chromosome_problem(s, k=k)[0])
                for s, k in ((3, 8), (4, 5))]
    topt.optimize_tours(problems, npop=8, ngen=45, seed=1, log_every=20,
                        backend='device', device='cpu')
    metrics = [getattr(r, 'metrics', {}) for r in caplog.records]
    logged = [m['ga_delta_gens'] for m in metrics if 'ga_delta_gens' in m]
    assert len(logged) == sum('ga_batch' in m for m in metrics) > 0
    assert sum(logged) == len(calls)
    assert (len(calls) > 0) == delta


def test_device_hot_start_and_skip_ga():
    problem, true_order, true_ori = _sim_chromosome_problem(5)
    hot = (true_order.astype(np.int32),
           true_ori[true_order].astype(np.int32))
    res = topt.optimize_tour(convert.problem_from_jax(problem), npop=8,
                             skip_ga=True, hot_start=hot,
                             backend='device', device='cpu')
    assert res.score == pytest.approx(
        _brute_score(problem, true_order, true_ori[true_order]), rel=1e-4)
    assert np.array_equal(res.order, hot[0])


def test_device_batched_groups_match_quality():
    """tests/test_optimize.py::test_optimize_tours_batched_matches_quality
    with the device backend: mixed (k, R) buckets plus a single-contig
    group."""
    problems, truths = [], []
    for seed, k in ((3, 8), (11, 8), (4, 5)):
        problem, true_order, true_ori = _sim_chromosome_problem(seed, k=k)
        problems.append(problem)
        truths.append((true_order, true_ori))
    tproblems = [convert.problem_from_jax(p) for p in problems]
    tproblems.append(topt.TourProblem(
        lengths=np.asarray([5000], np.int64),
        pair_a=np.zeros(0, np.int32), pair_b=np.zeros(0, np.int32),
        d=np.zeros((4, 0), np.float32), w=np.zeros(0, np.float32)))
    results = topt.optimize_tours(tproblems, npop=32, ngen=600, seed=1,
                                  log_every=200, backend='device',
                                  device='cpu')
    assert len(results) == 4
    assert results[3].order.tolist() == [0]
    for res, problem, (true_order, true_ori) in zip(results, problems,
                                                    truths):
        scores = [s for _, s in res.history]
        assert all(b >= a - 1e-6 for a, b in zip(scores, scores[1:]))
        true_score = _brute_score(problem, true_order,
                                  true_ori[true_order])
        assert res.score >= 0.95 * true_score
        assert _canonical_tour(res.order, res.ori) == \
            _canonical_tour(true_order, true_ori[true_order])


def test_tour_file_format(tmp_path):
    problem, _, _ = _sim_chromosome_problem(7)
    res = topt.optimize_tour(convert.problem_from_jax(problem), npop=8,
                             ngen=100, log_every=50, backend='device',
                             device='cpu')
    names = ['c{}'.format(i) for i in range(problem.k)]
    tour = topt.result_to_tour(res, np.arange(problem.k), names)
    p = tmp_path / 'group1.tour'
    topt.write_ga_tour(str(p), res, tour)
    lines = p.read_text().splitlines()
    assert lines[0] == '>INIT'
    ga_lines = [l for l in lines if l.startswith('>GA')]
    assert len(ga_lines) == 2 and ga_lines[0].startswith('>GA50-')
    final = lines[-1].split()
    assert sorted(x[:-1] for x in final) == sorted(names)
    assert all(x[-1] in '+-' for x in final)

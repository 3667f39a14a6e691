"""The delta generation from its draws (kernels.delta.
delta_generation_from_draws, the plain version the wrapper runs on CPU
tensors) against the JAX package's dgen: the moves of jopt._sample_moves
and the state after whole generations, on the CPU; and the move
arithmetic (moves_from_draws) bit for bit as it was, at the edges of
the geometric span.

The draws are JAX's own (the same keys and splits as _sample_moves), so
the moves can be held bit for bit. A float sum's order is the one thing
the two frameworks do not share: deltas and scores are held to the same
torch reduction of the JAX terms, and XLA's own sum within 1e-6 of the
score, as tests/test_torch_optimize.py holds the move-mode step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from haphic_tpu.order import optimize as jopt

from haphic_tpu_torch.kernels import delta as tdelta
from haphic_tpu_torch.order import optimize as topt

from .test_torch_kernels import _span_edges
from .test_torch_optimize import _jax_dgen, _jax_draws, _row_sums, _t

torch.set_num_threads(1)

_MOVE = ('do', 'op', 'i', 'j', 't')


def _group(seed, P, k, R):
    """One group's records and population, drawn as
    tests/test_torch_optimize.py's _cache_setup draws them."""
    rng = np.random.default_rng(seed)
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


def _jax_state(lengths, pa, pb, order, ori, d, w):
    jl, jpa, jpb = jnp.asarray(lengths), jnp.asarray(pa), jnp.asarray(pb)
    consts = (jl[jpa], jl[jpb], jnp.asarray(d), jnp.asarray(w))
    jc = jopt._build_caches(jnp.asarray(order), jnp.asarray(ori), jl, jpa,
                            jpb)
    c0 = jopt._contrib_from_cache(*jc[2:], *consts)
    return (jnp.asarray(order), jnp.asarray(ori)) + tuple(jc) + (
        jnp.asarray(_row_sums(c0)),), consts


@pytest.mark.parametrize('G,P,k,R', [(1, 16, 32, 300), (3, 8, 24, 200),
                                     (2, 12, 64, 400)],
                         ids=['G1-k32', 'G3-k24', 'G2-k64'])
def test_generations_from_draws_match_jax_dgen(G, P, k, R):
    """20 generations of G groups through delta_generation_from_draws on
    JAX's draws: every generation's moves equal jopt._sample_moves's,
    acceptance and delta equal, and order, ori, L_slot, startsx, the six
    caches, the contributions and the scores equal to JAX's dgen."""
    groups = [_group(1000 * G + g, P, k, R) for g in range(G)]
    jax_side = [_jax_state(*grp) for grp in groups]
    jstates = [s for s, _ in jax_side]
    lengths, pa, pb, order, ori, d, w = [np.stack(x) for x in zip(*groups)]
    rec = topt._Records(_t(lengths, torch.int64), _t(pa), _t(pb), _t(d),
                        _t(w))
    state = (_t(order), _t(ori)) + rec.caches(_t(order), _t(ori))
    keys = [jax.random.PRNGKey(7 + g) for g in range(G)]
    names = ('order', 'ori', 'L_slot', 'startsx', 'posA', 'sA', 'oA',
             'posB', 'sB', 'oB')
    n0 = tdelta.delta_generation.launches
    n_acc = 0
    for gen in range(20):
        kms = []
        for g in range(G):
            keys[g], km = jax.random.split(keys[g])
            kms.append(km)
        draws = [_t(np.stack([np.asarray(x) for x in per]))
                 for per in zip(*[_jax_draws(km, P, k) for km in kms])]
        moves = tuple(torch.empty((G, P), dtype=dt)
                      for dt in (torch.bool,) + (torch.int32,) * 4)
        delta, acc = tdelta.delta_generation_from_draws(
            state, draws, rec.la, rec.lb, rec.d, rec.w, 1.1,
            topt._DELTA_LOCAL_FRAC, topt._DELTA_MIN_GAIN,
            topt._DELTA_SPAN_GAIN, moves_out=moves)
        for g in range(G):
            what = 'gen {} group {}'.format(gen, g)
            jmoves = jopt._sample_moves(kms[g], P, k, 1.1,
                                        local_frac=jopt._DELTA_LOCAL_FRAC)
            for name, got, want in zip(_MOVE, moves, jmoves):
                assert np.array_equal(got[g].numpy(), np.asarray(want)), \
                    '{} move {}'.format(what, name)
            jstates[g], jacc, jdelta, xla_delta = _jax_dgen(
                jstates[g], jmoves, *jax_side[g][1])
            assert np.array_equal(acc[g].numpy(), jacc), what
            assert np.array_equal(delta[g].numpy(), jdelta), what
            assert np.all(np.abs(xla_delta - jdelta)
                          <= 1e-6 * np.abs(np.asarray(jstates[g][-1])))
            for name, got, want in zip(names, state[:10], jstates[g][:10]):
                assert np.array_equal(got[g].numpy(), np.asarray(want)), \
                    '{} {}'.format(what, name)
            jc = jopt._contrib_from_cache(*jstates[g][4:10],
                                          *jax_side[g][1])
            assert np.array_equal(state[10][g].numpy(), np.asarray(jc)), \
                '{} contrib'.format(what)
            assert np.array_equal(state[11][g].numpy(),
                                  np.asarray(jstates[g][10])), \
                '{} scores'.format(what)
            n_acc += int(jacc.sum())
    assert tdelta.delta_generation.launches == n0     # plain on the CPU
    assert 0 < n_acc < 20 * G * P


def _moves_before(u_do, op, e1, e2, e3, u_local, u_span, k, mutprob,
                  local_frac):
    """The move arithmetic as it was before the divisor was cached: the
    same f32 operations, with log(0.75) made as a new tensor each
    call."""
    do = u_do < mutprob
    i = torch.minimum(e1, e2)
    j = torch.maximum(e1, e2)
    local = u_local < local_frac
    log_075 = torch.tensor(float(np.log(np.float32(0.75)).astype(
        np.float32)), dtype=torch.float32, device=u_span.device)
    span = 1 + torch.floor(torch.log(1.0 - u_span) / log_075).to(
        torch.int32)
    j_local = torch.clamp(e1 + span, max=k - 1)
    i = torch.where(local, e1, i)
    j = torch.where(local, torch.maximum(j_local, e1), j)
    e3 = torch.where(local, j, e3)
    t = torch.maximum(j, e3)
    return do, op, i, j, t


@pytest.mark.parametrize('mutprob,local_frac', [(1.1, 0.5), (0.5, 1.0)])
def test_moves_from_draws_bits_unchanged(mutprob, local_frac):
    """moves_from_draws, with its divisor made once, gives the bits the
    per-call divisor gave: on seeded draws and on planted u_span edges
    (exactly 0, within 1e-7 of 1, the steps of the geometric span),
    with e1 at k - 1 on some rows."""
    rng = np.random.default_rng(19)
    k = 64
    edges = _span_edges()
    P = 4096 + edges.size
    u_span = rng.random(P).astype(np.float32)
    u_span[:edges.size] = edges
    e1 = rng.integers(0, k, P).astype(np.int32)
    e1[::7] = k - 1
    draws = [rng.random(P).astype(np.float32),
             rng.integers(0, 4, P).astype(np.int32), e1,
             rng.integers(0, k, P).astype(np.int32),
             rng.integers(0, k, P).astype(np.int32),
             rng.random(P).astype(np.float32), u_span]
    draws = [_t(x[None]) for x in draws]
    got = topt._moves_from_draws(*draws, k, mutprob, local_frac)
    want = _moves_before(*draws, k, mutprob, local_frac)
    for name, a, b in zip(_MOVE, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # the largest spans: u_span within 1e-7 of 1 gives 58
    span = 1 + torch.floor(torch.log(1.0 - draws[6])
                           / tdelta._log_075_on(draws[6].device)).to(
        torch.int32)
    assert int(span.max()) == 58 and int(span.min()) == 1
    assert int(span[0, 0]) == 1                       # u_span = 0


def test_log_075_divisor_is_made_once_per_device(monkeypatch):
    """The divisor's tensor is made at the first call on a device and
    reused: one torch.tensor call over many moves and mutations."""
    calls = []
    real = torch.tensor

    def counting(*args, **kw):
        calls.append(kw.get('device'))
        return real(*args, **kw)
    tdelta._log_075_on.cache_clear()
    monkeypatch.setattr(torch, 'tensor', counting)
    gen = torch.Generator()
    gen.manual_seed(2)
    draws = topt._Draws(gen, 2)
    order = torch.stack([torch.randperm(20, generator=gen)
                         for _ in range(10)]).to(torch.int32).view(2, 5, 20)
    ori = torch.zeros_like(order)
    for _ in range(6):
        topt._sample_moves(draws, (2, 5), 20, 1.1, device='cpu')
        order, ori = topt._mutate(draws, order, ori, 0.7)
    assert len(calls) == 1
    assert tdelta._log_075_on(torch.device('cpu')).item() == tdelta.LOG_075


def _small_ga(G=2, P=6, k=24, R=200):
    groups = [_group(50 + g, P, k, R) for g in range(G)]
    lengths, pa, pb, order, ori, d, w = [np.stack(x) for x in zip(*groups)]
    rec = topt._Records(_t(lengths, torch.int64), _t(pa), _t(pb), _t(d),
                        _t(w))
    return rec, (_t(order), _t(ori)) + rec.caches(_t(order), _t(ori))


def test_dgen_from_draws_equals_the_move_steps_on_cpu():
    """_dgen's own path (the draws wrapper) and _dgen with a given step
    (moves by _moves_from_draws, then the move-mode wrapper or the plain
    version) leave the same state after 10 generations from the same
    generator; each generation counts once and launches nothing."""
    rec, state0 = _small_ga()
    out = []
    n0 = tdelta.delta_generation.launches
    for step in (None, tdelta.delta_generation,
                 tdelta.delta_generation_plain):
        gen = torch.Generator()
        gen.manual_seed(5)
        state = tuple(x.clone() for x in state0)
        g0 = topt._delta_step.generations
        for _ in range(10):
            state = topt._dgen(topt._Draws(gen, 2), rec, state, step)
        assert topt._delta_step.generations == g0 + 10
        out.append(state)
    assert tdelta.delta_generation.launches == n0
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)


def test_draws_wrapper_rejects_bad_input():
    """The draws wrapper checks its draws and moves_out as the move-mode
    wrapper checks its move: count, dtype, shape, device and
    contiguity."""
    rec, state = _small_ga()
    gen = torch.Generator()
    gen.manual_seed(1)
    draws = list(topt._move_draws(topt._Draws(gen, 2), (2, 6), 24, 'cpu'))

    def call(ds, moves_out=None):
        tdelta.delta_generation_from_draws(
            tuple(x.clone() for x in state), ds, rec.la, rec.lb, rec.d,
            rec.w, 1.1, 0.5, 0.0, 2e-6, moves_out=moves_out)
    call(draws)
    bad_draws = [draws[:6],
                 draws[:1] + [draws[1].to(torch.int64)] + draws[2:],
                 [draws[0].double()] + draws[1:],
                 draws[:6] + [draws[6][:, :5].contiguous()],
                 draws[:2] + [torch.zeros((2, 12), dtype=torch.int32)[
                     :, ::2]] + draws[3:],
                 draws[:5] + [torch.rand((2, 6), device='meta')]
                 + draws[6:]]
    for bad in bad_draws:
        with pytest.raises(ValueError):
            call(bad)
    moves = [torch.empty((2, 6), dtype=torch.bool)] + [
        torch.empty((2, 6), dtype=torch.int32) for _ in range(4)]
    for bad in (moves[:4], [moves[0].to(torch.int32)] + moves[1:],
                moves[:4] + [torch.empty((2, 5), dtype=torch.int32)]):
        with pytest.raises(ValueError):
            call(draws, bad)

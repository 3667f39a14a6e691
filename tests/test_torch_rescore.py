"""Parity of the GA cycle's rescoring (haphic_tpu_torch.kernels.rescore,
the plain version the wrapper runs on CPU tensors) with the JAX
package's ``_build_caches`` + ``_contrib_from_cache`` + row sum
(``scores_of`` in haphic_tpu/order/optimize.py), on the CPU; and the
GA's cycles through it against the JAX package's cycle.

Caches and contributions are held bit for bit. The order of a float sum
is the one thing the two frameworks do not share, so a score is held to
the same torch reduction of the JAX contributions (``_row_sums``) and
to XLA's own sum within 1e-6 relative."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from haphic_tpu.order import optimize as jopt

from haphic_tpu_torch import convert
from haphic_tpu_torch.kernels import rescore as krs
from haphic_tpu_torch.order import optimize as topt

from .kit import kernelkit as kit
from .test_optimize import _sim_chromosome_problem
from .test_torch_optimize import (_cache_setup, _eq, _jax_dgen, _jax_draws,
                                  _row_sums, _t)

torch.set_num_threads(1)


def _case(seed, G, P, k, R, pad):
    """G groups of a random population and records; the last ``pad``
    records of each group are padding (pa = pb = 0, d = 0, w = 0) and
    some distances are negative (the clamp at 1)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 500000, (G, k)).astype(np.int64)
    pa = rng.integers(0, k, (G, R)).astype(np.int32)
    pb = rng.integers(0, k, (G, R)).astype(np.int32)
    d = rng.integers(-5000, 100000, (G, 4, R)).astype(np.float32)
    w = rng.random((G, R)).astype(np.float32)
    if pad:
        for x in (pa, pb, d, w):
            x[..., R - pad:] = 0
    order = np.stack([np.stack([rng.permutation(k) for _ in range(P)])
                      for _ in range(G)]).astype(np.int32)
    ori = rng.integers(0, 2, (G, P, k)).astype(np.int32)
    la = np.take_along_axis(lengths, pa, axis=1).astype(np.int32)
    lb = np.take_along_axis(lengths, pb, axis=1).astype(np.int32)
    return order, ori, lengths, pa, pb, la, lb, d, w


@pytest.mark.parametrize('G,P,k,R,pad', [
    (1, 6, 2, 200, 0), (3, 5, 33, 700, 40), (1, 4, 300, 1500, 0),
    (3, 7, 300, 900, 100)], ids=['k2-G1', 'k33-G3-pad', 'k300-G1',
                                 'k300-G3-pad'])
@pytest.mark.parametrize('caches', [True, False], ids=['caches', 'scores'])
def test_rescore_matches_jax(G, P, k, R, pad, caches):
    case = _case(G * 100 + k, G, P, k, R, pad)
    got = krs.rescore(*[torch.as_tensor(x) for x in case], caches=caches)
    scores = got[-1] if caches else got
    assert scores.shape == (G, P) and scores.dtype == torch.float32
    order, ori, lengths, pa, pb, la, lb, d, w = case
    for g in range(G):
        jc = jopt._build_caches(jnp.asarray(order[g]), jnp.asarray(ori[g]),
                                jnp.asarray(lengths[g]), jnp.asarray(pa[g]),
                                jnp.asarray(pb[g]))
        jcontrib = jopt._contrib_from_cache(
            *jc[2:], jnp.asarray(la[g]), jnp.asarray(lb[g]),
            jnp.asarray(d[g]), jnp.asarray(w[g]))
        if caches:
            for n, (a, b) in enumerate(zip(got[:-1], tuple(jc) + (jcontrib,))):
                _eq(a[g:g + 1], b, 'group {} field {}'.format(g, n))
        assert np.array_equal(scores[g].numpy(), _row_sums(jcontrib))
        np.testing.assert_allclose(scores[g].numpy(),
                                   np.asarray(jcontrib.sum(axis=1)),
                                   rtol=1e-6)


def test_rescore_scores_mode_equals_caches_mode_and_launches_nothing():
    case = [torch.as_tensor(x) for x in _case(3, 2, 6, 40, 500, 10)]
    n0 = krs.rescore.launches
    full = krs.rescore(*case, caches=True)
    assert len(full) == 10
    assert torch.equal(krs.rescore(*case, caches=False), full[-1])
    assert torch.equal(krs.rescore_plain(*case, caches=False), full[-1])
    assert krs.rescore.launches == n0


def test_rescore_rejects_bad_input():
    case = [torch.as_tensor(x) for x in _case(4, 1, 4, 16, 100, 0)]
    for i, bad in ((0, case[0].long()), (5, case[5][:, :50]),
                   (7, case[7].double()),
                   (8, torch.rand((1, 200))[:, ::2]),
                   (2, case[2].to(torch.int32))):
        args = list(case)
        args[i] = bad
        with pytest.raises(ValueError):
            krs.rescore(*args, caches=True)


def test_records_route_through_rescore(monkeypatch):
    """_Records.caches and _Records.cache_scores call rescore, in caches
    and in scores mode, and count each call."""
    calls = []

    def recording(*args, caches):
        calls.append(caches)
        return krs.rescore(*args, caches=caches)
    monkeypatch.setattr(topt, 'rescore', recording)
    order, ori, lengths, pa, pb, la, lb, d, w = [
        torch.as_tensor(x) for x in _case(5, 2, 4, 12, 80, 0)]
    rec = topt._Records(lengths, pa, pb, d, w)
    assert torch.equal(rec.la, la) and torch.equal(rec.lb, lb)
    n0 = topt._Records.rescores
    full = rec.caches(order, ori)
    scores = rec.cache_scores(order, ori)
    assert calls == [True, False]
    assert topt._Records.rescores == n0 + 2
    want = krs.rescore_plain(order, ori, lengths, pa, pb, la, lb, d, w,
                             caches=True)
    for a, b in zip(full, want):
        assert torch.equal(a, b)
    assert torch.equal(scores, want[-1])


def test_ga_logs_its_rescorings(caplog, monkeypatch):
    """optimize_tours logs, per batch, the rescoring calls it made
    (`ga_rescores`): three a cycle, as counted at the wrapper."""
    calls = []

    def counted(*args, caches):
        calls.append(caches)
        return krs.rescore(*args, caches=caches)
    monkeypatch.setattr(topt, 'rescore', counted)
    caplog.set_level(logging.INFO, logger='haphic_tpu_torch')
    problems = [convert.problem_from_jax(_sim_chromosome_problem(s, k=k)[0])
                for s, k in ((3, 8), (4, 5))]
    topt.optimize_tours(problems, npop=8, ngen=60, seed=1, log_every=30,
                        backend='device', device='cpu')
    metrics = [getattr(r, 'metrics', {}) for r in caplog.records]
    logged = [m['ga_rescores'] for m in metrics if 'ga_rescores' in m]
    assert len(logged) == sum('ga_batch' in m for m in metrics) > 0
    # two windows of 30 generations: one cycle of 30 generations each
    assert logged == [3 * 2] * len(logged)
    assert sum(logged) == len(calls)
    assert calls.count(True) * 2 == calls.count(False)


class _Replay:
    """The port's draw interface (optimize._Draws) handing out, in
    order, draws made by JAX; each must be asked for with its shape."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, shape, kind):
        x = self.draws.pop(0)
        assert x.dtype.kind == kind and (1,) + x.shape == tuple(shape)
        return _t(x[None])

    def rand(self, shape, device):
        return self._next(shape, 'f')

    def randint(self, hi, shape, device):
        return self._next(shape, 'i')


def _jax_scores(order, ori, consts):
    jl, jpa, jpb, jla, jlb, jd, jw = consts
    jc = jopt._build_caches(order, ori, jl, jpa, jpb)
    c = jopt._contrib_from_cache(*jc[2:], jla, jlb, jd, jw)
    return tuple(jc), jnp.asarray(_row_sums(c))


def test_evolve_delta_cycles_match_jax(monkeypatch):
    """40 whole cycles of _evolve_delta_impl (rescoring of parents and
    offspring, OX crossover, mutation, stable top-P selection, half
    re-seed, the selected population's caches, then 3 delta generations
    each) on the CPU against the JAX package's cycle (its `cycle` body,
    haphic_tpu/order/optimize.py:921-949, assembled from its own
    functions with torch's row sums) on the same draws: the same tours,
    orientations and scores."""
    P, k, per, n_cycles, mutprob, xoprob = 16, 32, 4, 40, 0.2, 0.3
    monkeypatch.setattr(topt, 'GA_SYNC_EVERY', per)
    lengths, pa, pb, order, ori, d, w = _cache_setup(P, k)
    jl, jpa, jpb = jnp.asarray(lengths), jnp.asarray(pa), jnp.asarray(pb)
    consts = (jl, jpa, jpb, jl[jpa], jl[jpb], jnp.asarray(d), jnp.asarray(w))
    key = jax.random.PRNGKey(3)
    jorder, jori = jnp.asarray(order), jnp.asarray(ori)
    draws = []
    for _ in range(n_cycles):
        key, k1, k2 = jax.random.split(key, 3)
        _, scores = _jax_scores(jorder, jori, consts)
        keys = jax.random.split(k1, 4)
        draws += [np.asarray(x) for x in (
            jax.random.uniform(keys[0], (P,)),
            jax.random.randint(keys[1], (P,), 0, P),
            jax.random.randint(keys[2], (P,), 0, k),
            jax.random.randint(keys[3], (P,), 0, k))]
        draws += [np.asarray(x) for x in _jax_draws(k2, P, k)]
        off_order, off_ori = jopt._ox_crossover(k1, jorder, jori, xoprob)
        off_order, off_ori = jopt._mutate(k2, off_order, off_ori, mutprob)
        _, off_scores = _jax_scores(off_order, off_ori, consts)
        _, top = lax.top_k(jnp.concatenate([scores, off_scores]), P)
        g = jopt._take_rows(jnp.stack([
            jnp.concatenate([jorder, off_order]),
            jnp.concatenate([jori, off_ori])], axis=1), top)
        h = P // 2
        jorder = jnp.concatenate([g[:h, 0], jnp.broadcast_to(g[0, 0],
                                                             (P - h, k))])
        jori = jnp.concatenate([g[:h, 1], jnp.broadcast_to(g[0, 1],
                                                           (P - h, k))])
        jc, scores = _jax_scores(jorder, jori, consts)
        state = (jorder, jori) + jc + (scores,)
        for _ in range(per - 1):
            key, km = jax.random.split(key)
            draws += [np.asarray(x) for x in _jax_draws(km, P, k)]
            moves = jopt._sample_moves(km, P, k, 1.1,
                                       local_frac=jopt._DELTA_LOCAL_FRAC)
            state = _jax_dgen(state, moves, *consts[3:])[0]
        jorder, jori = state[0], state[1]
    top_scores, top = lax.top_k(state[-1], P)
    g = jopt._take_rows(jnp.stack([jorder, jori], axis=1), top)

    rec = topt._Records(_t(lengths[None], torch.int64), _t(pa[None]),
                        _t(pb[None]), _t(d[None]), _t(w[None]))
    replay = _Replay(draws)
    t_order, t_ori, t_scores = topt._evolve_delta_impl(
        replay, rec, _t(order[None]), _t(ori[None]), mutprob,
        per * n_cycles, xoprob)
    assert not replay.draws
    _eq(t_order, g[:, 0], 'order')
    _eq(t_ori, g[:, 1], 'ori')
    _eq(t_scores, top_scores, 'scores')
    # the tours moved: the window is not the identity
    assert not np.array_equal(t_order[0].numpy(), order)


@pytest.mark.parametrize('caches', [True, False])
def test_rescore_bound(caches):
    """The bound at the dense pipeline's largest batch: the bytes
    written bound caches mode, the operations scores mode."""
    ms, by = kit.rescore_bound_ms(7, 100, 1024, 196608, caches)
    pairs = 7 * 100 * 196608
    if caches:
        assert by == 'bytes'
        assert ms == pytest.approx(28 * pairs / kit.HBM_BPS * 1e3, rel=0.05)
    else:
        assert by == 'operations'
        assert ms == pytest.approx(kit.RESCORE_OPS_PER_PAIR * pairs
                                   / kit.FP32_FLOPS * 1e3)

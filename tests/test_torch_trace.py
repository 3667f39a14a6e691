"""The port's spans (haphic_tpu_torch.trace) and the dense MCL engine's
spans and host-sync counter (cluster/mcl.py): off, the sweep records
nothing and computes the same; on, the spans nest as the module
docstring says; the counter rises by its formula; the spans show in a
profiler's trace. The last test needs a card.

Imports nothing of JAX, so that the card test runs beside the others."""

import logging
import warnings

import numpy as np
import pytest
import torch

from haphic_tpu_torch import trace
from haphic_tpu_torch.cluster import mcl

torch.set_num_threads(1)

HOST_SPANS = ('mcl.sweep', 'mcl.batch', 'mcl.pattern', 'mcl.interpret')


def _links(n_blocks=4, block=12, seed=5):
    """Upper-triangle COO links of ``n_blocks`` dense blocks with a few
    weak links between them."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block
    w = rng.integers(1, 4, (n, n)).astype(np.float64)
    same = np.arange(n)[:, None] // block == np.arange(n)[None, :] // block
    w = np.where(same, w * 20, w * (rng.random((n, n)) < 0.05))
    ci, cj = np.nonzero(np.triu(w, 1))
    return ci, cj, w[ci, cj], n


def _adjacency(coo):
    ci, cj, cw, n = coo
    return mcl._coo_to_dense_np(ci, cj, cw, n)


@pytest.fixture
def tracing(monkeypatch):
    """The torch route at toy sizes, batches of two inflations, tracing
    off and empty before and after."""
    monkeypatch.setattr(mcl, 'DEVICE_MIN_N', 0)
    monkeypatch.setattr(mcl, '_batch_size', lambda B, n: 2)
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _sweep(route, inflations=(1.4, 2.0, 2.6, 3.2, 1.8), max_iter=60,
           device='cpu'):
    coo = _links()
    if route == 'coo':
        return mcl.run_mcl_partitions(None, list(inflations),
                                      max_iter=max_iter, coo=coo,
                                      device=device)
    return mcl.run_mcl_partitions(_adjacency(coo), list(inflations),
                                  max_iter=max_iter, device=device)


def _logged(caplog):
    got = [r.metrics for r in caplog.records
           if getattr(r, 'metrics', {}).get('mcl_engine') == 'dense']
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize('route', ['coo', 'adjacency'])
def test_off_records_nothing_and_on_computes_the_same(tracing, route):
    off = _sweep(route)
    assert trace.records() == [] and not trace.enabled()
    trace.enable()
    on = _sweep(route)
    assert {r.name for r in trace.records()} == set(HOST_SPANS)
    assert on[0] == off[0]
    assert np.array_equal(on[1], off[1]) and np.array_equal(on[2], off[2])


def test_spans_nest_one_batch_a_logged_batch(tracing, caplog):
    trace.enable()
    with caplog.at_level(logging.INFO, logger=mcl.__name__):
        parts, iters, _ = _sweep('coo')
    batches = _logged(caplog)['batches']
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    sweep = [r for r in recs if r.name == 'mcl.sweep']
    assert len(sweep) == 1
    sweep = sweep[0]
    assert sweep.parent is None and sweep.root == sweep.id
    assert sweep.attrs == {'n': 48, 'B': 5}
    batch = [r for r in recs if r.name == 'mcl.batch']
    assert [b.attrs['B'] for b in batch] == batches == [2, 2, 1]
    for b in batch:
        assert b.parent == sweep.id and b.root == sweep.id
        assert sweep.start <= b.start <= b.end <= sweep.end
    for name in ('mcl.pattern', 'mcl.interpret'):
        got = [r for r in recs if r.name == name]
        assert [by_id[r.parent] for r in got] == batch, name
        assert all(r.root == sweep.id for r in got)
    assert all(r.events is None for r in recs)
    assert trace.host_seconds('mcl.sweep') == pytest.approx(
        (sweep.end - sweep.start) / 1e9)
    assert 0 < trace.host_seconds('mcl.interpret') \
        < trace.host_seconds('mcl.sweep')


def _expected_syncs(iters, batches, route):
    """Five waits an iteration from the third (up to the batch's last):
    three boolean-mask indexings and the copies of the two scalars
    written through them; three copies to the host a batch; the
    inflations' copy to the card; the links' three copies (the
    adjacency's one)."""
    out, s = 0, 0
    for size in batches:
        out += 5 * max(0, int(max(iters[s:s + size])) - 2) + 3
        s += size
    return out + 1 + (3 if route == 'coo' else 1)


@pytest.mark.parametrize('route,inflations,max_iter', [
    ('coo', (1.4, 2.0, 2.6, 3.2, 1.8), 60),
    ('adjacency', (1.4, 2.0, 2.6, 3.2, 1.8), 60),
    ('coo', (1.1, 1.2, 1.3), 5),          # batches cut by max_iter
    ('coo', (2.0,), 2),                   # no statistic at all
    ('coo', (2.0, 2.2), 1),
])
@pytest.mark.parametrize('on', [False, True], ids=['off', 'on'])
def test_syncs_rise_by_the_formula(tracing, caplog, route, inflations,
                                   max_iter, on):
    trace.enable(on)
    before = mcl.run_mcl_partitions.syncs
    with caplog.at_level(logging.INFO, logger=mcl.__name__):
        _, iters, _ = _sweep(route, inflations, max_iter)
    got = mcl.run_mcl_partitions.syncs - before
    assert got == _expected_syncs(iters, _logged(caplog)['batches'], route)


@pytest.mark.parametrize('on', [False, True], ids=['off', 'on'])
def test_spans_show_in_a_profiler_trace(tracing, on):
    from torch.profiler import ProfilerActivity, profile
    trace.enable(on)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep('coo')
    names = [e.name for e in prof.events()]
    if not on:
        assert not [n for n in names if n.startswith('mcl.')]
        return
    for name in HOST_SPANS:
        assert name in names, name
    assert names.count('mcl.batch') == 3


@pytest.mark.parametrize('on', [False, True], ids=['off', 'on'])
def test_span_api(tracing, on):
    trace.enable(on)
    outer = trace.span('a', n=1)
    with outer:
        with trace.span('b'):
            with trace.device_span('c', 'cpu'):
                pass
        with trace.span('b', device='cpu'):
            pass
    recs = trace.records()
    if not on:
        assert outer is trace.span('b') is trace.device_span('c', 'cpu')
        assert recs == [] and trace.host_seconds('a') == 0.0
        return
    assert [r.name for r in recs] == ['b', 'b', 'a']
    a = recs[-1]
    assert a.attrs == {'n': 1} and a.parent is None
    assert all(r.parent == a.id and r.root == a.id for r in recs[:2])
    assert trace.device_seconds('b') == 0.0
    assert trace.device_intervals('b') == []
    assert trace.host_seconds('b') <= trace.host_seconds('a')
    trace.reset()
    assert trace.records() == []


def test_a_generator_closed_late_leaves_no_span_open(tracing):
    """A span held open across a yield may close after a span opened
    later; later spans then nest under what is still open."""
    trace.enable()

    def gen():
        with trace.span('g'):
            yield

    it = gen()
    next(it)
    inner = trace.span('late')
    inner.__enter__()
    it.close()
    inner.__exit__(None, None, None)
    with trace.span('after'):
        pass
    after = [r for r in trace.records() if r.name == 'after'][0]
    assert after.parent is None and after.root == after.id


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _gap(outer, inner):
    """Σ over ``outer`` of its length less the union of ``inner``."""
    total = 0.0
    for lo, hi in outer:
        cut = sorted((max(s, lo), min(e, hi)) for s, e in inner
                     if e > lo and s < hi)
        cur = lo
        for s, e in cut:
            if e > cur:
                total -= e - max(s, cur)
                cur = e
        total += hi - lo
    return total


@pytest.mark.cuda
def test_device_spans_on_the_card(tracing, card, monkeypatch):
    """On the card (n = 1,200, batches of two): partitions, n_iters and
    converged bit-equal with tracing off and on; the device spans'
    sums positive; the idle between the busy spans of the sweep within
    the sweep's device span; the counter as on the CPU, and equal to
    the syncs torch's sync debug mode flags."""
    monkeypatch.setattr(mcl, '_batch_size', lambda B, n: 2)
    coo = _links(n_blocks=6, block=200, seed=11)
    infl = [1.4, 2.0, 2.6]

    def run():
        return mcl.run_mcl_partitions(None, infl, coo=coo, device=card)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        off = run()
        torch.cuda.synchronize()
    # off: no record, no profiler range, no CUDA event
    assert trace.records() == []
    assert not [e.name for e in prof.events()
                if e.name.startswith(('mcl.', 'cudaEventRecord'))]
    trace.enable()
    before = mcl.run_mcl_partitions.syncs
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            on = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = mcl.run_mcl_partitions.syncs - before
    assert on[0] == off[0]
    assert np.array_equal(on[1], off[1]) and np.array_equal(on[2], off[2])
    assert syncs == _expected_syncs(on[1], [2, 1], 'coo')
    # every wait torch's sync debug mode sees is counted, and no more
    assert syncs == sum('synchronizing CUDA operation' in str(w.message)
                        for w in flagged)
    for name in ('mcl.sweep', 'mcl.densify', 'mcl.pre_expand', 'mcl.batch',
                 'mcl.expand', 'mcl.column', 'mcl.pattern'):
        assert trace.device_seconds(name) > 0, name
    sweep = trace.device_intervals('mcl.sweep')
    assert len(sweep) == 1
    busy = [iv for name in ('mcl.densify', 'mcl.pre_expand', 'mcl.batch',
                            'mcl.pattern')
            for iv in trace.device_intervals(name)]
    gap = _gap(sweep, busy)
    assert 0 <= gap <= sweep[0][1] - sweep[0][0]
    assert trace.device_seconds('mcl.expand') + \
        trace.device_seconds('mcl.column') <= \
        trace.device_seconds('mcl.sweep')
    assert len(trace.device_intervals('mcl.batch')) == 2

"""The readers of the program's own spans and counter (``mcl.expand_s``,
``mcl.column_s``, ``mcl.pattern_s``, ``mcl.host_gap_s``, ``mcl.syncs``,
``mcl.interpret_s``): None on the CPU (the device's) and on a program
without them; the defined figure from hand-made records; the idle's
union over overlapping and nested spans; every metric of a traced run
of each cell on the card."""

import json
import time
import types

import pytest
import torch

from hicbench import harness
from test_hicbench_run import bench, cpu_route, tiny  # noqa: F401

NEW = ('mcl.expand_s', 'mcl.column_s', 'mcl.pattern_s', 'mcl.host_gap_s',
       'mcl.syncs')


@pytest.fixture
def clean_trace():
    from haphic_tpu_torch import trace
    trace.enable(False)
    trace.reset()
    yield trace
    trace.enable(False)
    trace.reset()


def _stage(device):
    return types.SimpleNamespace(device=torch.device(device))


def _probe(units):
    return types.SimpleNamespace(units=units)


def test_no_new_metric_on_a_cpu_rehearsal(cpu_route, clean_trace):
    rc, res = harness.run(bench(), 'xtropicalis.cluster', 2 ** 31 + 5,
                          0.01, True, time.monotonic(), device='cpu',
                          overrides=tiny('xtropicalis.cluster'))
    assert rc == 0 and res['correct']
    assert not set(NEW) & set(res['metrics'])
    # the host spans were taken all the same
    assert clean_trace.host_seconds('mcl.pattern') > 0
    # the partitions' host span is read on both routes
    assert res['metrics']['mcl.interpret_s']['value'] == pytest.approx(
        clean_trace.host_seconds('mcl.interpret') / res['attempted'])


@pytest.mark.parametrize('name', NEW)
def test_none_on_the_cpu(clean_trace, name):
    r = harness.metric_reader(name)
    if hasattr(r, 'install'):
        r.install(_probe(0))
    assert r.read(_probe(1), _stage('cpu'), [], None) is None


@pytest.mark.parametrize('name', NEW + ('mcl.interpret_s',))
def test_none_on_a_program_without_spans(monkeypatch, clean_trace, name):
    """A program without the spans: no ``trace`` module, no counter."""
    import sys
    import haphic_tpu_torch
    from haphic_tpu_torch.cluster import mcl
    monkeypatch.setitem(sys.modules, 'haphic_tpu_torch.trace', None)
    monkeypatch.delattr(haphic_tpu_torch, 'trace')
    monkeypatch.delattr(mcl.run_mcl_partitions, 'syncs')
    r = harness.metric_reader(name)
    if hasattr(r, 'install'):
        r.install(_probe(0))
    assert r.read(_probe(2), _stage('cuda'), [], None) is None


def _fake_trace(intervals, host=None):
    """A stand-in for the program's trace module on the CPU: device
    spans as given intervals (seconds on one clock), host seconds as
    given."""
    host = host or {}
    recs = [types.SimpleNamespace(name=n) for n in [*intervals, *host]]
    return types.SimpleNamespace(
        records=lambda: recs,
        device_intervals=lambda n: list(intervals.get(n, [])),
        device_seconds=lambda n: sum(e - s
                                     for s, e in intervals.get(n, [])),
        host_seconds=lambda n: host.get(n, 0.0))


@pytest.mark.parametrize('name,intervals,host,want', [
    ('mcl.expand_s', {'mcl.expand': [(0, 1.5), (2, 3)],
                      'mcl.column': [(1.5, 2)]}, None, 1.25),
    ('mcl.column_s', {'mcl.column': [(1.5, 2), (3, 3.25)]}, None, 0.375),
    ('mcl.pattern_s', {}, {'mcl.pattern': 0.5}, 0.25),
    ('mcl.interpret_s', {}, {'mcl.interpret': 0.1}, 0.05),
    # two sweeps; the first: densify, pre_expand, then a batch whose
    # span nests a pattern and overlaps the next: idle 1 + 0.5; the
    # second: 0.5
    ('mcl.host_gap_s', {'mcl.sweep': [(0, 10), (20, 25)],
                        'mcl.densify': [(0, 1)],
                        'mcl.pre_expand': [(1, 2)],
                        'mcl.batch': [(3, 7), (6.5, 9), (21, 24.5)],
                        'mcl.pattern': [(4, 5), (9, 9.5), (19, 21.5)],
                        'mcl.expand': [(9.5, 10)]}, None,
     (1 + 0.5 + 0.5) / 2),
])
def test_figure_from_hand_made_spans(monkeypatch, name, intervals, host,
                                     want):
    r = harness.metric_reader(name)
    fake = _fake_trace(intervals, host)
    monkeypatch.setattr(r, '_trace', lambda: fake)
    assert r.read(_probe(2), _stage('cuda'), [], None) == \
        pytest.approx(want)


@pytest.mark.parametrize('outer,inner,want', [
    ([(0, 10)], [], 10),
    ([(0, 10)], [(2, 4), (3, 5)], 7),                 # overlapping
    ([(0, 10)], [(1, 9), (2, 3), (4, 8)], 2),         # nested
    ([(0, 10)], [(-5, 1), (9, 15)], 8),               # past both ends
    ([(0, 10), (10, 12)], [(9, 11)], 10),             # across two sweeps
    ([(0, 4)], [(1, 2), (1, 2), (3, 3)], 3),          # repeated, empty
])
def test_idle_union(outer, inner, want):
    r = harness.metric_reader('mcl.host_gap_s')
    assert r.gap_seconds(outer, inner) == pytest.approx(want)


def test_syncs_from_the_counter(monkeypatch):
    from haphic_tpu_torch.cluster import mcl
    r = harness.metric_reader('mcl.syncs')
    monkeypatch.setattr(mcl.run_mcl_partitions, 'syncs', 40)
    r.install(_probe(0))
    mcl.run_mcl_partitions.syncs += 1234
    assert r.read(_probe(2), _stage('cuda'), [], None) == 617
    assert r.read(_probe(2), _stage('cpu'), [], None) is None



class _Event:
    """A raw profiler event: times in ns."""

    def __init__(self, name, start, end, cuda=False):
        self._v = (name, start, end - start,
                   types.SimpleNamespace(name='CUDA' if cuda else 'CPU'))

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_the_trace_from_raw_events():
    """A unit of 10 s: device work on [1, 3] and [2, 4] s (one kernel
    twice) and [6, 7] s, a benchmark span on the device's timeline (left
    out); idle [0, 1], [4, 6] and [7, 10] s, named by the innermost host
    event at each gap's middle."""
    from hicbench import probe
    s = int(1e9)
    got = probe._read_trace([
        _Event('hicbench.unit', 0, 10 * s),
        _Event('hicbench.unit', 0, 10 * s, cuda=True),
        _Event('k', 1 * s, 3 * s, cuda=True),
        _Event('k', 2 * s, 4 * s, cuda=True),
        _Event('m', 6 * s, 7 * s, cuda=True),
        _Event('outer', 3 * s, 9 * s),
        _Event('inner', 4 * s, 6 * s)])
    assert got['busy_s'] == 4 and got['window_s'] == 10
    assert got['device_ops'] == [['k', 4.0], ['m', 1.0]]
    assert got['idle_gaps'] == [['outer', 3.0], ['inner', 2.0],
                                ['python', 1.0]]

# ---- on the card ----

@pytest.mark.cuda
def test_traced_run_on_the_card_reports_every_metric(cpu_route,
                                                      clean_trace):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    rc, res = harness.run(bench(), 'xtropicalis.cluster', 2 ** 31 + 5,
                          0.01, True, time.monotonic(), device='cuda',
                          overrides=tiny('xtropicalis.cluster'))
    assert rc == 0 and res['correct']
    names = {m['name'] for m in bench()['per_layer']
             if harness.applies(m, 'xtropicalis.cluster')}
    assert set(res['metrics']) == names
    got = {k: v['value'] for k, v in res['metrics'].items()}
    for name in NEW:
        assert got[name] > 0, name
    # the program's spans add nothing to the device's timeline
    assert not [n for n, _ in res['breakdown']['device_ops']
                if n.startswith('mcl.')]
    sweep = clean_trace.device_seconds('mcl.sweep') / res['attempted']
    assert got['mcl.host_gap_s'] <= sweep
    assert got['mcl.expand_s'] + got['mcl.column_s'] <= sweep


@pytest.mark.cuda
def test_traced_sort_on_the_card_reports_every_metric(cpu_route):
    """The tiny sort cell's GA on the card: the problem and evolution
    spans, the idle share and the rescoring's roofline, each under
    100%."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    rc, res = harness.run(bench(), 'alfalfa_4x.sort', 2 ** 31 + 5, 0.01,
                          True, time.monotonic(), device='cuda',
                          overrides=tiny('alfalfa_4x.sort'))
    assert rc == 0 and res['correct']
    names = {m['name'] for m in bench()['per_layer']
             if harness.applies(m, 'alfalfa_4x.sort')}
    assert set(res['metrics']) == names
    got = {k: v['value'] for k, v in res['metrics'].items()}
    assert got['ga.problem_s'] > 0 and got['ga.evolve_s'] > 0
    assert 0 < got['rescore_roofline'] <= 100
    assert 0 <= got['idle.sort'] < 100


def _read_tree(events) -> dict:
    """busy_s and window_s as the benchmark read them before it read the
    raw events: from the profiler's parsed tree (``prof.events()``),
    times in microseconds."""
    unit = [e for e in events if e.name == 'hicbench.unit'][0]
    lo, hi = unit.time_range.start, unit.time_range.end
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if getattr(e.device_type, 'name', '') == 'CUDA'
                 and not e.name.startswith('hicbench.'))
    busy, cur = 0.0, lo
    for s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    return {'busy_s': busy / 1e6, 'window_s': (hi - lo) / 1e6}


@pytest.mark.cuda
def test_raw_events_read_a_frog_sweep_as_the_parsed_tree_did():
    """One sweep of the frog's cell at its full size, traced once and
    read both ways: the raw events give the parsed tree's busy and
    window times (the tree rounds each event to a microsecond)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from torch.profiler import ProfilerActivity, profile, record_function

    from hicbench import genome as gen
    from hicbench import probe, stages
    cfg = harness.load('configs', 'xtropicalis')
    mix = harness.load('traffic', 'cluster_dense')
    seed = 2 ** 31 + 29
    stage = stages.load('cluster_dense').Stage(
        cfg, mix, gen.make(cfg, seed), torch.device('cuda'), seed)
    stage.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('hicbench.unit'):
            stage.unit(0)
            torch.cuda.synchronize()
    raw = probe._read_trace(prof.profiler.kineto_results.events())
    tree = _read_tree(prof.events())
    print(json.dumps({'raw': {k: raw[k] for k in ('busy_s', 'window_s')},
                      'tree': tree}))
    assert abs(raw['window_s'] - tree['window_s']) < 1e-5
    assert abs(raw['busy_s'] - tree['busy_s']) < 1e-4 * tree['window_s']

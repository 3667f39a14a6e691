"""The readers of the program's own spans and counter (``mcl.expand_s``,
``mcl.column_s``, ``mcl.pattern_s``, ``mcl.host_gap_s``, ``mcl.syncs``):
None on the CPU and on a program without them; the defined figure from
hand-made records; the idle's union over overlapping and nested spans;
every metric of a traced run on the card."""

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


@pytest.mark.parametrize('name', NEW)
def test_none_on_the_cpu(clean_trace, name):
    r = harness.metric_reader(name)
    if hasattr(r, 'install'):
        r.install(_probe(0))
    assert r.read(_probe(1), _stage('cpu'), [], None) is None


@pytest.mark.parametrize('name', NEW)
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
    names = {m['name'] for m in bench()['per_layer']}
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

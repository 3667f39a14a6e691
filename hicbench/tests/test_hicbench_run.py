"""Whole runs of each cell on the CPU at a tiny size (the harness's look
for a card skipped): the result line, the modules loaded, and the check
with the timed path broken underneath; and the control on the card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from hicbench import harness
from hicbench.stages import STAGES

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELLS = ('xtropicalis.cluster',)
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def tiny(workload):
    """The overrides of a tiny version of ``workload``: 240
    contigs in 4 groups; 2 inflations."""
    wl = next(w for w in bench()['workloads'] if w['name'] == workload)
    cfg = harness.load('configs', wl['config'])
    cfg['published'] = dict(cfg['published'], contigs=240,
                            genome_bp=240 * 150_000, chromosomes=4,
                            haplotypes=1)
    mix = harness.load('traffic', wl['traffic'])
    mix = dict(mix, inflations={'min': 1.6, 'max': 2.4, 'step': 0.8})
    return {'config': cfg, 'traffic': mix}


@pytest.fixture
def cpu_route(monkeypatch):
    """The port's CPU path at tiny sizes: the torch dense sweep, not its
    host twin. The repository's conftest loads JAX
    into the test process, so the harness's look for it is skipped here
    (test_loads_nothing_of_jax makes it in a process of its own)."""
    from haphic_tpu_torch.cluster import mcl
    monkeypatch.setattr(harness, 'forbidden_modules', lambda: [])
    monkeypatch.setattr(mcl, 'DEVICE_MIN_N', 0)


def rehearse(workload, trace=False, limits=None):
    over = tiny(workload)
    if limits:
        over['limits'] = limits
    return harness.run(bench(), workload, 2 ** 31 + 17, 0.01, trace,
                       time.monotonic(), device='cpu', overrides=over)


@pytest.mark.parametrize('workload', CELLS)
def test_last_line(cpu_route, workload):
    limits = harness.load('limits', workload)['limits']
    rc, res = rehearse(workload, limits=limits)
    assert rc == 0 and res['correct'] and res['failed'] == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == 'checks'
    assert res['attempted'] == 1
    assert set(res['device']) >= {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    unit = harness.load('traffic', 'cluster_dense')['unit_metric']
    assert set(res['metrics']) == {unit, 'peak_gib', 'setup_s'}
    assert all(set(m) == {'value', 'unit'} for m in res['metrics'].values())
    assert set(res['checks']) == set(limits)
    json.dumps(res)


def test_traced_run_reports_layer_metrics(cpu_route):
    rc, res = rehearse('xtropicalis.cluster', trace=True)
    # on the CPU: the counters and spans; the device's metrics need a card
    assert rc == 0 and set(res['metrics']) == {'mcl.iters',
                                               'mcl.interpret_s'}


def test_loads_nothing_of_jax(tmp_path):
    code = '''
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import test_hicbench_run as t
from haphic_tpu_torch.cluster import mcl
mcl.DEVICE_MIN_N = 0
for w in t.CELLS:
    t.rehearse(w)
from hicbench import harness
print(harness.forbidden_modules())
'''.format(root=ROOT, tests=os.path.join(HERE, 'tests'))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_refuses_to_run_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: run.py would measure')
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(HERE, tmp_path / 'hicbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for root in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, 'hicbench/run.py', '--workload',
             'xtropicalis.cluster', '--seed', '1', '--seconds', '1',
             '--trace', '0'], capture_output=True, text=True, cwd=root,
            timeout=300)
        assert out.returncode != 0 and out.stdout == ''


# ---- the timed path broken underneath: the check must fail ----

def _unchanged_column(e, infl, pruning, old=None):
    """A dense step that returns its state: the iterate unchanged."""
    out = (old if old is not None else e).clone()
    return out, torch.zeros(e.shape[0])


def _half_dense(fn):
    def batched(pre, infl, *args):
        h = max(1, infl.shape[0] // 2)
        m, it, cv = fn(pre, infl[:h], *args)
        rep = torch.arange(infl.shape[0]) % h
        return m[rep], it[rep], cv[rep]
    return batched


def _altered_partition(fn):
    def interpret(matrix, tol=0.0):
        part = fn(matrix, tol)
        if part and len(part) > 1:
            a, b = list(part[0]), list(part[1])
            part = sorted([tuple(a[1:]), tuple(sorted(b + a[:1]))] + part[2:])
        return part
    return interpret


def faults():
    from haphic_tpu_torch.cluster import mcl
    return [
        ('xtropicalis.cluster', 'state unchanged', mcl, 'mcl_column',
         lambda f: _unchanged_column),
        ('xtropicalis.cluster', 'half the batch', mcl, '_mcl_batched',
         _half_dense),
        ('xtropicalis.cluster', 'answer altered', mcl, 'interpret_result',
         _altered_partition),
    ]


@pytest.mark.parametrize('case', range(3))
def test_a_broken_path_is_not_correct(cpu_route, monkeypatch, case):
    workload, what, module, attr, make = faults()[case]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    rc, res = rehearse(workload)
    assert rc == 0 and not res['correct'], (what, res['checks'])
    assert res['failed'] == res['attempted'] >= 1


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_and_program_passes_on_the_card(card, workload):
    """At the cell's own size on the card, one seed: the program's unit
    within every limit, the control (the reference at the precision
    below the configuration's, in the program's place) outside one."""
    wl = next(w for w in bench()['workloads'] if w['name'] == workload)
    cfg = harness.load('configs', wl['config'])
    mix = harness.load('traffic', wl['traffic'])
    limits = harness.load('limits', workload)['limits']
    from hicbench import genome as gen
    seed = 2 ** 31 + 99
    stage = STAGES[mix['stage']](cfg, mix, gen.make(cfg, seed), card, seed)
    stage.warmup()
    out = stage.unit(0)
    ref = stage.reference()
    got = stage.compare(out, ref)
    ctl = stage.compare(stage.control([out]), ref)
    assert all(got[k] <= limits[k] for k in limits), got
    assert any(ctl[k] > limits[k] for k in limits), ctl

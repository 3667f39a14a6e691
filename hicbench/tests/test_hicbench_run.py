"""Whole runs of each cell on the CPU at a tiny size (the harness's look
for a card skipped): the result line, the modules loaded, and the check
with the timed path broken underneath; and, on the card, the control
and the card route's broken answer."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from hicbench import harness, stages

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELLS = ('xtropicalis.cluster', 'alfalfa_4x.sort')
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


# each stage's tiny mix: 2 inflations; a short GA on its torch route (the
# native GA takes work this small) at a low depth. The GA's progress
# depends on its length and the groups' size, so the tiny GA has its own
# truth_ratio limit: sound 3.18 at 60 contigs a group, 200 generations
# of 8 tours; every fault planted below 8.7 or more (CPU).
TINY = {'cluster_dense': ({}, {'inflations': {'min': 1.6, 'max': 2.4,
                                              'step': 0.8}}, {}),
        'sort_ga': ({'hic_depth_x': 1.0},
                    {'npop': 8, 'ngen': 200, 'log_every': 100,
                     'backend': 'device'},
                    {'truth_ratio': 5.0})}


def tiny(workload):
    """The overrides of a tiny version of ``workload``: 240 contigs in 4
    groups, the stage's tiny mix, and the cell's limits with the tiny
    mix's own."""
    wl = next(w for w in bench()['workloads'] if w['name'] == workload)
    cfg = harness.load('configs', wl['config'])
    mix = harness.load('traffic', wl['traffic'])
    published, params, limits = TINY[mix['stage']]
    cfg['published'] = dict(cfg['published'], contigs=240,
                            genome_bp=240 * 150_000, chromosomes=4,
                            haplotypes=1, **published)
    return {'config': cfg, 'traffic': dict(mix, **params),
            'limits': dict(harness.load('limits', workload)['limits'],
                           **limits)}


@pytest.fixture
def cpu_route(monkeypatch):
    """The port's CPU path at tiny sizes: the torch dense sweep, not its
    host twin. The repository's conftest loads JAX
    into the test process, so the harness's look for it is skipped here
    (test_loads_nothing_of_jax makes it in a process of its own)."""
    from haphic_tpu_torch.cluster import mcl
    monkeypatch.setattr(harness, 'forbidden_modules', lambda: [])
    monkeypatch.setattr(mcl, 'DEVICE_MIN_N', 0)


def rehearse(workload, trace=False, device='cpu'):
    return harness.run(bench(), workload, 2 ** 31 + 17, 0.01, trace,
                       time.monotonic(), device=device,
                       overrides=tiny(workload))


@pytest.mark.parametrize('workload', CELLS)
def test_last_line(cpu_route, workload):
    limits = tiny(workload)['limits']
    rc, res = rehearse(workload)
    assert rc == 0 and res['correct'] and res['failed'] == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == 'checks'
    assert res['attempted'] == 1
    assert set(res['device']) >= {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    wl = next(w for w in bench()['workloads'] if w['name'] == workload)
    unit = harness.load('traffic', wl['traffic'])['unit_metric']
    assert set(res['metrics']) == {unit, 'peak_gib', 'setup_s'}
    assert all(set(m) == {'value', 'unit'} for m in res['metrics'].values())
    assert set(res['checks']) == set(limits)
    json.dumps(res)


@pytest.mark.parametrize('workload,names', [
    ('xtropicalis.cluster', {'mcl.iters', 'mcl.interpret_s'}),
    ('alfalfa_4x.sort', {'ga.problem_s', 'ga.evolve_s'})])
def test_traced_run_reports_layer_metrics(cpu_route, workload, names):
    rc, res = rehearse(workload, trace=True)
    # on the CPU: the counters and spans; the device's metrics need a card
    assert rc == 0 and set(res['metrics']) == names


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


def _altered_labels(fn):
    """The card route's partitions, one fragment moved between the first
    two clusters."""
    alter = _altered_partition(lambda m, tol: fn(m))
    return lambda labels: alter(labels)


def _unchanged_delta(state, *args, **kwargs):
    """A delta generation whose commit is skipped: the state unchanged."""
    return state


def _unchanged_evolve(gen, rec, order, ori, mutprob, ngen, xoprob=0.3):
    """Every generation returns its state: the population as it came,
    best first."""
    from haphic_tpu_torch.order import optimize as opt
    top, idx = opt._top_rows(rec.cache_scores(order, ori), order.shape[1])
    return opt._take_rows(order, idx), opt._take_rows(ori, idx), top


def _half_groups(fn):
    """The GA run on the first half of the groups; the rest returned as
    they started: the first tour of their initial population on the same
    route (the start tour) and its score."""
    def optimize_tours(problems, **kw):
        h = max(1, len(problems) // 2)
        hots = kw.pop('hot_starts')
        ngen = kw.pop('ngen')
        rest = dict(kw, backend='device')
        return (fn(problems[:h], hot_starts=hots[:h], ngen=ngen, **kw)
                + fn(problems[h:], hot_starts=hots[h:], ngen=0, **rest))
    return optimize_tours


def _contig_left_out(fn):
    """Each returned tour without its last contig (its score kept)."""
    def optimize_tours(*args, **kw):
        out = fn(*args, **kw)
        for r in out:
            r.order, r.ori = r.order[:-1], r.ori[:-1]
        return out
    return optimize_tours


def _altered_score(fn):
    def optimize_tours(*args, **kw):
        out = fn(*args, **kw)
        for r in out:
            r.score *= 1 + 1e-3
        return out
    return optimize_tours


def faults():
    from haphic_tpu_torch.cluster import mcl
    from haphic_tpu_torch.order import optimize as opt
    return [
        ('xtropicalis.cluster', 'state unchanged', mcl, 'mcl_column',
         lambda f: _unchanged_column, 'cpu'),
        ('xtropicalis.cluster', 'half the batch', mcl, '_mcl_batched',
         _half_dense, 'cpu'),
        ('xtropicalis.cluster', 'answer altered', mcl, 'interpret_result',
         _altered_partition, 'cpu'),
        ('alfalfa_4x.sort', 'state unchanged: the delta commit skipped',
         opt, 'delta_generation_from_draws', lambda f: _unchanged_delta,
         'cpu'),
        ('alfalfa_4x.sort', 'state unchanged: every generation', opt,
         '_evolve_delta_impl', lambda f: _unchanged_evolve, 'cpu'),
        ('alfalfa_4x.sort', 'half the batch', opt, 'optimize_tours',
         _half_groups, 'cpu'),
        ('alfalfa_4x.sort', 'score altered', opt, 'optimize_tours',
         _altered_score, 'cpu'),
        ('alfalfa_4x.sort', 'tour altered: a contig left out', opt,
         'optimize_tours', _contig_left_out, 'cpu'),
        ('xtropicalis.cluster', 'answer altered on the card route', mcl,
         'partition_from_labels', _altered_labels, 'cuda'),
    ]


N_FAULTS = 9


@pytest.mark.parametrize('case', [
    pytest.param(i, marks=pytest.mark.cuda) if i == N_FAULTS - 1 else i
    for i in range(N_FAULTS)])
def test_a_broken_path_is_not_correct(cpu_route, monkeypatch, case):
    workload, what, module, attr, make, device = faults()[case]
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('the card route: needs a CUDA card')
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    rc, res = rehearse(workload, device=device)
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
    stage = stages.load(mix['stage']).Stage(cfg, mix, gen.make(cfg, seed),
                                            card, seed)
    stage.warmup()
    out = stage.unit(0)
    ref = stage.reference()
    got = stage.compare(out, ref)
    ctl = stage.compare(stage.control([out]), ref)
    assert all(got[k] <= limits[k] for k in limits), got
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_calibrate_plants_the_faults_off_the_card_route(cpu_route):
    """``calibrate.py --faults`` reads each fault planted off the card's
    route in one unit of the stage and takes it out after."""
    sys.path.insert(0, HERE)
    import calibrate
    from hicbench import genome as gen
    from haphic_tpu_torch.order import optimize as opt
    names = [w for w, _ in calibrate.faults('alfalfa_4x.sort')]
    assert names == [f[1] for f in faults()
                     if f[0] == 'alfalfa_4x.sort' and f[5] == 'cpu']
    over, seed = tiny('alfalfa_4x.sort'), 2 ** 31 + 17
    stage = stages.load('sort_ga').Stage(
        over['config'], over['traffic'], gen.make(over['config'], seed),
        torch.device('cpu'), seed)
    before = opt.optimize_tours
    what, run = calibrate.faults('alfalfa_4x.sort')[-1]
    got = stage.compare(run(stage), stage.reference())
    assert got['invalid'] == 4 and opt.optimize_tours is before

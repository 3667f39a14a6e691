"""The sparse cell, ``tieguanyin_2x.cluster_sets``, on the CPU at a tiny
size through the program's CPU route (the engine's plain versions):
the sparse reference against the dense one, the stage's inputs and log
capture, whole runs that pass, runs with the timed path broken
underneath that fail, the new cost functions; and, on the card, a short
traced run that reports every new metric."""

import json
import logging
import time

import numpy as np
import pytest
import torch

from hicbench import genome as gen
from hicbench import harness, peaks, stages
from hicbench.reference import mcl_dense, mcl_sparse
from test_hicbench_run import bench

CELL = 'tieguanyin_2x.cluster_sets'
NEW = ('sparse.iters', 'sparse.sweep_s', 'sparse.ell_s',
       'sparse.interpret_s', 'cluster.map_s', 'sparse_column_roofline', 'col_allclose_roofline',
       'idle.cluster_sets')
# the program's own records and the benchmark's host span, read on any
# device
RECORDS = ('sparse.iters', 'sparse.sweep_s', 'sparse.ell_s',
           'sparse.interpret_s', 'cluster.map_s')


# the tiny cell's own limits: its sound runs read 0 on every number (5
# seeds); the faults planted below read moved 4 or more, iters_gap 7 or
# more, or dropped_gap 2 or more (CPU)
TINY_LIMITS = {'moved': 1, 'iters_gap': 4, 'dropped_gap': 1}


def tiny(K: int = 8):
    """A tiny version of the cell: 240 contigs of the law's lengths in
    4 groups at 1x (300 kb bins, so that some contigs are split; 100 kb
    flanks, so that some fragments count two regions), four inflations,
    the sparse engine forced below its threshold, K small enough to cut,
    its own limits."""
    cfg = harness.load('configs', 'tieguanyin_2x')
    cfg['published'] = dict(cfg['published'], contigs=240,
                            genome_bp=240 * 150_000, contig_n50_bp=300_000,
                            chromosomes=4, haplotypes=1, hic_depth_x=1.0)
    cfg['pipeline'] = dict(cfg['pipeline'], flank_kbp=100)
    mix = dict(harness.load('traffic', 'cluster_sets'),
               inflations={'min': 1.2, 'max': 3.0, 'step': 0.6},
               mcl_backend='sparse', sparse_K=K)
    return {'config': cfg, 'traffic': mix, 'limits': dict(TINY_LIMITS)}


@pytest.fixture
def cpu_route(monkeypatch):
    """The repository's conftest loads JAX into the test process, so
    the harness's look for it is skipped here (test_hicbench_run's
    test_loads_nothing_of_jax makes it in a process of its own)."""
    monkeypatch.setattr(harness, 'forbidden_modules', lambda: [])


def rehearse(seed=2 ** 31 + 17, trace=False, device='cpu', K=8):
    return harness.run(bench(), CELL, seed, 0.01, trace, time.monotonic(),
                       device=device, overrides=tiny(K))


def stage(seed=2 ** 31 + 17, cfg=None, K=8):
    over = tiny(K)
    cfg = cfg or over['config']
    return stages.load('cluster_sets').Stage(
        cfg, over['traffic'], gen.make(cfg, seed), torch.device('cpu'),
        seed)


# ---- the reference ----

def _links(seed=7):
    return stage(seed)._links()


@pytest.mark.parametrize('seed', [7, 8])
def test_reference_is_the_dense_sweep_when_K_holds_every_column(seed):
    ci, cj, cw, n = _links(seed)
    infl = [1.2, 2.0, 3.0]
    want = mcl_dense.sweep(ci, cj, cw, n, infl, 2, 200, 1e-4, 'cpu')
    got = mcl_sparse.sweep(ci, cj, cw, n, infl, 2, 200, 1e-4, n, 'cpu')
    assert got[0] == want[0] and got[1] == want[1]


def test_reference_departs_from_the_dense_sweep_when_K_cuts():
    ci, cj, cw, n = _links()
    infl = [1.2, 2.0, 3.0]
    want = mcl_dense.sweep(ci, cj, cw, n, infl, 2, 200, 1e-4, 'cpu')
    got = mcl_sparse.sweep(ci, cj, cw, n, infl, 2, 200, 1e-4, 4, 'cpu')
    assert got[1] != want[1] or got[0] != want[0]


def test_the_blocks_do_not_change_the_sweep(monkeypatch):
    """Blocks of a few columns give the sweep of one block a step."""
    ci, cj, cw, n = _links()
    infl = [1.2, 2.0, 3.0]
    whole = mcl_sparse.sweep(ci, cj, cw, n, infl, 2, 200, 1e-4, 8, 'cpu')
    monkeypatch.setattr(mcl_sparse, 'CANDIDATES', 300)
    assert mcl_sparse.sweep(ci, cj, cw, n, infl, 2, 200, 1e-4, 8,
                            'cpu') == whole


def _one_column(rows, vals, r, pruning, K, n, old=None, bf16=False):
    rows = torch.tensor(rows)
    return mcl_sparse._columns(
        torch.zeros_like(rows), rows, torch.tensor(vals, dtype=torch.float64),
        1, torch.tensor([r]), pruning, K, n, old, bf16)


def test_a_column_by_hand():
    """Candidates of rows 2, 0, 2, 1 (0.25, 0.5, 0.25, 0.5): rows 0, 1,
    2 sum to 0.5 each; squared and normalised a third each; with K = 2
    the two lower rows, then halves; the statistic against an old column
    of row 0 alone at 1: |0.5 - 1| - 1e-5 on row 0, 0.5 on row 1."""
    (idx, val), st = _one_column(
        [2, 0, 2, 1], [0.25, 0.5, 0.25, 0.5], 2.0, 1e-4, 2, 5,
        old=(torch.tensor([[0, 5]]), torch.tensor([[1.0, 0.0]])))
    assert idx[0].tolist() == [0, 1] and val[0].tolist() == [0.5, 0.5]
    assert st.tolist() == [0.5]


def test_the_cap_keeps_the_lower_row_among_ties():
    """A column of five equal entries capped at K = 3 keeps its three
    lowest rows: the input's cap, and the product's."""
    n = 5
    ci, cj = np.zeros(4, np.int64), np.arange(1, 5)
    idx, val = mcl_sparse.initial(ci, cj, np.ones(4), n, 3, 'cpu')
    assert sorted(idx[0][val[0] > 0].tolist()) == [0, 1, 2]
    (idx, val), _ = _one_column([4, 3, 2, 1, 0], [0.2] * 5, 1.0, None, 3, n)
    assert sorted(idx[0][val[0] > 0].tolist()) == [0, 1, 2]


def test_the_prune_keeps_the_first_argmax():
    """Every entry under the threshold: the column keeps its first
    largest entry alone."""
    (idx, val), _ = _one_column([1, 3, 2], [0.3, 0.3, 0.2], 1.0, 0.5, 8, 4)
    assert idx[0][val[0] > 0].tolist() == [1]
    assert val[0].max().item() == 1.0


# ---- the stage ----

def test_the_stage_reads_none_of_the_configs_groups():
    """A ``groups`` key (the sort unit's cut in other configurations)
    changes nothing: MCL clusters every kept fragment at once."""
    a = stage()
    b = stage(cfg=dict(tiny()['config'], groups=1))
    c = stage(cfg=dict(tiny()['config'], groups=7))
    for s in (b, c):
        assert np.array_equal(a.filtered, s.filtered)
        for k in ('i', 'j', 'w'):
            assert np.array_equal(getattr(a.flank, k), getattr(s.flank, k))


def test_the_seed_orders_the_work_without_sizing_it():
    a, b = stage(seed=3), stage(seed=4)
    assert a.m == b.m and a.sizes == b.sizes
    assert not np.array_equal(a.filtered, b.filtered)
    assert np.isclose(a.flank.w.sum(), b.flank.w.sum())


def test_the_log_capture_finds_the_programs_records(cpu_route):
    s = stage()
    out = s.unit(0)
    assert len(out.sparse['n_iters']) == len(s.infl) == 4
    assert out.sparse['interpret_s'] >= 0 and out.sparse['sweep_s'] > 0
    assert out.sparse['K'] == 8 and out.sparse['n'] == s.m
    assert out.sets['cluster_map_s'] >= 0
    # a second stage replaces the first's handler
    stage()
    assert sum(getattr(h, 'hicbench', False) for h in logging.getLogger(
        'haphic_tpu_torch.cluster.sweep').handlers) == 1


def test_a_unit_off_the_sparse_engine_is_refused(cpu_route, monkeypatch):
    s = stage()
    monkeypatch.setitem(s.mix, 'mcl_backend', 'dense')
    with pytest.raises(RuntimeError, match='sparse engine'):
        s.unit(0)


# ---- whole runs ----

@pytest.mark.parametrize('seed', [2 ** 31 + 17, 2 ** 32 + 5, 12345])
def test_the_program_meets_the_limits(cpu_route, seed):
    rc, res = rehearse(seed)
    assert rc == 0 and res['correct'] and res['failed'] == 0, res['checks']
    assert set(res['metrics']) == {'cluster_sparse_s', 'peak_gib',
                                   'setup_s'}
    assert list(res)[-1] == 'checks' and set(res['checks']) == {
        'moved', 'iters_gap', 'dropped_gap'}
    json.dumps(res)


def test_a_traced_cpu_run_reports_the_programs_records(cpu_route):
    rc, res = rehearse(trace=True)
    # the kernels' events and the profiler's trace need a card
    assert rc == 0 and res['correct'] and set(res['metrics']) == set(
        RECORDS)
    got = {k: v['value'] for k, v in res['metrics'].items()}
    assert got['sparse.iters'] > 0
    assert 0 < got['sparse.ell_s'] < got['sparse.sweep_s']


# ---- the timed path broken underneath: the check must fail ----

def _unchanged_columns(A_i, A_v, ci, cv, infl, n, K, pruning, expand):
    """A column step that returns its columns: the state unchanged."""
    return ci[..., :K].clone(), cv[..., :K].clone()


def _half_batch(fn):
    """Each inflation batch run on its first half; the rest returned as
    it started, the batch's input with n_iters 0."""
    def run(idx0, val0, infl, n, K, chunk, max_iter, pruning, expansion,
            mesh=None):
        h = max(1, infl.shape[0] // 2)
        i, v, it, cv, ks = fn(idx0, val0, infl[:h], n, K, chunk, max_iter,
                              pruning, expansion, mesh=mesh)
        r = infl.shape[0] - h
        i0 = np.broadcast_to(idx0.cpu().numpy(), (r,) + i.shape[1:])
        v0 = np.broadcast_to(val0.cpu().numpy(), (r,) + v.shape[1:])
        return (np.concatenate([i, i0]), np.concatenate([v, v0]),
                np.concatenate([it, np.zeros(r, it.dtype)]),
                np.concatenate([cv, np.zeros(r, bool)]), ks)
    return run


def _altered_partition(fn):
    """Each inflation's contig clusters with one contig moved from its
    first cluster to its second, where the program produces them."""
    def clusters_to_ctgs(*args, **kw):
        out = fn(*args, **kw)
        if len(out) > 1 and out[0][0]:
            (a, la), (b, lb) = out[0], out[1]
            out = [(a[1:], la), (b + a[:1], lb)] + out[2:]
        return out
    return clusters_to_ctgs


def _narrow_K(fn):
    """The program run at half the selection width (K 64 for 128)."""
    def run_clustering(*args, **kw):
        kw['sparse_K'] = (kw.get('sparse_K') or 128) // 2
        return fn(*args, **kw)
    return run_clustering


def faults():
    """(workload, what, module, attr, make, device) of each fault, as
    test_hicbench_run.faults gives its cells'."""
    from haphic_tpu_torch.cluster import sparse_mcl, sweep
    return [
        (CELL, 'state unchanged', sparse_mcl, 'sparse_column',
         lambda f: _unchanged_columns, 'cpu'),
        (CELL, 'half the batch', sparse_mcl, '_run_sweep_batch',
         _half_batch, 'cpu'),
        (CELL, 'answer altered', sweep, '_clusters_to_ctgs',
         _altered_partition, 'cpu'),
        (CELL, 'selection width halved', sweep, 'run_clustering',
         _narrow_K, 'cpu'),
    ]


@pytest.mark.parametrize('case', range(4))
def test_a_broken_path_is_not_correct(cpu_route, monkeypatch, case):
    workload, what, module, attr, make, device = faults()[case]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    rc, res = rehearse()
    assert rc == 0 and not res['correct'], (what, res['checks'])
    assert res['failed'] == res['attempted'] >= 1


def test_the_control_is_the_reference_in_bfloat16():
    s = stage()
    ref, ctl = s.reference(), s.control([])
    assert ref.n_iters != ctl.n_iters or ref.partitions != ctl.partitions


# ---- the cost functions ----

def test_sparse_column_cost():
    A = torch.zeros(2, 10, 4, dtype=torch.int32)
    ci = torch.zeros(2, 3, 4, dtype=torch.int32)
    # 2 x 3 columns of 4 read and of K = 5 written, 8 B an entry, the
    # two inflations; 4 x 4 products a column
    nb, ops, peak = peaks.sparse_column_cost(A, A.float(), ci, ci.float(),
                                             torch.ones(2), 9, 5, 1e-4,
                                             expand=True)
    assert (nb, ops, peak) == (8 * 6 * 9 + 8, 6 * 16, peaks.FP32_FLOPS)
    assert peaks.sparse_column_cost(None, None, ci, ci.float(),
                                    torch.ones(2), 9, 4, 1e-4,
                                    expand=False)[:2] == (8 * 6 * 8 + 8, 24)


def test_col_allclose_cost():
    old = torch.zeros(4, 5, 16, dtype=torch.int32)
    new = torch.zeros(4, 5, 8, dtype=torch.int32)
    nb, ops, _ = peaks.col_allclose_cost(old, old.float(), new, new.float(),
                                         99, bad=None)
    assert nb == 8 * 20 * 24 + 4 * 20 and ops == 4 * 20 * 24


def test_kernel_roofline_reads_the_traced_units_launches():
    """The bound of the traced unit's launches (unit 0) over the device
    time of the kernel named, whatever its arguments; nothing where no
    launch or no trace was recorded."""
    from hicbench.probe import Probe
    p = Probe()
    ms = peaks.HBM_BPS * 1e-3       # bytes of a millisecond's bound
    p.calls['k'] = [(0, (ms, 0, peaks.FP32_FLOPS)),
                    (0, (ms, 0, peaks.FP32_FLOPS)),
                    (1, (50 * ms, 0, peaks.FP32_FLOPS))]
    profiled = {'kernels': {'k_kernel(int const*, float)': 2e-3,
                            'void k_kernel<8, true>(int const*)': 1e-3,
                            'k_kernel_other(int)': 5.0,
                            'void at::native::reduce(int)': 7.0}}
    assert p.kernel_roofline('k', profiled, 'k_kernel') == \
        pytest.approx(100 * 2 / 3)
    assert p.kernel_roofline('k', None, 'k_kernel') is None
    assert p.kernel_roofline('none', profiled, 'k_kernel') is None
    assert p.kernel_roofline('k', profiled, 'absent_kernel') is None


# ---- on the card ----

@pytest.mark.cuda
def test_traced_run_on_the_card_reports_every_new_metric(cpu_route):
    """The tiny cell through the card's kernels, traced: every new
    metric, each share under 100%."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    rc, res = rehearse(trace=True, device='cuda')
    assert rc == 0 and res['correct'], res['checks']
    assert set(res['metrics']) == set(NEW)
    got = {k: v['value'] for k, v in res['metrics'].items()}
    assert got['sparse.iters'] > 0
    assert 0 < got['sparse_column_roofline'] <= 100
    assert 0 < got['col_allclose_roofline'] <= 100
    assert 0 <= got['idle.cluster_sets'] < 100

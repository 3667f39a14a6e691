"""The port's multi-process layer (haphic_tpu_torch/parallel/) against
the single-process runs and haphic_tpu, on the CPU.

In process: rank-sharded ingest merges, shard_range, the GA's draws and
row sums. Then two gloo processes (tests/torch_parallel_worker.py,
joined through a file store in tmp_path) run every sharded place once
(ingest, the dense and the sparse MCL sweeps, the GA and the pipeline),
and each test holds one of them to the meshless result: bit for bit
where the JAX package's tests do (sparse iterates, GA results), byte
for byte for the pipeline trees."""

import itertools
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from haphic_tpu.cluster import mcl as jmcl
from haphic_tpu.core.fragments import build_fragments as jbuild_fragments
from haphic_tpu.io.fasta import Assembly as JAssembly
from haphic_tpu.io.pairs import AlignChunk as JAlignChunk
from haphic_tpu.parallel import ingest as jingest
from haphic_tpu.pipeline import run_pipeline as jrun_pipeline

from haphic_tpu_torch.cluster import mcl as tmcl
from haphic_tpu_torch.cluster import sparse_mcl as tsp
from haphic_tpu_torch.core.contacts import aggregate
from haphic_tpu_torch.io.links import write_clm
from haphic_tpu_torch.order import optimize as topt
from haphic_tpu_torch.parallel import ingest
from haphic_tpu_torch.parallel.mesh import Mesh, shard_range
from haphic_tpu_torch.pipeline import run_pipeline

from . import torch_parallel_worker as W
from . import util
from .test_torch_pipeline import STAGES, _assert_trees_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 240


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def _mesh(rank, world):
    return Mesh(group=None, rank=rank, world=world,
                device=torch.device('cpu'), backend='gloo')


@pytest.mark.parametrize('n,world', [(7, 2), (7, 3), (2, 4), (0, 3),
                                     (12, 4)])
def test_shard_range_covers_in_contiguous_near_equal_shares(n, world):
    got = [shard_range(n, _mesh(r, world)) for r in range(world)]
    assert got[0][0] == 0 and got[-1][1] == n
    for (s0, e0), (s1, _) in zip(got, got[1:]):
        assert e0 == s1
    sizes = [e - s for s, e in got]
    assert max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    if n < world:
        assert 0 in sizes


def _jax_ingest_inputs():
    """The same fixture in haphic_tpu's classes."""
    asm, _, chunks = W.ingest_inputs()
    jasm = JAssembly(names=asm.names, name2id=asm.name2id,
                     lengths=asm.lengths, re_sites=asm.re_sites, seqs=None,
                     input_order=asm.input_order)
    jfrags = jbuild_fragments(jasm, nchrs=2, Nx=100, bin_size_kbp=0,
                              flank_kbp=0)

    def jchunks():
        for c in chunks():
            yield JAlignChunk(ref=c.ref, mref=c.mref, pos=c.pos,
                              mpos=c.mpos)
    return jfrags, jchunks


def _eq_links(got, want, merged=True):
    """Every array of two LinkData-like dicts (tests/torch_parallel_
    worker._links_arrays) equal. ``merged``: ``got`` was merged from
    shards and ``want`` was not, so each pair's CLM distances are
    compared as a multiset (a merge lists a pair's records shard by
    shard), as tests/test_ingest_sharded.py does."""
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = got[key], want[key]
        if key == 'clm' and merged:
            (pi, pj, d, uk, uf), (wi, wj, wd, wuk, wuf) = a, b
            for x, y in ((pi, wi), (pj, wj), (uk, wuk), (uf, wuf)):
                np.testing.assert_array_equal(x, y)
            for c in range(4):
                np.testing.assert_array_equal(
                    d[c][np.lexsort((d[c], pi, pj))],
                    wd[c][np.lexsort((wd[c], wi, wj))])
            continue
        if isinstance(b, tuple):
            assert len(a) == len(b), key
            for x, y in zip(a, b):
                if y is None:
                    assert x is None, key
                else:
                    np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize('n_shards', [1, 3, 4])
def test_shard_merge_equals_single_and_haphic_tpu(n_shards):
    """aggregate_shard + merge_link_data at 1, 3 and 4 shards on the
    17-chunk fixture of tests/test_ingest_sharded.py: equal to the
    port's single aggregate (COO, frag_links, CLM, sampled coords, the
    ctg-pair map) and to haphic_tpu's merge of the same shards."""
    asm, frags, chunks = W.ingest_inputs()
    single = aggregate(chunks(), frags, **W.INGEST_KW)
    parts = [ingest.aggregate_shard(chunks(), frags, n_shards, h,
                                    **W.INGEST_KW)
             for h in range(n_shards)]
    merged = ingest.merge_link_data(parts, max_read_pairs=5)
    got = W._links_arrays(merged)
    _eq_links(got, W._links_arrays(single))
    jfrags, jchunks = _jax_ingest_inputs()
    jparts = [jingest.aggregate_shard(jchunks(), jfrags, n_shards, h,
                                      **W.INGEST_KW)
              for h in range(n_shards)]
    _eq_links(got, W._links_arrays(jingest.merge_link_data(
        jparts, max_read_pairs=5)), merged=False)


def test_clm_file_byte_identical_across_shard_counts(tmp_path):
    asm, frags, chunks = W.ingest_inputs()
    texts = []
    for n_shards in (1, 2, 3, 4):
        parts = [ingest.aggregate_shard(chunks(), frags, n_shards, h,
                                        **W.INGEST_KW)
                 for h in range(n_shards)]
        path = tmp_path / 'c{}.clm'.format(n_shards)
        write_clm(ingest.merge_link_data(parts, 5).clm, asm.names,
                  str(path), min_read_pairs=1)
        texts.append(path.read_bytes())
    single = tmp_path / 'single.clm'
    write_clm(aggregate(chunks(), frags, **W.INGEST_KW).clm, asm.names,
              str(single), min_read_pairs=1)
    assert len(texts[0]) > 1000
    assert all(t == single.read_bytes() for t in texts)


def test_batch_draws_do_not_depend_on_the_rows():
    """A _Draws of rows [g0, g1) gives those rows of the whole batch's
    draws, move for move and crossover for crossover."""
    G, P, k = 5, 6, 24

    def draws(rows):
        gen = torch.Generator()
        gen.manual_seed(9)
        d = topt._Draws(gen, G, *rows)
        n = rows[1] - rows[0]
        return (topt._move_draws(d, (n, P), k, 'cpu')
                + topt._ox_draws(d, n, P, k, 'cpu'))
    whole = draws((0, G))
    for rows in ((0, 2), (2, 5), (4, 5)):
        for a, b in zip(draws(rows), whole):
            assert torch.equal(a, b[rows[0]:rows[1]])


def test_group_sums_equal_the_batched_sum_on_the_cpu():
    """_group_sums reduces one group at a time; on the CPU each row
    sums in the order of the batched reduction, so the GA's CPU results
    did not change with it."""
    g = torch.Generator()
    g.manual_seed(1)
    contrib = torch.rand((7, 100, 4096), generator=g) / torch.rand(
        (7, 100, 4096), generator=g)
    assert torch.equal(topt._group_sums(contrib), contrib.sum(dim=2))
    assert torch.equal(topt._group_sums(contrib)[2:5],
                       topt._group_sums(contrib[2:5]))


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """Runs every case of the worker on two gloo ranks; returns the work
    directory and each rank's results by case."""
    tmp = tmp_path_factory.mktemp('tpar')
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(12345), nchrs=3, ctgs_per_chr=5, ctg_len=8000,
        n_pairs=24000)
    util.write_genome(str(tmp / 'asm.fa'), ctgs)
    util.write_pairs(str(tmp / 'hic.pairs'), recs)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT', 'LOCAL_WORLD_SIZE'):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, 'tests',
                                      'torch_parallel_worker.py'),
         str(r), str(WORLD), str(tmp / 'store'), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    res = {}
    for case in W.CASES:
        res[case] = []
        for r in range(WORLD):
            with open(tmp / 'r{}_{}.pkl'.format(r, case), 'rb') as f:
                res[case].append(pickle.load(f))
    return tmp, res


def test_distributed_aggregate_equals_single(two_ranks):
    _, res = two_ranks
    asm, frags, chunks = W.ingest_inputs()
    want = W._links_arrays(aggregate(chunks(), frags, **W.INGEST_KW))
    for got in res['ingest']:
        _eq_links(got, want)


def test_distributed_aggregate_with_an_empty_rank_equals_single(two_ranks):
    """One chunk over two ranks: rank 1 aggregates nothing, so its
    coords carry no stream-order keys, and the merge still keeps the
    first max_read_pairs per pair in stream order."""
    _, res = two_ranks
    asm, frags, chunks = W.ingest_inputs()
    want = W._links_arrays(aggregate(itertools.islice(chunks(), 1), frags,
                                     **W.INGEST_KW))
    assert len(want['coords'][2]) > 0
    for got in res['ingest_one_chunk']:
        _eq_links(got, want)


def test_sharded_dense_sweep_equals_meshless(two_ranks, monkeypatch):
    """Inflations split 4 / 3: every rank's partitions and iteration
    counts equal the port's run_mcl_partitions and haphic_tpu's."""
    _, res = two_ranks
    m = W.dense_input()
    monkeypatch.setattr(tmcl, 'DEVICE_MIN_N', 0)
    parts, iters, _ = tmcl.run_mcl_partitions(m, W.DENSE_INFLATIONS,
                                              max_iter=40, device='cpu')
    jparts, jiters, _ = jmcl.run_mcl_partitions(m, W.DENSE_INFLATIONS,
                                                max_iter=40)
    assert parts == jparts and np.array_equal(iters, jiters)
    assert any(p is not None and len(p) > 1 for p in parts)
    for gparts, giters, _ in res['dense']:
        assert gparts == parts
        np.testing.assert_array_equal(giters, iters)


@pytest.mark.parametrize('case', range(len(W.SPARSE_CASES)),
                         ids=[c[0] for c in W.SPARSE_CASES])
def test_sharded_sparse_iterates_bit_equal(two_ranks, case):
    """The column-sharded sparse sweep (n+1 padded to the world where
    odd) against the meshless run_mcl_sparse: iterates, iteration
    counts, converged flags and K shrinks bit-equal on every rank."""
    _, res = two_ranks
    name, n, K, infl, max_iter = W.SPARSE_CASES[case]
    want = tsp.run_mcl_sparse(*W.sparse_input(name, n), n, infl, K=K,
                              max_iter=max_iter, device='cpu')
    if name == 'capped':
        assert want.overflow_cols > 0
    if name == 'mh_worker_n96':
        assert (n + 1) % WORLD and len(want.k_steps[0]) > 1
    for got in res['sparse']:
        idx, val, iters, conv, k_steps, overflow = got[name]
        np.testing.assert_array_equal(idx, want.idx)
        np.testing.assert_array_equal(val, want.val)
        np.testing.assert_array_equal(iters, want.n_iters)
        np.testing.assert_array_equal(conv, want.converged)
        assert k_steps == want.k_steps and overflow == want.overflow_cols


@pytest.mark.parametrize('case', range(len(W.SPARSE_CASES)),
                         ids=[c[0] for c in W.SPARSE_CASES])
def test_sharded_sweep_takes_the_statistic_once_a_step(two_ranks, case):
    """On every rank _sharded_sweep_step calls col_allclose once a step,
    on the rank's whole share of the columns (N = n+1 padded to the
    world, split evenly), whatever the column chunk; the iterates stay
    the meshless run's (test_sharded_sparse_iterates_bit_equal)."""
    _, res = two_ranks
    name, n, K, infl, max_iter = W.SPARSE_CASES[case]
    share = -(-(n + 1) // WORLD)
    for got in res['sparse']:
        calls = got['_calls'][name]
        assert calls['steps'] > 1
        assert calls['stat_columns'] == [share] * calls['steps']


def test_group_sharded_ga_equals_single(two_ranks):
    """Four groups in two batches (shares 2 / 1 and 1 / 0): every group's
    order, ori, score and history equal the single-process run's."""
    _, res = two_ranks
    problems, hots = W.ga_inputs()
    assert len(topt._batches(problems, W.GA_KW['npop'],
                             topt.CHUNK)) == 2
    want = topt.optimize_tours(problems, hot_starts=hots, **W.GA_KW)
    for got in res['ga']:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.order, w.order)
            np.testing.assert_array_equal(g.ori, w.ori)
            assert g.score == w.score and g.history == w.history
            assert len(w.history) == 3


def test_whole_matrix_sweep_equals_meshless(two_ranks):
    """mcl_sweep_sharded: every rank gets the full matrices of run_mcl,
    bit for bit."""
    _, res = two_ranks
    want = tmcl.run_mcl(W.dense_input(), W.DENSE_INFLATIONS[:3],
                        max_iter=40, device='cpu', device_min_n=0)
    for got in res['whole']:
        mats, iters, conv = got['sweep']
        np.testing.assert_array_equal(mats, want.matrices)
        np.testing.assert_array_equal(iters, want.n_iters)
        np.testing.assert_array_equal(conv, want.converged)


def test_row_sharded_matrix_equals_meshless(two_ranks):
    """mcl_sharded_matrix (rows 24 / 24, column sums all-reduced) ends
    at the meshless matrix to f32 rounding, with the same clusters."""
    _, res = two_ranks
    m = W.dense_input()
    want = tmcl.run_mcl(m, [2.0], max_iter=40, device='cpu',
                        device_min_n=0).matrices[0]
    part = tmcl.interpret_result(want)
    assert part is not None and len(part) > 1
    for got in res['whole']:
        np.testing.assert_allclose(got['matrix'], want, rtol=1e-5,
                                   atol=1e-6)
        assert tmcl.interpret_result(got['matrix']) == part


def test_population_sharded_evolution_equals_meshless(two_ranks):
    """evolve_sharded (rows 5 / 5 scored per rank, scores gathered for
    the selection) equals the full-scoring evolution in one process
    from the same identity population and generator."""
    _, res = two_ranks
    p = W.toy_problem(0, 16, 400)
    pa, pb, d, w, _ = topt._pad_records(p, topt._effective_chunk(
        p.n_records))
    rec = topt._Records(torch.as_tensor(p.lengths[None]),
                        torch.as_tensor(pa[None]),
                        torch.as_tensor(pb[None]), torch.as_tensor(d[None]),
                        torch.as_tensor(w[None]))
    order = torch.arange(16, dtype=torch.int32).expand(1, 10, 16)
    gen = torch.Generator()
    gen.manual_seed(3)
    o, r, s = topt._evolve_impl(topt._Draws(gen, 1), rec,
                                order.contiguous(), torch.zeros_like(order),
                                0.2, 8)
    for got in res['whole']:
        go, gr, gs = got['evolve']
        np.testing.assert_array_equal(go, o[0].numpy())
        np.testing.assert_array_equal(gr, r[0].numpy())
        np.testing.assert_array_equal(gs, s[0].numpy())
        assert np.all(np.sort(go, axis=1) == np.arange(16))
        assert np.all(np.diff(gs) <= 0)


def _single_tree(tmp, name, ga_backend, jax_package=False):
    cfg = W.pipeline_config(ga_backend)
    out = tmp / name
    if not out.exists():
        fa, pairs = str(tmp / 'asm.fa'), str(tmp / 'hic.pairs')
        if jax_package:
            from haphic_tpu.pipeline import PipelineConfig
            jcfg = PipelineConfig()
            for f in vars(cfg):
                if f not in ('reassign', 'device', 'mesh'):
                    setattr(jcfg, f, getattr(cfg, f))
            jcfg.use_mesh = 'off'
            for f in vars(cfg.reassign):
                setattr(jcfg.reassign, f, getattr(cfg.reassign, f))
            jrun_pipeline(fa, pairs, 3, cfg=jcfg, outdir=str(out))
        else:
            run_pipeline(fa, pairs, 3, cfg=cfg, outdir=str(out))
    return out


@pytest.mark.parametrize('case', ['pipeline_device', 'pipeline_auto'])
def test_sharded_pipeline_trees_byte_equal(two_ranks, case):
    """run_pipeline(use_mesh='on') on two ranks, on the genome of
    tests/test_multiprocess.py with remove_allelic_links=2: each rank's
    01.cluster ... 04.build is byte-equal to the single-process port
    tree (the device GA forced), and at the default GA route also to
    haphic_tpu's single-process tree."""
    tmp, res = two_ranks
    assert all(r == {'mesh': True, 'world': WORLD} for r in res[case])
    backend = case.split('_', 1)[1]
    want = [_single_tree(tmp, 'single_' + backend, backend)]
    if backend == 'auto':
        want.append(_single_tree(tmp, 'jax_single', backend,
                                 jax_package=True))
    for rank in range(WORLD):
        got = tmp / ('mesh_' + case + ('.rank{}'.format(rank)
                                       if rank else ''))
        for w in want:
            assert _assert_trees_equal(w, got, STAGES) > 20

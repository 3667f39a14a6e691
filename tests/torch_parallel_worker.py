"""One rank of the port's multi-process tests (tests/test_torch_parallel.py):
a torch.distributed gloo process on the CPU, joined through a file
store. Usage:

    python tests/torch_parallel_worker.py <rank> <world> <store> <workdir>

Each rank runs every case of CASES over the default group and pickles
its results to <workdir>/r<rank>_<case>.pkl; the pipeline cases write
their trees to <workdir>/mesh_<case> (rank 0) and
<workdir>/mesh_<case>.rank<r>. The inputs are built here from seeds, so
the test builds the same ones for the meshless runs. Imports no JAX.
"""

import itertools
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# sparse MCL inputs: (name, n, K, inflations, max_iter)
SPARSE_CASES = [('mh_worker_n96', 96, 32, [1.2, 2.0], 60),
                ('even_n_plus_1', 111, 32, [1.3, 1.8, 2.6], 60),
                ('capped', 64, 8, [1.4, 2.2], 60)]
DENSE_INFLATIONS = [1.1 + 0.2 * t for t in range(7)]
GA_KW = dict(npop=12, ngen=60, log_every=30, seed=5, backend='device',
             device='cpu')


def ingest_inputs():
    """The 17-chunk fixture of tests/test_ingest_sharded.py, in the
    port's classes: (asm, frags, chunks)."""
    from haphic_tpu_torch.core.fragments import build_fragments
    from haphic_tpu_torch.io.fasta import Assembly
    from haphic_tpu_torch.io.pairs import AlignChunk
    rng = np.random.default_rng(3)
    n_ctg = 10
    names = ['ctg%02d' % t for t in range(n_ctg)]
    lengths = rng.integers(30000, 120000, size=n_ctg).astype(np.int64)
    asm = Assembly(names=names,
                   name2id={c: t for t, c in enumerate(names)},
                   lengths=lengths,
                   re_sites=np.ones(n_ctg, np.int64), seqs=None,
                   input_order={c: t for t, c in enumerate(names)})
    frags = build_fragments(asm, nchrs=2, Nx=100, bin_size_kbp=0,
                            flank_kbp=0)

    def chunks():
        r = np.random.default_rng(5)
        for _ in range(17):
            sz = int(r.integers(50, 400))
            ref = r.integers(0, n_ctg, sz).astype(np.int32)
            mref = r.integers(0, n_ctg, sz).astype(np.int32)
            pos = r.integers(0, lengths[ref] - 1).astype(np.int64)
            mpos = r.integers(0, lengths[mref] - 1).astype(np.int64)
            yield AlignChunk(ref=ref, mref=mref, pos=pos, mpos=mpos)

    return asm, frags, chunks


INGEST_KW = dict(need_coords=True, keep_clm=True, max_read_pairs=5,
                 track_ctg_pair_to_frag=True)


def dense_input():
    """A 48-fragment symmetric link matrix with self loops (the dense
    case of __graft_entry__.dryrun_multichip)."""
    rng = np.random.default_rng(0)
    n = 48
    m = np.zeros((n, n), np.float32)
    for i, j in rng.integers(0, n, size=(300, 2)):
        if i != j:
            m[i, j] = m[j, i] = rng.integers(1, 40)
    np.fill_diagonal(m, 1.0)
    return m


def sparse_input(name, n):
    """Upper-triangle COO (i, j, w) of one SPARSE_CASES input."""
    if name == 'mh_worker_n96':
        # tests/mh_worker.py:54-66
        rng = np.random.default_rng(5)
        i = rng.integers(0, n, 700)
        off = rng.integers(1, 6, 700)
        j = np.minimum(i + off, n - 1)
        return i, j, rng.integers(1, 20, 700).astype(np.float64)
    rng = np.random.default_rng(n)
    if name == 'capped':
        # dense columns: most are wider than K = 8
        a, b = np.triu_indices(n, 1)
        keep = rng.random(len(a)) < 0.4
        return a[keep], b[keep], rng.integers(1, 30, keep.sum()).astype(
            np.float64)
    # four diagonal blocks plus noise
    a, b = rng.integers(0, n, (2, 6 * n))
    blk = (a // 28 == b // 28) | (rng.random(len(a)) < 0.1)
    a, b = a[blk & (a != b)], b[blk & (a != b)]
    return (np.minimum(a, b), np.maximum(a, b),
            rng.integers(1, 20, len(a)).astype(np.float64))


def toy_problem(seed, k, R):
    """A random tour problem (the JAX package's __graft_entry__
    _toy_problem, in the port's TourProblem)."""
    from haphic_tpu_torch.order.optimize import TourProblem
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20000, 90000, size=k).astype(np.int64)
    a = rng.integers(0, k - 1, size=R).astype(np.int32)
    b = (a + rng.integers(1, k - 1, size=R)).astype(np.int32) % k
    a2, b2 = np.minimum(a, b), np.maximum(a, b)
    keep = a2 < b2
    a2, b2 = a2[keep], b2[keep]
    pa = rng.integers(0, lengths[a2])
    pb = rng.integers(0, lengths[b2])
    d = np.stack([lengths[a2] - pa + pb,
                  lengths[a2] - pa + lengths[b2] - pb,
                  pa + pb, pa + lengths[b2] - pb]).astype(np.float32)
    return TourProblem(lengths=lengths, pair_a=a2, pair_b=b2, d=d,
                       w=rng.integers(1, 4, len(a2)).astype(np.float32))


def ga_inputs():
    """Three groups of one bucket (k_pad 16, R_pad 512) and one of
    another (k_pad 8), with a hot start on two of them: over two ranks
    the shares are 2 / 1 and 1 / 0."""
    problems = [toy_problem(10, 12, 300), toy_problem(11, 6, 200),
                toy_problem(12, 14, 400), toy_problem(13, 10, 350)]
    hots = [None, None, (np.arange(14, dtype=np.int32)[::-1].copy(),
                         np.zeros(14, np.int32)), None]
    hots[3] = (np.roll(np.arange(10, dtype=np.int32), 3),
               (np.arange(10) % 2).astype(np.int32))
    return problems, hots


def pipeline_config(ga_backend):
    """tests/mh_worker.py's configuration, in the port, with the mesh
    asked for."""
    from haphic_tpu_torch.assign.reassign import ReassignParams
    from haphic_tpu_torch.pipeline import PipelineConfig
    return PipelineConfig(
        Nx=100, RE_site_cutoff=0, density_lower='0', density_upper='1',
        rank_sum_upper='1', flank=0, ngen=50, npop=16,
        remove_allelic_links=2, device='cpu', ga_backend=ga_backend,
        reassign=ReassignParams(min_group_len=0, min_RE_sites=0,
                                min_links=1))


def _links_arrays(ld):
    out = {'frag_links': ld.frag_links}
    for f in ('full', 'flank', 'ht', 'ctg_pair_to_frag'):
        c = getattr(ld, f)
        out[f] = (c.i, c.j, c.w)
    out['clm'] = (ld.clm.pair_i, ld.clm.pair_j, ld.clm.d, ld.clm.u_keys,
                  ld.clm.u_first_seen)
    c = ld.coords
    out['coords'] = (c.pair_i, c.pair_j, c.ci, c.cj, c.total_counts_i,
                     c.total_counts, c.starts, c.counts, c.okey)
    return out


def run_case(case, mesh, workdir):
    from haphic_tpu_torch.cluster import mcl as tmcl
    from haphic_tpu_torch.cluster import sparse_mcl as sp
    from haphic_tpu_torch.order import optimize as topt
    from haphic_tpu_torch.parallel import ingest, mesh as pmesh
    if case == 'ingest':
        asm, frags, chunks = ingest_inputs()
        return _links_arrays(ingest.distributed_aggregate(
            chunks(), frags, mesh, **INGEST_KW))
    if case == 'ingest_one_chunk':
        # one chunk: every rank but rank 0 consumes nothing
        asm, frags, chunks = ingest_inputs()
        return _links_arrays(ingest.distributed_aggregate(
            itertools.islice(chunks(), 1), frags, mesh, **INGEST_KW))
    if case == 'dense':
        keep = tmcl.DEVICE_MIN_N
        tmcl.DEVICE_MIN_N = 0          # the torch sweep, not numpy
        try:
            return pmesh.mcl_sweep_sharded_partitions(
                mesh, dense_input(), DENSE_INFLATIONS, max_iter=40)
        finally:
            tmcl.DEVICE_MIN_N = keep
    if case == 'sparse':
        # the sharded steps, and the statistic's calls with their columns
        calls = {'steps': 0, 'stat_columns': []}
        step, stat = sp._sharded_sweep_step, sp.col_allclose

        def counted_step(*args, **kw):
            calls['steps'] += 1
            return step(*args, **kw)

        def counted_stat(*args, **kw):
            calls['stat_columns'].append(int(args[0].shape[1]))
            return stat(*args, **kw)
        out = {'_calls': {}}
        for name, n, K, infl, max_iter in SPARSE_CASES:
            calls.update(steps=0, stat_columns=[])
            sp._sharded_sweep_step, sp.col_allclose = counted_step, counted_stat
            try:
                res = sp.run_mcl_sparse(*sparse_input(name, n), n, infl,
                                        K=K, max_iter=max_iter,
                                        device='cpu', mesh=mesh)
            finally:
                sp._sharded_sweep_step, sp.col_allclose = step, stat
            out[name] = (res.idx, res.val, res.n_iters, res.converged,
                         res.k_steps, res.overflow_cols)
            out['_calls'][name] = dict(calls)
        return out
    if case == 'ga':
        problems, hots = ga_inputs()
        return topt.optimize_tours(problems, hot_starts=hots, mesh=mesh,
                                   **GA_KW)
    if case == 'whole':
        # the functions no command calls: full matrices, one row-sharded
        # matrix, one population-sharded group
        m = dense_input()
        keep = tmcl.DEVICE_MIN_N
        tmcl.DEVICE_MIN_N = 0
        try:
            sweep = pmesh.mcl_sweep_sharded(mesh, m, DENSE_INFLATIONS[:3],
                                            max_iter=40)
        finally:
            tmcl.DEVICE_MIN_N = keep
        one = pmesh.mcl_sharded_matrix(mesh, m, 2.0, max_iter=40)
        evo = pmesh.evolve_sharded(mesh, toy_problem(0, 16, 400), npop=10,
                                   ngen=8, seed=3)
        return {'sweep': (sweep.matrices, sweep.n_iters, sweep.converged),
                'matrix': one, 'evolve': evo}
    if case.startswith('pipeline_'):
        from haphic_tpu_torch.cli import _rank_outdir
        from haphic_tpu_torch.pipeline import run_pipeline
        cfg = pipeline_config(case.split('_', 1)[1])
        cfg.use_mesh = 'on'
        out = _rank_outdir(os.path.join(workdir, 'mesh_' + case), mesh.rank)
        res = run_pipeline(os.path.join(workdir, 'asm.fa'),
                           os.path.join(workdir, 'hic.pairs'), 3, cfg=cfg,
                           outdir=out)
        return {'mesh': cfg.mesh is not None,
                'world': None if cfg.mesh is None else cfg.mesh.world}
    raise ValueError(case)


CASES = ['ingest', 'ingest_one_chunk', 'dense', 'sparse', 'ga', 'whole', 'pipeline_device',
         'pipeline_auto']


def main():
    rank, world, store, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    import torch
    torch.set_num_threads(1)
    from haphic_tpu_torch.parallel import mesh as pmesh
    pmesh.init_distributed('cpu', init_method='file://' + store,
                           rank=rank, world_size=world)
    mesh = pmesh.make_mesh('cpu')
    assert mesh.backend == 'gloo' and mesh.world == world
    for case in CASES:
        res = run_case(case, mesh, workdir)
        with open(os.path.join(workdir, 'r{}_{}.pkl'.format(rank, case)),
                  'wb') as f:
            pickle.dump(res, f)
    pmesh.shutdown_distributed()
    print('WORKER_OK', rank, flush=True)


if __name__ == '__main__':
    main()

"""Parity of the port's sparse top-K MCL engine
(haphic_tpu_torch.cluster.sparse_mcl) with the JAX package's, on the
CPU, on the block matrices of tests/test_sparse_mcl.py.

Tolerances: the ELL layout (host numpy in both) is bit-equal. One
first iteration, pre-expansion or sweep step agrees to rtol=1e-5,
atol=1e-7 on the dense reconstruction, with equal sets of entries above
1e-6: both run f32, but the run sums (cumsum), the column sums and
exp/log round differently (PyTorch's CPU cumsum accumulates in f64,
XLA's in f32). Whole sweeps must give equal partitions, iteration
counts and K shrinks, and the cluster files must be byte-equal."""

import importlib
import logging
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haphic_tpu.cluster import sparse_mcl as jsp
from haphic_tpu.cluster import sweep as jsweep

from haphic_tpu_torch.cluster import sparse_mcl as tsp
from haphic_tpu_torch.cluster import sweep as tsweep

from . import util
from .test_sparse_mcl import _block_matrix, _ell_to_dense, _to_coo

# xdist runs several test files at once on the same cores; torch's
# default of one intra-op thread per core then oversubscribes them.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
KEPT = 1e-6              # entries above this must be kept by both
INFLATIONS = [1.2, 1.5, 2.0, 2.8]


def _dense(idx, val, n):
    """Dense (..., n, n) reconstruction of (..., n+1, K) ELL iterates."""
    idx, val = np.asarray(idx), np.asarray(val)
    lead = idx.shape[:-2]
    flat_i = idx.reshape((-1,) + idx.shape[-2:])
    flat_v = val.reshape((-1,) + val.shape[-2:])
    out = np.stack([_ell_to_dense(a, b, n) for a, b in zip(flat_i, flat_v)])
    return out.reshape(lead + (n, n))


def _assert_close(got_i, got_v, want_i, want_v, n):
    got, want = _dense(got_i, got_v, n), _dense(want_i, want_v, n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got > KEPT, want > KEPT)
    # the sentinel column n stays empty on both sides
    assert (np.asarray(got_i)[..., n, :] == n).all()
    assert (np.asarray(got_v)[..., n, :] == 0).all()


def _ell(n, K, seed):
    """ELL idx/val of a 4-block matrix (tests/test_sparse_mcl.py)."""
    i, j, w = _to_coo(_block_matrix(n=n, n_blocks=4, seed=seed))
    return jsp.coo_to_ell(i, j, w, n, K)[:2]


@pytest.mark.parametrize('n,K,seed', [(32, 32, 1), (96, 16, 2), (60, 8, 5)],
                         ids=['exact', 'capped', 'capped-narrow'])
def test_coo_to_ell_bit_equal(n, K, seed):
    m = _block_matrix(n=n, n_blocks=3, seed=seed)
    i, j, w = _to_coo(m)
    # duplicates and a mixed triangle: collapsed the same way
    i = np.concatenate([i, j[:20]])
    j = np.concatenate([j, i[:20]])
    w = np.concatenate([w, np.arange(1.0, 21.0)])
    want = jsp.coo_to_ell(i, j, w, n, K)
    got = tsp.coo_to_ell(i, j, w, n, K)
    assert got[2] == want[2]
    assert (got[2] > 0) == (K < n)
    for a, b in zip(got[:2], want[:2]):
        a = a.numpy()
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))


@pytest.mark.parametrize('K', [96, 40], ids=['K=n', 'capped'])
def test_first_iteration_matches_jax(K):
    n = 96
    idx0, val0 = _ell(n, K, seed=2)
    infl = np.asarray(INFLATIONS, np.float32)
    wi, wv = jsp._first_iteration(jnp.asarray(idx0), jnp.asarray(val0),
                                  jnp.asarray(infl), n, K, 1e-4)
    gi, gv = tsp._first_iteration(torch.as_tensor(idx0),
                                  torch.as_tensor(val0),
                                  torch.as_tensor(infl), n, K, 1e-4)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    _assert_close(gi.numpy(), gv.numpy(), wi, wv, n)


@pytest.mark.parametrize('K', [24, 10], ids=['K=n', 'capped'])
def test_pre_expand_matches_jax_and_matrix_power(K):
    """Each _pre_expand from the same input (JAX's previous iterate)
    matches JAX's; the port's own iterates, e-1 pre-expansions from the
    base, equal with K = n the column-normalized A^e for e = 2..4 (the
    tolerance of tests/test_sparse_mcl.py:147)."""
    n = 24
    m = _block_matrix(n=n, n_blocks=2, seed=7)
    i, j, w = _to_coo(m)
    idx, val, _ = jsp.coo_to_ell(i, j, w, n, K=K)
    base = _ell_to_dense(idx, val, n)
    expected = base.copy()
    ji, jv = jnp.asarray(idx), jnp.asarray(val)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    cur_j, cur_t = (ji, jv), (ti, tv)
    for e in range(2, 5):
        same = tuple(torch.as_tensor(np.array(x)) for x in cur_j)
        one = tsp._pre_expand(ti, tv, *same, n, K, 8)
        cur_j = jsp._pre_expand(ji, jv, *cur_j, n, K, 8)
        _assert_close(one[0].numpy(), one[1].numpy(), *cur_j, n)
        cur_t = tsp._pre_expand(ti, tv, *cur_t, n, K, 8)
        expected = base @ expected
        if K == n:
            got = _ell_to_dense(cur_t[0].numpy(), cur_t[1].numpy(), n)
            np.testing.assert_allclose(got, expected, rtol=2e-3,
                                       atol=1e-6), e


@pytest.mark.parametrize('K', [96, 48], ids=['K=n', 'capped'])
def test_sweep_step_matches_jax_with_a_frozen_inflation(K):
    """One sweep step from the same first-iteration state (JAX's), with
    the second inflation frozen: the active ones agree with JAX, the
    frozen one passes through bit for bit, the statistic of the active
    ones agrees, and max_nnz (over the whole batch) is equal."""
    n = 96
    idx0, val0 = _ell(n, K, seed=2)
    infl = np.asarray(INFLATIONS[:3], np.float32)
    pi, pv = jsp._pre_expand(jnp.asarray(idx0), jnp.asarray(val0),
                             jnp.asarray(idx0), jnp.asarray(val0), n, K, 32)
    si, sv = jsp._first_iteration(pi, pv, jnp.asarray(infl), n, K, 1e-4)
    active = np.array([True, False, True])
    wi, wv, wstat, wnz = jsp._sweep_step(si, sv, jnp.asarray(infl),
                                         jnp.asarray(active), n, K, 32,
                                         1e-4, 2)
    ti = torch.as_tensor(np.array(si))
    tv = torch.as_tensor(np.array(sv))
    gi, gv, gstat, gnz = tsp._sweep_step(ti, tv, torch.as_tensor(infl),
                                         active, n, K, 32, 1e-4, 2)
    # the inputs are left as they were
    assert np.array_equal(ti.numpy(), np.asarray(si))
    assert np.array_equal(tv.numpy(), np.asarray(sv))
    _assert_close(gi.numpy(), gv.numpy(), wi, wv, n)
    assert np.array_equal(gi[1].numpy(), np.asarray(si)[1])
    assert np.array_equal(gv[1].numpy(), np.asarray(sv)[1])
    np.testing.assert_allclose(gstat.numpy()[active],
                               np.asarray(wstat)[active], rtol=RTOL,
                               atol=ATOL)
    assert gstat[1] == -np.inf
    assert int(gnz) == int(wnz)


def _shrinks(caplog, logger_name):
    return [r.getMessage().rsplit('shrinking K ', 1)[1]
            for r in caplog.records
            if r.name == logger_name and 'shrinking K' in r.getMessage()]


def _both_sparse(caplog, i, j, w, n, inflations, **kw):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        want = jsp.run_mcl_sparse(i, j, w, n, inflations, **kw)
        got = tsp.run_mcl_sparse(i, j, w, n, inflations, device='cpu', **kw)
    assert np.array_equal(got.n_iters, want.n_iters)
    assert np.array_equal(got.converged, want.converged)
    assert (got.K, got.overflow_cols) == (want.K, want.overflow_cols)
    assert got.idx.shape == want.idx.shape
    for b in range(len(inflations)):
        assert got.interpret(b) == want.interpret(b), b
    # the K shrinks, as each package logs them
    shrinks = _shrinks(caplog, tsp.logger.name)
    assert shrinks == _shrinks(caplog, jsp.logger.name)
    assert shrinks == ['{} -> {}'.format(a, b) for ks in got.k_steps
                       for a, b in zip(ks, ks[1:])]
    return want, got


@pytest.mark.parametrize('K_mode', ['exact', 'capped'])
def test_run_mcl_sparse_matches_jax(caplog, K_mode):
    """The cases of tests/test_sparse_mcl.py:61, port against JAX."""
    m = _block_matrix(n=96, n_blocks=4, seed=2)
    n = m.shape[0]
    i, j, w = _to_coo(m)
    K = n if K_mode == 'exact' else 48
    _, got = _both_sparse(caplog, i, j, w, n, INFLATIONS, K=K, max_iter=80)
    assert got.batches == [4]
    assert all(p is not None for p in map(got.interpret, range(4)))


def test_expansion_3_matches_jax(caplog):
    """tests/test_sparse_mcl.py:184, port against JAX."""
    m = _block_matrix(n=48, n_blocks=2, seed=4)
    i, j, w = _to_coo(m)
    _, got = _both_sparse(caplog, i, j, w, 48, [1.6], K=48, expansion=3,
                          max_iter=80)
    assert got.interpret(0) is not None


def test_adaptive_shrink_matches_jax(caplog):
    """Three K shrinks on inflation batches of 4 and 1 (the last batch
    shorter, where JAX pads it): the same shrink sequence, iteration
    counts and partitions as JAX."""
    m = _block_matrix(n=160, n_blocks=5, seed=9)
    i, j, w = _to_coo(m)
    want, got = _both_sparse(caplog, i, j, w, 160,
                             [1.3, 1.6, 2.0, 2.4, 3.0], K=128, max_iter=80)
    assert got.batches == [4, 1]
    assert max(len(ks) for ks in got.k_steps) == 4      # 3 shrinks
    assert all(ks[-1] >= 16 for ks in got.k_steps)
    assert got.idx.shape[-1] == 128                    # padded back


def _sim_frags(seed=5):
    """A 60-fragment block matrix over 60 one-fragment contigs
    (tests/test_sparse_mcl.py:88). The port's run_clustering takes the
    JAX package's COO and Fragments as they are (duck typing, as in
    tests/test_torch_mcl.py)."""
    from haphic_tpu.core.contacts import COO
    from haphic_tpu.core.fragments import build_fragments
    from haphic_tpu.io.fasta import Assembly

    m = _block_matrix(n=60, n_blocks=3, seed=seed)
    n = m.shape[0]
    names = ['c%02d' % t for t in range(n)]
    asm = Assembly(names=names,
                   name2id={c: t for t, c in enumerate(names)},
                   lengths=np.full(n, 50000, np.int64),
                   re_sites=np.ones(n, np.int64), seqs=None,
                   input_order={c: t for t, c in enumerate(names)})
    frags = build_fragments(asm, nchrs=3, Nx=100, bin_size_kbp=0,
                            flank_kbp=0)
    i, j, w = _to_coo(m)
    return COO(i=i, j=j, w=w), frags, n


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def test_run_clustering_sparse_matches_jax(tmp_path):
    """run_clustering(mcl_backend='sparse') against JAX's (the case of
    tests/test_sparse_mcl.py:88): equal cluster sets and recommendation,
    byte-equal cluster files and sparse_mcl_info.txt."""
    flank, frags, n = _sim_frags()
    kw = dict(max_iter=80, min_inflation=1.2, max_inflation=2.0,
              mcl_backend='sparse', sparse_K=n)
    jout, tout = tmp_path / 'jax', tmp_path / 'torch'
    jout.mkdir()
    tout.mkdir()
    want = jsweep.run_clustering(flank, np.arange(n), frags, 3,
                                 outdir=str(jout), **kw)
    got = tsweep.run_clustering(flank, np.arange(n), frags, 3,
                                outdir=str(tout), device='cpu', **kw)
    assert {cs.inflation: cs.clusters for cs in got.cluster_sets} == \
        {cs.inflation: cs.clusters for cs in want.cluster_sets}
    assert got.recommended_inflation == want.recommended_inflation
    assert got.recommended_inflation is not None
    jf, tf = _files(jout), _files(tout)
    assert sorted(tf) == sorted(jf)
    assert any(p.name == 'sparse_mcl_info.txt' for p in jf)
    assert len(jf) > 5
    for rel in jf:
        assert tf[rel] == jf[rel], rel


def test_sparse_default_device_raises_without_card(monkeypatch):
    """No CPU fallback: without a card the default device raises, on the
    sparse route as on the dense one."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    flank, frags, n = _sim_frags()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tsweep.run_clustering(flank, np.arange(n), frags, 3,
                              mcl_backend='sparse', write_files=False)
    i, j, w = _to_coo(_block_matrix(n=16, n_blocks=2, seed=1))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tsp.run_mcl_sparse(i, j, w, 16, [2.0])


SIM_FLAGS = ['--Nx', '100', '--RE_site_cutoff', '0', '--density_lower', '0',
             '--density_upper', '1', '--rank_sum_upper', '1', '--flank', '0',
             '--min_group_len', '0', '--min_RE_sites', '0', '--min_links',
             '1', '--steps', '1']


@pytest.fixture(scope='module')
def make_sim_genome(tmp_path_factory):
    """The genome tests/make_sim.py writes by default (3 chromosomes x 5
    contigs of 8 kb, 24,000 pairs, seed 12345)."""
    tmp = tmp_path_factory.mktemp('sparse_sim')
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(12345), nchrs=3, ctgs_per_chr=5, ctg_len=8000,
        n_pairs=8000 * 3 * 5 // 5)
    util.write_genome(str(tmp / 'asm.fa'), ctgs)
    util.write_pairs(str(tmp / 'hic.pairs'), recs)
    return tmp


def _cli_cluster_both(tmp, name, extra):
    from haphic_tpu.cli import main as jmain

    from haphic_tpu_torch.cli import main as tmain
    args = [str(tmp / 'asm.fa'), str(tmp / 'hic.pairs'), '3']
    jout, tout = tmp / (name + '_jax'), tmp / (name + '_torch')
    assert jmain(['pipeline', *args, '--outdir', str(jout), *SIM_FLAGS,
                  *extra]) == 0
    assert tmain(['pipeline', *args, '--outdir', str(tout), '--device',
                  'cpu', *SIM_FLAGS, *extra]) == 0
    jf = _files(jout / '01.cluster')
    tf = _files(tout / '01.cluster')
    assert sorted(tf) == sorted(jf)
    for rel in jf:
        assert tf[rel] == jf[rel], rel
    return jf


def test_pipeline_sparse_cluster_dir_byte_equal(make_sim_genome):
    """`pipeline --mcl_backend sparse --device cpu` writes 01.cluster/
    byte-equal to haphic_tpu's, sparse_mcl_info.txt included."""
    jf = _cli_cluster_both(make_sim_genome, 'sparse',
                           ['--mcl_backend', 'sparse'])
    info = [rel for rel in jf if rel.name == 'sparse_mcl_info.txt']
    assert len(info) == 1
    assert b'exact\tyes' in jf[info[0]]
    assert any(rel.name.startswith('mcl_inflation_') for rel in jf)


@pytest.fixture
def sparse_min_n(monkeypatch):
    """Sets HAPHIC_SPARSE_MCL_MIN_N and reloads both sweep modules,
    which read it at load; restores both afterwards."""
    def apply(value):
        monkeypatch.setenv('HAPHIC_SPARSE_MCL_MIN_N', str(value))
        importlib.reload(jsweep)
        importlib.reload(tsweep)
    yield apply
    monkeypatch.undo()
    importlib.reload(jsweep)
    importlib.reload(tsweep)


def test_auto_routes_to_sparse_below_the_environment_threshold(
        make_sim_genome, sparse_min_n):
    """With HAPHIC_SPARSE_MCL_MIN_N below the fragment count, the
    default `auto` backend takes the sparse engine in both packages."""
    assert jsweep.SPARSE_MIN_N == tsweep.SPARSE_MIN_N == 20000
    sparse_min_n(4)
    assert jsweep.SPARSE_MIN_N == tsweep.SPARSE_MIN_N == 4
    jf = _cli_cluster_both(make_sim_genome, 'auto', [])
    assert any(rel.name == 'sparse_mcl_info.txt' for rel in jf)

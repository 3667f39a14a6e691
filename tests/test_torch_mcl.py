"""Parity of the port's MCL sweep (haphic_tpu_torch.cluster) with the
JAX package's, on the cases of tests/test_mcl.py, on the CPU.

Partitions and iteration counts must be equal. Final matrices agree to
rtol=1e-4, atol=1e-7: both run f32, but the matmul sums run in another
order (XLA:CPU vs PyTorch's CPU BLAS). The labels route that reads the
final matrices on the card (kernels/mcl_interpret, then
partition_from_labels), run here through its plain version, must give
the JAX package's interpret_result on the cases of
tests/test_torch_mcl_interpret.py."""

import random

import numpy as np
import pytest
import torch

from haphic_tpu.cluster import mcl as jmcl
from haphic_tpu.cluster import sweep as jsweep

from haphic_tpu_torch.cluster import mcl as tmcl
from haphic_tpu_torch.cluster import sweep as tsweep

from . import util
from .test_mcl import _random_block_matrix
from .test_torch_mcl_interpret import (CONVERGED, PLANTED, SEEDED,
                                       converged_matrices, partitions,
                                       seeded_pair)

# xdist runs several test files at once on the same cores; torch's
# default of one intra-op thread per core then oversubscribes them and
# the many small ops of the GA and MCL loops wait on each other.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-7


def _both(mat, inflations, device_min_n, **kw):
    want = jmcl.run_mcl(mat, inflations, device_min_n=device_min_n, **kw)
    got = tmcl.run_mcl(mat, inflations, device_min_n=device_min_n,
                       device='cpu', **kw)
    return want, got


def _assert_same(want, got):
    assert np.array_equal(got.n_iters, want.n_iters)
    assert np.array_equal(got.converged, want.converged)
    np.testing.assert_allclose(got.matrices, want.matrices, rtol=RTOL,
                               atol=ATOL)
    for b in range(len(want.n_iters)):
        assert tmcl.interpret_result(got.matrices[b]) == \
            jmcl.interpret_result(want.matrices[b]), b


@pytest.mark.parametrize('device_min_n', [None, 0],
                         ids=['host-numpy', 'torch'])
def test_block_recovery_parity(device_min_n):
    mat = _random_block_matrix(random.Random(3), n_blocks=4, block=10,
                               noise=0.0)
    want, got = _both(mat, [2.0], device_min_n)
    _assert_same(want, got)
    parts = {frozenset(c) for c in tmcl.interpret_result(got.matrices[0])}
    assert parts == {frozenset(range(b * 10, (b + 1) * 10))
                     for b in range(4)}


@pytest.mark.parametrize('device_min_n', [None, 0],
                         ids=['host-numpy', 'torch'])
def test_padding_parity(device_min_n):
    """n=18 is no multiple of anything: the JAX side pads to 128, the
    port does not pad at all; the results must agree."""
    mat = _random_block_matrix(random.Random(11), n_blocks=2, block=9)
    want, got = _both(mat, [1.8], device_min_n)
    _assert_same(want, got)
    covered = sorted(i for c in tmcl.interpret_result(got.matrices[0])
                     for i in c)
    assert covered == list(range(mat.shape[0]))


def _partition_matrix():
    rng = np.random.default_rng(3)
    n, blocks = 96, 4
    m = np.zeros((n, n), dtype=np.float32)
    per = n // blocks
    for b in range(blocks):
        lo = b * per
        w = rng.integers(1, 50, (per, per)).astype(np.float32)
        blk = np.triu(w * (rng.random((per, per)) < 0.5), 1)
        m[lo:lo + per, lo:lo + per] += blk + blk.T
    np.fill_diagonal(m, 1.0)
    return m


def test_partitions_match_matrices_and_jax():
    m = _partition_matrix()
    inflations = [1.3, 1.8, 2.4]
    want_res, got_res = _both(m, inflations, 0, max_iter=60)
    _assert_same(want_res, got_res)
    want = jmcl.run_mcl_partitions(m, inflations, max_iter=60,
                                   device_min_n=0)
    got = tmcl.run_mcl_partitions(m, inflations, max_iter=60,
                                  device_min_n=0, device='cpu')
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])
    assert got[0] == want[0]
    assert np.array_equal(got[1], got_res.n_iters)
    for b in range(len(inflations)):
        assert got[0][b] == tmcl.interpret_result(got_res.matrices[b])


def test_partitions_from_coo_match_jax():
    """The COO input densified on the device gives the JAX partitions."""
    m = _partition_matrix()
    iu, ju = np.nonzero(np.triu(m, 1))
    coo = (iu, ju, m[iu, ju].astype(np.float64), m.shape[0])
    inflations = [1.5, 2.0]
    want = jmcl.run_mcl_partitions(None, inflations, max_iter=60,
                                   device_min_n=0, coo=coo)
    got = tmcl.run_mcl_partitions(None, inflations, max_iter=60,
                                  device_min_n=0, coo=coo, device='cpu')
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])


def test_densify_coo_matches_jax_and_host_build():
    from haphic_tpu_torch.core.contacts import COO
    rng = np.random.default_rng(3)
    m, nnz = 37, 400
    i = rng.integers(0, m, nnz)
    j = rng.integers(0, m, nnz)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    w = rng.integers(1, 9, keep.sum()).astype(np.float64)
    want = np.asarray(jmcl._densify_coo(lo, hi, w, 64, m))[:m, :m]
    got = tmcl.densify_coo(lo, hi, w, m, 'cpu').numpy()
    assert np.array_equal(got, want)
    host, _ = tsweep.build_adjacency(COO(i=lo, j=hi, w=w), np.arange(m), m)
    assert np.array_equal(got, host)


@pytest.mark.parametrize('device_min_n', [1024, 0],
                         ids=['host-numpy', 'torch'])
def test_run_clustering_files_byte_equal(tmp_path, monkeypatch,
                                         device_min_n):
    """Clustered sim genome -> ingest -> MCL sweep: the inflation_*/
    cluster files of both packages are byte-equal."""
    from haphic_tpu.core.contacts import aggregate
    from haphic_tpu.core.fragments import build_fragments
    from haphic_tpu.io.fasta import read_fasta
    from haphic_tpu.io.pairs import PairsReader

    rng = random.Random(5)
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        rng, nchrs=3, ctgs_per_chr=5, n_pairs=20000)
    fa, pr = tmp_path / 'asm.fa', tmp_path / 'hic.pairs'
    util.write_genome(str(fa), ctgs)
    util.write_pairs(str(pr), recs)
    asm = read_fasta(str(fa))
    frags = build_fragments(asm)
    links = aggregate(PairsReader(str(pr), asm.names), frags)
    filtered = np.nonzero(frags.nx_mask)[0]
    monkeypatch.setattr(jmcl, 'DEVICE_MIN_N', device_min_n)
    monkeypatch.setattr(tmcl, 'DEVICE_MIN_N', device_min_n)
    outs = {}
    for name, run in (('jax', jsweep.run_clustering),
                      ('torch', tsweep.run_clustering)):
        out = tmp_path / name
        out.mkdir()
        kw = {'device': 'cpu'} if name == 'torch' else {}
        res = run(links.flank, filtered, frags, nchrs=3, outdir=str(out),
                  **kw)
        outs[name] = (out, res)
    (jout, jres), (tout, tres) = outs['jax'], outs['torch']
    assert tres.recommended_inflation == jres.recommended_inflation
    assert tres.recommended_inflation is not None
    jfiles = sorted(p.relative_to(jout) for p in jout.rglob('*')
                    if p.is_file())
    tfiles = sorted(p.relative_to(tout) for p in tout.rglob('*')
                    if p.is_file())
    assert tfiles == jfiles and jfiles
    for rel in jfiles:
        assert (tout / rel).read_bytes() == (jout / rel).read_bytes(), rel


def _jax_partitions(mats):
    return [jmcl.interpret_result(x) for x in mats]


@pytest.mark.parametrize('seed,n,block', CONVERGED)
def test_labels_route_matches_jax_on_converged_sweeps(seed, n, block):
    mats = converged_matrices(seed, n, block)
    want = _jax_partitions(mats)
    assert any(w is not None for w in want)
    assert partitions(mats) == want


@pytest.mark.parametrize('seed,n', SEEDED)
def test_labels_route_matches_jax_on_seeded_block_matrices(seed, n):
    mats = seeded_pair(seed, n)
    want = _jax_partitions(mats)
    assert want[0] is not None
    assert partitions(mats) == want


@pytest.mark.parametrize('name,m', PLANTED, ids=[c[0] for c in PLANTED])
def test_labels_route_matches_jax_on_planted_cases(name, m):
    assert partitions(m[None]) == _jax_partitions(m[None])

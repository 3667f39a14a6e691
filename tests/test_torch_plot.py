"""The port's contact map (haphic_tpu_torch.post.plot) against the JAX
package's numpy one, on the CPU: bin mapping, the int64 scatter-add and
symmetrisation exact; KR vectors, normalised matrices and vmax within
1e-9 relative; the pickle cache byte-equal and read by both packages;
and run_plot end to end where matplotlib is installed."""

import os
import pickle
import random

import numpy as np
import pytest
import torch

from haphic_tpu.cli import main as jmain
from haphic_tpu.io.pairs import AlignChunk, PairsReader
from haphic_tpu.post import plot as jplot

from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.post import plot as tplot

from . import util

RTOL = 1e-9

torch.set_num_threads(1)


def _write_agp(path, rows):
    with open(path, 'w') as f:
        for r in rows:
            f.write('\t'.join(str(x) for x in r) + '\n')


def _mapping_agp(path):
    """tests/test_plot.py's AGP: 2 groups of 3 contigs with mixed
    orientations (one offset into its contig), a gap line, and an
    unanchored contig as its own group."""
    rows = [
        ('g1', 1, 120000, 1, 'W', 'c1', 1, 120000, '+'),
        ('g1', 120001, 120100, 2, 'U', 100, 'scaffold', 'yes',
         'proximity_ligation'),
        ('g1', 120101, 200000, 3, 'W', 'c2', 1, 79900, '-'),
        ('g2', 1, 90000, 1, 'W', 'c3', 10001, 100000, '+'),
        ('c4', 1, 50000, 1, 'W', 'c4', 1, 50000, '+'),
    ]
    _write_agp(path, rows)
    return str(path)


@pytest.mark.parametrize('min_len,specified', [
    (0, None), (0.08, None), (0, ['c4', 'g1']),
], ids=['all', 'min-len', 'specified'])
def test_map_to_bins_exact(tmp_path, min_len, specified):
    path = _mapping_agp(tmp_path / 't.agp')
    jbi = jplot.build_bins(jplot.parse_agp(path), 10000, min_len, specified)
    tbi = tplot.build_bins(tplot.parse_agp(path), 10000, min_len, specified)
    assert tbi.total_bins == jbi.total_bins
    assert np.array_equal(tbi.group_bin_offset, jbi.group_bin_offset)
    rng = np.random.default_rng(0)
    # positions in and around every contig (c3 starts at raw 10001), and
    # a contig id past the AGP's
    ctg = rng.integers(0, 5, 4000)
    pos = rng.integers(-5, 125000, 4000)
    want = jplot.map_to_bins(jbi, ctg, pos)
    got = tplot.map_to_bins(tbi, torch.as_tensor(ctg), torch.as_tensor(pos))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 1000 and (want < 0).sum() > 100


def _clustered(tmp_path, seed=2, nchrs=2, ctgs_per_chr=3, ctg_len=6000,
               n_pairs=4000, reverse=False):
    """tests/test_plot.py's end-to-end inputs: a clustered genome's
    pairs and an AGP of one scaffold per chromosome (every other contig
    reversed when ``reverse``)."""
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(seed), nchrs=nchrs, ctgs_per_chr=ctgs_per_chr,
        ctg_len=ctg_len, n_pairs=n_pairs)
    pairs = tmp_path / 'hic.pairs'
    util.write_pairs(str(pairs), recs)
    rows = []
    for c in range(nchrs):
        pos = 0
        for i in range(ctgs_per_chr):
            name = 'chr{}_ctg{}'.format(c + 1, i + 1)
            L = len(ctgs[name])
            rows.append(('chr{}'.format(c + 1), pos + 1, pos + L,
                         2 * i + 1, 'W', name, 1, L,
                         '-' if reverse and i % 2 else '+'))
            pos += L
    agp = tmp_path / 's.agp'
    _write_agp(str(agp), rows)
    return str(agp), str(pairs)


def _jax_matrix(agp, pairs, bin_size):
    """haphic_tpu's run_plot up to the symmetrised matrix."""
    ai = jplot.parse_agp(agp)
    bi = jplot.build_bins(ai, bin_size)
    names = sorted(ai.ctg_names)
    remap = np.asarray([ai.ctg_id[c] for c in names], np.int64)

    def chunks():
        for c in PairsReader(pairs, names):
            ok = (c.ref >= 0) & (c.mref >= 0)
            yield AlignChunk(ref=remap[c.ref[ok]], pos=c.pos[ok],
                             mref=remap[c.mref[ok]], mpos=c.mpos[ok])
    raw = jplot.accumulate_contacts(bi, chunks())
    return bi, raw, jplot.symmetrize(raw)


@pytest.mark.parametrize('reverse', [False, True], ids=['fwd', 'mixed'])
def test_accumulate_and_symmetrize_exact(tmp_path, reverse):
    agp, pairs = _clustered(tmp_path, reverse=reverse)
    jbi, jraw, jsym = _jax_matrix(agp, pairs, 2000)
    ai = tplot.parse_agp(agp)
    tbi = tplot.build_bins(ai, 2000)
    names = sorted(ai.ctg_names)
    remap = np.asarray([ai.ctg_id[c] for c in names], np.int64)
    chunks = []
    for c in PairsReader(pairs, names):
        ok = (c.ref >= 0) & (c.mref >= 0)
        chunks.append(AlignChunk(ref=remap[c.ref[ok]], pos=c.pos[ok],
                                 mref=remap[c.mref[ok]], mpos=c.mpos[ok]))
    raw = tplot.accumulate_contacts(tbi, chunks, device='cpu')
    assert raw.dtype == torch.int64
    assert np.array_equal(raw.numpy(), jraw)
    sym = tplot.symmetrize(raw)
    assert np.array_equal(sym.numpy(), jsym)
    assert int(jraw.sum()) > 3000


def _random_contact(seed, n=40):
    """tests/test_plot.py's KR matrices."""
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 50, size=(n, n)).astype(np.float64)
    return m + m.T


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize('seed', [0, 1])
def test_kr_balance_matches(seed):
    m = _random_contact(seed)
    counts = []
    got = tplot.kr_balance(torch.as_tensor(m), counts=counts)
    _close(got, jplot.kr_balance(m))
    assert got.dtype == torch.float64
    assert len(counts) == 1 and counts[0][0] >= 1 and counts[0][1] >= 1


@pytest.mark.parametrize('limit', [{'max_outer': 1}, {'max_inner': 1}],
                         ids=['outer', 'inner'])
def test_kr_balance_limits_raise_as_haphic_tpu(limit):
    m = _random_contact(0)
    with pytest.raises(RuntimeError, match='did not converge') as je:
        jplot.kr_balance(m, **limit)
    with pytest.raises(RuntimeError, match='did not converge') as te:
        tplot.kr_balance(torch.as_tensor(m), **limit)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize('normalization', ['KR', 'log10', 'none'])
@pytest.mark.parametrize('vmax', [-1.0, 7.5], ids=['median', 'manual'])
def test_normalize_matrix_matches(tmp_path, normalization, vmax):
    agp, pairs = _clustered(tmp_path, nchrs=3, ctgs_per_chr=4,
                            ctg_len=6000, n_pairs=12000, reverse=True)
    jbi, _, jsym = _jax_matrix(agp, pairs, 2000)
    tbi = tplot.build_bins(tplot.parse_agp(agp), 2000)
    want, wvmax = jplot.normalize_matrix(jsym, jbi, normalization,
                                         manual_vmax=vmax)
    counts = []
    got, gvmax = tplot.normalize_matrix(torch.as_tensor(jsym), tbi,
                                        normalization, manual_vmax=vmax,
                                        counts=counts)
    assert got.dtype == torch.float64
    _close(got, want)
    assert gvmax == pytest.approx(wvmax, rel=RTOL, abs=0)
    # KR: the whole matrix, then each of the 3 scaffolds
    assert len(counts) == (4 if normalization == 'KR' else 0)


def test_even_count_median():
    """np.median averages the two middle values of an even count;
    torch.median would give the lower one."""
    v = np.asarray([4.0, 1.0, 3.0, 10.0, 2.0, 8.0])
    assert tplot._median(torch.as_tensor(v)) == np.median(v) == 3.5
    assert float(torch.median(torch.as_tensor(v))) == 3.0
    assert tplot._median(torch.as_tensor(v[:5])) == np.median(v[:5])


@pytest.mark.parametrize('normalization', ['log10', 'none'])
def test_vmax_of_even_count_matches(tmp_path, normalization):
    """One scaffold of 2 bins: two off-diagonal cells, vmax from their
    mean."""
    _write_agp(str(tmp_path / 'e.agp'),
               [('s', 1, 1500, 1, 'W', 'c', 1, 1500, '+')])
    contact = np.asarray([[5, 2], [7, 1]], np.int64)
    jbi = jplot.build_bins(jplot.parse_agp(str(tmp_path / 'e.agp')), 1000)
    tbi = tplot.build_bins(tplot.parse_agp(str(tmp_path / 'e.agp')), 1000)
    assert tbi.total_bins == 2
    _, want = jplot.normalize_matrix(contact, jbi, normalization)
    _, got = tplot.normalize_matrix(torch.as_tensor(contact), tbi,
                                    normalization)
    assert got == pytest.approx(want, rel=RTOL, abs=0)
    lo = float(torch.median(torch.as_tensor([2.0, 7.0])))
    assert got != pytest.approx(lo * 5.0)


def test_scaffold_past_quantile_limit(tmp_path):
    """One scaffold of 4,101 bins: 16.8M off-diagonal cells, past the
    2^24 values torch.quantile accepts."""
    _write_agp(str(tmp_path / 'big.agp'),
               [('s', 1, 4100000, 1, 'W', 'c', 1, 4100000, '+')])
    tbi = tplot.build_bins(tplot.parse_agp(str(tmp_path / 'big.agp')), 1000)
    jbi = jplot.build_bins(jplot.parse_agp(str(tmp_path / 'big.agp')), 1000)
    n = tbi.total_bins
    assert n == 4101 and n * (n - 1) > 2 ** 24
    rng = np.random.default_rng(3)
    contact = rng.integers(0, 40, (n, n), dtype=np.int64)
    with pytest.raises(RuntimeError, match='too large'):
        torch.quantile(torch.zeros(n * (n - 1), dtype=torch.float64), 0.5)
    want, wvmax = jplot.normalize_matrix(contact, jbi, 'log10')
    got, gvmax = tplot.normalize_matrix(torch.as_tensor(contact), tbi,
                                        'log10')
    _close(got, want)
    assert gvmax == pytest.approx(wvmax, rel=RTOL, abs=0)


def _jax_cache(agp, pairs, outdir, bin_kbp):
    bi, _, sym = _jax_matrix(agp, pairs, bin_kbp * 1000)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, 'contact_matrix.pkl')
    jplot.save_cache(path, sym, agp, (bin_kbp * 1000, 0, None))
    return path, sym


def test_cache_byte_equal_and_read_by_both(tmp_path):
    agp, pairs = _clustered(tmp_path, reverse=True)
    jpath, jsym = _jax_cache(agp, pairs, str(tmp_path / 'jax'), 2)
    cm = tplot.contact_map(agp, pairs, outdir=str(tmp_path / 'torch'),
                           bin_size_kbp=2, device='cpu')
    tpath = str(tmp_path / 'torch' / 'contact_matrix.pkl')
    with open(tpath, 'rb') as f, open(jpath, 'rb') as g:
        assert f.read() == g.read()
    assert np.array_equal(cm.matrix.numpy(), jsym)
    with open(tpath, 'rb') as f:
        assert type(pickle.load(f)[0]) is np.ndarray
    # each package reads the other's cache
    assert np.array_equal(jplot.load_cache(tpath, agp, (2000, 0, None)),
                          jsym)
    again = tplot.contact_map(agp, jpath, outdir=str(tmp_path / 'again'),
                              bin_size_kbp=2, normalization='log10',
                              device='cpu')
    assert np.array_equal(again.matrix.numpy(), jsym)
    assert not os.path.exists(tmp_path / 'again' / 'contact_matrix.pkl')
    # and refuses it for other parameters, as haphic_tpu does
    with pytest.raises(RuntimeError, match='not consistent'):
        tplot.contact_map(agp, jpath, outdir=str(tmp_path / 'again'),
                          bin_size_kbp=4, device='cpu')


def test_contact_map_matches_normalize(tmp_path):
    """contact_map's KR result and its iteration counts (whole matrix,
    then each scaffold) against haphic_tpu's normalize_matrix."""
    agp, pairs = _clustered(tmp_path, reverse=True)
    jbi, _, jsym = _jax_matrix(agp, pairs, 2000)
    want, wvmax = jplot.normalize_matrix(jsym, jbi, 'KR')
    cm = tplot.contact_map(agp, pairs, outdir=str(tmp_path),
                           bin_size_kbp=2, device='cpu')
    _close(cm.norm, want)
    assert cm.vmax == pytest.approx(wvmax, rel=RTOL, abs=0)
    assert len(cm.kr_iters) == 3
    assert cm.accumulate_s > 0 and cm.normalize_s > 0


def test_run_plot_end_to_end_as_haphic_tpu(tmp_path):
    """tests/test_plot.py::test_run_plot_end_to_end through both
    packages' CLIs: the PDFs drawn, the caches byte-equal, the cache
    reused, wrong parameters refused."""
    pytest.importorskip('matplotlib')
    agp, pairs = _clustered(tmp_path)
    for main, name in ((jmain, 'jax'), (tmain, 'torch')):
        out = tmp_path / name
        dev = ['--device', 'cpu'] if name == 'torch' else []
        assert main(['plot', agp, pairs, '--outdir', str(out),
                     '--bin_size', '2', '--separate_plots'] + dev) == 0
        assert os.path.getsize(out / 'contact_map.pdf') > 0
        assert sorted(os.listdir(out / 'separate_plots')) == \
            ['chr1.pdf', 'chr2.pdf']
        assert main(['plot', agp, str(out / 'contact_matrix.pkl'),
                     '--outdir', str(out), '--bin_size', '2',
                     '--normalization', 'log10', '--out_name',
                     'log.pdf'] + dev) == 0
        assert os.path.getsize(out / 'log.pdf') > 0
        with pytest.raises(RuntimeError, match='not consistent'):
            main(['plot', agp, str(out / 'contact_matrix.pkl'),
                  '--outdir', str(out), '--bin_size', '4'] + dev)
    assert (tmp_path / 'torch' / 'contact_matrix.pkl').read_bytes() == \
        (tmp_path / 'jax' / 'contact_matrix.pkl').read_bytes()

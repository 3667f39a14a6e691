"""The port's contact map (haphic_tpu_torch.post.plot) on the card
against its own run on the CPU: the raw and symmetrised int64 matrices
equal cell for cell, the KR vectors, normalised matrices and vmax within
1e-9 relative, and the same KR iteration counts. It needs a CUDA card,
so it carries the `cuda` marker and skips without one. This file
imports neither JAX nor the JAX package, so it runs on a card host:

    HAPHIC_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_plot_card.py
"""

import random

import numpy as np
import pytest
import torch

from haphic_tpu_torch.io.pairs import AlignChunk
from haphic_tpu_torch.post import plot as tplot

from . import util

RTOL = 1e-9


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the device path runs there')
    return torch.device('cuda')


def _inputs(tmp_path, nchrs, ctgs_per_chr, n_pairs):
    """A clustered genome's pairs and an AGP of one scaffold per
    chromosome, every other contig reversed."""
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(4), nchrs=nchrs, ctgs_per_chr=ctgs_per_chr,
        ctg_len=6000, n_pairs=n_pairs)
    pairs = tmp_path / 'hic.pairs'
    util.write_pairs(str(pairs), recs)
    with open(tmp_path / 's.agp', 'w') as f:
        for c in range(nchrs):
            pos = 0
            for i in range(ctgs_per_chr):
                name = 'chr{}_ctg{}'.format(c + 1, i + 1)
                L = len(ctgs[name])
                f.write('chr{}\t{}\t{}\t{}\tW\t{}\t1\t{}\t{}\n'.format(
                    c + 1, pos + 1, pos + L, 2 * i + 1, name, L,
                    '-' if i % 2 else '+'))
                pos += L
    return str(tmp_path / 's.agp'), str(pairs)


@pytest.mark.cuda
@pytest.mark.parametrize('normalization', ['KR', 'log10', 'none'])
def test_contact_map_on_card_matches_cpu(card, tmp_path, normalization):
    agp, pairs = _inputs(tmp_path, 3, 6, 20000)
    runs = {}
    for dev in ('cuda', 'cpu'):
        runs[dev] = tplot.contact_map(
            agp, pairs, outdir=str(tmp_path / dev), bin_size_kbp=2,
            normalization=normalization, device=dev)
    got, want = runs['cuda'], runs['cpu']
    assert got.matrix.device.type == 'cuda'
    assert torch.equal(got.matrix.cpu(), want.matrix)
    np.testing.assert_allclose(got.norm.cpu().numpy(), want.norm.numpy(),
                               rtol=RTOL, atol=0)
    assert got.vmax == pytest.approx(want.vmax, rel=RTOL, abs=0)
    assert got.kr_iters == want.kr_iters
    assert (tmp_path / 'cuda' / 'contact_matrix.pkl').read_bytes() == \
        (tmp_path / 'cpu' / 'contact_matrix.pkl').read_bytes()


@pytest.mark.cuda
def test_scatter_add_and_kr_on_card_match_cpu(card):
    """accumulate_contacts on random chunks (duplicates in every cell)
    and kr_balance on a seeded matrix, card against CPU."""
    rng = np.random.default_rng(5)
    agp = tplot.AgpIndex(
        ctg_names=['a', 'b'], ctg_id={'a': 0, 'b': 1},
        seg_key=np.asarray([1, 100002 + 1]), seg_ctg=np.asarray([0, 1]),
        seg_raw_start=np.asarray([1, 1]),
        seg_raw_end=np.asarray([100000, 100000]),
        seg_group=np.asarray([0, 0]),
        seg_group_start=np.asarray([1, 100101]),
        seg_fwd=np.asarray([True, False]), group_names=['s'],
        group_sizes=np.asarray([200100]), KEY=100002)
    bi = tplot.build_bins(agp, 1000)
    chunks = [AlignChunk(ref=rng.integers(0, 2, 50000),
                         pos=rng.integers(0, 100000, 50000),
                         mref=rng.integers(0, 2, 50000),
                         mpos=rng.integers(0, 100000, 50000))
              for _ in range(3)]
    got = tplot.accumulate_contacts(bi, chunks, device='cuda')
    want = tplot.accumulate_contacts(bi, chunks, device='cpu')
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    assert int(want.sum()) == 150000
    m = rng.integers(1, 50, (300, 300)).astype(np.float64)
    m = m + m.T
    cg, cc = [], []
    xg = tplot.kr_balance(torch.as_tensor(m, device='cuda'), counts=cg)
    xc = tplot.kr_balance(torch.as_tensor(m), counts=cc)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=RTOL,
                               atol=0)
    assert cg == cc

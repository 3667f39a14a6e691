"""Parity of the port's assembly correction (haphic_tpu_torch.core.correct)
with the JAX package's, on seeded chimeric contigs: coverage, break
points, the corrected FASTA, list file and Assembly, and the coordinate
remapper (vectorised in the port) for 1 and 2 rounds."""

import random

import numpy as np
import pytest

from haphic_tpu.core import correct as jcorr
from haphic_tpu.io.fasta import read_fasta as jread_fasta
from haphic_tpu.io.pairs import AlignChunk as JChunk

from haphic_tpu_torch.core import correct as tcorr
from haphic_tpu_torch.io.fasta import read_fasta as tread_fasta
from haphic_tpu_torch.io.pairs import AlignChunk as TChunk

from . import util


def _sim_reads(seed, chimera_at=60000, bridge=0.0):
    """One chimeric contig (junction at ``chimera_at``) + two normal
    contigs; intra-contig read pairs with short separations (as
    tests/test_correct.py makes them). A ``bridge`` share of the chimera's
    pairs spans the junction, so its valley is not empty."""
    rng = random.Random(seed)
    ctgs = {
        'chim': ''.join(rng.choice('ATCG') for _ in range(100000)),
        'norm1': ''.join(rng.choice('ATCG') for _ in range(80000)),
        'norm2': ''.join(rng.choice('ATCG') for _ in range(60000)),
    }
    recs = []
    for name, L in (('chim', 100000), ('norm1', 80000), ('norm2', 60000)):
        for _ in range(4000):
            if name == 'chim' and rng.random() < bridge:
                # across the whole dead zone
                recs.append((name, rng.randrange(chimera_at - 2900,
                                                 chimera_at - 2001),
                             rng.randrange(chimera_at + 2001,
                                           chimera_at + 2900)))
                continue
            if name == 'chim':
                # dead zone around the junction -> zero-coverage valley
                if rng.random() < 0.6:
                    lo_lim, hi_lim = 0, chimera_at - 2001
                else:
                    lo_lim, hi_lim = chimera_at + 2000, L - 1
            else:
                lo_lim, hi_lim = 0, L - 1
            a = rng.randrange(lo_lim, hi_lim)
            b = min(a + rng.randrange(1, 4000), hi_lim)
            recs.append((name, a, b))       # 0-based
    return ctgs, recs


def _chunks(Chunk, recs, asm, n_chunks=3):
    recs = [recs[k] for k in np.random.default_rng(0).permutation(len(recs))]
    ref = np.asarray([asm.name2id[c] for c, _, __ in recs], np.int32)
    pos = np.asarray([a for _, a, __ in recs], np.int64)
    mpos = np.asarray([b for _, __, b in recs], np.int64)
    return [Chunk(ref=r, pos=p, mref=r.copy(), mpos=m) for r, p, m in
            zip(*(np.array_split(x, n_chunks) for x in (ref, pos, mpos)))]


def _both(tmp_path, seed, **kw):
    ctgs, recs = _sim_reads(seed, **kw)
    fa = tmp_path / 'asm.fa'
    util.write_genome(str(fa), ctgs)
    jasm, tasm = jread_fasta(str(fa)), tread_fasta(str(fa))
    return recs, jasm, tasm


CASES = [(0, {}), (1, {}), (2, {'bridge': 0.002}),
         (3, {'chimera_at': 30000, 'bridge': 0.002})]


@pytest.mark.parametrize('seed,kw', CASES)
def test_coverage_and_break_points_match_jax(tmp_path, seed, kw):
    recs, jasm, tasm = _both(tmp_path, seed, **kw)
    want = jcorr.accumulate_coverage(_chunks(JChunk, recs, jasm),
                                     jasm.names, jasm.lengths, 500)
    got = tcorr.accumulate_coverage(_chunks(TChunk, recs, tasm),
                                    tasm.names, tasm.lengths, 500)
    assert list(got.cov) == list(want.cov)
    for c in want.cov:
        assert np.array_equal(got.cov[c], want.cov[c])
        for part in ('links_lo', 'links_hi'):
            g, w = getattr(got, part)[c], getattr(want, part)[c]
            assert len(g) == len(w) == 3
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
    lengths = {c: tasm.length_of(c) for c in tasm.names}
    for args in ((), (0.5, 2000, 0.05)):
        assert tcorr.detect_break_points(got, lengths, *args) == \
            jcorr.detect_break_points(want, lengths, *args)
    assert tcorr.detect_break_points(got, lengths)['chim']


@pytest.mark.parametrize('nrounds', [1, 2])
@pytest.mark.parametrize('seed,kw', CASES)
def test_correct_assembly_matches_jax(tmp_path, nrounds, seed, kw):
    recs, jasm, tasm = _both(tmp_path, seed, **kw)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'torch').mkdir()
    want = jcorr.correct_assembly(jasm, _chunks(JChunk, recs, jasm),
                                  str(tmp_path / 'jax'),
                                  correct_nrounds=nrounds)
    got = tcorr.correct_assembly(tasm, _chunks(TChunk, recs, tasm),
                                 str(tmp_path / 'torch'),
                                 correct_nrounds=nrounds)
    assert got.n_broken == want.n_broken >= 1
    assert got.corrected_names == want.corrected_names
    for name in ('corrected_asm.fa', 'corrected_ctgs.txt'):
        assert (tmp_path / 'torch' / name).read_bytes() == \
            (tmp_path / 'jax' / name).read_bytes(), name
    for f in ('names', 'name2id', 'seqs', 'input_order'):
        assert getattr(got.asm, f) == getattr(want.asm, f), f
    for f in ('lengths', 're_sites'):
        assert np.array_equal(getattr(got.asm, f), getattr(want.asm, f)), f
    rm, jrm = got.remapper, want.remapper
    assert (rm.old_names, rm.new_names, rm.new_name2id) == \
        (jrm.old_names, jrm.new_names, jrm.new_name2id)
    for a, b in zip(rm.seg_pos + rm.seg_new, jrm.seg_pos + jrm.seg_new):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('nrounds', [1, 2])
@pytest.mark.parametrize('seed,kw', CASES[2:])
def test_remapper_gives_the_same_arrays_as_jax(tmp_path, nrounds, seed, kw):
    """The port's one-pass remapper against haphic_tpu's per-contig loop
    on random records: unknown contigs (-1), positions past a contig's
    end and left of its start, int32 and int64 positions."""
    recs, jasm, tasm = _both(tmp_path, seed, **kw)
    want = jcorr.correct_assembly(jasm, _chunks(JChunk, recs, jasm),
                                  str(tmp_path), correct_nrounds=nrounds)
    got = tcorr.correct_assembly(tasm, _chunks(TChunk, recs, tasm),
                                 str(tmp_path), correct_nrounds=nrounds)
    assert sum(len(sp) > 1 for sp in got.remapper.seg_pos) >= 1
    rng = np.random.default_rng(seed)
    n = 5000
    for dtype in (np.int64, np.int32):
        ref = rng.integers(-1, len(tasm), n).astype(np.int32)
        mref = rng.integers(-1, len(tasm), n).astype(np.int32)
        pos = rng.integers(-50, 110000, n).astype(dtype)
        mpos = rng.integers(0, 110000, n).astype(dtype)
        w = want.remapper.remap(JChunk(ref=ref, pos=pos, mref=mref,
                                       mpos=mpos))
        g = got.remapper.remap(TChunk(ref=ref, pos=pos, mref=mref,
                                      mpos=mpos))
        for f in ('ref', 'pos', 'mref', 'mpos'):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f

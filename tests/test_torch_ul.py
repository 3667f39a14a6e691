"""Parity of the port's ultra-long read integration (haphic_tpu_torch.
core.ul) with the JAX package's, on BAMs written by tests/bamutil.py:
parsed paths, the support filter, the whitelist and both link boosts."""

import random

import numpy as np
import pytest

from haphic_tpu.core import ul as jul
from haphic_tpu.core.contacts import COO as JCOO
from haphic_tpu.core.fragments import Fragments as JFragments
from haphic_tpu.io.fasta import Assembly as JAssembly

from haphic_tpu_torch.core import ul as tul
from haphic_tpu_torch.core.contacts import COO as TCOO
from haphic_tpu_torch.core.fragments import Fragments as TFragments
from haphic_tpu_torch.io.fasta import Assembly as TAssembly

from . import bamutil
from .test_ul import _ul_bam


def _random_ul_bam(tmp_path, seed, n_ctg=14):
    """Reads over a linear chain of contig ends, a circular one, and
    noise: primaries with 1-3 supplementaries each (random strand,
    AS, clips, indels, overlaps and gaps), some unmapped or low-MAPQ
    records, and reference names missing from the assembly."""
    rng = random.Random(seed)
    names = ['c{:02d}'.format(c) for c in range(n_ctg)] + ['absent']
    lens = [rng.randrange(30000, 60000) for _ in names]
    chain = list(range(0, 6))
    ring = list(range(6, 10)) + [6]
    junctions = list(zip(chain, chain[1:])) + list(zip(ring, ring[1:]))
    recs = []
    for rid in range(rng.randrange(40, 70)):
        if rng.random() < 0.8:
            a, b = rng.choice(junctions)
        else:
            a, b = rng.randrange(len(names)), rng.randrange(len(names))
        name = 'ul{}'.format(rid).encode()
        span = rng.randrange(8000, 22000)
        clip = rng.randrange(5000, 25000)
        fa, fb = rng.choice((0, 16)), rng.choice((0, 16))
        cig_a = [('M', span - 100), ('I', 50), ('D', 50), ('M', 50),
                 ('S', clip)]
        cig_b = [('H', rng.randrange(0, 3000)), ('S', clip),
                 ('M', span)]
        if fa & 16:
            cig_a = cig_a[::-1]
        if fb & 16:
            cig_b = cig_b[::-1]
        pos_a = rng.choice((0, lens[a] - span, rng.randrange(0, 300)))
        pos_b = rng.choice((0, lens[b] - span, lens[b] - span - 50))
        flag_a = fa | (4 if rng.random() < 0.03 else 0)
        recs.append(bamutil.bam_record(
            a, max(pos_a, 0), -1, -1, flag_a,
            mapq=rng.choice((60, 60, 60, 10)), name=name, cigar=cig_a,
            tags=[(b'AS', rng.randrange(500, 2000))]))
        for _ in range(rng.randrange(1, 4)):
            recs.append(bamutil.bam_record(
                b, max(pos_b, 0), -1, -1, fb | 0x800, mapq=60, name=name,
                cigar=cig_b, tags=[(b'AS', rng.randrange(500, 2000))]))
            b = rng.choice((b, rng.randrange(len(names))))
    path = tmp_path / 'ul_random.bam'
    bamutil.write_bam(str(path), names, lens, recs)
    asm_names = sorted(names[:-1])
    lengths = np.asarray([lens[names.index(c)] for c in asm_names], np.int64)
    return str(path), asm_names, lengths


def _parse_both(bam, names, lens, **kw):
    want = jul.parse_ul_alignments(bam, names, lens, **kw)
    got = tul.parse_ul_alignments(bam, names, lens, **kw)
    assert got == want
    assert tul.path_ctg_set(got) == jul.path_ctg_set(want)
    return want


@pytest.mark.parametrize('n_reads,support', [(3, 2), (1, 2), (1, 1)])
def test_parse_ul_paths_match_jax(tmp_path, n_reads, support):
    bam, names, lens = _ul_bam(tmp_path, n_reads=n_reads)
    paths = _parse_both(bam, names, lens, min_ul_support=support)
    assert (paths == []) == (n_reads < support)


@pytest.mark.parametrize('seed', range(6))
def test_parse_random_ul_bam_matches_jax(tmp_path, seed):
    bam, names, lens = _random_ul_bam(tmp_path, seed)
    for kw in ({}, {'min_ul_support': 1, 'max_overlap_ratio': 0.9,
                    'max_gap_len': 30000, 'min_ul_mapq': 5},
               {'min_ul_alignment_length': 15000,
                'max_distance_to_end': 400}):
        _parse_both(bam, names, lens, **kw)
    assert _parse_both(bam, names, lens)


def _frags(pkg, names, lens, ctg_of_frag):
    asm = pkg[2](names=names, name2id={c: i for i, c in enumerate(names)},
                 lengths=lens, re_sites=np.ones(len(names), np.int64),
                 seqs=None, input_order={c: i for i, c in enumerate(names)})
    m = len(ctg_of_frag)
    offset = np.searchsorted(ctg_of_frag, np.arange(len(names) + 1))
    return pkg[1](asm=asm, ctg_of_frag=ctg_of_frag,
                  bin_no=np.ones(m, np.int32),
                  frag_start=np.zeros(m, np.int64),
                  frag_len=np.ones(m, np.int64), frag_re=np.ones(m, np.int64),
                  frag_offset=offset.astype(np.int64),
                  split_ctg=np.zeros(len(names), bool),
                  nx_mask=np.ones(m, bool), bin_size=0)


@pytest.mark.parametrize('seed', range(3))
def test_boosts_match_jax(tmp_path, seed):
    bam, names, lens = _random_ul_bam(tmp_path, seed)
    paths = _parse_both(bam, names, lens)
    rng = np.random.default_rng(seed)
    n = len(names)
    ctg_of_frag = np.sort(rng.integers(0, n, 3 * n)).astype(np.int32)
    hi, hj = rng.integers(0, 2 * n, (2, 300))
    ci, cj = rng.integers(0, n, (2, 200))
    fi, fj = rng.integers(0, 3 * n, (2, 400))
    out = []
    for pkg, mod in (((JCOO, JFragments, JAssembly), jul),
                     ((TCOO, TFragments, TAssembly), tul)):
        coo = pkg[0]
        ht = coo(i=np.minimum(hi, hj), j=np.maximum(hi, hj),
                 w=np.arange(300, dtype=np.float64))
        full = coo(i=np.minimum(ci, cj), j=np.maximum(ci, cj),
                   w=np.arange(200, dtype=np.float64) + 1)
        flank = coo(i=np.minimum(fi, fj), j=np.maximum(fi, fj),
                    w=np.arange(400, dtype=np.float64) + 2)
        frags = _frags(pkg, names, lens, ctg_of_frag)
        out.append((mod.boost_ht_links(paths, ht, n),
                    *mod.boost_flank_and_full(paths, flank, full, frags)))
    for got, want in zip(out[1], out[0]):
        for f in ('i', 'j', 'w'):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (out[0][0].w != np.arange(300)).any()

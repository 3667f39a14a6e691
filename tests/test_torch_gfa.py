"""Parity of the port's GFA reader (haphic_tpu_torch.io.gfa) with the JAX
package's, on seeded GFA files."""

import random

import numpy as np
import pytest

from haphic_tpu.io import gfa as jgfa
from haphic_tpu.io.fasta import read_fasta as jread_fasta

from haphic_tpu_torch.io import gfa as tgfa
from haphic_tpu_torch.io.fasta import read_fasta as tread_fasta

from . import util


def _genome(tmp_path, seed=3, n_ctg=12):
    ctgs = util.random_genome(random.Random(seed), n_ctg=n_ctg,
                              min_len=500, max_len=3000)
    fa = tmp_path / 'asm.fa'
    util.write_genome(str(fa), ctgs)
    return str(fa), ctgs


def _write_gfas(tmp_path, ctgs, n_hap, seed, extra=(), lengths=None):
    """One GFA per haplotype, contigs dealt out at random, with random
    read depths; ``extra`` names contigs absent from the FASTA."""
    rng = random.Random(seed)
    names = list(ctgs) + list(extra)
    rng.shuffle(names)
    paths = [str(tmp_path / 'hap{}.gfa'.format(h)) for h in range(n_hap)]
    files = [open(p, 'w') for p in paths]
    for name in names:
        f = files[rng.randrange(n_hap)]
        ln = (lengths or {}).get(name, len(ctgs.get(name, 'A' * 777)))
        f.write('H\tVN:Z:1.0\n' if rng.random() < 0.1 else '')
        f.write('S\t{}\t*\tLN:i:{}\trd:i:{}\n'.format(
            name, ln, rng.randrange(1, 90)))
        if rng.random() < 0.3:
            f.write('L\t{}\t+\t{}\t-\t0M\n'.format(name, names[0]))
    for f in files:
        f.close()
    return paths


@pytest.mark.parametrize('n_hap,extra', [(1, ()), (2, ()), (4, ('u1', 'u2'))])
def test_read_gfas_and_depth_arrays_match_jax(tmp_path, n_hap, extra):
    fa, ctgs = _genome(tmp_path, seed=n_hap)
    paths = _write_gfas(tmp_path, ctgs, n_hap, seed=10 + n_hap, extra=extra)
    jasm, tasm = jread_fasta(fa), tread_fasta(fa)
    want = jgfa.read_gfas(paths, jasm)
    got = tgfa.read_gfas(paths, tasm)
    assert got == want
    assert list(got) == list(want)
    jh, jd = jgfa.depth_arrays(want, jasm.names)
    th, td = tgfa.depth_arrays(got, tasm.names)
    for a, b in ((th, jh), (td, jd)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_length_mismatch_raises_as_jax(tmp_path):
    fa, ctgs = _genome(tmp_path)
    bad = next(iter(ctgs))
    paths = _write_gfas(tmp_path, ctgs, 2, seed=1,
                        lengths={bad: len(ctgs[bad]) + 1})
    with pytest.raises(RuntimeError, match='different length') as want:
        jgfa.read_gfas(paths, jread_fasta(fa))
    with pytest.raises(RuntimeError, match='different length') as got:
        tgfa.read_gfas(paths, tread_fasta(fa))
    assert str(got.value) == str(want.value)


def test_missing_contig_raises_as_jax(tmp_path):
    fa, ctgs = _genome(tmp_path)
    missing = sorted(ctgs)[4]
    paths = _write_gfas(tmp_path, {c: s for c, s in ctgs.items()
                                   if c != missing}, 2, seed=2)
    with pytest.raises(RuntimeError, match='Can not find') as want:
        jgfa.read_gfas(paths, jread_fasta(fa))
    with pytest.raises(RuntimeError, match='Can not find') as got:
        tgfa.read_gfas(paths, tread_fasta(fa))
    assert str(got.value) == str(want.value)

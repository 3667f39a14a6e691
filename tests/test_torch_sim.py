"""The port's simulation generators, scaffold evaluation and GA quality
study (haphic_tpu_torch.sim) against the JAX package's, on the CPU:
every case of tests/test_sim.py, with the reference-only evaluator
parity held against haphic_tpu instead; ga_study on the native route
(equal TSVs but for wall_s) and on the device route (both GAs to the
same quality); and the `sim` CLI surface of both packages."""

import argparse
import dataclasses
import os
import random

import numpy as np
import pytest

from haphic_tpu.cli import build_parser as jparser
from haphic_tpu.sim import evaluate as jev
from haphic_tpu.sim import ga_study as jga
from haphic_tpu.sim import generators as jgen

from haphic_tpu_torch.cli import build_parser as tparser
from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.sim import evaluate as tev
from haphic_tpu_torch.sim import ga_study as tga
from haphic_tpu_torch.sim import generators as tgen

from .test_torch_post import _tree

# device-route finals of the two GAs (different random streams) agree
# to this fraction, as the allhic tests hold them
QUALITY_TOL = 0.05
# a GA window that rescores its f32 caches may round its best score
# down by a few ulps, in both packages
FALL_TOL = 1e-6


def _template(seed=0, nchr=2, chr_len=300000):
    rng = random.Random(seed)
    return {'Chr{:02d}'.format(i + 1):
            ''.join(rng.choice('ATCG') for _ in range(chr_len))
            for i in range(nchr)}


# ---------------------------------------------------------------------------
# generators

@pytest.mark.parametrize('seed', [2, 6])
def test_sim_contigs_equal(seed):
    seqs = _template()
    got = tgen.sim_contigs(seqs, mean=40000, cv=0.3, seed=seed)
    assert got == jgen.sim_contigs(seqs, mean=40000, cv=0.3, seed=seed)
    assert list(got) == list(jgen.sim_contigs(seqs, mean=40000, cv=0.3,
                                              seed=seed))
    assert sum(len(s) for s in got.values()) == \
        sum(len(s) for s in seqs.values())
    for cid, seq in got.items():
        assert tgen.decode_truth_id(cid) == jgen.decode_truth_id(cid)
        chrom, start, end, ori = tgen.decode_truth_id(cid)
        expected = seqs[chrom][start - 1:end]
        if ori == '-':
            from haphic_tpu_torch.io.fasta import revcomp
            expected = revcomp(expected)
        assert seq == expected


def test_sim_haplotypes_equal():
    seqs = _template(nchr=1, chr_len=100000)
    got = tgen.sim_haplotypes(seqs, ploidy=2, div=0.01, seed=3)
    assert got == jgen.sim_haplotypes(seqs, ploidy=2, div=0.01, seed=3)
    haps, allele_info = got
    assert len(haps) == 2 and allele_info
    assert abs(len(haps[0]['Chr01_1']) - 100000) < 2000


def test_sim_chimeras_equal():
    seqs = _template(nchr=1)
    ctgs = tgen.sim_contigs(seqs, mean=50000, cv=0.2, seed=4)
    got = tgen.sim_chimeric_contigs(ctgs, 2, seed=5)
    want = jgen.sim_chimeric_contigs(ctgs, 2, seed=5)
    assert got == want and list(got) == list(want)
    assert sum(1 for c in got if c.endswith('_chimeric')) == 2
    assert len(got) == len(ctgs) + 2


def test_sim_hic_pairs_equal():
    seqs = _template(seed=9)
    ctgs = tgen.sim_contigs(seqs, mean=40000, cv=0.3, seed=9)
    got = tgen.sim_hic_pairs(ctgs, 2000, seed=9)
    assert got == jgen.sim_hic_pairs(ctgs, 2000, seed=9)
    same = sum(1 for _, c1, _p1, c2, _p2 in got
               if tgen.decode_truth_id(c1)[0] ==
               tgen.decode_truth_id(c2)[0])
    assert len(got) == 2000 and same / len(got) > 0.8


@pytest.mark.parametrize('depth,jitter', [(25, 0), (30, 7)])
def test_mock_gfa_byte_equal(depth, jitter, tmp_path):
    ctgs = {'a': 'ACGT' * 10, 'b': 'GGCC' * 5, 'c': 'T' * 33}
    paths = []
    for gen, name in ((jgen, 'j.gfa'), (tgen, 't.gfa')):
        paths.append(tmp_path / name)
        gen.mock_gfa(ctgs, str(paths[-1]), depth=depth, jitter=jitter,
                     seed=3)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    first = paths[1].read_text().splitlines()[0]
    assert first.startswith('S\ta\t') and 'LN:i:40' in first


# ---------------------------------------------------------------------------
# truth and evaluation

def test_generate_truth_roundtrip_equal(tmp_path):
    seqs = _template()
    ctgs = tgen.sim_contigs(seqs, mean=40000, cv=0.3, seed=6)
    ids = list(ctgs) + ['other_1', 'Scaf9_1_1_10_+_10']
    got = tev.generate_truth(ids, chr_pattern=r'Chr\d+')
    assert got == jev.generate_truth(ids, chr_pattern=r'Chr\d+')
    assert set(got) == set(seqs) | {'unanchored'}
    for d, ev in (('j', jev), ('t', tev)):
        ev.write_truth(got, str(tmp_path / (d + '.txt')))
    assert (tmp_path / 't.txt').read_bytes() == \
        (tmp_path / 'j.txt').read_bytes()
    assert tev.parse_truth(str(tmp_path / 'j.txt')) == \
        jev.parse_truth(str(tmp_path / 'j.txt')) == got


def _agp(path, scaffolds, lengths):
    """An AGP of ``scaffolds`` ({name: [(contig, orientation)]}), each
    contig whole; 'unanchored' contigs as scaffolds of their own."""
    with open(path, 'w') as f:
        for chrom, lst in scaffolds.items():
            if chrom == 'unanchored':
                for c, o in lst:
                    f.write('{0}\t1\t{1}\t1\tW\t{0}\t1\t{1}\t+\n'
                            .format(c, lengths[c]))
                continue
            acc = 0
            for n, (c, o) in enumerate(lst, 1):
                f.write('{}\t{}\t{}\t{}\tW\t{}\t1\t{}\t{}\n'.format(
                    chrom, acc + 1, acc + lengths[c], n, c,
                    lengths[c], o))
                acc += lengths[c]
    return str(path)


def _scrambled(truth):
    """tests/test_sim.py's scrambles: a swap across chromosomes
    (translocations), a flip (inversion), a local swap (relocation)."""
    scaf = {c: list(lst) for c, lst in truth.items()}
    a, b = [c for c in scaf if c != 'unanchored'][:2]
    scaf[a][2], scaf[b][3] = scaf[b][3], scaf[a][2]
    c0, o0 = scaf[a][0]
    scaf[a][0] = (c0, '-' if o0 == '+' else '+')
    scaf[b][1], scaf[b][4] = scaf[b][4], scaf[b][1]
    return scaf


@pytest.mark.parametrize('scramble', [False, True],
                         ids=['perfect', 'scrambled'])
@pytest.mark.parametrize('verbose', [False, True])
def test_evaluate_scaffolds_equal(scramble, verbose, tmp_path, capsys):
    seqs = _template(seed=8 if scramble else 0)
    ctgs = tgen.sim_contigs(seqs, mean=30000 if scramble else 40000,
                            cv=0.3, seed=8 if scramble else 7)
    truth = tev.generate_truth(list(ctgs))
    lengths = {c: len(s) for c, s in ctgs.items()}
    agp = _agp(tmp_path / 'x.agp',
               _scrambled(truth) if scramble else truth, lengths)
    got = []
    for ev in (jev, tev):
        capsys.readouterr()
        res = ev.evaluate_scaffolds(truth, agp, verbose=verbose)
        out = capsys.readouterr()
        got.append((dataclasses.asdict(res), out.out, out.err,
                    [res.pct(k) for k in sorted(res.counts)]))
    assert got[1] == got[0]
    res = got[1][0]
    if scramble:
        for key in ('translocation', 'inversion', 'relocation'):
            assert res['counts'][key] > 0, key
    else:
        assert res['counts']['syntenic'] == len(ctgs)


# ---------------------------------------------------------------------------
# ga_study

def _tsv_rows(path):
    """Rows of a ga_study TSV without the wall_s column."""
    rows = [line.rstrip('\n').split('\t') for line in open(path)]
    col = rows[0].index('wall_s')
    return [r[:col] + r[col + 1:] for r in rows]


def test_ga_study_native_equal(tmp_path):
    kw = dict(ks=(20, 40), ngen=300, backend='native')
    jrows = jga.run_study(out=str(tmp_path / 'j.tsv'), **kw)
    trows = tga.run_study(out=str(tmp_path / 't.tsv'), device='cpu', **kw)
    assert _tsv_rows(tmp_path / 't.tsv') == _tsv_rows(tmp_path / 'j.tsv')
    assert len(trows) == len(jrows) == 4
    for t, j in zip(trows, jrows):
        assert {k: v for k, v in t.items() if k != 'wall_s'} == \
            {k: v for k, v in j.items() if k != 'wall_s'}


def test_ga_study_device_quality(tmp_path):
    kw = dict(ks=(30,), ngen=200, backend='device')
    jrows = jga.run_study(out=str(tmp_path / 'j.tsv'), **kw)
    trows = tga.run_study(out=str(tmp_path / 't.tsv'), device='cpu', **kw)
    assert [(r['k'], r['start']) for r in trows] == \
        [(r['k'], r['start']) for r in jrows] == [(30, 'cold'), (30, 'hot')]
    for rows in (jrows, trows):
        for r in rows:
            scores = [s for _, s in r['history']]
            assert all(b >= a - FALL_TOL * abs(a)
                       for a, b in zip(scores, scores[1:])), r['start']
            assert r['history'][-1][0] == 200
        hot = rows[1]
        assert hot['score_final'] >= hot['score0']
    for t, j in zip(trows, jrows):
        assert abs(t['score_final'] - j['score_final']) <= \
            QUALITY_TOL * abs(j['score_final']), t['start']
        # the same truth, rescored by each package's own scorer
        assert t['score_truth'] == pytest.approx(j['score_truth'],
                                                 rel=1e-5)
    head = open(tmp_path / 't.tsv').readline()
    assert head == open(tmp_path / 'j.tsv').readline()


def test_ga_study_numpy_helpers_equal():
    for k in (12, 50):
        tp, to, tr = tga.simulate_group(7 + k, k)
        jp, jo, jr = jga.simulate_group(7 + k, k)
        for f in ('lengths', 'pair_a', 'pair_b', 'd', 'w'):
            a, b = getattr(tp, f), getattr(jp, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert np.array_equal(to, jo) and np.array_equal(tr, jr)
        got = tga.corrupt_tour(to, tr, 3, n_swaps=k // 4, n_flips=k // 5)
        want = jga.corrupt_tour(jo, jr, 3, n_swaps=k // 4, n_flips=k // 5)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got, want))
        assert tga.order_spearman(got[0], to) == \
            jga.order_spearman(want[0], jo)


# ---------------------------------------------------------------------------
# the CLI

def _sim_actions(parser):
    """{subcommand: [(dest, option strings, nargs, default, type,
    choices, required, action class)]} of the `sim` subparser."""
    def subparsers(p):
        return [a for a in p._actions
                if isinstance(a, argparse._SubParsersAction)][0]
    sim = subparsers(parser).choices['sim']
    out = {}
    for name, p in subparsers(sim).choices.items():
        out[name] = sorted(
            (a.dest, tuple(a.option_strings), str(a.nargs), repr(a.default),
             getattr(a.type, '__name__', None), repr(a.choices),
             a.required, type(a).__name__)
            for a in p._actions if a.dest != 'help')
    return out


def test_sim_cli_surface():
    got = _sim_actions(tparser())
    want = _sim_actions(jparser())
    assert sorted(got) == sorted(want)
    assert len(got) == 50
    device = ('device', ('--device',), 'None', repr('cuda'), None,
              repr(['cuda', 'cpu']), False, '_StoreAction')
    for name in want:
        extra = [a for a in got[name] if a not in want[name]]
        assert [a for a in want[name] if a not in got[name]] == [], name
        assert extra == ([device] if name == 'ga_study' else []), name


def test_ga_study_cli_device_default(tmp_path, monkeypatch):
    """`sim ga_study` resolves --device (default cuda) before any work:
    without a card it raises unless --device cpu is given."""
    import torch
    monkeypatch.chdir(tmp_path)
    argv = ['sim', 'ga_study', '--ks', '12', '--ngen', '20', '--npop',
            '8', '--backend', 'native', '--out', 'study.tsv']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tmain(argv)
        assert not os.path.exists('study.tsv')
    assert tmain(argv + ['--device', 'cpu']) == 0
    rows = _tsv_rows('study.tsv')
    assert [r[:2] for r in rows] == [['k', 'start'], ['12', 'cold'],
                                     ['12', 'hot']]


def test_ga_study_cli_writes_as_haphic_tpu(tmp_path, monkeypatch):
    from haphic_tpu.cli import main as jmain
    argv = ['sim', 'ga_study', '--ks', '16,24', '--ngen', '60', '--npop',
            '12', '--seed', '5', '--out', 'study.tsv']
    rows = []
    for main, name, extra in ((jmain, 'jax', []),
                              (tmain, 'torch', ['--device', 'cpu'])):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert main(argv + extra) == 0
        assert list(_tree(cwd)) == ['study.tsv']
        rows.append(_tsv_rows(cwd / 'study.tsv'))
    assert rows[1] == rows[0] and len(rows[1]) == 5

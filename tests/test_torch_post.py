"""The port's juicer and refsort (haphic_tpu_torch.post) against the JAX
package's, on the CPU: the cases of tests/test_juicer.py and
tests/test_refsort.py::test_refsort_fasta_roundtrip, run through both
packages on the same inputs, with byte-equal outputs; and the flag
surface of the five commands this slice adds to the port's CLI."""

import argparse
import io
import os
import random

import pytest

from haphic_tpu.build.scaffolds import build_final_scaffolds
from haphic_tpu.cli import build_parser as jparser
from haphic_tpu.cli import main as jmain
from haphic_tpu.io.fasta import read_fasta
from haphic_tpu.post import juicer as jjuicer
from haphic_tpu.post import refsort as jrefsort

from haphic_tpu_torch.cli import build_parser as tparser
from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.post import juicer as tjuicer
from haphic_tpu_torch.post import refsort as trefsort

from . import util


def _tree(d):
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


@pytest.fixture()
def scaffolded(tmp_path):
    """tests/test_juicer.py's fixture: 6 contigs, 2 scaffolds of 2
    contigs (one reversed) and 2 unanchored, 500 pairs among the 4."""
    rng = random.Random(7)
    ctgs = util.random_genome(rng, n_ctg=6, min_len=2000, max_len=6000)
    fa = tmp_path / 'ctgs.fa'
    util.write_genome(str(fa), ctgs)
    names = list(ctgs)
    tours = {'g1': [(names[0], '+'), (names[1], '-')],
             'g2': [(names[2], '+'), (names[3], '+')]}
    _, _, raw = build_final_scaffolds(
        tours, read_fasta(str(fa)), corrected_ctgs=set(),
        outdir=str(tmp_path))
    recs = []
    for k in range(500):
        a, b = rng.choice(names[:4]), rng.choice(names[:4])
        recs.append(('r{}'.format(k), a,
                     rng.randrange(1, len(ctgs[a]) + 1), b,
                     rng.randrange(1, len(ctgs[b]) + 1)))
    pairs = tmp_path / 'hic.pairs'
    util.write_pairs(str(pairs), recs)
    # the same pairs as PA5 and as bamtobed BED (tests/test_juicer.py)
    with open(pairs) as f, open(tmp_path / 'links.pa5', 'w') as f5, \
            open(tmp_path / 'links.bed', 'w') as fb:
        for line in f:
            if line.startswith('#'):
                continue
            r, a, pa_, b, pb_ = line.split()[:5]
            f5.write('\t'.join([r, a, pa_, b, pb_]) + '\n')
            fb.write('{}\t{}\t{}\t{}/1\t60\t+\n'.format(
                a, int(pa_) - 1, int(pa_) + 49, r))
            fb.write('{}\t{}\t{}\t{}/2\t60\t+\n'.format(
                b, int(pb_) - 1, int(pb_) + 49, r))
    with open(tmp_path / 'minus.bed', 'w') as f:
        f.write('{}\t10\t60\tr0/1\t60\t-\n'.format(names[0]))
        f.write('{}\t5\t55\tr0/2\t60\t+\n'.format(names[1]))
    return tmp_path, str(fa), names, raw, str(pairs)


def _pre_both(tmp, raw, links, capsys, **kw):
    """juicer_pre through both packages into their own directories;
    returns both trees and both stderr texts."""
    got = []
    for mod, name in ((jjuicer, 'jax'), (tjuicer, 'torch')):
        d = tmp / 'pre_{}_{}'.format(os.path.basename(links), name)
        d.mkdir()
        capsys.readouterr()
        mod.juicer_pre(raw, links, outdir=str(d), **kw)
        got.append((_tree(d), capsys.readouterr().err))
    return got


@pytest.mark.parametrize('links,kw', [
    ('hic.pairs', {}),
    ('links.pa5', {}),
    ('links.bed', {}),
    ('minus.bed', {}),
    ('hic.pairs', {'assembly_mode': False, 'out_prefix': 'plain'}),
    ('links.pa5', {'file_type': 'PA5', 'mapq': 30}),
], ids=['pairs', 'pa5', 'bed', 'bed-minus-strand', 'no-assembly',
        'file-type'])
def test_juicer_pre_byte_equal(scaffolded, capsys, links, kw):
    tmp, fa, names, raw, pairs = scaffolded
    (jt, jerr), (tt, terr) = _pre_both(tmp, raw, str(tmp / links),
                                       capsys, **kw)
    assert tt == jt
    assert 'PRE_C_SIZE: assembly' in terr and terr == jerr
    txt = [v for k, v in tt.items() if k.endswith('.txt')]
    assert len(txt) == 1 and txt[0]


@pytest.mark.parametrize('name,file_type,match', [
    ('links.bin', None, 'not supported'),
    ('hic.pairs', 'bin', 'not supported'),
    ('links.dat', None, 'unknown link file format'),
    ('hic.pairs', 'xyz', 'unknown --file-type'),
])
def test_juicer_pre_errors_as_haphic_tpu(scaffolded, name, file_type,
                                         match):
    tmp, fa, names, raw, pairs = scaffolded
    (tmp / 'links.bin').write_bytes(b'\x00' * 16)
    (tmp / 'links.dat').write_text('x\n')
    msgs = []
    for mod in (jjuicer, tjuicer):
        with pytest.raises(RuntimeError, match=match) as e:
            mod.juicer_pre(raw, str(tmp / name), outdir=str(tmp),
                           file_type=file_type)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _review_identity(tmp, frags, tours):
    return None


def _review_edits(tmp, frags, tours):
    """Flip scaffold 2's first fragment and merge both scaffolds."""
    merged = tours[0] + [-tours[1][0], tours[1][1]]
    review = tmp / 'review.assembly'
    with open(review, 'w') as f:
        for fid, (n, l) in enumerate(frags, 1):
            f.write('>{} {} {}\n'.format(n, fid, l))
        f.write(' '.join(str(x) for x in merged) + '\n')
    return str(review)


def _review_split(tmp, frags, tours):
    """Split the first fragment in two JBAT pieces, the second debris."""
    n0, l0 = frags[0]
    cut = l0 // 3
    review = tmp / 'review2.assembly'
    with open(review, 'w') as f:
        f.write('>{}:::fragment_1 1 {}\n'.format(n0, cut))
        f.write('>{}:::fragment_2:::debris 2 {}\n'.format(n0, l0 - cut))
        id_map = {}
        for fid, (n, l) in enumerate(frags[1:], 3):
            f.write('>{} {} {}\n'.format(n, fid, l))
            id_map[n] = fid
        f.write('1 -{}\n'.format(id_map[frags[1][0]]))
        f.write('2\n')
    return str(review)


@pytest.mark.parametrize('edit', [_review_identity, _review_edits,
                                  _review_split],
                         ids=['identity', 'edits', 'fragment-split'])
@pytest.mark.parametrize('with_fasta', [True, False],
                         ids=['fasta', 'agp-only'])
def test_juicer_post_byte_equal(scaffolded, edit, with_fasta):
    """juicer pre (JAX) then the review through both packages' post:
    byte-equal FINAL AGP and FASTA."""
    tmp, fa, names, raw, pairs = scaffolded
    jjuicer.juicer_pre(raw, pairs, outdir=str(tmp))
    frags, tours = jjuicer.parse_review_assembly(
        str(tmp / 'out_JBAT.assembly'))
    assert tjuicer.parse_review_assembly(
        str(tmp / 'out_JBAT.assembly')) == (frags, tours)
    review = edit(tmp, frags, tours) or str(tmp / 'out_JBAT.assembly')
    trees = []
    for mod, name in ((jjuicer, 'jax'), (tjuicer, 'torch')):
        d = tmp / 'post_{}'.format(name)
        d.mkdir()
        mod.juicer_post(review, str(tmp / 'out_JBAT.liftover.agp'),
                        contigs_fasta=fa if with_fasta else None,
                        outdir=str(d))
        trees.append(_tree(d))
    assert trees[1] == trees[0]
    assert len(trees[1]) == (2 if with_fasta else 1)


def test_juicer_cli_round_trip_byte_equal(scaffolded):
    """`juicer pre` then `juicer post` through both CLIs."""
    tmp, fa, names, raw, pairs = scaffolded
    trees = []
    for main, name in ((jmain, 'jax'), (tmain, 'torch')):
        d = tmp / 'cli_{}'.format(name)
        d.mkdir()
        assert main(['juicer', 'pre', pairs, raw, '--outdir', str(d)]) == 0
        assert main(['juicer', 'post', str(d / 'out_JBAT.assembly'),
                     str(d / 'out_JBAT.liftover.agp'), fa,
                     '--outdir', str(d)]) == 0
        trees.append(_tree(d))
    assert trees[1] == trees[0]
    assert {'out_JBAT.txt', 'out_JBAT.assembly', 'out_JBAT.liftover.agp',
            'out_JBAT.FINAL.agp', 'out_JBAT.FINAL.fa'} == set(trees[1])


def _refsort_scenario(tmp_path):
    """tests/test_refsort.py's scenario as test_refsort_fasta_roundtrip
    trims it: g1 = a(+) b(-) forward on ref1, g2 = c(+) d(+) reversed on
    ref2, g3 a long solo contig, g4 a short solo (skipped)."""
    agp_rows = [
        'g1\t1\t100000\t1\tW\ta\t1\t100000\t+',
        'g1\t100001\t100100\t2\tU\t100\tscaffold\tyes\tproximity_ligation',
        'g1\t100101\t180000\t3\tW\tb\t1\t79900\t-',
        'g2\t1\t90000\t1\tW\tc\t1\t90000\t+',
        'g2\t90001\t90100\t2\tU\t100\tscaffold\tyes\tproximity_ligation',
        'g2\t90101\t150000\t3\tW\td\t1\t59900\t+',
        'g3\t1\t200000\t1\tW\te\t1\t200000\t+',
        'g4\t1\t5000\t1\tW\tf\t1\t5000\t+',
    ]
    agp = tmp_path / 's.agp'
    agp.write_text('\n'.join(agp_rows) + '\n')
    rows = []

    def aln(ctg, qlen, qs, qe, strand, ref, ts, te):
        rows.append('\t'.join(map(str, [
            ctg, qlen, qs, qe, strand, ref, 50000000, ts, te,
            qe - qs, qe - qs, 60])))

    aln('a', 100000, 1000, 60000, '+', 'ref1', 101000, 160000)
    aln('b', 79900, 5000, 70000, '-', 'ref1', 190000, 255000)
    aln('c', 90000, 1000, 80000, '-', 'ref2', 400000, 479000)
    aln('d', 59900, 2000, 50000, '-', 'ref2', 300000, 348000)
    aln('e', 200000, 100000, 190000, '+', 'ref1', 1000000, 1090000)
    paf = tmp_path / 'aln.paf'
    paf.write_text('\n'.join(rows) + '\n')
    rng = random.Random(0)
    lens = {'a': 100000, 'b': 79900, 'c': 90000, 'd': 59900,
            'e': 200000, 'f': 5000}
    ctgs = {n: ''.join(rng.choice('ATCG') for _ in range(L))
            for n, L in lens.items()}
    fa = tmp_path / 'ctgs.fa'
    util.write_genome(str(fa), ctgs)
    return str(agp), str(paf), str(fa)


@pytest.mark.parametrize('kw', [
    {}, {'keep_original_ids': True}, {'ref_order': 'ref2,ref1'},
], ids=['default', 'keep-ids', 'ref-order'])
def test_refsort_byte_equal(tmp_path, kw):
    agp, paf, fa = _refsort_scenario(tmp_path)
    got = []
    for mod, name in ((jrefsort, 'jax'), (trefsort, 'torch')):
        buf = io.StringIO()
        out_fa = tmp_path / '{}.fa'.format(name)
        mod.run_refsort(agp, paf, fasta=fa, fasta_out=str(out_fa),
                        out=buf, **kw)
        got.append((buf.getvalue(), out_fa.read_bytes()))
    assert got[1] == got[0]
    text = got[1][0]
    if not kw:
        assert 'g1:ref1:+' in text and 'g2:ref2:-' in text


def test_refsort_cli_byte_equal(tmp_path, capsys):
    agp, paf, fa = _refsort_scenario(tmp_path)
    outs = []
    for main in (jmain, tmain):
        capsys.readouterr()
        assert main(['refsort', agp, paf, '--fasta', fa]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and 'g1:ref1:+' in outs[1]


def _surface(parser):
    """{command path: (positionals, option strings, choices)} of every
    subcommand, nested ones (util, juicer) included."""
    out = {}

    def walk(p, path):
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    walk(sp, path + (name,))
        opts = sorted(s for a in p._actions for s in a.option_strings)
        pos = [a.dest for a in p._actions if not a.option_strings
               and not isinstance(a, argparse._SubParsersAction)]
        choices = {a.dest: (a.default, tuple(a.choices or ()))
                   for a in p._actions if not isinstance(
                       a, (argparse._SubParsersAction,
                           argparse._HelpAction))}
        out[path] = (pos, opts, choices)
    walk(parser, ())
    return out


@pytest.mark.parametrize('command', ['allhic', 'plot', 'refsort', 'util',
                                     'juicer'])
def test_cli_takes_every_flag_of_haphic_tpu(command):
    """Every flag, positional, default and choice list of haphic_tpu's
    parser for the command; allhic and plot add --device (default
    cuda)."""
    want = {k: v for k, v in _surface(jparser()).items()
            if k[:1] == (command,)}
    got = {k: v for k, v in _surface(tparser()).items()
           if k[:1] == (command,)}
    assert set(got) == set(want)
    for path in want:
        gpos, gopts, gch = got[path]
        wpos, wopts, wch = want[path]
        assert gpos == wpos
        if path == (command,) and command in ('allhic', 'plot'):
            assert set(gopts) - set(wopts) == {'--device'}
            assert gch.pop('device') == ('cuda', ('cuda', 'cpu'))
        else:
            assert gopts == wopts
        assert gch == wch

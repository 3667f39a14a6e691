"""The port's aux utilities (haphic_tpu_torch.utils.tools) against the
JAX package's, on the CPU: every case of tests/test_utils_tools.py but
the reference-only global_chaining parity, and global_chaining itself on
that test's PAF, each run through both packages on the same inputs in
a working directory of its own, with byte-equal return values, output
streams and files."""

import gzip
import io
import os
import random

import pytest

from haphic_tpu.cli import main as jmain
from haphic_tpu.utils import tools as jtools

from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.utils import tools as ttools

from . import bamutil
from .test_torch_post import _tree


def _inputs(d):
    """Every input file of the cases, written into ``d``."""
    rng = random.Random(0)
    (d / 'a.fa').write_text('>c1\nACGT\nAC\n>c2\nGGG\n')
    (d / 'g1.txt').write_text('#Contig\tRECounts\tLength\na\t2\t10\n'
                              'b\t3\t20\n')
    (d / 'g2.txt').write_text('c\t1\t5\n')
    (d / 'list.txt').write_text('{}\n{}\n'.format(d / 'g1.txt',
                                                  d / 'g2.txt'))
    (d / 'a.gfa').write_text('S\tutg1\t*\tLN:i:100\trd:i:5\n'
                             'L\tutg1\t+\tutg2\t-\t0M\n'
                             'S\tutg2\t*\tLN:i:50\trd:i:9\n')
    (d / 'lift.agp').write_text('n1\t1\t60\t1\tW\tutg1\t1\t60\t+\n'
                                'n2\t1\t40\t1\tW\tutg1\t61\t100\t+\n'
                                'n3\t1\t50\t1\tW\tutg2\t1\t50\t+\n')
    (d / 'd.gfa').write_text('S\tc1\t*\tLN:i:100\trd:i:4\n'
                             'S\tc2\t*\tLN:i:50\trd:i:9\n')
    (d / 's.agp').write_text('s1\t1\t100\t1\tW\tc1\t1\t100\t+\n'
                             's1\t101\t200\t2\tU\t100\tscaffold\tyes\tx\n'
                             's1\t201\t250\t3\tW\tc2\t1\t50\t+\n')
    mid = ''.join(rng.choice('ATCG') for _ in range(500))
    seq = 'CCCTAAA' * 10 + mid + 'TTTAGGG' * 10
    (d / 'tel.fa').write_text('>chr1\n{}\n>chr2\n{}\n'.format(seq, mid))
    (d / 'n.fa').write_text('>c\nACGTNNNNACGT\nNNACG\n')
    with gzip.open(d / 'in.fq.gz', 'wt') as f:
        f.write('@r1\nACGTACGT\n+\nIIIIIIII\n')
        f.write('@r2\nACG\n+\nIII\n')
    (d / 'g.fa').write_text('>c1\n' + 'A' * 100 + '\n')
    (d / 'x.bed').write_text('c1\t10\t20\tfeat\t0\t+\n')
    _make_chain_paf(str(d / 'aln.paf'))
    w = d / 'wrk' / 'sampleX' / '03.rescue'
    w.mkdir(parents=True)
    (w / 'group1.txt').write_text('#h\nctg1\t1\t100\nctg2\t1\t100\n')
    (w / 'group2.txt').write_text('ctg3\t1\t100\n')
    (w / 'other.txt').write_text('ctg9\t1\t100\n')
    (d / 'ref.fa').write_text('>Chr1_hap1\n' + 'A' * 500 + '\n')
    (d / 'groupX.tour').write_text(
        '>INIT\nChr1_1_1_200_+_200+ Chr1_2_201_500_+_300+\n')
    recs = [
        ('r1', 0x40 | 0x1, 0, 100), ('r1', 0x80 | 0x1, 1, 200),
        ('r2', 0x40 | 0x1, 0, 300), ('r2', 0x80 | 0x1 | 0x4, -1, 0),
        ('r3', 0x40 | 0x1, 1, 50), ('r3', 0x80 | 0x1, 1, 400),
        ('r3', 0x80 | 0x1 | 0x800, 0, 10),
    ]
    bamutil.write_bam(
        str(d / 'pairs.bam'), ['ctgA', 'ctgB'], [1000, 1000],
        [bamutil.bam_record(r, p, -1, 0, f, name=n.encode())
         for n, f, r, p in recs])


def _paf_line(q, ql, qs, qe, strand, r, rl, rs, re_, mapq=60, de=0.01):
    matches = int((re_ - rs) * 0.97)
    return ('{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t'
            'tp:A:P\tde:f:{}\n'.format(q, ql, qs, qe, strand, r, rl,
                                       rs, re_, matches, re_ - rs,
                                       mapq, de))


def _make_chain_paf(path):
    """tests/test_utils_tools.py's PAF: a forward and a reverse chain of
    three pieces, a noise hit, and four records the filters drop."""
    rng = random.Random(5)
    lines = []
    for i in range(3):
        lines.append(_paf_line('qA', 900000, 100000 * i + 5000,
                               100000 * i + 85000, '+', 'chr1', 2000000,
                               500000 + 100000 * i,
                               500000 + 100000 * i + 80000))
    lines.append(_paf_line('qA', 900000, 700000, 715000, '+', 'chr2',
                           1500000, 10000, 25000))
    for i in range(3):
        lines.append(_paf_line('qB', 600000, 400000 - 120000 * i,
                               400000 - 120000 * i + 90000, '-', 'chr2',
                               1500000, 300000 + 120000 * i,
                               300000 + 120000 * i + 88000))
    lines.append(_paf_line('qA', 900000, 0, 50000, '+', 'chr1', 2000000,
                           0, 48000, mapq=0))
    lines.append(_paf_line('qB', 600000, 0, 9000, '+', 'chr2', 1500000,
                           0, 8000))
    lines.append(_paf_line('tiny', 50000, 0, 40000, '+', 'chr1',
                           2000000, 0, 39000))
    lines.append('qA\t900000\t0\t70000\t+\tchr1\t2000000\t900000\t'
                 '968000\t66000\t68000\t60\ttp:A:P\n')
    rng.shuffle(lines)
    with open(path, 'w') as f:
        f.writelines(lines)


# each case: (tools module, input dir, output buffer) -> return value;
# it runs with its package's own working directory as cwd
CASES = {
    'mock_agp': lambda t, d, out: t.mock_agp(str(d / 'a.fa'), out=out),
    'groups_to_clusters': lambda t, d, out: t.groups_to_clusters(
        [str(d / 'g1.txt'), str(d / 'g2.txt')], out=out),
    'combine_groups': lambda t, d, out: t.combine_groups(
        str(d / 'list.txt'), out=out),
    'convert_gfa_ids': lambda t, d, out: t.convert_gfa_ids(
        str(d / 'a.gfa'), str(d / 'lift.agp'), out=out),
    'gfa_depth_to_bedgraph': lambda t, d, out: t.gfa_depth_to_bedgraph(
        [str(d / 'd.gfa')], str(d / 's.agp'), out=out),
    'gfa_depth_to_bedgraph-scaled': lambda t, d, out:
        t.gfa_depth_to_bedgraph([str(d / 'd.gfa'), str(d / 'a.gfa')],
                                str(d / 's.agp'), scale=0.5, out=out),
    'find_telomeres': lambda t, d, out: t.find_telomeres(
        str(d / 'tel.fa'), out=out),
    'find_telomeres-contigs': lambda t, d, out: t.find_telomeres(
        str(d / 'tel.fa'), repeat='TTTAGGG', contigs=['chr1'], out=out),
    'fasta_count_N': lambda t, d, out: t.fasta_count_N(
        str(d / 'n.fa'), out=out),
    'fastq_length_filtering': lambda t, d, out: t.fastq_length_filtering(
        'out.fq.gz', [str(d / 'in.fq.gz')], length=5),
    'reverse_bed': lambda t, d, out: t.reverse_bed(
        str(d / 'x.bed'), str(d / 'g.fa'), out=out),
    'global_chaining': lambda t, d, out: t.global_chaining(
        str(d / 'aln.paf'), mapq=1, min_cov_ratio=0.1,
        perform_clustering=True, out=out),
    'global_chaining-defaults': lambda t, d, out: t.global_chaining(
        str(d / 'aln.paf'), out=out),
    'prepare_clusters': lambda t, d, out: t.prepare_clusters(
        str(d / 'wrk')),
    'prepare_clusters-manual': lambda t, d, out: t.prepare_clusters(
        str(d / 'wrk'), for_manual=True),
    'mock_blast': lambda t, d, out: t.mock_blast(
        str(d / 'ref.fa'), str(d / 'groupX.tour')),
    'remove_singletons': lambda t, d, out: t.remove_singletons(
        str(d / 'pairs.bam'), out=out),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_tools_byte_equal(case, tmp_path, monkeypatch):
    inp = tmp_path / 'in'
    inp.mkdir()
    _inputs(inp)
    got = []
    for tools, name in ((jtools, 'jax'), (ttools, 'torch')):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        out = io.StringIO()
        ret = CASES[case](tools, inp, out)
        got.append((ret, out.getvalue(), _tree(cwd)))
    assert got[1] == got[0]
    assert got[1][1] or got[1][2]          # each case writes something


@pytest.mark.parametrize('argv', [
    ['fastq_length_filtering', 'out.fq.gz', '{in}/in.fq.gz',
     '--length', '5'],
    ['prepare_clusters', '{in}/wrk', '--for_manual'],
    ['mock_blast', '{in}/ref.fa', '{in}/groupX.tour'],
    ['global_chaining', '{in}/aln.paf', '--mapq', '1',
     '--perform_clustering'],
], ids=lambda a: a[0])
def test_util_cli_writes_as_haphic_tpu(argv, tmp_path, monkeypatch):
    """`util` subcommands that write files, through both CLIs."""
    inp = tmp_path / 'in'
    inp.mkdir()
    _inputs(inp)
    trees = []
    for main, name in ((jmain, 'jax'), (tmain, 'torch')):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert main(['util'] + [a.replace('{in}', str(inp))
                                for a in argv]) == 0
        trees.append(_tree(cwd))
    assert trees[1] == trees[0] and trees[1]
    assert os.path.isdir(inp)

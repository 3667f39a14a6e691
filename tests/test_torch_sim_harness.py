"""The port's simulation harness (haphic_tpu_torch.sim.harness) against
the JAX package's, on the CPU: every case of tests/test_sim_harness.py
(the reference-only parity cases held against haphic_tpu instead), and
the two samtools tools and pbsperf with stub binaries on PATH. Each
case runs both packages on the same inputs, each in a directory of its
own as cwd, and compares the return values, the output streams and
every file in the directory byte for byte."""

import gzip
import io
import os
import random
import re
import subprocess
import sys

import pytest

from haphic_tpu.cli import main as jmain
from haphic_tpu.sim import harness as jh

from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.sim import harness as th

from . import bamutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

AGP = """scaffold_1\t1\t100\t1\tW\tctgA\t1\t100\t+
scaffold_1\t101\t300\t2\tU\t200\tscaffold\tyes\tproximity_ligation
scaffold_1\t301\t400\t3\tW\tctgB\t1\t100\t-
scaffold_2\t1\t50\t1\tW\tctgC\t1\t50\t+
scaffold_2\t51\t120\t2\tW\tctgA\t120\t189\t+
scaffold_3\t1\t70\t1\tW\tctgD\t1\t70\t-
"""

ASSEMBLY = """>ctgA 1 100
>ctgB 2 100
>ctgC 3 50
1 -2
3
"""

# printed by the stub `samtools`: a header, then records of two source
# chromosomes, intra and inter, with mates on '=' and by name
SAM = """@HD\tVN:1.6\tSO:coordinate
@SQ\tSN:Chr1_1_c1\tLN:1000
@SQ\tSN:Chr1_2_c1\tLN:1000
@SQ\tSN:Chr2_1_c1\tLN:1000
@PG\tID:stub
r1\t65\tChr1_1_c1\t10\t60\t50M\tChr1_2_c1\t20\t0\t*\t*
r2\t65\tChr1_1_c1\t30\t60\t50M\t=\t90\t0\t*\t*
r3\t65\tChr1_2_c1\t40\t60\t50M\tChr2_1_c1\t50\t0\t*\t*
r4\t129\tChr2_1_c1\t60\t60\t50M\t=\t10\t0\t*\t*
r5\t65\tChr2_1_c1\t70\t60\t50M\tChr1_1_c1\t5\t0\t*\t*
"""

TRACEJOB = """\
10/17/2026 10:00:00  S    Job Queued
10/17/2026 11:00:00  S    Exit_status=0 resources_used.cput=01:02:03 \
resources_used.mem=${MEM}kb resources_used.vmem=9kb \
resources_used.walltime=00:${MIN}:30
"""


def _template_allele(d):
    """tests/test_sim_harness.py's collapsed-region input: 2 template
    chromosomes of 3 kb and a 4-haplotype allele table."""
    rng = random.Random(3)
    chrlen = 3000
    seqs, recs = {}, []
    for cid in ('Chr1_t', 'Chr2_t'):
        s = ''.join(rng.choice('ACGT') for _ in range(chrlen))
        seqs[cid] = s
        recs.append('>{}\n{}\n'.format(cid, s))
    (d / 'coll_template.fa').write_text(''.join(recs))
    rows = ['Number\tChrom\tRef_coord\tRef_base\th1\th2\th3\th4\n']
    n = 0
    for cid in seqs:
        for pos in range(50, chrlen, 97):
            n += 1
            ref = seqs[cid][pos - 1]
            alts = [c for c in 'ACGT' if c != ref]
            rows.append('{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\n'.format(
                n, cid, pos, ref, ref, alts[0], ref, alts[1]))
    (d / 'coll_allele_info.txt').write_text(''.join(rows))


def _inputs(d):
    """Every input of the cases, written into ``d``."""
    (d / 'x.agp').write_text(AGP)
    (d / 'g.assembly').write_text(ASSEMBLY)
    (d / 'chr.assembly').write_text(
        '>Chr1_f1 1 100\n>Chr1_f2 2 60\n>debris 3 10\n1 -2\n3\n1 2\n')
    # convert_lachesis
    (d / 'lach.fa').write_text('>c1\nACGT\n>c2\nACGTAC\n>c3\nAC\n')
    (d / 'clusters.by_name.txt').write_text('#comment\nc1 c2\nc3\n')
    (d / 'group0.ordering').write_text('#h\n0\tc2\t1\n1\tc1\t0\n')
    (d / 'group1.ordering').write_text('0\tc3\t0\n0\tcX\t0\n')
    # sim_group_files
    (d / 'sg.fa').write_text(
        '>g1_a\ngatcGATC\n>g1_b\nGATCGATCGATC\n>g2_a\nAAAA\n')
    (d / 'g.tour').write_text('>INIT\na+ b-\n>GA500-1.25\na+ b-\n'
                              '>GA1000-2.50\nb- a+\n')
    # result_statistics
    recs = ['>{}\n{}\n'.format(name, 'A' * ln) for name, ln in
            [('Chr1_hap1_c1', 100), ('Chr1_hap1_c2', 50),
             ('Chr1_hap2_c1', 80), ('Chr4_hap1_c1', 60),
             ('chimeric_1', 40)]]
    (d / 'rs.fa').write_text(''.join(recs))
    (d / 'rs_g1.txt').write_text('Chr1_hap1_c1\tNA\t100\n'
                                 'Chr1_hap1_c2\tNA\t50\n'
                                 'Chr1_hap2_c1\tNA\t80\n')
    (d / 'rs_g2.txt').write_text('Chr4_hap1_c1\tNA\t60\n'
                                 'chimeric_1\tNA\t40\n')
    # link_statistics
    (d / 'ls.fa').write_text('>Chr1_hap1_c1\nAAAA\n>Chr1_hap2_c1\nAAAA\n'
                             '>Chr2_hap1_c1\nAAAA\n')
    bamutil.write_bam(
        str(d / 'ls.bam'), ['Chr1_hap1_c1', 'Chr1_hap2_c1',
                            'Chr2_hap1_c1'], [4, 4, 4],
        [bamutil.bam_record(0, 1, 1, 1, 0x40 | 0x1, name=b'p1'),
         bamutil.bam_record(0, 1, 2, 1, 0x40 | 0x1, name=b'p2'),
         bamutil.bam_record(1, 1, 2, 1, 0x80 | 0x1, name=b'p2')])
    # shuffle_fasta, split_fasta, sample_mnd, sort_agp
    (d / 'shuf.fa').write_text(''.join('>{}\n{}\n'.format(i, 'ACGT' * (i + 1))
                                       for i in range(8)))
    (d / 'split.fa').write_text(
        '>s1\nACGTACGTAC\nNNN\nGGGGCCCC\n>s2\nTTTTTTTT\n')
    (d / 'm.txt').write_text(''.join('line{}\n'.format(i)
                                     for i in range(100)))
    lines = []
    for g, chrom in [('groupA', 'Chr2_hap1'), ('groupB', 'Chr1_hap1'),
                     ('groupC', 'Chr3_hap1')]:
        for i in range(10):
            lines.append('{}\t1\t100\t{}\tW\t{}_ctg{}_x\t1\t100\t+\n'
                          .format(g, i + 1, chrom, i))
    (d / 'sort.agp').write_text(''.join(lines))
    # sim_switch_errors
    (d / 'template.fa').write_text('>Chr1_t\nACGTACGTAC\n>Chr2_t\n'
                                   'GGGGCCCC\n')
    (d / 'allele_info.txt').write_text(
        'Number\tChrom\tRef_coord\tRef_base\thap_1\thap_2\n'
        '1\tChr1_t\t2\tC\tC\tT\n'
        '2\tChr1_t\t5\tA\tG\tA\n'
        '3\tChr2_t\t3\tG\tG\t-\n'
        '4\tChr2_t\t6\tC\tA\tC\n')
    # sim_for_reassignment
    recs = []
    for chrom in ('Chr1', 'Chr2'):
        for hap in (1, 2):
            for i in range(5):
                recs.append('>{}_{}_c{}\n{}\n'.format(
                    chrom, hap, i, 'A' * (10 + i)))
    (d / 'reassign.fa').write_text(''.join(recs))
    # break points and corrected contigs
    (d / 'bp_raw.fa').write_text('>ctg1\nAAAA\n>chimeric_inter_homo_x\n'
                                 'CCCC\n')
    (d / 'bp_cor.fa').write_text('>ctg1\nAAAA\n'
                                 '>chimeric_inter_homo_x_break1\nCC\n'
                                 '>chimeric_inter_homo_x_break2\nCC\n')
    (d / 'ec_raw.fa').write_text('>c1\nAACCGGTT\n>c2\nTTTT\n')
    (d / 'ec_y.agp').write_text('s1\t1\t4\t1\tW\tc1\t1\t4\t+\n'
                                's1\t5\t8\t2\tW\tc1\t5\t8\t+\n'
                                's2\t1\t4\t1\tW\tc2\t1\t4\t-\n')
    (d / 'ec_s.agp').write_text('s1\t1\t4\t1\tW\tc1_0\t1\t4\t+\n'
                                's2\t1\t4\t1\tW\tc1_1\t1\t4\t+\n')
    (d / 'ec.assembly').write_text('>c1:::fragment_1 1 4\n'
                                   '>c1:::fragment_2 2 4\n'
                                   '>hic_gap_1 3 100\n1 2\n')
    cid = 'Chr1_1_chimeric_inter_homo_1_100_2000_x_y_z_a_b_3000_0'
    (d / 'correction_stat.txt').write_text(
        'HapHiC\t1M\t{}\tInter_homo\t1\t950\n'.format(cid) +
        'HapHiC\t1M\tctgA\tNon_chimeric\t0\tNA\n' +
        'YaHS\t1M\t{}\tInter_nonhomo\t0\tNA\n'.format(cid))
    (d / 'cb_raw.fa').write_text('>chimeric_inner_chrom_1\n' + 'A' * 10 +
                                 '\n>ctgB\nCCCC\n')
    (d / 'cb_y.agp').write_text(
        's1\t1\t6\t1\tW\tchimeric_inner_chrom_1\t1\t6\t+\n'
        's2\t1\t4\t1\tW\tchimeric_inner_chrom_1\t7\t10\t+\n'
        's2\t5\t8\t2\tW\tctgB\t1\t4\t+\n')
    (d / 'cb_s.agp').write_text(
        's1\t1\t6\t1\tW\tchimeric_inner_chrom_1_0\t1\t6\t+\n'
        's2\t1\t4\t1\tW\tchimeric_inner_chrom_1_1\t1\t4\t+\n')
    (d / 'cb.assembly').write_text(
        '>chimeric_inner_chrom_1:::fragment_1 1 4\n'
        '>chimeric_inner_chrom_1:::fragment_2:::debris 2 2\n'
        '>chimeric_inner_chrom_1:::fragment_3 3 4\n'
        '>ctgB 4 4\n1 3\n4\n')
    (d / 'cb_cor.fa').write_text('>chimeric_inner_chrom_1_1_6\nAAAAAA\n'
                                 '>chimeric_inner_chrom_1_7_10\nAAAA\n'
                                 '>ctgB\nCCCC\n')
    _template_allele(d)
    # generic_result_statistics
    (d / 'gr.fa').write_text('>Chr1_1_c1\n' + 'A' * 100 + '\n'
                             '>Chr1_2_c1\n' + 'A' * 80 + '\n'
                             '>scaff_x\n' + 'A' * 20 + '\n')
    (d / 'gr_g1.txt').write_text('Chr1_1_c1\tNA\t100\nChr1_2_c1\tNA\t80\n'
                                 'scaff_x\tNA\t20\n')
    # draw_tour_file
    (d / 'dt_ref.fa').write_text('>Chr1_x\n' + 'A' * 200 + '\n')
    (d / 'g1.tour').write_text(
        '>INIT\nChr1_1_1_100_+_100+ Chr1_2_101_200_+_100+\n')
    (d / 'g2.tour').write_text(
        '>INIT\nChr1_1_1_100_+_100+ Chr1_2_101_200_+_100-\n')
    # the small analysis tools
    (d / 'Allele.ctg.table').write_text(
        'Chr1\t100\tChr1_1_c1\tChr1_2_c1\n')
    (d / 'correlation.txt').write_text(
        'Chr1_1_c1\tChr1_2_c1\tx\tx\t0.5\tx\t0.3\n'
        'Chr1_1_c1\tChr2_1_c1\tx\tx\t0.9\tx\t0.7\n')
    (d / 'ai.txt').write_text('Number\tChrom\tRef\tRefB\th1\th2\th3\th4\n'
                              '1\tChr1_1\t5\tA\tA\tG\tA\tT\n'
                              '2\tChr2_1\t9\tC\tC\tC\tC\tC\n')
    (d / 'new_ai.txt').write_text(
        'Number\tChrom\tRef\tRefB\th1\th2\th3\th4\n'
        '1\tChr1_1\t5\tA\tG\tA\tA\tT\n'
        '2\tChr2_1\t9\tC\tC\tC\tC\tC\n')
    (d / 'link_density.txt').write_text('t0\tChr1_12_5_9_collapsed\t1.5\n'
                                        't0\tChr1_1_c\t0.5\n')
    (d / 'a.paf').write_text(
        'q\t100\t10\t50\t+\ts\t200\t30\t70\t40\t40\t60\n'
        'q\t100\t10\t50\t-\ts\t200\t30\t70\t40\t40\t60\n')
    (d / 'm.mnd').write_text('0 Chr1_a 5 0 0 Chr1_b 9 1\n'
                             '0 Chr1_a 5 0 0 Chr2_b 9 1\n'
                             '0 Chr2_a 2 0 0 Chr2_c 3 1\n')
    (d / 'r.fq').write_text('@a\nACGTACGT\n+\nIIIIIIII\n@b\nACG\n+\nIII\n')
    with gzip.open(d / 'r2.fq.gz', 'wt') as f:
        f.write('@c\nACGTAC\n+\nIIIIII\n@e\nACGTACGTAA\n+\nIIII\n')
    # ROC statistics
    (d / 'roc.fa').write_text('>ctg_inter_homo_chimeric_1\nAAAA\n'
                              '>good_1_x\nCCCC\n>good_1_y\nGGGG\n')
    (d / 'cluster.log').write_text(
        'ts [rank sum filtering] Fragment good_1_x, rank sum=1\n'
        'ts [rank sum filtering] Fragment good_1_y, rank sum=2\n'
        'ts [rank sum filtering] Fragment ctg_inter_homo_chimeric_1, '
        'rank sum=9\n')
    (d / 'col.fa').write_text('>Chr1_12_1_9_collapsed\nAAAA\n'
                              '>Chr1_1_c\nCC\n')
    (d / 'cluster2.log').write_text(
        'ts [link density filtering] Fragment Chr1_1_c, density=0.5\n'
        'ts [link density filtering] Fragment Chr1_12_1_9_collapsed, '
        'density=2.5\n'
        'ts [rank sum filtering] Fragment Chr1_1_c, rank sum=3\n'
        'ts [rank sum filtering] Fragment Chr1_12_1_9_collapsed, '
        'rank sum=7\n')
    # synteny
    (d / 'genes.bed').write_text('Chr02\t100\t200\tg1\t0\t+\n'
                                 'Chr02\t300\t400\tg2\t0\t+\n'
                                 'Chr01\t10\t20\tg0\t0\t+\n')
    (d / 'x.anchors.simple').write_text('g*g1\tg2\tg1\tg2\t0\t-\n')
    (d / 'a.bed').write_text('c1\t1\t2\ta1\t0\t+\nc1\t3\t4\ta2\t0\t+\n'
                             'c1\t5\t6\ta3\t0\t+\n')
    (d / 'b.bed').write_text('d1\t1\t2\tb1\t0\t+\nd1\t3\t4\tb2\t0\t+\n'
                             'd1\t5\t6\tb3\t0\t+\n')
    (d / 'x.simple').write_text('a1\ta1\tb1\tb1\t0\t+\n'
                                'a2\ta2\tb3\tb3\t0\t+\n'
                                'a3\ta3\tb2\tb2\t0\t+\n')
    # mock_delta
    rng = random.Random(13)
    chr1 = ''.join(rng.choice('ACGT') for _ in range(120))
    (d / 'md_ref.fa').write_text('>Chr1\n{}\n'.format(chr1))
    (d / 'md_scaffolds.fa').write_text('>scaffold_1\n{}\n'.format(
        chr1[:60] + 'N' * 10 + chr1[60:]))
    (d / 'md.agp').write_text(
        'scaffold_1\t1\t60\t1\tW\tChr1_ctg1_+\t1\t60\t+\n'
        'scaffold_1\t61\t70\t2\tU\t10\tscaffold\tyes\t'
        'proximity_ligation\n'
        'scaffold_1\t71\t130\t3\tW\tChr1_ctg2_-\t1\t60\t-\n')
    rng = random.Random(7)
    chr1 = ''.join(rng.choice('ACGT') for _ in range(120))
    un = ''.join(rng.choice('ACGT') for _ in range(40))
    (d / 'mc_ref.fa').write_text('>Chr1\n{}\n>Un\n{}\n'.format(chr1, un))
    (d / 'mc_scaffolds.fa').write_text(
        '>scaffold_1\n{}\n>scaffold_2\n{}\n'.format(
            chr1[:60] + 'N' * 10 + un + chr1[60:], chr1[:30]))
    (d / 'mc.agp').write_text(
        'scaffold_1\t1\t60\t1\tW\tChr1_ctg1_+\t1\t60\t+\n'
        'scaffold_1\t61\t70\t2\tU\t10\tscaffold\tyes\t'
        'proximity_ligation\n'
        'scaffold_1\t71\t110\t3\tW\tUn_ctg1_+\t1\t40\t+\n'
        'scaffold_1\t111\t170\t4\tW\tChr1_ctg2_-\t1\t60\t-\n'
        'scaffold_2\t1\t30\t1\tW\tChr1_ctg3_+\t1\t30\t+\n')
    # haplotype_kmers
    rng = random.Random(21)
    h1 = ''.join(rng.choice('ACGT') for _ in range(300))
    h2 = h1[:100] + ''.join(rng.choice('ACGT')
                            for _ in range(100)) + h1[200:]
    (d / 'hk_ref.fa').write_text('>Chr1_1\n{}\n>Chr1_2\n{}\n'.format(h1, h2))
    (d / 'hk_asm.fa').write_text('>ctgA\n{}\n>ctgB\n{}\n'.format(
        h2[80:220], h1[150:300]))
    # allelic_contig_statistics
    a1 = 'Chr1_1_1_1_10000_+_10000'
    a2 = 'Chr1_2_1_1_10000_+_10000'
    b1 = 'Chr1_1_2_10001_20000_+_10000'
    pre = '2026-01-01 00:00:00 <prune> [remove_allelic_links] '
    (d / 'allelic.log').write_text(
        pre + '{} {} links=30 concordance_ratio=0.8\n'.format(a1, a2) +
        pre + '{} {} links=25 concordance_ratio=0.6\n'.format(a1, b1) +
        pre + '{} {} links=3 concordance_ratio=0.9\n'.format(a2, b1))
    (d / 'allelic.table').write_text('Chr1\tgene1\t{}\t{}\n'.format(a1, a2))
    # get_discordant_HiC_links
    ctga = 'C_1_1_1_100_+_100'
    ctgb = 'C_1_2_101_200_+_100'
    (d / 'truth.agp').write_text(
        's1\t1\t100\t1\tW\t{}\t1\t100\t-\n'.format(ctgb) +
        's1\t101\t200\t2\tU\t100\tscaffold\tyes\tproximity_ligation\n'
        's1\t201\t300\t3\tW\t{}\t1\t100\t-\n'.format(ctga))
    (d / 'good.agp').write_text(
        's1\t1\t100\t1\tW\t{}\t1\t100\t+\n'.format(ctga) +
        's1\t101\t200\t2\tU\t100\tscaffold\tyes\tproximity_ligation\n'
        's1\t201\t300\t3\tW\t{}\t1\t100\t+\n'.format(ctgb))
    (d / 'bad.agp').write_text(
        'sA\t1\t100\t1\tW\t{}\t1\t100\t+\n'.format(ctga) +
        'sB\t1\t100\t1\tW\t{}\t1\t100\t+\n'.format(ctgb))
    recs = [bamutil.bam_record(0, 10, 0, 50, 0x40 | 0x1) for _ in range(3)]
    recs += [bamutil.bam_record(0, 20, 1, 30, 0x40 | 0x1) for _ in range(2)]
    bamutil.write_bam(str(d / 'hic.bam'), [ctga, ctgb], [100, 100], recs)
    # correction_analysis
    (d / 'ca_raw.fa').write_text(
        '>ctgX\n{}\n>hapA_chr1\n{}\n>hapB_chr1\n{}\n'.format(
            'A' * 30000, 'C' * 1000, 'G' * 1000))
    (d / 'anno.txt').write_text('chimeric:\nctgX\nnonchimeric:\n')
    (d / 't1.agp').write_text(
        's1\t1\t15000\t1\tW\tctgX_break1\t1\t15000\t+\n'
        's1\t15001\t30000\t2\tW\tctgX_break2\t1\t15000\t+\n')
    (d / 't2.agp').write_text(
        's1\t1\t15000\t1\tW\tctgX_1_15000\t1\t15000\t+\n'
        's1\t15001\t30000\t2\tW\tctgX_15001_30000\t1\t15000\t+\n')
    bamutil.write_bam(
        str(d / 'ca.bam'), ['ctgX', 'hapA_chr1', 'hapB_chr1'],
        [30000, 1000, 1000],
        [bamutil.bam_record(0, 1000, 0, 12000, 0x40 | 0x1),
         bamutil.bam_record(0, 5000, 1, 10, 0x40 | 0x1),
         bamutil.bam_record(0, 25000, 2, 10, 0x40 | 0x1)])
    # filter_bam_from_list
    (d / 'drop.txt').write_text('r2\n\nr4\n')


# each case: (harness module, output, error) -> return value; it runs
# with its package's own directory (the inputs written there) as cwd
CASES = {
    'convert_agp_to_tour': lambda h, out, err: h.convert_agp_to_tour(
        'x.agp', 'out'),
    'convert_assembly_to_tour': lambda h, out, err:
        h.convert_assembly_to_tour('g.assembly', 'out'),
    'convert_agp_to_groups': lambda h, out, err: h.convert_agp_to_groups(
        'x.agp'),
    'convert_assembly_to_groups': lambda h, out, err:
        h.convert_assembly_to_groups('chr.assembly'),
    'convert_lachesis': lambda h, out, err: (
        h.convert_lachesis_result_to_groups('clusters.by_name.txt',
                                            'lach.fa'),
        h.convert_lachesis_ordering_to_tour(
            'lach.fa', 'lach', ['group1.ordering', 'group0.ordering'])),
    'sim_group_files': lambda h, out, err: h.sim_group_files('sg.fa'),
    'score_statistics': lambda h, out, err: h.score_statistics(
        'g.tour', 'Chr1', '1M', 'HapHiC', out=out, err=err),
    'score_statistics-each_iteration': lambda h, out, err:
        h.score_statistics('g.tour', 'Chr1', '1M', 'HapHiC',
                           each_iteration=True, out=out, err=err),
    'result_statistics': lambda h, out, err: h.result_statistics(
        'rs.fa', ['rs_g1.txt', 'rs_g2.txt'], out=out, err=err),
    'result_statistics-excluded': lambda h, out, err: h.result_statistics(
        'rs.fa', ['rs_g1.txt', 'rs_g2.txt'], excluded_chrs=('Chr1',),
        out=out, err=err),
    'link_statistics': lambda h, out, err: h.link_statistics(
        'ls.fa', 'ls.bam', 'tag0'),
    'shuffle_fasta': lambda h, out, err: h.shuffle_fasta(
        'shuf.fa', seed=7, offset=2),
    'split_fasta': lambda h, out, err: h.split_fasta(
        'split.fa', bin_size=None, seed=3, out=out),
    'split_fasta-bins': lambda h, out, err: h.split_fasta(
        'split.fa', bin_size=4, seed=5, out=out),
    'sample_mnd': lambda h, out, err: h.sample_mnd(
        'm.txt', 100, 0.2, seed=5, out=out),
    'sort_agp': lambda h, out, err: h.sort_agp(
        'sort.agp', ['Chr1_hap1', 'Chr2_hap1'], out=out),
    'sim_switch_errors': lambda h, out, err: h.sim_switch_errors(
        'template.fa', 'allele_info.txt', rate=0.5, seed=7),
    'get_haphic_break_points': lambda h, out, err:
        h.get_haphic_break_points('bp_raw.fa', 'bp_cor.fa', '1M', out=out),
    'extract_corrected_ctgs_from_yahs_agp': lambda h, out, err:
        h.extract_corrected_ctgs_from_yahs_agp('ec_y.agp', 'ec_raw.fa',
                                               out=out),
    'extract_corrected_ctgs_from_salsa_agp': lambda h, out, err:
        h.extract_corrected_ctgs_from_salsa_agp('ec_s.agp', 'ec_raw.fa',
                                                out=out),
    'extract_corrected_ctgs_from_3d_dna_assembly': lambda h, out, err:
        h.extract_corrected_ctgs_from_3d_dna_assembly(
            'ec.assembly', 'ec_raw.fa', out=out),
    'summarize_correction': lambda h, out, err: h.summarize_correction(
        'correction_stat.txt'),
    'get_yahs_break_points': lambda h, out, err: h.get_yahs_break_points(
        'cb_raw.fa', 'cb_y.agp', '1M', out=out),
    'get_salsa_break_points': lambda h, out, err: h.get_salsa_break_points(
        'cb_raw.fa', 'cb_s.agp', '1M', out=out),
    'get_3d_dna_break_points': lambda h, out, err:
        h.get_3d_dna_break_points('cb_raw.fa', 'cb.assembly', '1M',
                                  out=out),
    'get_allhic_break_points': lambda h, out, err:
        h.get_allhic_break_points('cb_raw.fa', 'cb_cor.fa', '1M', out=out),
    'sim_collapsed_regions': lambda h, out, err: h.sim_collapsed_regions(
        'coll_template.fa', 'coll_allele_info.txt', collapsed_len=400,
        collapsed_ratio=0.2, seed=9),
    'sim_collapsed_regions-strict': lambda h, out, err:
        h.sim_collapsed_regions(
            'coll_template.fa', 'coll_allele_info.txt', collapsed_len=300,
            collapsed_ratio=0.3, weights=(0.2, 0.3, 0.5), seed=4,
            strict=True),
    'generic_result_statistics': lambda h, out, err:
        h.generic_result_statistics('gr.fa', r'Chr\d+_\d+', ['gr_g1.txt'],
                                    out=out, err=err),
    'draw_tour_file': lambda h, out, err: (
        h.draw_tour_file('dt_ref.fa', 'g1.tour', 'HapHiC', '1M', ccc=True,
                         plot=False, out=out),
        h.draw_tour_file('dt_ref.fa', 'g2.tour', 'HapHiC', '1M', ccc=True,
                         plot=False, out=out)),
    'add_allele_tag': lambda h, out, err: h.add_allele_tag(
        'correlation.txt', 'Allele.ctg.table', out=out),
    'allele_statistics': lambda h, out, err: h.allele_statistics(
        'ai.txt', 'stats'),
    'density_statistics': lambda h, out, err: h.density_statistics(
        'link_density.txt', out=out),
    'get_paf_alignments': lambda h, out, err: h.get_paf_alignments(
        ['a.paf', 'a.paf'], out=out),
    'interpret_switch_errors': lambda h, out, err:
        h.interpret_switch_errors('ai.txt', 'new_ai.txt', out=out),
    'split_mnd': lambda h, out, err: h.split_mnd('m.mnd', ['Chr1', 'Chr2']),
    'filter_fastq_len': lambda h, out, err: h.filter_fastq_len(
        ['r.fq', 'r2.fq.gz'], len_cutoff=5, out_path='out.fq.gz'),
    'chimeric_contig_statistics': lambda h, out, err:
        h.chimeric_contig_statistics('roc.fa', 'cluster.log', '1M'),
    'collapsed_contig_statistics': lambda h, out, err:
        h.collapsed_contig_statistics('col.fa', 'cluster2.log', 't0'),
    'collapsed_contig_statistics-rank_sum': lambda h, out, err:
        h.collapsed_contig_statistics('col.fa', 'cluster2.log', 't1',
                                      method='rank_sum'),
    'extract_SVs_from_simple': lambda h, out, err:
        h.extract_SVs_from_simple('x.anchors.simple', 'genes.bed'),
    'filter_orthologous_anchors': lambda h, out, err:
        h.filter_orthologous_anchors('x.simple', 'a.bed', 'b.bed', ['c1'],
                                     ['d1'], out=out),
    'mock_delta': lambda h, out, err: h.validate_mock_delta(
        'md_ref.chrs.nogaps.fa', 'md_scaffolds.chrs.nogaps.fa',
        h.mock_delta('md.agp', 'md_scaffolds.fa', 'md_ref.fa'), out=out),
    'haplotype_kmers': lambda h, out, err: h.haplotype_kmers(
        'hk_ref.fa', 'hk_asm.fa', kmer_size=21, bin_size=1000),
    'allelic_contig_statistics': lambda h, out, err:
        h.allelic_contig_statistics('allelic.log', 'allelic.table', '1M'),
    'get_discordant_hic_links': lambda h, out, err:
        h.get_discordant_hic_links(
            'truth.agp', [('Good', 'good.agp'), ('Bad', 'bad.agp')],
            'hic.bam', bin_size=100, out=out),
    'correction_analysis': lambda h, out, err: h.correction_analysis(
        'ca_raw.fa', 'ca.bam', 'anno.txt',
        [('AutoHiC', 't1.agp'), ('ALLHiC', 't2.agp')], ['hapA', 'hapB']),
    'mock_delta_chrs_only': lambda h, out, err: h.mock_delta_chrs_only(
        'mc.agp', 'mc_scaffolds.fa', 'mc_ref.fa', 'Chr'),
    'filter_bam_from_list': lambda h, out, err: h.filter_bam_from_list(
        'in.bam', 'drop.txt', threads=3, out=out),
    'split_bam': lambda h, out, err: h.split_bam('in.bam', ['Chr1', 'Chr2'],
                                                 threads=2),
    'pbsperf': lambda h, out, err: h.pbsperf(['1001.pbs', '1002'],
                                             ndays=7, out=out),
}
CASES.update({
    'sim_for_reassignment-' + t: (
        lambda t, r: lambda h, out, err: h.sim_for_reassignment(
            'reassign.fa', r, error_type=t, seed=11,
            output_groups=True))(t, r)
    for t, r in [('inter_homo', 0.4), ('inter_nonhomo', 0.4),
                 ('anchoring_rate', 0.2), ('contiguity', 0.5)]})


def _stub_bin(d):
    """A directory holding stub `samtools` (prints SAM and its own
    arguments as an @CO line) and `tracejob` (one finished PBS job)."""
    b = d / 'bin'
    b.mkdir()
    (b / 'samtools').write_text(
        '#!/bin/sh\nprintf "@CO\\targs: %s\\n" "$*"\ncat <<"EOF"\n' + SAM
        + 'EOF\n')
    (b / 'tracejob').write_text(
        '#!/bin/sh\nMEM=$((${1} * 1000))\nMIN=$((${1} % 60))\ncat <<EOF\n'
        + TRACEJOB + 'EOF\n')
    for f in ('samtools', 'tracejob'):
        os.chmod(b / f, 0o755)
    return str(b)


def _norm(x, d):
    """``x`` with the working directory's path replaced by '<cwd>'."""
    if isinstance(x, str):
        return x.replace(d, '<cwd>')
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, d) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v, d) for k, v in x.items()}
    return x


def _files(d):
    """{relative path: bytes} of every file under ``d``, with ``d``'s
    own path replaced by '<cwd>'; gzip files decompressed (their header
    holds the time they were written)."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            opener = gzip.open if f.endswith('.gz') else open
            with opener(p, 'rb') as fh:
                out[os.path.relpath(p, d)] = fh.read().replace(
                    d.encode(), b'<cwd>')
    return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_harness_byte_equal(case, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv('PATH', _stub_bin(tmp_path) + os.pathsep +
                       os.environ.get('PATH', ''))
    got = []
    for h, name in ((jh, 'jax'), (th, 'torch')):
        cwd = tmp_path / name
        cwd.mkdir()
        _inputs(cwd)
        bamutil.write_bam(str(cwd / 'in.bam'), ['Chr1_1_c1'], [1000], [])
        before = _files(str(cwd))
        monkeypatch.chdir(cwd)
        out, err = io.StringIO(), io.StringIO()
        capsys.readouterr()
        ret = CASES[case](h, out, err)
        std = capsys.readouterr()
        after = _files(str(cwd))
        written = {k: v for k, v in after.items() if before.get(k) != v}
        got.append((_norm(ret, str(cwd)), out.getvalue(), err.getvalue(),
                    std.out, std.err, written))
    assert got[1] == got[0]
    ret, out, err, _, _, written = got[1]
    assert out or written, case         # each case writes something


def test_harness_checks_hold_on_the_port(tmp_path, monkeypatch):
    """What tests/test_sim_harness.py asserts beyond parity, on the
    port's output."""
    monkeypatch.setenv('PATH', _stub_bin(tmp_path) + os.pathsep +
                       os.environ.get('PATH', ''))
    _inputs(tmp_path)
    bamutil.write_bam(str(tmp_path / 'in.bam'), ['Chr1_1_c1'], [1000], [])
    monkeypatch.chdir(tmp_path)
    th.convert_assembly_to_tour('g.assembly', 'out')
    assert open('out.tour').read().splitlines()[1] == 'ctgA+ ctgB- ctgC+'
    assert [os.path.basename(p) for p in
            th.convert_agp_to_groups('x.agp')] == ['group1.txt',
                                                   'group2.txt']
    assert open('group2.txt').read() == \
        'ctgC_seg1\tNA\t50\nctgA_seg2\tNA\t70\n'
    out, err = io.StringIO(), io.StringIO()
    th.score_statistics('g.tour', 'Chr1', '1M', 'HapHiC',
                        each_iteration=True, out=out, err=err)
    assert out.getvalue() == ('HapHiC\tChr1\t1M\t2.50\n'
                              'HapHiC_presort\tChr1\t1M\t1.25\n')
    ids = [l[1:] for l in open(th.shuffle_fasta('shuf.fa', seed=7,
                                                offset=2))
           if l.startswith('>')]
    expect = [str(i) for i in range(8)]
    rng = random.Random()
    rng.seed(9)
    rng.shuffle(expect)
    assert [i.strip() for i in ids] == expect
    out = io.StringIO()
    lines, ccc = th.draw_tour_file('dt_ref.fa', 'g1.tour', 'HapHiC', '1M',
                                   ccc=True, plot=False, out=out)
    assert ccc == pytest.approx(1.0)
    out = io.StringIO()
    th.validate_mock_delta(
        'md_ref.chrs.nogaps.fa', 'md_scaffolds.chrs.nogaps.fa',
        th.mock_delta('md.agp', 'md_scaffolds.fa', 'md_ref.fa'), out=out)
    assert out.getvalue() == 'Check Passed...\n'
    out = io.StringIO()
    th.filter_bam_from_list('in.bam', 'drop.txt', threads=3, out=out)
    reads = [l.split('\t')[0] for l in out.getvalue().splitlines()
             if not l.startswith('@')]
    assert reads == ['r1', 'r3', 'r5']
    assert out.getvalue().startswith('@CO\targs: view -h in.bam -@ 3\n')
    chr1, chr2 = th.split_bam('in.bam', ['Chr1', 'Chr2'])
    assert [l.split('\t')[0] for l in open(chr1)
            if not l.startswith('@')] == ['r1', 'r2']
    assert [l.split('\t')[0] for l in open(chr2)
            if not l.startswith('@')] == ['r4']
    assert th.pbsperf(['1001.pbs', '1002'], out=io.StringIO()) == \
        (round((41 * 60 + 30 + 42 * 60 + 30) / 60, 2),
         round(2 * 3723 / 60, 2), round(1002000 / 1024 ** 2, 2))


@pytest.mark.parametrize('argv', [
    ['convert_agp_to_tour', 'x.agp', 'out'],
    ['convert_agp_to_groups', 'x.agp'],
    ['convert_lachesis_ordering_to_tour', 'lach.fa', 'lach',
     'group1.ordering', 'group0.ordering'],
    ['sim_group_files', 'sg.fa'],
    ['shuffle_fasta', 'shuf.fa', '--seed', '3', '--offset', '1'],
    ['sim_switch_errors', 'template.fa', 'allele_info.txt', '--rate',
     '0.5', '--seed', '2'],
    ['sim_for_reassignment', 'reassign.fa', '0.3', '--error_type',
     'contiguity', '--output_groups', '--seed', '4'],
    ['summarize_correction', 'correction_stat.txt'],
    ['sim_collapsed_regions', 'coll_template.fa', 'coll_allele_info.txt',
     '--collapsed_len', '400', '--weights', '0.5,0.3,0.2', '--seed', '6'],
    ['mock_delta_chrs_only', 'mc.agp', 'mc_scaffolds.fa', 'mc_ref.fa',
     'Chr'],
    ['get_discordant_HiC_links', 'truth.agp', 'hic.bam', '--agp', 'Good',
     'good.agp', '--agp', 'Bad', 'bad.agp', '--bin_size', '100'],
    ['split_bam', 'in.bam', 'Chr1', 'Chr2', '--threads', '2'],
], ids=lambda a: a[0])
def test_sim_cli_writes_as_haphic_tpu(argv, tmp_path, monkeypatch):
    """`sim` tools that write files, through both CLIs."""
    monkeypatch.setenv('PATH', _stub_bin(tmp_path) + os.pathsep +
                       os.environ.get('PATH', ''))
    written = []
    for main, name in ((jmain, 'jax'), (tmain, 'torch')):
        cwd = tmp_path / name
        cwd.mkdir()
        _inputs(cwd)
        bamutil.write_bam(str(cwd / 'in.bam'), ['Chr1_1_c1'], [1000], [])
        before = _files(str(cwd))
        monkeypatch.chdir(cwd)
        assert main(['sim'] + argv) == 0
        after = _files(str(cwd))
        written.append({k: v for k, v in after.items()
                        if before.get(k) != v})
    assert written[1] == written[0] and written[1]


@pytest.mark.parametrize('argv', [
    ['score_statistics', 'g.tour', 'Chr1', '1M', 'HapHiC',
     '--each_iteration'],
    ['get_paf_alignments', 'a.paf'],
    ['filter_bam_from_list', 'in.bam', 'drop.txt', '--threads', '2'],
], ids=lambda a: a[0])
def test_sim_cli_prints_as_haphic_tpu(argv, tmp_path):
    """`sim` tools that print, through both CLIs in processes of their
    own (the harness binds sys.stdout as a default at import)."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO,
               PATH=_stub_bin(tmp_path) + os.pathsep +
               os.environ.get('PATH', ''))
    _inputs(tmp_path)
    bamutil.write_bam(str(tmp_path / 'in.bam'), ['Chr1_1_c1'], [1000], [])
    runs = []
    for mod in ('haphic_tpu', 'haphic_tpu_torch'):
        p = subprocess.run([sys.executable, '-m', mod, 'sim'] + argv,
                           cwd=str(tmp_path), env=env, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        # absl's log lines (XLA's CPU loader) are JAX's, not the tool's
        runs.append((p.stdout, [l for l in p.stderr.splitlines()
                                if not re.match(r'[EWI]\d{4} ', l)]))
    assert runs[1] == runs[0] and runs[1][0]

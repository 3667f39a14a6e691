"""Command-line interface of the port: ``python -m haphic_tpu_torch``.

Port of haphic_tpu/cli.py for the subcommands pipeline, cluster,
reassign, sort, build, check, plot, refsort, util, sim, allhic and
juicer, with the same flags. The commands that use the card (pipeline,
cluster, sort, allhic, plot, sim ga_study) also take ``--device
cuda|cpu`` (default cuda); asking for CUDA on a host without a card
raises.

Under torchrun every process runs the same command: ``main`` joins the
process group (parallel/mesh.py), and rank r > 0 writes to the sibling
directory ``<outdir>.rank<r>`` so that two processes never write one
path.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from haphic_tpu_torch._version import __version__, __update_time__


def _add_cluster_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group('clustering')
    g.add_argument('--RE', default='GATC',
                   help='restriction enzyme site(s), comma separated')
    g.add_argument('--bin_size', type=int, default=-1,
                   help='bin size (kbp); -1 auto, 0 disables binning')
    g.add_argument('--flank', type=int, default=500, help='flank size (kbp)')
    g.add_argument('--Nx', type=int, default=80)
    g.add_argument('--RE_site_cutoff', type=int, default=25)
    g.add_argument('--density_lower', default='0.2X')
    g.add_argument('--density_upper', default='1.9X')
    g.add_argument('--topN', type=int, default=10)
    g.add_argument('--rank_sum_upper', default='1.5X')
    g.add_argument('--rank_sum_hard_cutoff', type=int, default=0)
    g.add_argument('--read_depth_upper', default='1.5X')
    g.add_argument('--remove_allelic_links', type=int, default=0,
                   help='ploidy; 0 disables allelic link removal')
    g.add_argument('--remove_concentrated_links', action='store_true')
    g.add_argument('--concentration_ratio', type=float, default=10.0,
                   help='bins holding >= this multiple of the median '
                        'link count are deemed concentrated (the '
                        'reference hardcodes 10)')
    g.add_argument('--concordance_ratio_cutoff', type=float, default=0.2)
    g.add_argument('--nwindows', type=int, default=50)
    g.add_argument('--max_read_pairs', type=int, default=200)
    g.add_argument('--min_read_pairs', type=int, default=20)
    g.add_argument('--phasing_weight', type=float, default=1.0)
    g.add_argument('--normalize_by_nlinks', action='store_true')
    g.add_argument('--min_inflation', type=float, default=1.1)
    g.add_argument('--max_inflation', type=float, default=3.0)
    g.add_argument('--inflation_step', type=float, default=0.1)
    g.add_argument('--max_iter', type=int, default=200)
    g.add_argument('--pruning', type=float, default=1e-4)
    g.add_argument('--mcl_backend', default='auto',
                   choices=['auto', 'dense', 'sparse'],
                   help='MCL engine: dense batched, sparse top-K, or '
                        'auto by fragment count')
    g.add_argument('--sparse_K', type=int, default=0,
                   help='sparse MCL top-K per column (0 = default 128)')
    g.add_argument('--use_mesh', default='auto',
                   choices=['auto', 'on', 'off'],
                   help='shard the MCL sweep + sort GA over the ranks of '
                        'a torch.distributed run, one process per card '
                        '(python -m torch.distributed.run '
                        '--nproc_per_node N -m haphic_tpu_torch ...); '
                        'auto and on shard when there is more than one '
                        'process, off never; rank r > 0 writes to '
                        '<outdir>.rank<r>')
    g.add_argument('--ga_backend', default='auto',
                   choices=['auto', 'device', 'native'],
                   help='sort-stage GA engine (auto picks by work size)')
    g.add_argument('--whitelist', default=None)
    g.add_argument('--gfa', default=None)
    g.add_argument('--quick_view', action='store_true')
    g.add_argument('--correct_nrounds', type=int, default=0)
    g.add_argument('--correct_resolution', type=int, default=500)
    g.add_argument('--median_cov_ratio', type=float, default=0.2)
    g.add_argument('--region_len_ratio', type=float, default=0.1)
    g.add_argument('--min_region_cutoff', type=int, default=5000)
    g.add_argument('--ul', default=None,
                   help='ultra-long read alignments (BAM)')
    g.add_argument('--min_ul_mapq', type=int, default=30)
    g.add_argument('--min_ul_alignment_length', type=int, default=10000)
    g.add_argument('--max_distance_to_end', type=int, default=100)
    g.add_argument('--max_overlap_ratio', type=float, default=0.5)
    g.add_argument('--max_gap_len', type=int, default=10000)
    g.add_argument('--min_ul_support', type=int, default=2)


def _add_reassign_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group('reassignment')
    g.add_argument('--min_group_len', type=float, default=5)
    g.add_argument('--max_ctg_len', type=float, default=10000)
    g.add_argument('--min_RE_sites', type=int, default=25)
    g.add_argument('--min_links', type=int, default=25)
    g.add_argument('--min_link_density', type=float, default=0.0001)
    g.add_argument('--min_density_ratio', type=float, default=4)
    g.add_argument('--ambiguous_cutoff', type=float, default=0.6)
    g.add_argument('--reassign_nrounds', type=int, default=5)
    g.add_argument('--nclusters', type=int, default=0)
    g.add_argument('--no_additional_rescue', action='store_true')


def _add_sort_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group('ordering and orientation')
    g.add_argument('--skip_fast_sort', action='store_true')
    g.add_argument('--skip_allhic', action='store_true',
                   help='skip GA tour optimization')
    g.add_argument('--skipGA', action='store_true')
    g.add_argument('--mutprob', type=float, default=0.2)
    g.add_argument('--ngen', type=int, default=5000)
    g.add_argument('--npop', type=int, default=100)
    g.add_argument('--seed', type=int, default=42)
    g.add_argument('--flanking_region', type=int, default=0)
    g.add_argument('--density_cal_method', default='multiplication',
                   choices=['multiplication', 'sum', 'geometric_mean'])
    g.add_argument('--confidence_cutoff', type=float, default=1.0)


def _add_build_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group('scaffold building')
    g.add_argument('--Ns', type=int, default=100)
    g.add_argument('--max_width', type=int, default=60)
    g.add_argument('--sort_by_input', action='store_true')
    g.add_argument('--prefix', default='scaffolds')


def _add_device_arg(p: argparse.ArgumentParser,
                    what: str = 'the MCL sweep and the GA') -> None:
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='torch device of {} (default: cuda; raises when '
                        'CUDA is absent)'.format(what))


def _config_from_args(args) -> 'PipelineConfig':
    from haphic_tpu_torch.assign.reassign import ReassignParams
    from haphic_tpu_torch.pipeline import PipelineConfig
    cfg = PipelineConfig()
    for name in vars(cfg):
        if hasattr(args, name) and getattr(args, name) is not None \
                and name != 'reassign':
            setattr(cfg, name, getattr(args, name))
    rp = ReassignParams()
    for name in vars(rp):
        if hasattr(args, name):
            setattr(rp, name, getattr(args, name))
    cfg.reassign = rp
    return cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='haphic-tpu-torch',
        description='Hi-C scaffolding on NVIDIA GPUs (HapHiC-compatible), '
                    'version {} (update: {})'.format(__version__,
                                                     __update_time__))
    parser.add_argument('--version', action='version', version=__version__)
    parser.add_argument('--verbose', action='store_true')
    sub = parser.add_subparsers(dest='command', required=True)

    pp = sub.add_parser('pipeline', help='run the whole scaffolding pipeline')
    pp.add_argument('fasta')
    pp.add_argument('alignments', help='.pairs[.gz] or .bam Hi-C alignments')
    pp.add_argument('nchrs', type=int)
    pp.add_argument('--outdir', default='.')
    pp.add_argument('--steps', default='1234')
    _add_device_arg(pp)
    _add_cluster_args(pp)
    _add_reassign_args(pp)
    _add_sort_args(pp)
    _add_build_args(pp)

    pc = sub.add_parser('cluster', help='run only the clustering stage')
    pc.add_argument('fasta')
    pc.add_argument('alignments')
    pc.add_argument('nchrs', type=int)
    pc.add_argument('--outdir', default='.')
    _add_device_arg(pc)
    _add_cluster_args(pc)

    pr2 = sub.add_parser('reassign',
                         help='rescue/reassign contigs from clusters')
    pr2.add_argument('fasta')
    pr2.add_argument('links', help='full_links.pkl or .pairs[.gz]/.bam')
    pr2.add_argument('clusters', help='*.clusters.txt or Juicebox .assembly')
    pr2.add_argument('clm', help='paired_links.clm')
    pr2.add_argument('--outdir', default='.')
    pr2.add_argument('--RE', default='GATC')
    _add_reassign_args(pr2)

    ps = sub.add_parser('sort', help='order and orient contigs per group')
    ps.add_argument('fasta')
    ps.add_argument('HT_links', help='HT_links.pkl')
    ps.add_argument('clm_dir', help='directory with split per-group .clm')
    ps.add_argument('groups', nargs='+', help='group*.txt files')
    ps.add_argument('--outdir', default='.')
    _add_device_arg(ps)
    _add_sort_args(ps)

    pb = sub.add_parser('build', help='build scaffolds from tour files')
    pb.add_argument('fasta')
    pb.add_argument('raw_fasta')
    pb.add_argument('alignments')
    pb.add_argument('tours', nargs='+')
    pb.add_argument('--corrected_ctgs', default=None)
    pb.add_argument('--outdir', default='.')
    _add_build_args(pb)

    sub.add_parser('check', help='check the torch/CUDA runtime and '
                   'build the CUDA kernels')

    pl = sub.add_parser('plot', help='draw contact-map heatmap')
    pl.add_argument('agp')
    pl.add_argument('alignments')
    pl.add_argument('--outdir', default='.')
    pl.add_argument('--bin_size', type=int, default=500,
                    help='heatmap bin size (kbp)')
    pl.add_argument('--normalization', default='KR',
                    choices=['KR', 'log10', 'none'])
    pl.add_argument('--min_len', type=float, default=0,
                    help='minimum scaffold length to plot (Mbp)')
    pl.add_argument('--specified_scaffolds', default=None,
                    help='comma-separated scaffold subset')
    pl.add_argument('--vmax_coef', type=float, default=5.0,
                    help='vmax = coef x median nondiagonal signal')
    pl.add_argument('--vmax', type=float, default=-1.0,
                    help='manual vmax (overrides --vmax_coef)')
    pl.add_argument('--cmap', default='whitered')
    pl.add_argument('--origin', default='bottom_left',
                    choices=['bottom_left', 'top_left'])
    pl.add_argument('--border_style', default='grid',
                    choices=['grid', 'outline'])
    pl.add_argument('--separate_plots', action='store_true',
                    help='one heatmap per scaffold')
    pl.add_argument('--threads', type=int, default=4,
                    help='BAM decoder threads')
    pl.add_argument('--out_name', default='contact_map.pdf')
    _add_device_arg(pl, 'the contact matrix and its normalisation')

    pr = sub.add_parser('refsort', help='reference-guided scaffold ordering')
    pr.add_argument('agp')
    pr.add_argument('paf')
    pr.add_argument('--fasta', default=None)

    pu = sub.add_parser('util', help='aux utilities (see utils/tools.py)')
    pusub = pu.add_subparsers(dest='util_cmd', required=True)
    u = pusub.add_parser('mock_agp')
    u.add_argument('fasta')
    u = pusub.add_parser('groups_to_clusters')
    u.add_argument('groups', nargs='+')
    u = pusub.add_parser('combine_groups')
    u.add_argument('list_file')
    u = pusub.add_parser('convert_gfa_ids')
    u.add_argument('gfa')
    u.add_argument('liftover_agp')
    u = pusub.add_parser('gfa_depth_to_bedgraph')
    u.add_argument('agp')
    u.add_argument('gfas', nargs='+')
    u.add_argument('--depth_tag', default='rd')
    u.add_argument('--scale', type=float, default=1.0)
    u = pusub.add_parser('find_telomeres')
    u.add_argument('genome')
    u.add_argument('--repeat', default='CCCTAAA')
    u.add_argument('--contigs', nargs='+', default=None)
    u = pusub.add_parser('fasta_count_N')
    u.add_argument('fasta')
    u = pusub.add_parser('fastq_length_filtering')
    u.add_argument('out_fq')
    u.add_argument('in_fqs', nargs='+')
    u.add_argument('--length', type=int, default=50000)
    u = pusub.add_parser('reverse_bed')
    u.add_argument('bed')
    u.add_argument('genome')
    u = pusub.add_parser('global_chaining')
    u.add_argument('paf')
    u.add_argument('--mapq', type=int, default=0)
    u.add_argument('--min_len', type=int, default=100000)
    u.add_argument('--min_aln_len', type=int, default=10000)
    u.add_argument('--div', choices=['de', 'dv'], default='de')
    u.add_argument('--min_identity', type=float, default=90)
    u.add_argument('--min_cov_ratio', type=float, default=0)
    u.add_argument('--min_sb_ratio', type=float, default=0.2)
    u.add_argument('--perform_clustering', action='store_true',
                   default=False)
    u = pusub.add_parser('prepare_clusters')
    u.add_argument('wrk_dir')
    u.add_argument('--for_manual', action='store_true', default=False)
    u = pusub.add_parser('mock_blast')
    u.add_argument('fasta')
    u.add_argument('tour')
    u = pusub.add_parser('remove_singletons')
    u.add_argument('bam')

    pm = sub.add_parser('sim',
                        help='simulation/evaluation harness tools')
    pmsub = pm.add_subparsers(dest='sim_cmd', required=True)
    s = pmsub.add_parser('convert_agp_to_tour')
    s.add_argument('agp')
    s.add_argument('prefix')
    s = pmsub.add_parser('convert_assembly_to_tour')
    s.add_argument('assembly')
    s.add_argument('prefix')
    s = pmsub.add_parser('convert_agp_to_groups')
    s.add_argument('agp')
    s = pmsub.add_parser('convert_assembly_to_groups')
    s.add_argument('assembly')
    s = pmsub.add_parser('convert_lachesis_result_to_groups')
    s.add_argument('clusters')
    s.add_argument('fasta')
    s = pmsub.add_parser('convert_lachesis_ordering_to_tour')
    s.add_argument('fasta')
    s.add_argument('prefix')
    s.add_argument('ordering_files', nargs='+')
    s = pmsub.add_parser('sim_group_files')
    s.add_argument('fasta')
    s = pmsub.add_parser('ga_study',
                         help='GA quality study: score-vs-generation on '
                              'simulated groups (docs/GA_VALIDATION.md)')
    s.add_argument('--ks', default='50,200')
    s.add_argument('--ngen', type=int, default=3000)
    s.add_argument('--npop', type=int, default=100)
    s.add_argument('--seed', type=int, default=42)
    s.add_argument('--backend', default='auto',
                   choices=['auto', 'native', 'device'])
    s.add_argument('--out', default=None)
    _add_device_arg(s, 'the GA')

    s = pmsub.add_parser('score_statistics')
    s.add_argument('tour')
    s.add_argument('chrom')
    s.add_argument('N50')
    s.add_argument('program')
    s.add_argument('--each_iteration', action='store_true', default=False)
    s = pmsub.add_parser('result_statistics')
    s.add_argument('fasta')
    s.add_argument('groups', nargs='+')
    s = pmsub.add_parser('link_statistics')
    s.add_argument('fasta')
    s.add_argument('bam')
    s.add_argument('tag')
    s = pmsub.add_parser('shuffle_fasta')
    s.add_argument('fasta')
    s.add_argument('--seed', type=int, default=12345)
    s.add_argument('--offset', type=int, default=0)
    s = pmsub.add_parser('split_fasta')
    s.add_argument('fasta')
    s.add_argument('--bin_size', type=int, default=None)
    s.add_argument('--seed', type=int, default=12345)
    s = pmsub.add_parser('sample_mnd')
    s.add_argument('mnd')
    s.add_argument('npairs', type=int)
    s.add_argument('proportion', type=float)
    s.add_argument('--seed', type=int, default=12345)
    s = pmsub.add_parser('sort_agp')
    s.add_argument('agp')
    s.add_argument('chr_ordering', nargs='+')
    s = pmsub.add_parser('sim_switch_errors')
    s.add_argument('fasta')
    s.add_argument('allele_info')
    s.add_argument('--rate', type=float, default=0.1)
    s.add_argument('--seed', type=int, default=12345)
    s = pmsub.add_parser('sim_for_reassignment')
    s.add_argument('fasta')
    s.add_argument('ratio', type=float)
    s.add_argument('--error_type', default='inter_homo',
                   choices=['inter_homo', 'inter_nonhomo', 'contiguity',
                            'anchoring_rate'])
    s.add_argument('--output_groups', action='store_true', default=False)
    s.add_argument('--seed', type=int, default=12345)
    s = pmsub.add_parser('get_haphic_break_points')
    s.add_argument('raw_fasta')
    s.add_argument('corrected_fasta')
    s.add_argument('N50')
    s = pmsub.add_parser('extract_corrected_ctgs_from_yahs_agp')
    s.add_argument('agp')
    s.add_argument('fasta')
    s = pmsub.add_parser('extract_corrected_ctgs_from_salsa_agp')
    s.add_argument('agp')
    s.add_argument('fasta')
    s = pmsub.add_parser('extract_corrected_ctgs_from_3d_dna_assembly')
    s.add_argument('assembly')
    s.add_argument('fasta')
    s = pmsub.add_parser('summarize_correction')
    s.add_argument('stat')
    s = pmsub.add_parser('get_yahs_break_points')
    s.add_argument('raw_fasta')
    s.add_argument('agp')
    s.add_argument('N50')
    s = pmsub.add_parser('get_salsa_break_points')
    s.add_argument('raw_fasta')
    s.add_argument('agp')
    s.add_argument('N50')
    s = pmsub.add_parser('get_3d_dna_break_points')
    s.add_argument('raw_fasta')
    s.add_argument('assembly')
    s.add_argument('N50')
    s = pmsub.add_parser('get_allhic_break_points')
    s.add_argument('raw_fasta')
    s.add_argument('corrected_fasta')
    s.add_argument('N50')
    s = pmsub.add_parser('haplotype_kmers')
    s.add_argument('ref')
    s.add_argument('asm')
    s.add_argument('--kmer_size', type=int, default=201)
    s.add_argument('--bin_size', type=int, default=500000)
    s = pmsub.add_parser('mock_delta')
    s.add_argument('query_agp')
    s.add_argument('query_fasta')
    s.add_argument('ref_fasta')
    s = pmsub.add_parser('validate_mock_delta')
    s.add_argument('ref_fa')
    s.add_argument('query_fa')
    s.add_argument('mock_delta')
    s = pmsub.add_parser('chimeric_contig_statistics')
    s.add_argument('fasta')
    s.add_argument('result')
    s.add_argument('program')
    s.add_argument('N50')
    s = pmsub.add_parser('collapsed_contig_statistics')
    s.add_argument('fasta')
    s.add_argument('result')
    s.add_argument('program')
    s.add_argument('tag')
    s.add_argument('--method', default='link_density',
                   choices=['link_density', 'rank_sum'])
    s = pmsub.add_parser('extract_SVs_from_simple')
    s.add_argument('simple')
    s.add_argument('gene_bed')
    s.add_argument('--chrom', default='Chr02')
    s = pmsub.add_parser('filter_orthologous_anchors')
    s.add_argument('anchors_simple')
    s.add_argument('bed1')
    s.add_argument('bed2')
    s.add_argument('chrs1')
    s.add_argument('chrs2')
    s = pmsub.add_parser('pbsperf')
    s.add_argument('jobids', nargs='+')
    s.add_argument('--ndays', type=int, default=100)
    s = pmsub.add_parser('add_allele_tag')
    s.add_argument('cor_file')
    s.add_argument('allele_table')
    s = pmsub.add_parser('allele_statistics')
    s.add_argument('allele_info')
    s.add_argument('prefix')
    s.add_argument('--chrom', default='Chr1_1')
    s = pmsub.add_parser('density_statistics')
    s.add_argument('density')
    s = pmsub.add_parser('get_paf_alignments')
    s.add_argument('pafs', nargs='+')
    s = pmsub.add_parser('filter_bam_from_list')
    s.add_argument('bam')
    s.add_argument('listf')
    s.add_argument('--threads', type=int, default=8)
    s = pmsub.add_parser('filter_fastq_len')
    s.add_argument('fastq_files', nargs='+')
    s.add_argument('--len_cutoff', type=int, default=50000)
    s = pmsub.add_parser('interpret_switch_errors')
    s.add_argument('allele_info')
    s.add_argument('new_allele_info')
    s = pmsub.add_parser('split_mnd')
    s.add_argument('mnd')
    s.add_argument('chrs', nargs='+')
    s = pmsub.add_parser('split_bam')
    s.add_argument('bam')
    s.add_argument('chrs', nargs='+')
    s.add_argument('--threads', type=int, default=8)
    s = pmsub.add_parser('generic_result_statistics')
    s.add_argument('fasta')
    s.add_argument('chr_pattern')
    s.add_argument('groups', nargs='+')
    s = pmsub.add_parser('draw_tour_file')
    s.add_argument('fasta')
    s.add_argument('tour')
    s.add_argument('program')
    s.add_argument('N50')
    s.add_argument('--CCC', action='store_true', default=False)
    s = pmsub.add_parser('sim_collapsed_regions')
    s.add_argument('fasta')
    s.add_argument('allele_info')
    s.add_argument('--collapsed_len', type=int, default=500000)
    s.add_argument('--collapsed_ratio', type=float, default=0.2)
    s.add_argument('--weights', default='0.7,0.2,0.1')
    s.add_argument('--seed', type=int, default=12345)
    s.add_argument('--strict', action='store_true', default=False)
    s = pmsub.add_parser('allelic_contig_statistics')
    s.add_argument('result', help='cluster-stage --verbose log')
    s.add_argument('allele_table', help='ALLHiC Allele.ctg.table')
    s.add_argument('tag')
    s.add_argument('--overlap_len_cutoff', type=int, default=10000)
    s.add_argument('--link_cutoff', type=int, default=20)
    s = pmsub.add_parser('get_discordant_HiC_links')
    s.add_argument('agp_truth')
    s.add_argument('bam')
    s.add_argument('--agp', nargs=2, action='append', required=True,
                   metavar=('TAG', 'AGP'),
                   help='result to compare (repeatable)')
    s.add_argument('--bin_size', type=int, default=500000)
    s = pmsub.add_parser('correction_analysis')
    s.add_argument('raw', help='raw assembly FASTA')
    s.add_argument('bam')
    s.add_argument('ctg_anno', help='contig annotation list')
    s.add_argument('--agp', nargs=2, action='append', required=True,
                   metavar=('TAG', 'AGP'),
                   help='corrected AGP to compare (repeatable)')
    s.add_argument('--hap_prefixes', required=True,
                   help='comma-separated haplotype sequence-name '
                        'prefixes')
    s.add_argument('--resolution', type=int, default=10000)
    s = pmsub.add_parser('mock_delta_chrs_only')
    s.add_argument('query_agp')
    s.add_argument('query_fasta')
    s.add_argument('ref_fasta')
    s.add_argument('ref_chrom_pattern')

    pa = sub.add_parser(
        'allhic',
        help='standalone tour optimization (allhic optimize replacement)')
    pa.add_argument('group', help='group*.txt (#Contig RECounts Length)')
    pa.add_argument('clm', help='per-group .clm file')
    pa.add_argument('--mutapb', type=float, default=0.2,
                    help='mutation probability (default: %(default)s)')
    pa.add_argument('--ngen', type=int, default=5000,
                    help='GA generations (default: %(default)s)')
    pa.add_argument('--npop', type=int, default=100,
                    help='GA population size (default: %(default)s)')
    pa.add_argument('--seed', type=int, default=42,
                    help='random seed (default: %(default)s)')
    pa.add_argument('--resume', action='store_true', default=False,
                    help='hot-start from an existing <group>.tour '
                         '(renamed to .tour.sav, as the reference binary '
                         'does)')
    pa.add_argument('--skipGA', action='store_true', default=False,
                    help='score/emit the hot-start tour without running '
                         'the GA')
    _add_device_arg(pa, 'the GA')

    pj = sub.add_parser('juicer',
                        help='Juicebox curation round-trip (pre/post)')
    pjsub = pj.add_subparsers(dest='juicer_cmd', required=True)
    pre = pjsub.add_parser('pre')
    pre.add_argument('alignments',
                     help='.bam, .bed, .pa5 or .pairs[.gz]')
    pre.add_argument('--file-type', dest='file_type', default=None,
                     help='BED|BAM|BIN|PA5: override the extension '
                          '(reference utils/juicer surface)')
    pre.add_argument('agp', help='scaffolds.raw.agp')
    pre.add_argument('fai', nargs='?', default=None,
                     help='contigs .fai (accepted for CLI compatibility)')
    pre.add_argument('-a', '--assembly_mode', action='store_true',
                     default=True)
    pre.add_argument('-q', '--mapq', type=int, default=1)
    pre.add_argument('-o', '--out_prefix', default='out_JBAT')
    pre.add_argument('--outdir', default='.')
    post = pjsub.add_parser('post')
    post.add_argument('review_assembly')
    post.add_argument('liftover_agp')
    post.add_argument('contigs_fasta', nargs='?', default=None)
    post.add_argument('-o', '--out_prefix', default='out_JBAT.FINAL')
    post.add_argument('--outdir', default='.')
    return parser


def cmd_pipeline(args) -> int:
    from haphic_tpu_torch.pipeline import run_pipeline
    cfg = _config_from_args(args)
    cfg.steps = args.steps
    run_pipeline(args.fasta, args.alignments, args.nchrs, cfg=cfg,
                 outdir=args.outdir)
    return 0


def cmd_cluster(args) -> int:
    from haphic_tpu_torch.pipeline import cluster_stage
    cfg = _config_from_args(args)
    cres = cluster_stage(args.fasta, args.alignments, args.nchrs, cfg,
                         args.outdir)
    if cres.stat_wait is not None:   # standalone: join the PDF workers
        cres.stat_wait()
    return 0


def cmd_reassign(args) -> int:
    import os

    from haphic_tpu_torch.assign.reassign import (ReassignParams, reassign,
                                            split_clm_file,
                                            write_group_files)
    from haphic_tpu_torch.io.artifacts import (load_link_pickle,
                                         parse_assembly_file,
                                         parse_clusters_file)
    from haphic_tpu_torch.io.fasta import read_fasta

    if not args.links.endswith(('.pkl', '.pairs', '.pairs.gz', '.bam')):
        raise RuntimeError('The "links" argument should end with .bam, '
                           '.pkl, .pairs, or .pairs.gz')
    asm = read_fasta(args.fasta, RE=args.RE, keep_seqs=False)
    if args.links.endswith('.pkl'):
        full = load_link_pickle(args.links, asm.name2id)
    else:
        from haphic_tpu_torch.core.contacts import aggregate
        from haphic_tpu_torch.core.fragments import build_fragments
        from haphic_tpu_torch.io.pairs import PairsReader
        frags = build_fragments(asm, RE=args.RE, bin_size_kbp=0)
        if args.links.endswith('.bam'):
            from haphic_tpu_torch.io.bam import BamReader
            reader = BamReader(args.links, asm.names)
        else:
            reader = PairsReader(args.links, asm.names)
        full = aggregate(reader, frags, keep_clm=False).full
    if args.clusters.endswith('.clusters.txt'):
        clusters = parse_clusters_file(args.clusters)
    elif args.clusters.endswith('.assembly'):
        clusters = parse_assembly_file(args.clusters)
    else:
        raise RuntimeError('The "clusters" argument should end with '
                           '.clusters.txt or .assembly')
    initial = [[asm.name2id[c] for c in ctgs if c in asm.name2id]
               for _, ctgs in clusters]
    p = ReassignParams(
        min_group_len=args.min_group_len, max_ctg_len=args.max_ctg_len,
        min_RE_sites=args.min_RE_sites, min_links=args.min_links,
        min_link_density=args.min_link_density,
        min_density_ratio=args.min_density_ratio,
        ambiguous_cutoff=args.ambiguous_cutoff,
        reassign_nrounds=args.reassign_nrounds,
        nclusters=args.nclusters,
        no_additional_rescue=args.no_additional_rescue)
    res = reassign(asm, full, initial, params=p)
    sub = 'hc_groups' if res.hc_applied else 'reassigned_groups'
    prefix = 'hc' if res.hc_applied else 'reassigned'
    write_group_files(res.groups, asm, os.path.join(args.outdir, sub),
                      prefix=prefix)
    final_dir = os.path.join(args.outdir, 'final_groups')
    os.makedirs(final_dir, exist_ok=True)
    for gname in res.groups.names:
        dst = os.path.join(final_dir, '{}.txt'.format(gname))
        if not os.path.exists(dst):
            os.symlink(os.path.join('..', sub,
                                    '{}_{}.txt'.format(prefix, gname)), dst)
    cdst = os.path.join(final_dir, 'final_clusters.txt')
    if not os.path.exists(cdst):
        os.symlink(os.path.join('..', sub,
                                '{}_clusters.txt'.format(prefix)), cdst)
    split_clm_file(args.clm, res.groups, asm,
                   os.path.join(args.outdir, 'split_clms'))
    return 0


def cmd_sort(args) -> int:
    import os

    from haphic_tpu_torch.io.artifacts import (load_ht_pickle, parse_clm_file,
                                         parse_group_file)
    from haphic_tpu_torch.io.fasta import read_fasta
    from haphic_tpu_torch.order import optimize as opt
    from haphic_tpu_torch.order.arbiter import choose_fast_sort
    from haphic_tpu_torch.order.fast_sort import (fast_sort, make_group_data,
                                                  paths_to_tour, write_tour)
    from haphic_tpu_torch.runtime import resolve_device

    resolve_device(args.device)
    asm = read_fasta(args.fasta, keep_seqs=False)
    ht = load_ht_pickle(args.HT_links, asm.name2id)
    final_dir = os.path.join(args.outdir, 'final_tours')
    os.makedirs(final_dir, exist_ok=True)
    lengths = {c: int(l) for c, l in zip(asm.names, asm.lengths)}

    for group_file in args.groups:
        prefix = os.path.splitext(os.path.basename(group_file))[0]
        ctgs = parse_group_file(group_file)
        for c, _, length in ctgs:
            if c not in asm.name2id:
                raise RuntimeError(
                    'CANNOT find contig {} in the FASTA file'.format(c))
            if lengths[c] != length:
                raise RuntimeError(
                    'Length of contig {} in the group file does NOT '
                    'match the FASTA file'.format(c))
        members = [asm.name2id[c] for c, _, __ in ctgs]
        gd = make_group_data(members, asm.lengths, ht)
        fast_tour = None
        if not args.skip_fast_sort and members:
            paths = fast_sort(
                gd, confidence_cutoff=args.confidence_cutoff,
                density_cal_method=args.density_cal_method,
                flanking_region_kbp=args.flanking_region,
                log_prefix=prefix)
            fast_tour = paths_to_tour(paths, gd.ctg_ids, asm.names)
            write_tour(os.path.join(args.outdir,
                                    '{}.tour.sav'.format(prefix)),
                       fast_tour)
        final = fast_tour
        if not args.skip_allhic and len(members) > 1:
            clm_path = os.path.join(args.clm_dir,
                                    '{}.clm'.format(prefix))
            clm = parse_clm_file(clm_path, asm.name2id)
            problem, hot = opt.group_problem(gd.ctg_ids, asm.lengths, clm,
                                             fast_tour, asm.name2id)
            res = opt.optimize_tour(problem, npop=args.npop,
                                    ngen=args.ngen,
                                    mutprob=args.mutprob,
                                    seed=args.seed, hot_start=hot,
                                    skip_ga=args.skipGA,
                                    device=args.device)
            ga_tour = opt.result_to_tour(res, gd.ctg_ids, asm.names)
            opt.write_ga_tour(os.path.join(args.outdir,
                                           '{}.tour'.format(prefix)),
                              res, ga_tour, init_tour=fast_tour)
            if fast_tour is not None and choose_fast_sort(
                    fast_tour, ga_tour, lengths):
                final = fast_tour
            else:
                final = ga_tour
        elif fast_tour is not None:
            write_tour(os.path.join(args.outdir,
                                    '{}.tour'.format(prefix)), fast_tour)
        if final is None:
            final = [(asm.names[c], '+') for c in members]
        write_tour(os.path.join(final_dir, '{}.tour'.format(prefix)),
                   final)
    return 0


def cmd_build(args) -> int:
    from haphic_tpu_torch.build.scaffolds import (build_final_scaffolds,
                                            generate_juicebox_script,
                                            parse_corrected_ctgs,
                                            parse_tours)
    from haphic_tpu_torch.io.fasta import read_fasta
    asm = read_fasta(args.fasta)
    tours = parse_tours(args.tours, set(asm.names))
    corrected = parse_corrected_ctgs(args.corrected_ctgs)
    build_final_scaffolds(tours, asm, corrected, prefix=args.prefix,
                          Ns=args.Ns, max_width=args.max_width,
                          sort_by_input=args.sort_by_input,
                          outdir=args.outdir)
    generate_juicebox_script(args.raw_fasta, args.alignments,
                             prefix=args.prefix, outdir=args.outdir)
    return 0


def cmd_check(args) -> int:
    """Report torch, CUDA, nvcc and the card, and build the CUDA
    kernels; exit 1 when any of them is missing or fails."""
    import importlib
    import torch
    from haphic_tpu_torch.kernels import build as kbuild
    ok = True
    for mod in ('numpy', 'scipy', 'torch'):
        try:
            m = importlib.import_module(mod)
            print('{:<12} {}'.format(mod, getattr(m, '__version__', '?')))
        except ImportError as e:
            ok = False
            print('{:<12} MISSING ({})'.format(mod, e))
    print('{:<12} {}'.format('cuda', torch.version.cuda))
    if torch.cuda.is_available():
        print('{:<12} {} x {}'.format('card', torch.cuda.device_count(),
                                      torch.cuda.get_device_name(0)))
    else:
        ok = False
        print('{:<12} none (torch.cuda.is_available() is False)'.format(
            'card'))
    nvcc = kbuild.nvcc_path()
    print('{:<12} {}'.format('nvcc', nvcc or 'MISSING'))
    if nvcc is None:
        ok = False
    else:
        # a failed build raises with nvcc's output
        for name, path in kbuild.build().items():
            print('{:<12} built {}'.format(name, path))
    from haphic_tpu_torch.io.bam import native_lib as bam_native
    from haphic_tpu_torch.order.optimize import native_lib as ga_native
    print('{:<12} {}'.format('bam_reader',
                             'native' if bam_native() else
                             'python fallback'))
    print('{:<12} {}'.format('tour_ga',
                             'native' if ga_native() else
                             'device-only (run make -C native)'))
    return 0 if ok else 1


def cmd_plot(args) -> int:
    from haphic_tpu_torch.post.plot import run_plot
    run_plot(args.agp, args.alignments, outdir=args.outdir,
             bin_size_kbp=args.bin_size, normalization=args.normalization,
             min_len_mbp=args.min_len,
             specified_scaffolds=args.specified_scaffolds,
             vmax_coef=args.vmax_coef, manual_vmax=args.vmax,
             cmap=args.cmap, origin=args.origin,
             border_style=args.border_style,
             separate_plots=args.separate_plots, threads=args.threads,
             out_name=args.out_name, device=args.device)
    return 0


def cmd_refsort(args) -> int:
    from haphic_tpu_torch.post.refsort import run_refsort
    run_refsort(args.agp, args.paf, fasta=args.fasta, out=sys.stdout)
    return 0


def cmd_util(args) -> int:
    from haphic_tpu_torch.utils import tools
    c = args.util_cmd
    if c == 'mock_agp':
        tools.mock_agp(args.fasta)
    elif c == 'groups_to_clusters':
        tools.groups_to_clusters(args.groups)
    elif c == 'combine_groups':
        tools.combine_groups(args.list_file)
    elif c == 'convert_gfa_ids':
        tools.convert_gfa_ids(args.gfa, args.liftover_agp)
    elif c == 'gfa_depth_to_bedgraph':
        tools.gfa_depth_to_bedgraph(args.gfas, args.agp,
                                    depth_tag=args.depth_tag,
                                    scale=args.scale)
    elif c == 'find_telomeres':
        tools.find_telomeres(args.genome, repeat=args.repeat,
                             contigs=args.contigs)
    elif c == 'fasta_count_N':
        tools.fasta_count_N(args.fasta)
    elif c == 'fastq_length_filtering':
        tools.fastq_length_filtering(args.out_fq, args.in_fqs,
                                     length=args.length)
    elif c == 'reverse_bed':
        tools.reverse_bed(args.bed, args.genome)
    elif c == 'global_chaining':
        tools.global_chaining(
            args.paf, mapq=args.mapq, min_len=args.min_len,
            min_aln_len=args.min_aln_len, div=args.div,
            min_identity=args.min_identity,
            min_cov_ratio=args.min_cov_ratio,
            min_sb_ratio=args.min_sb_ratio,
            perform_clustering=args.perform_clustering)
    elif c == 'prepare_clusters':
        tools.prepare_clusters(args.wrk_dir, for_manual=args.for_manual)
    elif c == 'mock_blast':
        print(tools.mock_blast(args.fasta, args.tour))
    elif c == 'remove_singletons':
        tools.remove_singletons(args.bam)
    return 0


def cmd_sim(args) -> int:
    from haphic_tpu_torch.sim import harness as h
    c = args.sim_cmd
    if c == 'convert_agp_to_tour':
        h.convert_agp_to_tour(args.agp, args.prefix)
    elif c == 'convert_assembly_to_tour':
        h.convert_assembly_to_tour(args.assembly, args.prefix)
    elif c == 'convert_agp_to_groups':
        h.convert_agp_to_groups(args.agp)
    elif c == 'convert_assembly_to_groups':
        h.convert_assembly_to_groups(args.assembly)
    elif c == 'convert_lachesis_result_to_groups':
        h.convert_lachesis_result_to_groups(args.clusters, args.fasta)
    elif c == 'convert_lachesis_ordering_to_tour':
        h.convert_lachesis_ordering_to_tour(args.fasta, args.prefix,
                                            args.ordering_files)
    elif c == 'sim_group_files':
        h.sim_group_files(args.fasta)
    elif c == 'ga_study':
        from haphic_tpu_torch.runtime import resolve_device
        from haphic_tpu_torch.sim.ga_study import run_study
        resolve_device(args.device)
        run_study(ks=[int(x) for x in args.ks.split(',')],
                  ngen=args.ngen, npop=args.npop, seed=args.seed,
                  backend=args.backend, out=args.out, device=args.device)
    elif c == 'score_statistics':
        h.score_statistics(args.tour, args.chrom, args.N50, args.program,
                           each_iteration=args.each_iteration)
    elif c == 'result_statistics':
        h.result_statistics(args.fasta, args.groups)
    elif c == 'link_statistics':
        h.link_statistics(args.fasta, args.bam, args.tag)
    elif c == 'shuffle_fasta':
        h.shuffle_fasta(args.fasta, seed=args.seed, offset=args.offset)
    elif c == 'split_fasta':
        h.split_fasta(args.fasta, bin_size=args.bin_size, seed=args.seed)
    elif c == 'sample_mnd':
        h.sample_mnd(args.mnd, args.npairs, args.proportion,
                     seed=args.seed)
    elif c == 'sort_agp':
        h.sort_agp(args.agp, args.chr_ordering)
    elif c == 'sim_switch_errors':
        h.sim_switch_errors(args.fasta, args.allele_info, rate=args.rate,
                            seed=args.seed)
    elif c == 'sim_for_reassignment':
        h.sim_for_reassignment(args.fasta, args.ratio,
                               error_type=args.error_type,
                               seed=args.seed,
                               output_groups=args.output_groups)
    elif c == 'get_haphic_break_points':
        h.get_haphic_break_points(args.raw_fasta, args.corrected_fasta,
                                  args.N50)
    elif c == 'extract_corrected_ctgs_from_yahs_agp':
        h.extract_corrected_ctgs_from_yahs_agp(args.agp, args.fasta)
    elif c == 'extract_corrected_ctgs_from_salsa_agp':
        h.extract_corrected_ctgs_from_salsa_agp(args.agp, args.fasta)
    elif c == 'extract_corrected_ctgs_from_3d_dna_assembly':
        h.extract_corrected_ctgs_from_3d_dna_assembly(args.assembly,
                                                      args.fasta)
    elif c == 'summarize_correction':
        h.summarize_correction(args.stat)
    elif c == 'get_yahs_break_points':
        h.get_yahs_break_points(args.raw_fasta, args.agp, args.N50)
    elif c == 'get_salsa_break_points':
        h.get_salsa_break_points(args.raw_fasta, args.agp, args.N50)
    elif c == 'get_3d_dna_break_points':
        h.get_3d_dna_break_points(args.raw_fasta, args.assembly,
                                  args.N50)
    elif c == 'get_allhic_break_points':
        h.get_allhic_break_points(args.raw_fasta, args.corrected_fasta,
                                  args.N50)
    elif c == 'haplotype_kmers':
        h.haplotype_kmers(args.ref, args.asm, kmer_size=args.kmer_size,
                          bin_size=args.bin_size)
    elif c == 'mock_delta':
        h.mock_delta(args.query_agp, args.query_fasta, args.ref_fasta)
    elif c == 'validate_mock_delta':
        h.validate_mock_delta(args.ref_fa, args.query_fa,
                              args.mock_delta)
    elif c == 'chimeric_contig_statistics':
        h.chimeric_contig_statistics(args.fasta, args.result, args.N50)
    elif c == 'collapsed_contig_statistics':
        h.collapsed_contig_statistics(args.fasta, args.result, args.tag,
                                      method=args.method)
    elif c == 'extract_SVs_from_simple':
        h.extract_SVs_from_simple(args.simple, args.gene_bed,
                                  chrom=args.chrom)
    elif c == 'filter_orthologous_anchors':
        h.filter_orthologous_anchors(args.anchors_simple, args.bed1,
                                     args.bed2, args.chrs1.split(','),
                                     args.chrs2.split(','))
    elif c == 'pbsperf':
        h.pbsperf(args.jobids, ndays=args.ndays)
    elif c == 'add_allele_tag':
        h.add_allele_tag(args.cor_file, args.allele_table)
    elif c == 'allele_statistics':
        h.allele_statistics(args.allele_info, args.prefix,
                            chrom=args.chrom)
    elif c == 'density_statistics':
        h.density_statistics(args.density)
    elif c == 'get_paf_alignments':
        h.get_paf_alignments(args.pafs)
    elif c == 'filter_bam_from_list':
        h.filter_bam_from_list(args.bam, args.listf,
                               threads=args.threads)
    elif c == 'filter_fastq_len':
        h.filter_fastq_len(args.fastq_files, len_cutoff=args.len_cutoff)
    elif c == 'interpret_switch_errors':
        h.interpret_switch_errors(args.allele_info, args.new_allele_info)
    elif c == 'split_mnd':
        h.split_mnd(args.mnd, args.chrs)
    elif c == 'split_bam':
        h.split_bam(args.bam, args.chrs, threads=args.threads)
    elif c == 'generic_result_statistics':
        h.generic_result_statistics(args.fasta, args.chr_pattern,
                                    args.groups)
    elif c == 'draw_tour_file':
        h.draw_tour_file(args.fasta, args.tour, args.program, args.N50,
                         ccc=args.CCC)
    elif c == 'sim_collapsed_regions':
        h.sim_collapsed_regions(
            args.fasta, args.allele_info,
            collapsed_len=args.collapsed_len,
            collapsed_ratio=args.collapsed_ratio,
            weights=[float(w) for w in args.weights.split(',')],
            seed=args.seed, strict=args.strict)
    elif c == 'allelic_contig_statistics':
        h.allelic_contig_statistics(
            args.result, args.allele_table, args.tag,
            overlap_len_cutoff=args.overlap_len_cutoff,
            link_cutoff=args.link_cutoff)
    elif c == 'get_discordant_HiC_links':
        h.get_discordant_hic_links(args.agp_truth, args.agp, args.bam,
                                   bin_size=args.bin_size)
    elif c == 'correction_analysis':
        h.correction_analysis(args.raw, args.bam, args.ctg_anno,
                              args.agp,
                              args.hap_prefixes.split(','),
                              resolution=args.resolution)
    elif c == 'mock_delta_chrs_only':
        h.mock_delta_chrs_only(args.query_agp, args.query_fasta,
                               args.ref_fasta, args.ref_chrom_pattern)
    return 0


def cmd_allhic(args) -> int:
    """Standalone `allhic optimize` replacement (flag contract:
    scripts/HapHiC_sort.py:618-642). Reads <group>.txt + .clm, writes
    <prefix>.tour in the current directory; with --resume an existing
    <prefix>.tour is renamed to <prefix>.tour.sav and used to hot-start
    the GA, matching the reference fork's behavior. The GA runs on
    ``--device`` (or the native C++ GA for small work, as `sort`)."""
    import os

    import numpy as np

    from haphic_tpu_torch.io.artifacts import (parse_clm_file,
                                               parse_group_file,
                                               parse_tour_file)
    from haphic_tpu_torch.order import optimize as opt
    from haphic_tpu_torch.runtime import resolve_device

    resolve_device(args.device)
    ctgs = parse_group_file(args.group)
    names = [c for c, _, __ in ctgs]
    name2id = {c: i for i, c in enumerate(names)}
    lengths = np.asarray([l for _, __, l in ctgs], dtype=np.int64)
    prefix = os.path.splitext(os.path.basename(args.group))[0]

    hot = None
    init_tour = None
    tour_path = '{}.tour'.format(prefix)
    if args.resume and os.path.exists(tour_path):
        init_tour = parse_tour_file(tour_path)
        os.replace(tour_path, '{}.tour.sav'.format(prefix))
        hot = (np.asarray([name2id[c] for c, _ in init_tour], np.int32),
               np.asarray([1 if o == '-' else 0 for _, o in init_tour],
                          np.int32))

    clm = parse_clm_file(args.clm, name2id)
    problem = opt.build_problem(np.arange(len(names)), lengths,
                                clm.pair_i, clm.pair_j, clm.d)
    res = opt.optimize_tour(problem, npop=args.npop, ngen=args.ngen,
                            mutprob=args.mutapb, seed=args.seed,
                            hot_start=hot, skip_ga=args.skipGA,
                            device=args.device)
    tour = opt.result_to_tour(res, np.arange(len(names)), names)
    opt.write_ga_tour(tour_path, res, tour, init_tour=init_tour)
    return 0


def cmd_juicer(args) -> int:
    from haphic_tpu_torch.post.juicer import juicer_post, juicer_pre
    if args.juicer_cmd == 'pre':
        juicer_pre(args.agp, args.alignments, out_prefix=args.out_prefix,
                   outdir=args.outdir, mapq=args.mapq,
                   assembly_mode=args.assembly_mode,
                   file_type=args.file_type)
    else:
        juicer_post(args.review_assembly, args.liftover_agp,
                    contigs_fasta=args.contigs_fasta,
                    out_prefix=args.out_prefix, outdir=args.outdir)
    return 0


def _rank_outdir(outdir: str, rank: int) -> str:
    """--outdir for ``rank``: rank 0 keeps it, rank r > 0 writes to the
    sibling <outdir>.rank<r>."""
    if rank == 0:
        return outdir
    return '{}.rank{}'.format(os.path.normpath(os.path.abspath(outdir)),
                              rank)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)s <%(module)s> [%(funcName)s] %(message)s',
        datefmt='%Y-%m-%d %H:%M:%S')
    # join the process group torchrun describes (a no-op in a single
    # process; see parallel/mesh.py for the execution model)
    from haphic_tpu_torch.parallel import mesh
    if mesh.init_distributed(getattr(args, 'device', 'cpu')) > 1 \
            and getattr(args, 'outdir', None) is not None:
        import torch.distributed as dist
        args.outdir = _rank_outdir(args.outdir, dist.get_rank())
    try:
        return _COMMANDS[args.command](args)
    finally:
        mesh.shutdown_distributed()


_COMMANDS = {
    'pipeline': cmd_pipeline,
    'cluster': cmd_cluster,
    'reassign': cmd_reassign,
    'sort': cmd_sort,
    'build': cmd_build,
    'check': cmd_check,
    'plot': cmd_plot,
    'refsort': cmd_refsort,
    'allhic': cmd_allhic,
    'sim': cmd_sim,
    'juicer': cmd_juicer,
    'util': cmd_util,
}


if __name__ == '__main__':
    sys.exit(main())

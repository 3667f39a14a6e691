"""End-to-end pipeline driver: cluster → reassign → sort → build.

Port of haphic_tpu/pipeline.py. The MCL sweep (dense, or sparse top-K
from SPARSE_MIN_N fragments on) and the GA run on
``PipelineConfig.device`` ("cuda" by default); the other stages are the
same host code, the flag-gated cluster steps included (assembly
correction, GFA read depth and phasing, concentrated and allelic link
pruning, UL reads), in haphic_tpu's order. Under torchrun (one process
per card, parallel/mesh.py) ingest, the MCL sweep and the GA shard over
the ranks, and every rank writes the single-process tree to its own
``outdir``.

The reference drives stages as subprocesses communicating through files
and regexes the recommended inflation out of its own log
(scripts/HapHiC_pipeline.py:349-532, design wart at :382-401). Here the
pipeline is one in-memory dataflow — stage functions pass arrays and
return values — while still writing every reference-format artifact
(01.cluster/ … 04.build/, pickles, CLM, cluster/group/tour files, AGP)
so users of the reference find the same on-disk contract.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from haphic_tpu_torch.assign.reassign import (Groups, ReassignParams,
                                              ReassignResult, reassign,
                                              split_clm_file, write_group_files)
from haphic_tpu_torch.build.scaffolds import (build_final_scaffolds,
                                              generate_juicebox_script)
from haphic_tpu_torch.cluster import sweep as sweep_mod
from haphic_tpu_torch.core.contacts import LinkData, aggregate
from haphic_tpu_torch.core.filter import (FilterResult, filter_fragments,
                                          normalize_by_nlinks)
from haphic_tpu_torch.core.fragments import Fragments, build_fragments
from haphic_tpu_torch.io.fasta import Assembly, read_fasta
from haphic_tpu_torch.io.links import (full_link_dict, ht_link_dict, write_clm,
                                       write_pickle)
from haphic_tpu_torch.io.pairs import PairsReader, detect_format
from haphic_tpu_torch.order import optimize as opt
from haphic_tpu_torch.order.arbiter import choose_fast_sort
from haphic_tpu_torch.order.fast_sort import (fast_sort, make_group_data,
                                              paths_to_tour, write_tour)
from haphic_tpu_torch.parallel.ingest import distributed_aggregate
from haphic_tpu_torch.parallel.mesh import make_mesh, world_size
from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    """Pipeline flags (named after the reference CLI,
    scripts/HapHiC_pipeline.py:36-346)."""
    # cluster
    RE: str = 'GATC'
    bin_size: int = -1                 # kbp; <0 auto, 0 disables
    flank: int = 500                   # kbp
    Nx: int = 80
    RE_site_cutoff: int = 25
    density_lower: str = '0.2X'
    density_upper: str = '1.9X'
    topN: int = 10
    rank_sum_upper: str = '1.5X'
    rank_sum_hard_cutoff: int = 0
    read_depth_upper: str = '1.5X'
    correct_nrounds: int = 0
    correct_resolution: int = 500
    median_cov_ratio: float = 0.2
    region_len_ratio: float = 0.1
    min_region_cutoff: int = 5000
    remove_allelic_links: int = 0
    remove_concentrated_links: bool = False
    concentration_ratio: float = 10.0
    concordance_ratio_cutoff: float = 0.2
    nwindows: int = 50
    max_read_pairs: int = 200
    min_read_pairs: int = 20
    phasing_weight: float = 1.0
    normalize_by_nlinks: bool = False
    min_inflation: float = 1.1
    max_inflation: float = 3.0
    inflation_step: float = 0.1
    max_iter: int = 200
    pruning: float = 1e-4
    expansion: int = 2
    mcl_backend: str = 'auto'          # dense | sparse | auto (by size)
    sparse_K: int = 0                  # top-K per column; 0 = default
    # sharding of the MCL sweep + sort GA over the ranks of a
    # torch.distributed run (one process per card, torchrun): 'auto'
    # and 'on' shard when the world has more than one process, 'off'
    # never shards; a single process never shards ('on' logs how to
    # launch one per card). `mesh`, a parallel.mesh.Mesh, overrides.
    # Ingest shards whenever the world has more than one process.
    use_mesh: str = 'auto'             # auto | on | off
    mesh: Optional[object] = None
    # torch device of the MCL sweep and the GA: 'cuda' or 'cpu'
    device: str = 'cuda'
    ga_backend: str = 'auto'           # auto | device | native
    whitelist: Optional[str] = None
    output_statistics: bool = True
    quick_view: bool = False
    ul: Optional[str] = None
    min_ul_mapq: int = 30
    min_ul_alignment_length: int = 10000
    max_distance_to_end: int = 100
    max_overlap_ratio: float = 0.5
    max_gap_len: int = 10000
    min_ul_support: int = 2
    gfa: Optional[str] = None
    # reassign
    reassign: ReassignParams = field(default_factory=ReassignParams)
    # sort
    skip_fast_sort: bool = False
    skip_allhic: bool = False
    skipGA: bool = False
    mutprob: float = 0.2
    ngen: int = 5000
    npop: int = 100
    seed: int = 42
    flanking_region: int = 0
    density_cal_method: str = 'multiplication'
    confidence_cutoff: float = 1.0
    # build
    Ns: int = 100
    max_width: int = 60
    sort_by_input: bool = False
    prefix: str = 'scaffolds'
    # misc
    processes: int = 8
    steps: str = '1234'


def _resolve_mesh(cfg: 'PipelineConfig'):
    """The mesh the hot stages shard over, or None. An explicit cfg.mesh
    wins; 'off' never shards; 'auto' and 'on' shard when this process
    is one of a torch.distributed world of more than one. Torch runs one
    process per card, so a single process never shards (JAX's one-
    device case). Resolved once and cached on cfg so the cluster and
    sort stages share one mesh."""
    if cfg.mesh is not None or cfg.use_mesh == 'off':
        return cfg.mesh
    if world_size() > 1:
        cfg.mesh = make_mesh(cfg.device)
        m = cfg.mesh
        logger.info('Sharding hot stages over a %d-rank %s mesh (rank %d '
                    'on %s)', m.world, m.backend, m.rank, m.device,
                    extra={'metrics': {'mesh': {
                        'world': m.world, 'rank': m.rank,
                        'backend': m.backend, 'device': str(m.device)}}})
        return cfg.mesh
    if cfg.use_mesh == 'on':
        logger.info('use_mesh=on in a single process: running on one '
                    'device; launch one process per card to shard '
                    '(python -m torch.distributed.run --nproc_per_node N '
                    '-m haphic_tpu_torch pipeline ...)')
    return None


def _ingest_mesh(cfg: 'PipelineConfig'):
    """The mesh ingest shards over: the hot stages' mesh, else the
    default group's when the world has more than one process (whatever
    use_mesh says, as in the JAX package), else None."""
    mesh = _resolve_mesh(cfg)
    if mesh is None and world_size() > 1:
        return make_mesh(cfg.device)
    return mesh


@dataclass
class ClusterStageResult:
    asm: Assembly
    frags: Fragments
    links: LinkData
    filtered: Optional[FilterResult]
    sweep: Optional[sweep_mod.SweepResult]
    clm_path: Optional[str]
    corrected_ctgs: List[str] = field(default_factory=list)
    # per-phase wall seconds (parse/ingest/filters/mcl/statistics) —
    # the profiling breakdown the bench surfaces
    timings: Dict[str, float] = field(default_factory=dict)
    # join handle for the backgrounded statistics.pdf render workers;
    # run_pipeline (and the standalone cluster CLI) calls this before
    # declaring the artifacts complete
    stat_wait: Optional[object] = None


def cluster_stage(fasta: str, alignments: str, nchrs: int,
                  cfg: PipelineConfig, outdir: str) -> ClusterStageResult:
    """01.cluster (parity: HapHiC_cluster.run,
    scripts/HapHiC_cluster.py:2738-2959)."""
    resolve_device(cfg.device)
    os.makedirs(outdir, exist_ok=True)
    t0 = time.time()
    timings: Dict[str, float] = {}
    asm = read_fasta(fasta, RE=cfg.RE)
    logger.info('Parsed FASTA: %d contigs, %.1f Mb', len(asm),
                asm.total_len / 1e6)

    whitelist: Set[str] = set()
    if cfg.whitelist:
        with open(cfg.whitelist) as f:
            whitelist = {l.split()[0] for l in f if l.strip()}

    read_depth = None
    hap_of = None
    if cfg.gfa:
        from haphic_tpu_torch.io.gfa import depth_arrays, read_gfas
        depth = read_gfas(cfg.gfa.split(','), asm)
        hap_of, read_depth = depth_arrays(depth, asm.names)

    # assembly correction: extra alignment pass over the original
    # contigs, then all later passes run against the broken fragments
    fmt = detect_format(alignments)

    def make_reader(names):
        if fmt in ('pairs', 'bgzipped_pairs'):
            return PairsReader(alignments, names)
        from haphic_tpu_torch.io.bam import BamReader
        return BamReader(alignments, names)

    corrected_ctgs: List[str] = []
    remapper = None
    if cfg.correct_nrounds:
        from haphic_tpu_torch.core.correct import correct_assembly
        t_corr = time.time()
        cres = correct_assembly(
            asm, make_reader(asm.names), outdir,
            correct_nrounds=cfg.correct_nrounds,
            correct_resolution=cfg.correct_resolution,
            median_cov_ratio=cfg.median_cov_ratio,
            min_region_cutoff=cfg.min_region_cutoff,
            region_len_ratio=cfg.region_len_ratio, RE=cfg.RE)
        corrected_ctgs = cres.corrected_names
        if cres.n_broken:
            remapper = cres.remapper
            asm = cres.asm
        timings['correct'] = time.time() - t_corr

    ul_paths: List = []
    if cfg.ul:
        from haphic_tpu_torch.core.ul import parse_ul_alignments, path_ctg_set
        ul_paths = parse_ul_alignments(
            cfg.ul, asm.names, asm.lengths,
            min_ul_mapq=cfg.min_ul_mapq,
            min_ul_alignment_length=cfg.min_ul_alignment_length,
            max_distance_to_end=cfg.max_distance_to_end,
            max_overlap_ratio=cfg.max_overlap_ratio,
            max_gap_len=cfg.max_gap_len,
            min_ul_support=cfg.min_ul_support)
        ul_ctgs = path_ctg_set(ul_paths)
        whitelist |= {asm.names[c] for c in ul_ctgs}
        logger.info('%d UL paths over %d contigs', len(ul_paths),
                    len(ul_ctgs), extra={'metrics': {
                        'ul_paths': len(ul_paths)}})

    bin_size_kbp = 0 if cfg.quick_view else cfg.bin_size
    Nx = 100 if cfg.quick_view else cfg.Nx
    frags = build_fragments(asm, RE=cfg.RE, nchrs=max(nchrs, 1),
                            flank_kbp=cfg.flank, Nx=Nx,
                            bin_size_kbp=bin_size_kbp, whitelist=whitelist)
    logger.info('Fragment table: %d fragments (bin size %d bp)',
                len(frags), frags.bin_size)
    timings['parse'] = time.time() - t0

    from haphic_tpu_torch.io.pairs import prefetch
    if remapper is not None:
        base_reader = make_reader(remapper.old_names)
        reader = prefetch(remapper.remap(c) for c in base_reader)
    else:
        reader = prefetch(make_reader(asm.names))
    # quick view skips allelic/concentrated pruning
    # (reference scripts/HapHiC_cluster.py:2779-2784)
    remove_allelic = 0 if cfg.quick_view else cfg.remove_allelic_links
    remove_concentrated = (False if cfg.quick_view
                           else cfg.remove_concentrated_links)
    ingest_kw = dict(
        flank_kbp=cfg.flank,
        need_coords=bool(remove_allelic) or remove_concentrated,
        max_read_pairs=cfg.max_read_pairs, keep_clm=not cfg.quick_view,
        track_ctg_pair_to_frag=bool(remove_allelic) and frags.any_split)
    imesh = _ingest_mesh(cfg)
    if imesh is not None:
        # each rank consumes its stride of the stream; the partial link
        # tensors are exchanged and merged on every rank
        links = distributed_aggregate(reader, frags, imesh, **ingest_kw)
    else:
        links = aggregate(reader, frags, **ingest_kw)
    timings['ingest'] = time.time() - t0 - timings['parse']
    logger.info('Alignment pass done in %.1fs (%d contig pairs, %d '
                'fragment pairs)', time.time() - t0, len(links.full.i),
                len(links.flank.i))

    if ul_paths:
        from haphic_tpu_torch.core.ul import boost_ht_links
        links.ht = boost_ht_links(ul_paths, links.ht, len(asm))

    # reference-format artifacts
    write_pickle(ht_link_dict(links, asm.names),
                 os.path.join(outdir, 'HT_links.pkl'))
    if cfg.quick_view:
        # quick view: the cluster stage ends after HT_links.pkl
        # (reference scripts/HapHiC_cluster.py:2884-2887)
        logger.info('Quick view: cluster stage finished in %.1fs',
                    time.time() - t0)
        return ClusterStageResult(asm=asm, frags=frags, links=links,
                                  filtered=None, sweep=None, clm_path=None,
                                  corrected_ctgs=corrected_ctgs,
                                  timings=timings)
    clm_path = os.path.join(outdir, 'paired_links.clm')
    # the CLM text artifact is ~half a minute of host string work at
    # 10M read pairs; the host is otherwise idle while the MCL sweep
    # runs on the device, so write it on a thread and join before the
    # stage returns (artifact contract unchanged)
    clm_err: List[BaseException] = []

    def _write_clm_bg():
        t_clm = time.time()
        try:
            write_clm(links.clm, asm.names, clm_path, min_read_pairs=2)
        except BaseException as e:     # re-raised at join
            clm_err.append(e)
        # its seconds overlap the filters and the MCL phase below
        timings['clm_write'] = time.time() - t_clm

    import threading
    clm_thread = threading.Thread(target=_write_clm_bg, daemon=True)
    clm_thread.start()

    # ---- ordering parity with run() (scripts/HapHiC_cluster.py:2890-2935):
    # normalize → concentrated → filter → allelic → UL boost → phasing
    # → pickle
    flank = links.flank
    full = links.full
    if cfg.normalize_by_nlinks:
        flank = normalize_by_nlinks(flank,
                                    links.frag_links.astype(np.float64))
    if cfg.remove_concentrated_links:
        from haphic_tpu_torch.core.prune import apply_concentration_adjustment
        full = apply_concentration_adjustment(
            full, links.coords, cfg.max_read_pairs,
            concentration_ratio=cfg.concentration_ratio)

    filtered = filter_fragments(
        frags, flank, links.frag_links,
        RE_site_cutoff=cfg.RE_site_cutoff,
        density_lower=cfg.density_lower, density_upper=cfg.density_upper,
        topN=cfg.topN, rank_sum_upper=cfg.rank_sum_upper,
        rank_sum_hard_cutoff=cfg.rank_sum_hard_cutoff,
        read_depth_upper=cfg.read_depth_upper,
        read_depth=read_depth, whitelist=whitelist)
    kept_ids = filtered.kept_ids

    if cfg.remove_allelic_links:
        from haphic_tpu_torch.core.prune import remove_allelic_links
        ares = remove_allelic_links(
            asm, frags, full, flank, links.coords, kept_ids,
            cfg.remove_allelic_links,
            concordance_ratio_cutoff=cfg.concordance_ratio_cutoff,
            nwindows=cfg.nwindows, min_read_pairs=cfg.min_read_pairs,
            max_read_pairs=cfg.max_read_pairs,
            ctg_pair_to_frag=links.ctg_pair_to_frag)
        full, flank, kept_ids = ares.full, ares.flank, ares.filtered_ids

    if ul_paths:
        from haphic_tpu_torch.core.ul import boost_flank_and_full
        flank, full = boost_flank_and_full(ul_paths, flank, full, frags)

    if cfg.gfa and cfg.phasing_weight > 0 and hap_of is not None:
        from haphic_tpu_torch.core.prune import (reduce_inter_hap_links_ctg,
                                                 reduce_inter_hap_links_frag)
        flank = reduce_inter_hap_links_frag(flank, frags, hap_of,
                                            cfg.phasing_weight)
        full = reduce_inter_hap_links_ctg(full, hap_of, cfg.phasing_weight)

    links.full = full
    write_pickle(full_link_dict(links, asm.names),
                 os.path.join(outdir, 'full_links.pkl'))

    timings['filters'] = (time.time() - t0 - timings['parse']
                          - timings['ingest'])
    t_mcl = time.time()
    sweep = sweep_mod.run_clustering(
        flank, kept_ids, frags, nchrs,
        expansion=cfg.expansion, min_inflation=cfg.min_inflation,
        max_inflation=cfg.max_inflation, inflation_step=cfg.inflation_step,
        max_iter=cfg.max_iter, pruning=cfg.pruning, outdir=outdir,
        mcl_backend=cfg.mcl_backend, sparse_K=cfg.sparse_K,
        device=cfg.device, mesh=_resolve_mesh(cfg))
    timings['mcl'] = time.time() - t_mcl
    # join the CLM writer before statistics: the PDF renderer forks,
    # and forking with another live thread risks inherited-lock
    # deadlocks in the children
    t_w = time.time()
    clm_thread.join()
    if clm_err:
        raise clm_err[0]
    timings['clm_wait'] = time.time() - t_w
    stat_wait = None
    if cfg.output_statistics:
        t_st = time.time()
        from haphic_tpu_torch.cluster.statistics import output_statistics
        # txt files written synchronously (the byte contract); the PDF
        # render workers are forked here and joined by run_pipeline
        # after the build stage — off the critical path
        stat_wait = output_statistics(asm, full, sweep.cluster_sets,
                                      outdir=outdir, background=True)
        timings['statistics'] = time.time() - t_st
    logger.info('Clustering stage finished in %.1fs (%s)',
                time.time() - t0,
                ', '.join('{} {:.1f}s'.format(k, v)
                          for k, v in timings.items()),
                extra={'metrics': {'cluster_secs': dict(timings)}})
    return ClusterStageResult(asm=asm, frags=frags, links=links,
                              filtered=filtered, sweep=sweep,
                              clm_path=clm_path,
                              corrected_ctgs=corrected_ctgs,
                              timings=timings, stat_wait=stat_wait)


def _mock_quick_view_groups(asm: Assembly, gfa: Optional[str],
                            outdir: str) -> ReassignResult:
    """Quick-view final_groups/: one group per haplotype when more than
    one GFA is given, else a single all-contigs group — with the
    reference's mock file formats (contigs in input order, parity:
    scripts/HapHiC_reassign.py:625-641,787-818)."""
    final_dir = os.path.join(outdir, 'final_groups')
    os.makedirs(final_dir, exist_ok=True)
    order = sorted(range(len(asm)),
                   key=lambda c: asm.input_order.get(asm.names[c], c))
    gfa_list = gfa.split(',') if gfa else []
    if len(gfa_list) <= 1:
        hap_members = [order]
    else:
        from haphic_tpu_torch.io.gfa import read_gfas
        depth = read_gfas(gfa_list, asm)
        hap_ctgs: Dict[int, List[int]] = {}
        for c in order:
            name = asm.names[c]
            if name in depth:
                hap_ctgs.setdefault(depth[name][0], []).append(c)
        hap_members = [hap_ctgs[h] for h in sorted(hap_ctgs)]

    names, lengths = [], []
    ctg_group = np.full(len(asm), -1, dtype=np.int64)
    for n, members in enumerate(hap_members, 1):
        total = int(asm.lengths[members].sum())
        names.append('group{}_{}bp'.format(n, total))
        lengths.append(total)
        ctg_group[members] = n - 1
    groups = Groups(members=hap_members, names=names, lengths=lengths,
                    ctg_group=ctg_group)

    with open(os.path.join(final_dir, 'final_clusters.txt'), 'w') as f:
        f.write('#Group\tnContigs\tContigs\n')
        for gname, members, total in zip(names, hap_members, lengths):
            f.write('{}\t{}\t{}\n'.format(
                gname, len(members),
                ' '.join(asm.names[c] for c in members)))
    for gname, members in zip(names, hap_members):
        with open(os.path.join(final_dir, '{}.txt'.format(gname)), 'w') as f:
            f.write('#Contig\tRECounts\tLength\n')
            for c in members:
                f.write('{}\t{}\t{}\n'.format(
                    asm.names[c], int(asm.re_sites[c]),
                    int(asm.lengths[c])))
    return ReassignResult(groups=groups, nrounds_run=0, hc_applied=False)


def reassign_stage(cres: ClusterStageResult, nchrs: int,
                   cfg: PipelineConfig, outdir: str,
                   inflation: Optional[Decimal] = None) -> ReassignResult:
    """02.reassign (parity: HapHiC_reassign.run)."""
    os.makedirs(outdir, exist_ok=True)
    asm = cres.asm
    if cfg.quick_view:
        return _mock_quick_view_groups(asm, cfg.gfa, outdir)
    inflation = inflation or cres.sweep.recommended_inflation
    if inflation is None:
        raise RuntimeError(
            'No inflation could be recommended; rerun with different '
            'parameters or pick one explicitly')
    cs = next(c for c in cres.sweep.cluster_sets if c.inflation == inflation)
    initial = [[asm.name2id[c] for c in ctgs] for ctgs, _ in cs.clusters]

    p = cfg.reassign
    if p.nclusters == 0:
        p.nclusters = nchrs
    p.gfa = bool(cfg.gfa)
    res = reassign(asm, cres.links.full, initial, params=p)

    sub = 'hc_groups' if res.hc_applied else 'reassigned_groups'
    prefix = 'hc' if res.hc_applied else 'reassigned'
    write_group_files(res.groups, asm, os.path.join(outdir, sub),
                      prefix=prefix)
    final_dir = os.path.join(outdir, 'final_groups')
    os.makedirs(final_dir, exist_ok=True)
    for gname, members in zip(res.groups.names, res.groups.members):
        src = os.path.join('..', sub, '{}_{}.txt'.format(prefix, gname))
        dst = os.path.join(final_dir, '{}.txt'.format(gname))
        if not os.path.exists(dst):
            os.symlink(src, dst)
    csrc = os.path.join('..', sub, '{}_clusters.txt'.format(prefix))
    cdst = os.path.join(final_dir, 'final_clusters.txt')
    if not os.path.exists(cdst):
        os.symlink(csrc, cdst)
    split_clm_file(cres.clm_path, res.groups, asm,
                   os.path.join(outdir, 'split_clms'))
    return res


@dataclass
class SortStageResult:
    tours: Dict[str, List[Tuple[str, str]]]   # group -> final tour
    tour_dir: str


def sort_stage(cres: ClusterStageResult, groups: 'ReassignResult',
               cfg: PipelineConfig, outdir: str) -> SortStageResult:
    """03.sort: per group fast sort + GA optimization + arbiter
    (parity: HapHiC_sort.run / run_haphic_sorting,
    scripts/HapHiC_sort.py:727-959)."""
    os.makedirs(outdir, exist_ok=True)
    final_dir = os.path.join(outdir, 'final_tours')
    os.makedirs(final_dir, exist_ok=True)
    asm = cres.asm
    g = groups.groups
    clm = cres.links.clm
    lengths = {c: int(l) for c, l in zip(asm.names, asm.lengths)}
    tours: Dict[str, List[Tuple[str, str]]] = {}

    # Pass 1 (host): fast sort per group + GA problem construction. The
    # reference fans the whole per-group sort over a process pool
    # (scripts/HapHiC_sort.py:932-956); here the host part is cheap and
    # the hot part (the GA) is batched into one vmapped device call per
    # shape bucket below.
    t_stage = time.time()
    fast_tours: List[Optional[List[Tuple[str, str]]]] = []
    group_datas = []
    for gname, members in zip(g.names, g.members):
        t0 = time.time()
        gd = make_group_data(members, asm.lengths, cres.links.ht)
        group_datas.append(gd)
        fast_tour = None
        if not cfg.skip_fast_sort and len(members) > 0:
            paths = fast_sort(gd, confidence_cutoff=cfg.confidence_cutoff,
                              density_cal_method=cfg.density_cal_method,
                              flanking_region_kbp=cfg.flanking_region,
                              log_prefix=gname)
            fast_tour = paths_to_tour(paths, gd.ctg_ids, asm.names)
            write_tour(os.path.join(outdir, '{}.tour.sav'.format(gname)),
                       fast_tour)
            logger.info('[%s] fast sort: %d contigs in %.1fs', gname,
                        len(members), time.time() - t0)
        fast_tours.append(fast_tour)

    # Pass 2 (device): batched GA over all multi-contig groups, each
    # hot-started from its fast sort tour.
    ga_idx = [i for i, members in enumerate(g.members)
              if not cfg.skip_allhic and len(members) > 1]
    ga_results: Dict[int, 'opt.GAResult'] = {}
    if ga_idx:
        t0 = time.time()
        problems, hots = zip(*[opt.group_problem(
            group_datas[i].ctg_ids, asm.lengths, clm, fast_tours[i],
            asm.name2id) for i in ga_idx])
        results = opt.optimize_tours(
            problems, npop=cfg.npop, ngen=cfg.ngen, mutprob=cfg.mutprob,
            seed=cfg.seed, hot_starts=hots,
            skip_ga=cfg.skipGA, backend=cfg.ga_backend,
            device=cfg.device, mesh=_resolve_mesh(cfg))
        ga_results = dict(zip(ga_idx, results))
        logger.info('optimized %d groups (batched GA) in %.1fs',
                    len(ga_idx), time.time() - t0,
                    extra={'metrics': {'ga_secs': time.time() - t0}})

    # Pass 3 (host): arbiter + tour emission per group.
    for i, (gname, members) in enumerate(zip(g.names, g.members)):
        fast_tour = fast_tours[i]
        final = fast_tour
        if i in ga_results:
            res = ga_results[i]
            ga_tour = opt.result_to_tour(res, group_datas[i].ctg_ids,
                                         asm.names)
            opt.write_ga_tour(os.path.join(outdir, '{}.tour'.format(gname)),
                              res, ga_tour, init_tour=fast_tour)
            if fast_tour is not None and choose_fast_sort(
                    fast_tour, ga_tour, lengths):
                final = fast_tour
            else:
                final = ga_tour
        elif fast_tour is not None:
            write_tour(os.path.join(outdir, '{}.tour'.format(gname)),
                       fast_tour)
        if final is None:
            final = [(asm.names[c], '+') for c in members]
        tours[gname] = final
        write_tour(os.path.join(final_dir, '{}.tour'.format(gname)), final)
    logger.info('sorted %d groups in %.1fs total', len(g.names),
                time.time() - t_stage)
    return SortStageResult(tours=tours, tour_dir=final_dir)


def build_stage(cres: ClusterStageResult, sres: SortStageResult,
                cfg: PipelineConfig, outdir: str, fasta: str,
                alignments: str) -> Tuple[str, str, str]:
    """04.build (parity: HapHiC_build.run)."""
    os.makedirs(outdir, exist_ok=True)
    asm = cres.asm
    if asm.seqs is None:
        asm = read_fasta(fasta, RE=cfg.RE)
    # scaffold names drop the _<len>bp suffix of the group/tour names,
    # exactly as the reference's tour parsing does
    # (scripts/HapHiC_build.py:37-38 rsplit('_', 1))
    tours = {g.rsplit('_', 1)[0]: t for g, t in sres.tours.items()}
    fa, agp, raw = build_final_scaffolds(
        tours, asm, corrected_ctgs=set(cres.corrected_ctgs),
        prefix=cfg.prefix,
        Ns=cfg.Ns, max_width=cfg.max_width,
        sort_by_input=cfg.sort_by_input, outdir=outdir)
    generate_juicebox_script(fasta, alignments, prefix=cfg.prefix,
                             outdir=outdir)
    return fa, agp, raw


@dataclass
class PipelineResult:
    cluster: ClusterStageResult
    reassign: Optional[ReassignResult]
    sort: Optional[SortStageResult]
    scaffold_files: Optional[Tuple[str, str, str]]
    # wall seconds per executed stage (cluster/reassign/sort/build)
    stage_secs: Dict[str, float] = field(default_factory=dict)


def run_pipeline(fasta: str, alignments: str, nchrs: int,
                 cfg: Optional[PipelineConfig] = None,
                 outdir: str = '.') -> PipelineResult:
    cfg = cfg or PipelineConfig()
    resolve_device(cfg.device)
    if cfg.quick_view:
        # quick view forces the no-GA fast path
        # (reference scripts/HapHiC_sort.py:869-870)
        cfg.skip_allhic = True
    os.makedirs(outdir, exist_ok=True)
    t0 = time.time()
    stage_secs: Dict[str, float] = {}
    cres = cluster_stage(fasta, alignments, nchrs, cfg,
                         os.path.join(outdir, '01.cluster'))
    stage_secs['cluster'] = time.time() - t0
    rres = sres = files = None
    if '2' in cfg.steps:
        t = time.time()
        rres = reassign_stage(cres, nchrs, cfg,
                              os.path.join(outdir, '02.reassign'))
        stage_secs['reassign'] = time.time() - t
    if '3' in cfg.steps and rres is not None:
        t = time.time()
        sres = sort_stage(cres, rres, cfg, os.path.join(outdir, '03.sort'))
        stage_secs['sort'] = time.time() - t
    if '4' in cfg.steps and sres is not None:
        t = time.time()
        files = build_stage(cres, sres, cfg,
                            os.path.join(outdir, '04.build'),
                            fasta, alignments)
        stage_secs['build'] = time.time() - t
    if cres.stat_wait is not None:
        t_w = time.time()
        cres.stat_wait()
        cres.timings['stat_wait'] = time.time() - t_w
    metrics = {'stage_secs': dict(stage_secs)}
    if cfg.mesh is not None:
        metrics['mesh_stats'] = dict(cfg.mesh.stats)
    logger.info('Pipeline finished in %.1fs (%s)', time.time() - t0,
                ', '.join('{} {:.1f}s'.format(k, v)
                          for k, v in stage_secs.items()),
                extra={'metrics': metrics})
    return PipelineResult(cluster=cres, reassign=rres, sort=sres,
                          scaffold_files=files, stage_secs=stage_secs)

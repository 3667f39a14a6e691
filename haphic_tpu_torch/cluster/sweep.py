"""Inflation sweep orchestration + cluster file emission.

Port of haphic_tpu/cluster/sweep.py. Mirrors run_mcl_clustering /
get_main_groups / recommend_inflation
(scripts/HapHiC_cluster.py:2098-2242) but:
  * all inflations execute batched on the card, on the dense engine
    (haphic_tpu_torch.cluster.mcl) or, from SPARSE_MIN_N fragments on,
    the sparse top-K engine (haphic_tpu_torch.cluster.sparse_mcl);
  * the recommended inflation is *returned as a value* instead of being
    regex-scraped from a log file (reference design wart,
    scripts/HapHiC_pipeline.py:382-401) — the log line is still emitted
    for drop-in compatibility.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from decimal import Decimal
from typing import Dict, List, Optional, Tuple

import numpy as np

from haphic_tpu_torch.cluster import mcl as mcl_mod
from haphic_tpu_torch.cluster import sparse_mcl as sp
from haphic_tpu_torch.core.contacts import COO
from haphic_tpu_torch.core.fragments import Fragments
from haphic_tpu_torch.parallel.mesh import mcl_sweep_sharded_partitions
from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)


def inflation_values(min_inflation: float, max_inflation: float,
                     step: float) -> List[Decimal]:
    """Decimal stepping, parity with reference lines :2139-2155."""
    start = Decimal(str(min_inflation))
    stepd = Decimal(str(step))
    end = Decimal(str(max_inflation)) + stepd
    out = []
    v = start
    while v < end:
        out.append(v)
        v += stepd
    return out


def build_adjacency(flank: COO, filtered_ids: np.ndarray, n_frag: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense symmetric adjacency over the filtered fragment subset, with
    self loops (reference dict_to_matrix(add_self_loops=True)).

    Returns (matrix, frag_ids) where frag_ids[i] is the fragment id of
    dense row i (ascending fragment id order — a deterministic
    canonicalisation of the reference's dict-insertion indexing, which
    does not affect cluster membership).
    """
    filtered_ids = np.asarray(sorted(filtered_ids))
    lookup = np.full(n_frag, -1, dtype=np.int64)
    lookup[filtered_ids] = np.arange(len(filtered_ids))
    sel = (lookup[flank.i] >= 0) & (lookup[flank.j] >= 0)
    i = lookup[flank.i[sel]]
    j = lookup[flank.j[sel]]
    w = flank.w[sel].astype(np.float32)
    m = len(filtered_ids)
    mat = np.zeros((m, m), dtype=np.float32)
    np.add.at(mat, (i, j), w)
    np.add.at(mat, (j, i), w)
    np.fill_diagonal(mat, mat.diagonal() + 1.0)
    return mat, filtered_ids


@dataclass
class ClusterSet:
    """Clusters of one inflation: list of (ctg_names, total_len),
    sorted by total length descending; ctgs sorted by length desc."""
    inflation: Decimal
    clusters: List[Tuple[List[str], int]]


@dataclass
class SweepResult:
    cluster_sets: List[ClusterSet]
    mcl_nrounds: int
    recommended_inflation: Optional[Decimal] = None
    recommendation_len_ratio: Optional[float] = None


def _clusters_to_ctgs(cluster_indices: List[Tuple[int, ...]],
                      frag_ids: np.ndarray, frags: Fragments
                      ) -> List[Tuple[List[str], int]]:
    """Map fragment-level clusters to contig-level clusters: contigs
    split into bins go to the cluster holding the largest summed bin
    length (reference lines :2168-2194)."""
    asm = frags.asm
    result: List[Tuple[List[str], int]] = []
    # split-contig votes: ctg -> {cluster_idx: bin_len_sum}, insertion ordered
    ctg_votes: Dict[int, Dict[int, int]] = {}
    per_cluster: List[List[int]] = []
    for n, idxs in enumerate(cluster_indices):
        ctgs: List[int] = []
        for di in idxs:
            fid = int(frag_ids[di])
            c = int(frags.ctg_of_frag[fid])
            if frags.split_ctg[c]:
                votes = ctg_votes.setdefault(c, {})
                votes[n] = votes.get(n, 0) + int(frags.frag_len[fid])
            else:
                ctgs.append(c)
        per_cluster.append(ctgs)

    for c, votes in ctg_votes.items():
        # max by bin length; ties broken by insertion order (parity with
        # the reference's stable sort over dict keys, line :2192)
        best = sorted(votes.keys(), key=lambda k: votes[k], reverse=True)[0]
        per_cluster[best].append(c)

    for ctgs in per_cluster:
        names = [asm.names[c] for c in ctgs]
        total = int(asm.lengths[ctgs].sum()) if ctgs else 0
        # sort contigs by length desc (reference line :2209)
        names.sort(key=lambda x: asm.length_of(x), reverse=True)
        result.append((names, total))

    # sort clusters by total length desc; deterministic tie-break on the
    # first contig name
    result.sort(key=lambda x: (-x[1], x[0][0] if x[0] else ''))
    return result


def write_cluster_files(cs: ClusterSet, asm, outdir: str) -> str:
    """Emit inflation_* directory with mcl_*.clusters.txt and group*.txt
    (byte format per reference lines :2199-2218)."""
    d = os.path.join(outdir, 'inflation_{}'.format(cs.inflation))
    os.makedirs(d, exist_ok=True)
    cpath = os.path.join(d, 'mcl_inflation_{}.clusters.txt'.format(cs.inflation))
    with open(cpath, 'w') as f:
        f.write('#Group\tnContigs\tContigs\n')
        for n, (ctgs, glen) in enumerate(cs.clusters, 1):
            f.write('group{}_{}bp\t{}\t{}\n'.format(n, glen, len(ctgs), ' '.join(ctgs)))
    for n, (ctgs, glen) in enumerate(cs.clusters, 1):
        with open(os.path.join(d, 'group{}_{}bp.txt'.format(n, glen)), 'w') as f:
            f.write('#Contig\tRECounts\tLength\n')
            for ctg in ctgs:
                f.write('{}\t{}\t{}\n'.format(ctg, asm.re_of(ctg), asm.length_of(ctg)))
    return cpath


def get_main_groups(clusters: List[Tuple[List[str], int]],
                    len_ratio: float) -> int:
    """Length-ratio knee (parity: reference lines :2098-2107)."""
    main_groups = len(clusters)
    for n in range(len(clusters) - 1):
        if clusters[n][1] and clusters[n + 1][1] / clusters[n][1] < len_ratio:
            return n + 1
    return main_groups


def recommend_inflation(cluster_sets: List[ClusterSet], nchrs: int
                        ) -> Tuple[Optional[Decimal], Optional[float]]:
    """Smallest inflation whose #main_groups >= nchrs, relaxing the
    length ratio 0.75 → 0.5 (parity: reference lines :2110-2129,
    :2229-2240). Logs the reference's exact recommendation sentence."""
    if not cluster_sets:
        return None, None
    max_ncl = max(len(cs.clusters) for cs in cluster_sets)
    if max_ncl < nchrs:
        logger.warning(
            'The maximum number of clusters (%d) is even less than the expected '
            'number of chromosomes (%d). You could try higher inflation.',
            max_ncl, nchrs)
        return None, None
    for len_ratio in (0.75, 0.7, 0.65, 0.6, 0.55, 0.5):
        separated = [(cs.inflation, get_main_groups(cs.clusters, len_ratio))
                     for cs in cluster_sets]
        separated = [(i, mg) for i, mg in separated if mg >= nchrs]
        if separated:
            separated.sort(key=lambda x: x[0])
            rcm = separated[0][0]
            logger.info('You could try inflation from %s (length ratio = %s)',
                        rcm, len_ratio)
            return rcm, len_ratio
        if len_ratio <= 0.5:
            logger.info(
                'It seems that some chromosomes were grouped together '
                '(length ratio = %s). You could check whether the parameters '
                'used are correct / appropriate.', len_ratio)
    return None, None


def build_adjacency_coo(flank: COO, filtered_ids: np.ndarray, n_frag: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """COO (i, j, w) over the filtered fragment subset (upper triangle,
    local indices) plus the frag_ids row map — the sparse-path twin of
    build_adjacency that never materializes n²."""
    filtered_ids = np.asarray(sorted(filtered_ids))
    lookup = np.full(n_frag, -1, dtype=np.int64)
    lookup[filtered_ids] = np.arange(len(filtered_ids))
    sel = (lookup[flank.i] >= 0) & (lookup[flank.j] >= 0)
    i = lookup[flank.i[sel]]
    j = lookup[flank.j[sel]]
    w = flank.w[sel].astype(np.float64)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    return lo, hi, w, filtered_ids


# From this fragment count on, the sweep runs on the sparse top-K ELL
# engine (cluster/sparse_mcl.py), whose memory is O(n·K) where the
# dense sweep's is O(n²). The value and its environment variable follow
# the JAX package so that the port routes work the same way; they change
# only on H100 measurements (PERF.md).
SPARSE_MIN_N = int(os.environ.get('HAPHIC_SPARSE_MCL_MIN_N', 20000))


def _write_sparse_info(path: str, m: int, res, inflations) -> None:
    """sparse_mcl_info.txt: the engine's parameters next to the cluster
    files (byte format of the JAX package)."""
    with open(path, 'w') as f:
        f.write('# sparse top-K MCL engine parameters\n')
        f.write('n_fragments\t{}\n'.format(m))
        f.write('K\t{}\n'.format(res.K))
        f.write('input_columns_over_K\t{}\n'.format(res.overflow_cols))
        f.write('exact\t{}\n'.format(
            'no (selection pruning active)' if res.overflow_cols
            else 'yes'))
        for b, inf_ in enumerate(inflations):
            f.write('inflation_{}\titerations={}\tconverged={}\n'.format(
                inf_, int(res.n_iters[b]), bool(res.converged[b])))


def _sparse_partitions(flank: COO, filtered_ids: np.ndarray,
                       frags: Fragments, inflations, expansion: int,
                       max_iter: int, pruning: float, sparse_K: int,
                       outdir: str, write_files: bool, device, mesh=None):
    """The sweep on the sparse top-K engine (column-sharded over
    ``mesh`` when given): per-inflation partitions and the fragment ids
    of their rows."""
    dev = resolve_device(device if mesh is None else mesh.device)
    m = len(np.asarray(filtered_ids))
    ci, cj, cw, frag_ids = build_adjacency_coo(flank, filtered_ids,
                                               len(frags))
    res = sp.run_mcl_sparse(ci, cj, cw, m, [float(i) for i in inflations],
                            K=sparse_K or sp.DEFAULT_K, expansion=expansion,
                            max_iter=max_iter, pruning=pruning, device=dev,
                            mesh=mesh)
    t0 = time.time()
    partitions = [res.interpret(b) for b in range(len(inflations))]
    interpret_s = time.time() - t0
    # selection pruning caps every column at K entries: surface the
    # approximation (exact iff no input column exceeded K) in the log
    # AND as a durable artifact next to the cluster files
    logger.info('Sparse MCL: top-K selection pruning with K=%d '
                '(%d/%d input columns wider than K -> %s); '
                '%d/%d inflations converged in %s iterations',
                res.K, res.overflow_cols, m,
                'approximate' if res.overflow_cols else 'exact',
                int(res.converged.sum()), len(inflations),
                res.n_iters.tolist(),
                extra={'metrics': {'mcl_route': dev.type,
                                   'mcl_engine': 'sparse', 'n': m,
                                   'K': res.K,
                                   'overflow_cols': res.overflow_cols,
                                   'batches': res.batches,
                                   'n_iters': res.n_iters.tolist(),
                                   'k_steps': res.k_steps,
                                   'sweep_s': res.sweep_s,
                                   'interpret_s': interpret_s}})
    if write_files:
        _write_sparse_info(os.path.join(outdir, 'sparse_mcl_info.txt'), m,
                           res, inflations)
    return partitions, frag_ids


def run_clustering(flank: COO, filtered_ids: np.ndarray, frags: Fragments,
                   nchrs: int, expansion: int = 2, min_inflation: float = 1.1,
                   max_inflation: float = 3.0, inflation_step: float = 0.1,
                   max_iter: int = 200, pruning: float = 1e-4,
                   outdir: str = '.', write_files: bool = True,
                   mcl_backend: str = 'auto', sparse_K: int = 0,
                   device=None, mesh=None) -> SweepResult:
    """Full clustering stage: adjacency → batched MCL sweep → cluster
    files + inflation recommendation.

    ``mcl_backend``: 'dense' | 'sparse' | 'auto' (sparse from
    SPARSE_MIN_N / HAPHIC_SPARSE_MCL_MIN_N fragments on). Both engines
    run on ``device``.

    ``mesh``: a parallel.mesh.Mesh to shard the sweep over, on its
    device: the sparse engine shards the matrix column axis, the dense
    engine the inflations (parallel.mesh.mcl_sweep_sharded_partitions).
    Every rank gets every partition."""
    inflations = inflation_values(min_inflation, max_inflation, inflation_step)
    m = len(np.asarray(filtered_ids))
    use_sparse = mcl_backend == 'sparse' or (
        mcl_backend == 'auto' and m >= SPARSE_MIN_N)
    logger.info('Performing Markov clustering (n=%d fragments, %d '
                'inflations, batched, %s%s)...', m, len(inflations),
                'sparse top-K' if use_sparse else 'dense',
                ', {}-rank mesh'.format(mesh.world)
                if mesh is not None else '')
    if use_sparse:
        partitions, frag_ids = _sparse_partitions(
            flank, filtered_ids, frags, inflations, expansion, max_iter,
            pruning, sparse_K, outdir, write_files, device, mesh)
    elif mesh is not None:
        ci, cj, cw, frag_ids = build_adjacency_coo(flank, filtered_ids,
                                                   len(frags))
        partitions, _, _ = mcl_sweep_sharded_partitions(
            mesh, None, [float(i) for i in inflations], expansion=expansion,
            max_iter=max_iter, pruning=pruning,
            coo=(ci, cj, cw, len(frag_ids)))
    else:
        # links go to the device as an O(nnz) COO list and are densified
        # there; only the nonzero pattern of each result comes back
        ci, cj, cw, frag_ids = build_adjacency_coo(flank, filtered_ids,
                                                   len(frags))
        partitions, _, _ = mcl_mod.run_mcl_partitions(
            None, [float(i) for i in inflations], expansion=expansion,
            max_iter=max_iter, pruning=pruning,
            coo=(ci, cj, cw, len(frag_ids)), device=device)
    map_s = files_s = 0.0
    cluster_sets: List[ClusterSet] = []
    for b, inflation in enumerate(inflations):
        idx_clusters = partitions[b]
        if not idx_clusters:
            logger.info('Some fragments are missing / redundant, result of '
                        'inflation %s will NOT be output', inflation)
            continue
        t0 = time.time()
        clusters = _clusters_to_ctgs(idx_clusters, frag_ids, frags)
        cs = ClusterSet(inflation=inflation, clusters=clusters)
        cluster_sets.append(cs)
        t1 = time.time()
        if write_files:
            write_cluster_files(cs, frags.asm, outdir)
        map_s += t1 - t0
        files_s += time.time() - t1
    # host seconds after the sweep: fragments to contigs, cluster files
    logger.info('Cluster sets of %d inflations in %.1fs, their files in '
                '%.1fs', len(cluster_sets), map_s, files_s,
                extra={'metrics': {
                    'cluster_map_s': map_s, 'cluster_files_s': files_s,
                    'clusters_per_inflation': [len(cs.clusters)
                                               for cs in cluster_sets]}})
    rcm, ratio = recommend_inflation(cluster_sets, nchrs)
    return SweepResult(cluster_sets=cluster_sets, mcl_nrounds=len(inflations),
                       recommended_inflation=rcm, recommendation_len_ratio=ratio)

"""Fast sorting: 3D-DNA-style iterative confidence scaffolding.

Re-implements the semantics of the reference fast_sort
(scripts/HapHiC_sort.py:117-615) on integer half-contig ("HT") ids with
vectorized numpy per-round math:

  * entity link recomputation (reference `update`, :338-437, a Python
    double loop over base-HT products) becomes one aggregation matmul
    ``S @ M0 @ S.T`` — MXU-shaped, and the dominant per-round cost;
  * confidence (density / second-largest incident density, reference
    :195-244) is computed for all edges at once from per-row top-3
    statistics instead of a per-edge O(n) hstack scan.

Terminology: each contig contributes two base HT nodes (head = 2*k,
tail = 2*k+1, local to the group). Each round groups the current paths
into two "entities" (half-scaffolds); sister entities (the two halves of
one path) are forced into the spanning forest by a 2*MAXS weight.

Tie-breaking note: the reference's Kruskal order for equal weights is
networkx edge-insertion order; here ties break on the (i, j) index pair
— identical results whenever confidences are distinct (floats; ties are
measure-zero apart from the conf==2 'only incident edge' case).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

logger = logging.getLogger(__name__)

Entity = Tuple[int, ...]          # ordered base HT ids


@dataclass
class GroupOrderData:
    """Per-group input to fast_sort / the tour optimizer.

    ctg_ids   group contig ids sorted by length descending (global ids)
    lengths   int64, aligned with ctg_ids
    ht_links  (2k, 2k) float64 base HT link matrix, ht local id =
              2*local_ctg + (0=head, 1=tail); sister entries are zero
    """
    ctg_ids: np.ndarray
    lengths: np.ndarray
    ht_links: np.ndarray


def make_group_data(ctg_ids: Sequence[int], lengths_all: np.ndarray,
                    ht: 'COO') -> GroupOrderData:
    """Build the local HT matrix for one group from the global HT COO
    (node ids = global ctg*2 + is_tail; see contacts.LinkAccumulator)."""
    ctg_ids = np.asarray(sorted(ctg_ids,
                                key=lambda c: (-int(lengths_all[c]), c)),
                         dtype=np.int64)
    k = len(ctg_ids)
    lookup: Dict[int, int] = {int(c): i for i, c in enumerate(ctg_ids)}
    m = np.zeros((2 * k, 2 * k), dtype=np.float64)
    gi = ht.i // 2
    gj = ht.j // 2
    for a, b, ia, ib, w in zip(gi.tolist(), gj.tolist(),
                               (ht.i % 2).tolist(), (ht.j % 2).tolist(),
                               ht.w.tolist()):
        la = lookup.get(a)
        lb = lookup.get(b)
        if la is None or lb is None or la == lb:
            continue
        x, y = 2 * la + ia, 2 * lb + ib
        m[x, y] += w
        m[y, x] += w
    return GroupOrderData(ctg_ids=ctg_ids,
                          lengths=lengths_all[ctg_ids].astype(np.int64),
                          ht_links=m)


def _entity_lengths(entities: List[Entity], half_len: np.ndarray,
                    flank_map: Dict[Entity, Tuple[Entity, float]]
                    ) -> np.ndarray:
    out = np.empty(len(entities))
    for n, e in enumerate(entities):
        if e in flank_map:
            out[n] = flank_map[e][1]
        else:
            out[n] = half_len[list(e)].sum()
    return out


def _density_matrix(links: np.ndarray, ent_len: np.ndarray,
                    method: str) -> np.ndarray:
    if method == 'sum':
        denom = ent_len[:, None] + ent_len[None, :]
    elif method == 'multiplication':
        denom = ent_len[:, None] * ent_len[None, :]
    elif method == 'geometric_mean':
        denom = np.sqrt(ent_len[:, None] * ent_len[None, :])
    else:
        raise ValueError(method)
    np.fill_diagonal(denom, 1.0)
    denom[denom == 0] = 1.0
    return links / denom


def _confidences(density: np.ndarray, edges: np.ndarray
                 ) -> Tuple[np.ndarray, float]:
    """Vectorized confidence for each edge (i, j):
    density(i,j) / second-largest density incident on i or j, where the
    multiset of incident densities is row_i minus column j plus the full
    column j (reference :211-225)."""
    if len(edges) == 0:
        return np.zeros(0), 0.0
    n = density.shape[0]
    k = min(3, n)
    # per-row top-3 values and their column indices
    part = np.argpartition(-density, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(density, part, axis=1)
    order = np.argsort(-vals, axis=1, kind='stable')
    top_idx = np.take_along_axis(part, order, axis=1)      # (n, k)
    top_val = np.take_along_axis(vals, order, axis=1)      # (n, k)

    i, j = edges[:, 0], edges[:, 1]
    d = density[i, j]

    # top-2 of row i excluding column j
    def top2_excluding(rows, excl):
        t_i = top_idx[rows]
        t_v = top_val[rows].copy()
        t_v[t_i == excl[:, None]] = -np.inf
        s = np.sort(t_v, axis=1)[:, ::-1]
        a1 = s[:, 0]
        a2 = s[:, 1] if s.shape[1] > 1 else np.full(len(rows), -np.inf)
        return a1, a2

    a1, a2 = top2_excluding(i, j)
    b1 = top_val[j, 0]
    b2 = top_val[j, 1] if k > 1 else np.full(len(j), -np.inf)

    merged = np.stack([a1, a2, b1, b2], axis=1)
    s = np.sort(merged, axis=1)[:, ::-1]
    second = s[:, 1]
    second = np.where(np.isfinite(second), second, 0.0)

    conf = np.where(d == 0, 0.0,
                    np.where(second == 0, 2.0, d / np.maximum(second, 1e-300)))
    maxs = float(conf.max()) if len(conf) else 0.0
    return conf, maxs


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.p[ra] = rb
        return True


def _spanning_paths(n_ent: int, edges: np.ndarray, weights: np.ndarray
                    ) -> List[List[int]]:
    """Maximum spanning forest via Kruskal; sister edges (2n, 2n+1) are
    pre-merged (their weight 2*MAXS dominates). Every node has at most
    one non-sister filtered edge, so each tree is a simple path of
    entity indices — returned in traversal order."""
    uf = _UnionFind(n_ent)
    adj: List[List[int]] = [[] for _ in range(n_ent)]
    for p in range(n_ent // 2):
        uf.union(2 * p, 2 * p + 1)
        adj[2 * p].append(2 * p + 1)
        adj[2 * p + 1].append(2 * p)

    order = np.lexsort((edges[:, 1], edges[:, 0], -weights))
    for t in order:
        a, b = int(edges[t, 0]), int(edges[t, 1])
        if uf.union(a, b):
            adj[a].append(b)
            adj[b].append(a)

    paths: List[List[int]] = []
    seen = [False] * n_ent
    for start in range(n_ent):
        if seen[start] or len(adj[start]) != 1:
            continue
        # walk from a degree-1 end
        path = [start]
        seen[start] = True
        prev, cur = start, adj[start][0]
        while True:
            path.append(cur)
            seen[cur] = True
            nxts = [x for x in adj[cur] if x != prev]
            if not nxts:
                break
            prev, cur = cur, nxts[0]
        paths.append(path)
    # cycles (all nodes degree 2) cannot occur: Kruskal rejects the
    # closing edge; still guard for isolated full coverage
    for start in range(n_ent):
        if not seen[start]:
            # isolated pair fallback (shouldn't happen: sisters linked)
            comp = [start] + adj[start]
            for x in comp:
                seen[x] = True
            paths.append(comp)
    return paths


def _split_scaffold(path_ents: List[Entity], half_len: np.ndarray,
                    known_adjacency: Set[Tuple[int, int]]
                    ) -> Tuple[Entity, Entity]:
    """Orient + concatenate the entities of a new path, then split at
    the length midpoint (reference split_new_scaffold, :268-326)."""
    sorted_path: List[int] = []
    for n in range(len(path_ents) // 2):
        e1 = path_ents[2 * n]
        e2 = path_ents[2 * n + 1]
        l1, r1 = e1[0], e1[-1]
        l2, r2 = e2[0], e2[-1]

        def known(a, b):
            return (min(a, b), max(a, b)) in known_adjacency

        if known(l1, l2):
            sorted_path.extend(e1[::-1])
            sorted_path.extend(e2)
        elif known(r1, r2):
            sorted_path.extend(e1)
            sorted_path.extend(e2[::-1])
        elif known(l1, r2):
            sorted_path.extend(e1[::-1])
            sorted_path.extend(e2[::-1])
        else:
            assert known(r1, l2), 'sister pair has no known adjacency'
            sorted_path.extend(e1)
            sorted_path.extend(e2)

    total = half_len[sorted_path].sum()
    half = total / 2
    acc = np.cumsum(half_len[sorted_path])
    split = int(np.argmin(np.abs(acc - half))) + 1
    left = tuple(sorted_path[:split])
    right = tuple(sorted_path[split:])
    adj = (min(left[-1], right[0]), max(left[-1], right[0]))
    known_adjacency.add(adj)
    return left, right


def _flank_restrict(e: Entity, order: int, flank_bp: float,
                    half_len: np.ndarray,
                    flank_map: Dict[Entity, Tuple[Entity, float]]) -> None:
    """Reference get_flank_HT (:352-368): drop base HTs from one side
    while the remaining length stays above the flank size."""
    rest_len = float(half_len[list(e)].sum())
    if rest_len <= flank_bp:
        return
    m = 0
    seq = e[::order]
    for m, ht in enumerate(seq):
        l = float(half_len[ht])
        if rest_len - l > flank_bp:
            rest_len -= l
        else:
            break
    if m == 0:
        rest: Entity = e
    elif order == 1:
        rest = e[:-m]
    else:
        rest = e[m:]
    flank_map[e] = (rest, float(half_len[list(rest)].sum()))


def fast_sort(group: GroupOrderData, confidence_cutoff: float = 1.0,
              density_cal_method: str = 'multiplication',
              flanking_region_kbp: int = 0,
              log_prefix: str = '') -> List[List[int]]:
    """Order and orient the contigs of one group.

    Returns the output path list: one list of base HT local ids per
    final path (scaffold), concatenated left-to-right; taking every
    second element gives the contig order, head-first meaning '+'
    (reference output_tour_file, :440-453).
    """
    k = len(group.ctg_ids)
    if k == 0:
        raise RuntimeError('empty group')
    if k == 1:
        return [[0, 1]]

    half_len = np.repeat(group.lengths / 2.0, 2)      # base HT half-length
    M0 = group.ht_links
    flank_bp = flanking_region_kbp * 1000.0

    # initial state: each contig is a path [H, T]
    entities: List[Entity] = [(i,) for i in range(2 * k)]
    S = np.eye(2 * k, dtype=np.float64)               # entity × baseHT
    links = M0.copy()
    output_paths: List[List[int]] = [[2 * i, 2 * i + 1] for i in range(k)]
    path_lens = [float(group.lengths[i]) for i in range(k)]
    known_adjacency: Set[Tuple[int, int]] = {(2 * i, 2 * i + 1)
                                             for i in range(k)}
    flank_map: Dict[Entity, Tuple[Entity, float]] = {}
    removed_paths: List[List[int]] = []
    need_rebuild = False
    r = 0

    while len(output_paths) > 1:
        r += 1
        n_ent = 2 * len(output_paths)
        if need_rebuild:
            links = links[:n_ent, :n_ent]
            need_rebuild = False

        ent_len = _entity_lengths(entities, half_len, flank_map)
        density = _density_matrix(links, ent_len, density_cal_method)
        # non-sister edges with links
        iu, ju = np.nonzero(np.triu(links, 1))
        sister = (iu // 2 == ju // 2)
        edges = np.stack([iu[~sister], ju[~sister]], axis=1)
        conf, maxs = _confidences(density, edges)

        if maxs <= confidence_cutoff:
            if len(output_paths) > 2:
                # drop the shortest (last) path and retry
                removed_paths.append(output_paths.pop(-1))
                path_lens.pop(-1)
                entities = entities[:-2]
                need_rebuild = True
                logger.debug('%s round %d: removed shortest path (MAXS=%s)',
                             log_prefix, r, maxs)
                continue
            break

        keep = conf > confidence_cutoff
        paths_idx = _spanning_paths(n_ent, edges[keep], conf[keep])

        # path lengths (full entity lengths, not flank-restricted)
        full_len = np.array([half_len[list(e)].sum() for e in entities])
        scored = []
        for p in paths_idx:
            scored.append((p, float(full_len[p].sum())))
        scored.sort(key=lambda x: -x[1])

        new_entities: List[Entity] = []
        output_paths = []
        path_lens = []
        for p, plen in scored:
            path_lens.append(plen)
            if len(p) == 2:
                e_l, e_r = entities[p[0]], entities[p[1]]
            else:
                e_l, e_r = _split_scaffold([entities[x] for x in p],
                                           half_len, known_adjacency)
                if flank_bp:
                    _flank_restrict(e_l, -1, flank_bp, half_len, flank_map)
                    _flank_restrict(e_r, 1, flank_bp, half_len, flank_map)
            new_entities.append(e_l)
            new_entities.append(e_r)
            output_paths.append(list(e_l) + list(e_r))
        entities = new_entities

        # rebuild entity link matrix: S @ M0 @ S.T with flank-restricted
        # membership (reference update(), :406-433). S is a 0/1
        # selection matrix, so the product rides scipy CSR — the dense
        # (n_ent, 2k) @ (2k, 2k) BLAS chain cost ~8 s/group at k=2000
        # (59 rounds), vs O(nnz * 2k) here
        from scipy.sparse import csr_matrix
        n_ent = len(entities)
        memb = [np.fromiter(flank_map[e][0] if e in flank_map else e,
                            np.int64) for e in entities]
        rows = np.repeat(np.arange(n_ent), [len(m) for m in memb])
        cols = np.concatenate(memb) if memb else np.zeros(0, np.int64)
        S = csr_matrix((np.ones(len(cols)), (rows, cols)),
                       shape=(n_ent, 2 * k))
        T = S @ M0                                     # (n_ent, 2k)
        links = np.asarray((S @ T.T).T)
        # zero sisters & diagonal so they never enter edge lists
        for p in range(n_ent // 2):
            links[2 * p, 2 * p + 1] = links[2 * p + 1, 2 * p] = 0.0
        np.fill_diagonal(links, 0.0)
        logger.debug('%s round %d: %d paths (MAXS=%s)',
                     log_prefix, r, len(output_paths), maxs)

    output_paths.extend(removed_paths[::-1])
    return output_paths


def paths_to_tour(output_paths: List[List[int]], ctg_ids: np.ndarray,
                  names: List[str]) -> List[Tuple[str, str]]:
    """Flatten output paths to [(ctg_name, '+'/'-')]: even positions are
    the entering HT; head first => '+' (reference :440-453)."""
    tour: List[Tuple[str, str]] = []
    for path in output_paths:
        for ht in path[::2]:
            ctg = int(ctg_ids[ht // 2])
            tour.append((names[ctg], '+' if ht % 2 == 0 else '-'))
    return tour


def write_tour(path: str, tour: List[Tuple[str, str]],
               header: str = '>INIT') -> None:
    with open(path, 'w') as f:
        f.write('{}\n'.format(header))
        f.write('{}\n'.format(' '.join(c + o for c, o in tour)))

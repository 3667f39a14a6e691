"""Parity of the port's link pruning (haphic_tpu_torch.core.prune) with
the JAX package's, on seeded inputs: the ratio statistics, the
concentration adjustment, allelic link removal at ploidy 2, 3 and 4 on
tie-heavy integer weights, the phasing weight, and the port's own clique
search against networkx's."""

import random
import types

import numpy as np
import pytest

from haphic_tpu.core import prune as jprune
from haphic_tpu.core.contacts import COO as JCOO, CoordPairs as JCoordPairs
from haphic_tpu.core.fragments import Fragments as JFragments
from haphic_tpu.io.fasta import Assembly as JAssembly

from haphic_tpu_torch.core import prune as tprune
from haphic_tpu_torch.core.contacts import COO as TCOO, CoordPairs as TCoordPairs
from haphic_tpu_torch.core.fragments import Fragments as TFragments
from haphic_tpu_torch.io.fasta import Assembly as TAssembly

JAX = types.SimpleNamespace(COO=JCOO, CoordPairs=JCoordPairs,
                            Fragments=JFragments, Assembly=JAssembly)
TORCH = types.SimpleNamespace(COO=TCOO, CoordPairs=TCoordPairs,
                              Fragments=TFragments, Assembly=TAssembly)


# ---- inputs, as tests/test_prune.py makes them, built in either package

def _make_asm(pkg, names, lengths):
    snames = sorted(names)
    return pkg.Assembly(names=snames,
                        name2id={c: i for i, c in enumerate(snames)},
                        lengths=np.asarray([lengths[names.index(c)]
                                            for c in snames], np.int64),
                        re_sites=np.full(len(names), 10, np.int64),
                        seqs=None,
                        input_order={c: i for i, c in enumerate(names)})


def _make_frags(pkg, asm):
    n = len(asm)
    return pkg.Fragments(asm=asm, ctg_of_frag=np.arange(n, dtype=np.int32),
                         bin_no=np.ones(n, np.int32),
                         frag_start=np.zeros(n, np.int64),
                         frag_len=asm.lengths.copy(),
                         frag_re=asm.re_sites.copy(),
                         frag_offset=np.arange(n + 1, dtype=np.int64),
                         split_ctg=np.zeros(n, bool),
                         nx_mask=np.ones(n, bool), bin_size=0)


def _coords_from_records(pkg, records, n, max_read_pairs):
    """records: list of (id_i, id_j, ci, cj) with id_i < id_j."""
    keys = np.asarray([a * n + b for a, b, _, _ in records], np.int64)
    ci = np.asarray([r[2] for r in records], np.int64)
    cj = np.asarray([r[3] for r in records], np.int64)
    order = np.argsort(keys, kind='stable')
    keys, ci, cj = keys[order], ci[order], cj[order]
    upk, starts, total = np.unique(keys, return_index=True,
                                   return_counts=True)
    rank = np.arange(len(keys)) - np.repeat(starts, total)
    keep = rank < max_read_pairs
    keys, ci, cj = keys[keep], ci[keep], cj[keep]
    upk2, starts2, cnt2 = np.unique(keys, return_index=True,
                                    return_counts=True)
    return pkg.CoordPairs(pair_i=(keys // n), pair_j=(keys % n), ci=ci,
                          cj=cj, total_counts_i=upk, total_counts=total,
                          starts=starts2, counts=cnt2,
                          upair_i=(upk // n), upair_j=(upk % n))


def _full_coo(pkg, records, n):
    keys = np.asarray([a * n + b for a, b, _, _ in records], np.int64)
    uk, cnt = np.unique(keys, return_counts=True)
    return pkg.COO(i=uk // n, j=uk % n, w=cnt.astype(np.float64))


def _polyploid_inputs(pkg, seed, ploidy, n_sets=4, n_other=4,
                      n_coords=30, n_noise=3):
    """Allele sets of ``ploidy`` contigs (one set of ploidy + 1, and one
    of ploidy + 2 from ploidy 3 on, so that cliques over the ploidy are
    split) whose pairs share diagonal coordinates, ``n_coords`` pairs
    each: their weights tie. Other pairs: a few random coordinates each,
    small integer counts that tie often."""
    rng = random.Random(seed)
    sets = []
    sizes = [ploidy] * n_sets
    sizes[0] += 1
    if ploidy > 2:
        sizes[1] += 2
    for s, size in enumerate(sizes):
        sets.append(['a{}_{}'.format(s, h) for h in range(size)])
    names = [c for members in sets for c in members] + \
        ['x{}'.format(i) for i in range(n_other)]
    lengths = [rng.randrange(200000, 400000, 1000) for _ in names]
    asm = _make_asm(pkg, names, lengths)
    records = []
    for members in sets:
        ids = sorted(asm.name2id[c] for c in members)
        for x, a in enumerate(ids):
            for b in ids[x + 1:]:
                L = min(asm.lengths[a], asm.lengths[b])
                for _ in range(n_coords):
                    p = rng.randrange(1, L)
                    records.append((a, b, p, min(p + rng.randrange(0, 500),
                                                 L)))
    n = len(asm)
    for i in range(n):
        for j in range(i + 1, n):
            for _ in range(rng.randrange(0, n_noise + 1)):
                records.append((i, j, rng.randrange(1, asm.lengths[i] + 1),
                                rng.randrange(1, asm.lengths[j] + 1)))
    frags = _make_frags(pkg, asm)
    coords = _coords_from_records(pkg, records, n, 200)
    full = _full_coo(pkg, records, n)
    flank = pkg.COO(i=full.i.copy(), j=full.j.copy(), w=full.w.copy())
    return asm, frags, full, flank, coords


def _diploid_coords(pkg, seed):
    rng = random.Random(seed)
    n = 10
    lengths = [rng.randrange(200000, 400000, 1000) for _ in range(n)]
    asm = _make_asm(pkg, ['c{}'.format(i) for i in range(n)], lengths)
    records = []
    for a in range(n):
        for b in range(a + 1, n):
            L = min(asm.lengths[a], asm.lengths[b])
            for _ in range(rng.randrange(0, 260)):
                if (a + b) % 3 == 0:      # concordant, or piled into a bin
                    p = rng.randrange(1, L)
                    q = min(p + rng.randrange(0, 900), L)
                elif (a + b) % 3 == 1 and rng.random() < 0.5:
                    p = 50000 + rng.randrange(0, 3000)
                    q = rng.randrange(1, L)
                else:
                    p, q = rng.randrange(1, L), rng.randrange(1, L)
                records.append((a, b, p, q))
    return asm, _coords_from_records(pkg, records, n, 200), \
        _full_coo(pkg, records, n)


def _assert_coo_equal(got, want):
    for f in ('i', 'j', 'w'):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---- ratio statistics and the concentration adjustment

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_concordance_and_concentration_ratios_match_jax(seed):
    jasm, jc, _ = _diploid_coords(JAX, seed)
    tasm, tc, _ = _diploid_coords(TORCH, seed)
    for nwindows in (50, 7):
        want = jprune.concordance_ratios(jc, jasm.lengths, nwindows)
        got = tprune.concordance_ratios(tc, tasm.lengths, nwindows)
        assert np.array_equal(got, want)
    assert (want > 0.2).any() and (want <= 0.2).any()
    for ratio in (10.0, 2.0):
        want = jprune.concentration_adj_ratios(jc, concentration_ratio=ratio)
        got = tprune.concentration_adj_ratios(tc, concentration_ratio=ratio)
        assert np.array_equal(got, want)
    assert (want < 1.0).any()


@pytest.mark.parametrize('max_read_pairs', [200, 60])
def test_apply_concentration_adjustment_matches_jax(max_read_pairs):
    _, jc, jfull = _diploid_coords(JAX, 4)
    _, tc, tfull = _diploid_coords(TORCH, 4)
    want = jprune.apply_concentration_adjustment(jfull, jc, max_read_pairs)
    got = tprune.apply_concentration_adjustment(tfull, tc, max_read_pairs)
    _assert_coo_equal(got, want)
    assert not np.array_equal(want.w, jfull.w)


# ---- allelic link removal

@pytest.mark.parametrize('ploidy,seed', [(2, 0), (2, 1), (3, 0), (3, 1),
                                         (4, 0), (4, 1)])
def test_remove_allelic_links_matches_jax(ploidy, seed):
    jin = _polyploid_inputs(JAX, seed, ploidy)
    tin = _polyploid_inputs(TORCH, seed, ploidy)
    n = len(jin[0])
    filtered = np.arange(n - 1)             # one fragment filtered out
    want = jprune.remove_allelic_links(*jin, filtered, ploidy)
    got = tprune.remove_allelic_links(*tin, filtered, ploidy)
    _assert_coo_equal(got.full, want.full)
    _assert_coo_equal(got.flank, want.flank)
    assert np.array_equal(got.filtered_ids, want.filtered_ids)
    assert got.n_allelic_pairs == want.n_allelic_pairs > 0
    assert got.n_nonmax_pairs == want.n_nonmax_pairs
    # the inputs tie: several allelic pairs carry the weakest weight
    full, coords = jin[2], jin[4]
    w = np.asarray([full.w[(full.i == a) & (full.j == b)][0]
                    for a, b in zip(coords.upair_i, coords.upair_j)])
    assert np.unique(w, return_counts=True)[1].max() > 1


@pytest.mark.parametrize('weight', [1.0, 0.5, 0.25])
def test_reduce_inter_hap_links_match_jax(weight):
    rng = np.random.default_rng(7)
    n_ctg, m = 12, 40
    names = ['c{:02d}'.format(c) for c in range(n_ctg)]
    hap = rng.integers(0, 3, n_ctg).astype(np.int32)
    ctg_of_frag = np.sort(rng.integers(0, n_ctg, m)).astype(np.int32)
    fi, fj = rng.integers(0, m, (2, 200))
    ci, cj = rng.integers(0, n_ctg, (2, 80))
    fw = rng.integers(1, 9, 200).astype(np.float64)
    cw = rng.integers(1, 9, 80).astype(np.float64)
    out = []
    for pkg, mod in ((JAX, jprune), (TORCH, tprune)):
        frags = _make_frags(pkg, _make_asm(pkg, names, [1000] * n_ctg))
        frags.ctg_of_frag = ctg_of_frag
        flank = pkg.COO(i=np.minimum(fi, fj), j=np.maximum(fi, fj), w=fw)
        full = pkg.COO(i=np.minimum(ci, cj), j=np.maximum(ci, cj), w=cw)
        out.append((mod.reduce_inter_hap_links_frag(flank, frags, hap,
                                                    weight),
                    mod.reduce_inter_hap_links_ctg(full, hap, weight)))
    for got, want in zip(out[1], out[0]):
        _assert_coo_equal(got, want)
    assert (len(out[0][1].i) < 80) == (weight == 1.0)


# ---- the clique search

def _random_graph_edges(seed):
    """Nodes and edges in a random insertion order: dense random graphs,
    planted cliques and isolated nodes, node ids spread wide so that
    the sets' hash layout varies."""
    rng = random.Random(seed)
    n = rng.randrange(1, 40)
    ids = rng.sample(range(0, 10 ** rng.randrange(2, 6)), n)
    p = rng.choice((0.05, 0.2, 0.5, 0.8))
    edges = [(a, b) for x, a in enumerate(ids) for b in ids[x + 1:]
             if rng.random() < p]
    for _ in range(rng.randrange(0, 3)):
        k = rng.sample(ids, min(n, rng.randrange(2, 8)))
        edges += [(a, b) for x, a in enumerate(k) for b in k[x + 1:]]
    rng.shuffle(edges)
    edges = [(b, a) if rng.random() < 0.5 else (a, b) for a, b in edges]
    isolated = rng.sample(ids, min(n, 3))
    return isolated, edges


@pytest.mark.parametrize('seed', range(60))
def test_find_cliques_yields_networkx_lists(seed):
    """The same list as networkx.find_cliques: the same cliques, in the
    same order, each in the same node order; also after removing an
    edge, as _split_cliques does."""
    nx = pytest.importorskip('networkx')
    isolated, edges = _random_graph_edges(seed)
    G, g = nx.Graph(), {}
    if seed % 2:
        G.add_nodes_from(isolated)
        for u in isolated:
            g.setdefault(u, {})
    for a, b in edges:
        G.add_edge(a, b, weight=1.0)
        g.setdefault(a, {})[b] = 1.0
        g.setdefault(b, {})[a] = 1.0
    assert list(tprune.find_cliques(g)) == list(nx.find_cliques(G))
    if edges:
        a, b = edges[len(edges) // 2]
        G.remove_edge(a, b)
        del g[a][b], g[b][a]
        assert list(tprune.find_cliques(g)) == list(nx.find_cliques(G))


def test_find_cliques_of_an_empty_graph():
    assert list(tprune.find_cliques({})) == []


@pytest.mark.parametrize('seed', range(8))
def test_split_cliques_matches_jax(seed):
    """Cliques over the ploidy split at their weakest edge, on integer
    weights with many ties (the strict < keeps the first weakest edge
    met, so the clique order decides)."""
    rng = random.Random(seed)
    nodes = rng.sample(range(1000), 14)
    adj = {}
    cliques = []
    for _ in range(4):
        k = rng.sample(nodes, rng.randrange(3, 8))
        cliques.append(tuple(k))
        for x, a in enumerate(k):
            for b in k[x + 1:]:
                w = float(rng.randrange(1, 4))
                adj.setdefault(a, {})[b] = w
                adj.setdefault(b, {})[a] = w
    for ploidy in (2, 3, 4):
        want = jprune._split_cliques(adj, cliques, ploidy)
        got = tprune._split_cliques(adj, cliques, ploidy)
        assert got == want
        assert all(len(c) <= ploidy for c in got)

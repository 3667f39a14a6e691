"""The sort stage's inputs and its reference: the CLM records and HT
links drawn from a genome, the plain tour score, the stage loader."""

import json
import os

import numpy as np
import pytest
import torch

from hicbench import clm
from hicbench import genome as gen
from hicbench import stages
from hicbench.reference import tour_score

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small(contigs=160, chromosomes=2, haplotypes=2, depth=2.0):
    with open(os.path.join(HERE, 'configs', 'alfalfa_4x.json')) as f:
        cfg = json.load(f)
    cfg['published'] = dict(cfg['published'], contigs=contigs,
                            genome_bp=contigs * 100_000,
                            chromosomes=chromosomes, haplotypes=haplotypes,
                            hic_depth_x=depth)
    return cfg


@pytest.fixture(scope='module')
def drawn():
    cfg = small()
    gn = gen.make(cfg, 2 ** 31 + 3)
    groups = [0, 1, 3]
    return cfg, gn, groups, clm.draw_reads(gn, cfg, groups)


def test_draw_counts_are_the_genome_links(drawn):
    """Every read pair of every link with both contigs in the groups,
    pair by pair."""
    cfg, gn, groups, reads = drawn
    gs = gn.group_start
    inside = np.zeros(gn.sizes.contigs, dtype=bool)
    for g in groups:
        inside[gs[g]:gs[g + 1]] = True
    sel = inside[gn.i] & inside[gn.j]
    n = gn.sizes.contigs
    want = dict(zip((gn.i[sel] * n + gn.j[sel]).tolist(),
                    gn.w[sel].astype(int).tolist()))
    key, cnt = np.unique(reads.a * n + reads.b, return_counts=True)
    assert dict(zip(key.tolist(), cnt.tolist())) == want
    assert (reads.a < reads.b).all()
    # between two groups every pair is uniform; inside one, few are
    group = np.searchsorted(gs, np.arange(n), side='right') - 1
    across = group[gn.i] != group[gn.j]
    assert np.array_equal(gn.w_trans[across], gn.w[across])
    assert gn.w_trans[~across].sum() < 0.02 * gn.w[~across].sum()
    L = gn.sizes.contig_bp
    assert reads.pa.min() >= 1 and reads.pa.max() <= L
    assert reads.pb.min() >= 1 and reads.pb.max() <= L


def test_cis_pairs_keep_their_separation(drawn):
    """A pair of one chromosome lies at least s_min apart; between
    neighbours the separation is uniform up to L and thins out to 2 L,
    so its median lies near 0.69 L; two contigs apart, past L."""
    cfg, gn, _, reads = drawn
    L = gn.sizes.contig_bp
    s = (reads.b - reads.a) * L + reads.pb - reads.pa
    nb = reads.b - reads.a == 1
    cis = s[nb] >= cfg['assumed']['s_min_bp']
    # the uniform pairs between neighbours may lie closer
    assert cis.mean() > 0.99
    assert 0.64 * L < np.median(s[nb][cis]) < 0.74 * L
    assert L < np.median(s[reads.b - reads.a == 2]) < 3 * L


def test_separations_follow_the_law():
    """Neighbours (d = 1): the separation's density is (L - |s - L|) / s
    on [s_min, 2 L]: 1 below L, (2 L - s) / s above; its mass below L is
    L - s_min, above L (2 ln 2 - 1) L."""
    L, s_min = 100_000.0, 1000.0
    rng = np.random.default_rng(5)
    s = clm.separations(np.ones(200_000, np.int64), L, s_min, rng)
    assert s.min() >= s_min and s.max() <= 2 * L
    below = (L - s_min) / L
    total = below + 2 * np.log(2) - 1
    assert (s < L).mean() == pytest.approx(below / total, abs=0.005)


def test_each_record_follows_from_its_positions(drawn):
    cfg, gn, groups, reads = drawn
    lengths = np.full(gn.sizes.contigs, gn.sizes.contig_bp, np.int64)
    new = clm.relabel(gn, 77)
    c = clm.records(reads, new, lengths)
    assert (c.pair_i < c.pair_j).all()
    L, p0i, p0j = lengths[c.pair_i], c.pi - 1, c.pj - 1
    Lj = lengths[c.pair_j]
    assert np.array_equal(c.d, np.stack([L - p0i + p0j,
                                         L - p0i + Lj - p0j,
                                         p0i + p0j, p0i + Lj - p0j]))
    # the same read pairs as in the genome's labels, relabelled
    inv = np.empty_like(new)
    inv[new] = np.arange(new.size)
    a, b = inv[c.pair_i], inv[c.pair_j]
    swap = a > b
    got = np.stack([np.where(swap, b, a), np.where(swap, a, b),
                    np.where(swap, c.pj, c.pi), np.where(swap, c.pi, c.pj)])
    want = np.stack([reads.a, reads.b, reads.pa, reads.pb])
    assert np.array_equal(got[:, np.lexsort(got[::-1])],
                          want[:, np.lexsort(want[::-1])])


def test_relabel_permutes_inside_each_group():
    gn = gen.make(small(), 1)
    new, other = clm.relabel(gn, 2 ** 31 + 9), clm.relabel(gn, 2 ** 31 + 10)
    gs = gn.group_start
    for g in range(gn.sizes.groups):
        assert sorted(new[gs[g]:gs[g + 1]]) == list(range(gs[g], gs[g + 1]))
    assert not np.array_equal(new, other)
    assert np.array_equal(new, clm.relabel(gn, 2 ** 31 + 9))


def test_ht_links_count_each_half(drawn):
    cfg, gn, groups, reads = drawn
    lengths = np.full(gn.sizes.contigs, gn.sizes.contig_bp, np.int64)
    c = clm.records(reads, np.arange(gn.sizes.contigs), lengths)
    lo, hi = gn.group_start[1], gn.group_start[2]
    ht = clm.ht_links(c, lengths, lo, hi)
    m = (c.pair_i >= lo) & (c.pair_j < hi)
    assert ht.w.sum() == m.sum()
    assert (ht.i < ht.j).all() and (ht.i >= 2 * lo).all() \
        and (ht.j < 2 * hi).all()
    # one record by hand: tail when 2 p > len
    r = np.flatnonzero(m)[0]
    hi_ = 2 * c.pair_i[r] + (2 * c.pi[r] > lengths[0])
    hj_ = 2 * c.pair_j[r] + (2 * c.pj[r] > lengths[0])
    assert ((ht.i == hi_) & (ht.j == hj_)).sum() == 1


def test_tour_score_by_hand():
    """Three contigs of lengths 10, 20, 30; tour 2+ 0- 1+. Records:
    (0, 1) with d = (1, 2, 3, 4): 0 then 1, 0 reversed: combo (-,+) = 2,
    gap 0 -> 3; (0, 2) with d = (5, 6, 7, 8): 2 first, so the tour read
    backwards puts 0 first with 0 as + and 2 as -: combo (+,-) = 1,
    d 6, gap 0 -> 6; (1, 2) with d = (9, 10, 11, 12): 2 first, 1 as -,
    2 as -: combo (-,-) = 3, 12 + gap 10 -> 22."""
    t = torch.tensor
    got = tour_score.score(
        t([2, 0, 1]), t([0, 1, 0]), t([10, 20, 30]), t([0, 0, 1]),
        t([1, 2, 2]), t([[1, 5, 9], [2, 6, 10], [3, 7, 11], [4, 8, 12]]))
    assert float(got) == pytest.approx(1 / 3 + 1 / 6 + 1 / 22, rel=1e-15)
    # weights, and the clamp at 1
    got = tour_score.score(t([0, 1]), t([0, 0]), t([5, 5]), t([0]), t([1]),
                           t([[0], [0], [0], [0]]), w=t([3.0]))
    assert float(got) == 3.0


def test_tour_score_equals_the_programs_plain_scorer():
    """The reference and the port's plain population scorer agree on
    random tours (the test may read the program; the reference does
    not)."""
    from haphic_tpu_torch.kernels.score import score_population_plain
    g = torch.Generator().manual_seed(3)
    k, R, P = 12, 400, 5
    lengths = torch.randint(1000, 5000, (k,), generator=g)
    a = torch.randint(0, k - 1, (R,), generator=g)
    b = a + 1 + (torch.rand(R, generator=g) * (k - 1 - a)).long()
    d = torch.randint(1, 9000, (4, R), generator=g)
    order = torch.stack([torch.randperm(k, generator=g) for _ in range(P)])
    ori = torch.randint(0, 2, (P, k), generator=g)
    plain = score_population_plain(
        order[None].int(), ori[None].int(), lengths[None],
        a[None].int(), b[None].int(), d[None].float(),
        torch.ones(1, R))[0]
    ref = torch.stack([tour_score.score(order[p], ori[p], lengths, a, b, d)
                       for p in range(P)])
    assert torch.allclose(plain.double(), ref, rtol=1e-5)


@pytest.mark.parametrize('name', ['cluster_dense', 'sort_ga'])
def test_stages_are_found_by_name(name):
    assert hasattr(stages.load(name), 'Stage')


def test_an_unknown_stage_is_refused():
    with pytest.raises(ValueError, match='stages/nothing.py'):
        stages.load('nothing')


def test_the_fast_sort_finds_the_drawn_order():
    """The program's fast sort, given a group's order data as the
    pipeline makes it, returns the order the genome was drawn in (read
    either way): it leaves the GA nothing to find, which is why the
    cell starts the GA without it (HapHiC's --skip_fast_sort)."""
    from haphic_tpu_torch.order import fast_sort as fs
    cfg = small(contigs=240, chromosomes=1, haplotypes=4, depth=10.1)
    seed = 2 ** 31 + 21
    gn = gen.make(cfg, seed)
    lengths = np.full(gn.sizes.contigs, gn.sizes.contig_bp, np.int64)
    new = clm.relabel(gn, seed)
    c = clm.records(clm.draw_reads(gn, cfg, range(gn.sizes.groups)), new,
                    lengths)
    gs = gn.group_start
    for g in range(gn.sizes.groups):
        lo, hi = int(gs[g]), int(gs[g + 1])
        gd = fs.make_group_data(np.arange(lo, hi), lengths,
                                clm.ht_links(c, lengths, lo, hi))
        paths = fs.fast_sort(gd, confidence_cutoff=1.0,
                             density_cal_method='multiplication',
                             flanking_region_kbp=0)
        order = [int(gd.ctg_ids[p[0] // 2]) for p in
                 (path[i:i + 2] for path in paths
                  for i in range(0, len(path), 2))]
        truth = new[lo:hi].tolist()
        assert order in (truth, truth[::-1])


@pytest.mark.parametrize('threads', [1, 3])
def test_records_come_ordered_by_pair(drawn, threads):
    """As the port's ingest hands the CLM on: by contig pair, a pair's
    records in the order they were drawn (a plain stable sort), on any
    number of threads."""
    _, gn, _, reads = drawn
    lengths = np.full(gn.sizes.contigs, gn.sizes.contig_bp, np.int64)
    new = clm.relabel(gn, 78)
    c = clm.records(reads, new, lengths, threads=threads)
    a, b = new[reads.a], new[reads.b]
    i, j = np.minimum(a, b), np.maximum(a, b)
    o = np.argsort(i * lengths.size + j, kind='stable')
    assert np.array_equal(c.pair_i, i[o]) and np.array_equal(c.pair_j, j[o])
    pi = np.where(a > b, reads.pb, reads.pa)
    assert np.array_equal(c.pi, pi[o])


def test_the_draw_is_the_same_on_any_number_of_threads(drawn):
    cfg, gn, groups, reads = drawn
    one = clm.draw_reads(gn, cfg, groups, threads=1)
    for k in ('a', 'b', 'pa', 'pb'):
        assert np.array_equal(getattr(one, k), getattr(reads, k))


def test_the_stage_hands_every_group_the_whole_clm():
    """The unit runs the first ``groups`` groups, and each of their
    problems is built from the genome's whole CLM, as the pipeline
    passes it: every group's records and the uniform pairs between
    groups."""
    cfg = small(contigs=160, chromosomes=2, haplotypes=2, depth=2.0)
    cfg['groups'] = 2
    with open(os.path.join(HERE, 'traffic', 'sort_ga.json')) as f:
        mix = json.load(f)
    seed = 2 ** 31 + 23
    gn = gen.make(cfg, seed)
    stage = stages.load('sort_ga').Stage(cfg, mix, gn, 'cpu', seed)
    assert stage.sizes['sort_groups'] == 2
    assert stage.sizes['clm_records'] == int(gn.w.sum()) == \
        stage.clm.pair_i.size
    assert int(gn.w.sum()) > sum(stage.sizes['records'])


def test_group_rows_are_the_groups_records(drawn):
    _, gn, groups, reads = drawn
    lengths = np.full(gn.sizes.contigs, gn.sizes.contig_bp, np.int64)
    c = clm.records(reads, clm.relabel(gn, 79), lengths)
    gs = gn.group_start
    for g in groups:
        lo, hi = int(gs[g]), int(gs[g + 1])
        want = np.flatnonzero((c.pair_i >= lo) & (c.pair_j < hi))
        assert want.size and np.array_equal(clm.group_rows(c, lo, hi), want)

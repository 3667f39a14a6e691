"""The sizes that follow from the configuration, and the genome's links
as the cell hands them to the program."""

import json
import os

import numpy as np
import pytest

from hicbench import genome as gen

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, 'configs', name + '.json')) as f:
        return json.load(f)


def test_derived_sizes():
    s = gen.derive(config('xtropicalis'))
    assert (s.fragments, s.groups, s.contig_bp) == (7705, 10, 153670)
    assert s.bin_bp == 2_000_000 and s.contig_bp < s.bin_bp
    # 47.5x of 1.48 Gb in pairs of 150 bp reads; 2% uniform
    assert s.pairs == 234_333_333 and s.trans_pairs == 4_686_667


def small(contigs=240, chromosomes=4):
    cfg = config('xtropicalis')
    cfg['published'] = dict(cfg['published'], contigs=contigs,
                            genome_bp=contigs * 150_000,
                            chromosomes=chromosomes)
    return cfg


@pytest.mark.parametrize('k,L,s_min', [(963, 153_670, 1000),
                                       (7, 150_000, 5000)])
def test_cis_law_holds_the_chromosome_pairs(k, L, s_min):
    """The expectations over every contig pair, and the pairs inside
    each contig, add up to the chromosome's pairs."""
    C, cis = k * L, 1e6
    d = np.arange(1, k)
    between = (gen.cis_expected(d, L, C, cis, s_min) * (k - d)).sum()
    kappa = cis / (C * np.log(C / s_min) - C + s_min)
    inside = k * kappa * (L * np.log(L / s_min) - L + s_min)
    assert between + inside == pytest.approx(cis, rel=1e-9)


def test_cis_law_decays_as_one_over_distance():
    lam = gen.cis_expected(np.array([1, 2, 100, 200]), 150_000,
                           150_000 * 900, 1e7, 1000)
    assert lam[0] > lam[1] > lam[2] > lam[3] > 0
    # far from the diagonal the count halves as the distance doubles
    assert lam[2] / lam[3] == pytest.approx(2.0, rel=1e-3)


def test_the_seed_orders_the_same_genome():
    cfg = small()
    a, b = gen.make(cfg, 2 ** 31 + 5), gen.make(cfg, 2 ** 31 + 5)
    c = gen.make(cfg, 2 ** 31 + 6)
    assert all(np.array_equal(getattr(a, k), getattr(c, k))
               for k in ('i', 'j', 'w'))
    la, lb, lc = (gen.fragment_links(x, 80) for x in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la[:3], lb[:3]))
    assert not np.array_equal(la[0], lc[0])
    # the same graph: the same link weights, another labelling
    assert np.array_equal(np.sort(la[2]), np.sort(lc[2]))


def test_links_follow_the_library():
    cfg = small()
    gn = gen.make(cfg, 7)
    s = gn.sizes
    assert (gn.i < gn.j).all() and gn.j.max() < s.contigs
    assert np.unique(gn.i * s.contigs + gn.j).size == gn.i.size
    group = np.searchsorted(gn.group_start, np.arange(s.contigs),
                            side='right') - 1
    trans = group[gn.i] != group[gn.j]
    # uniform pairs between two chromosomes: (1 - 1/groups) of them
    want = s.trans_pairs * (1 - 1 / s.groups)
    assert gn.w[trans].sum() == pytest.approx(want, rel=0.02)
    # every pair of contigs on one chromosome is linked at this depth
    per = s.contigs // s.groups
    assert (~trans).sum() == s.groups * per * (per - 1) // 2


def test_fragment_links_are_the_kept_upper_triangle():
    gn = gen.make(small(), 9)
    ci, cj, cw, m = gen.fragment_links(gn, 80)
    assert m == int(gen.nx_mask(gn.sizes.contigs, 80).sum()) == 192
    assert (ci < cj).all() and cj.max() < m
    assert np.unique(ci * m + cj).size == ci.size
    assert cw.dtype == np.float64 and cw.min() >= 1


def test_alfalfa_sizes():
    """The published alfalfa: 32 groups (8 chromosomes x 4 haplotypes)
    of 992-993 contigs of 99,458 bp, 2 Mb bins, 10.1x in 150 bp pairs;
    Nx 80 keeps 25,418 fragments."""
    s = gen.derive(config('alfalfa_4x'))
    assert (s.contigs, s.groups, s.contig_bp, s.bin_bp) == \
        (31772, 32, 99458, 2_000_000)
    assert s.pairs == 106_386_667 and s.trans_pairs == 2_127_733
    assert s.fragments == 25418


def test_alfalfa_records_a_group():
    """A group of 993 contigs holds about 2.14M CLM records (its cis
    pairs between two contigs, and some 2,000 uniform pairs), over
    about 332k of its 492,528 contig pairs."""
    s = gen.derive(config('alfalfa_4x'))
    k, L = 993, s.contig_bp
    d = np.arange(1, k)
    lam = gen.cis_expected(d, L, k * L, (s.pairs - s.trans_pairs) * k
                           / s.contigs, 1000)
    cis = (lam * (k - d)).sum()
    trans = s.trans_pairs * (k / s.contigs) ** 2
    assert cis + trans == pytest.approx(2.14e6, rel=0.005)
    linked = ((k - d) * (1 - np.exp(-lam))).sum()
    assert linked == pytest.approx(332_000, rel=0.005)
    assert k * (k - 1) // 2 == 492_528


# ---- contigs of unequal lengths ----

def test_tea_sizes():
    """The published Tieguanyin under its length law: N50 0.22 Mb on
    60,345 contigs of mean 99,263 bp, 79 of them over the 2 Mb bin; Nx
    80 keeps 20,443 of 60,440 fragments, past the sparse engine's
    20,000."""
    cfg = config('tieguanyin_2x')
    pub = cfg['published']
    law, sigma = gen.lengths(pub['contigs'], pub['genome_bp'],
                             pub['contig_n50_bp'])
    assert law.sum() == pub['genome_bp'] and law.min() >= 1
    assert abs(gen._n50(law) - 220_000) < 100
    assert sigma == pytest.approx(1.262, abs=1e-3)
    off, flen = gen.bins(law, 2_000_000)
    assert (flen.size, int((law > 2_000_000).sum())) == (60440, 79)
    assert int(gen.nx_keep(flen, 80).sum()) == 20443


def test_alfalfa_under_its_length_law_takes_the_dense_engine():
    """The alfalfa's published N50 (0.46 Mb, 4.6 times its mean) under
    the same law: Nx 80 keeps 6,027 fragments, under 20,000."""
    pub = config('alfalfa_4x')['published']
    law, _ = gen.lengths(pub['contigs'], pub['genome_bp'],
                         pub['contig_n50_bp'])
    off, flen = gen.bins(law, 2_000_000)
    assert int(gen.nx_keep(flen, 80).sum()) == 6027


def test_bins_and_nx_are_the_ports():
    """The copies of build_fragments' bins and Nx cut give the port's
    own fragments on contigs of unequal lengths."""
    from haphic_tpu_torch.core.fragments import build_fragments
    from haphic_tpu_torch.io.fasta import Assembly
    law, _ = gen.lengths(40, 40 * 150_000, 400_000)
    law = law[np.random.default_rng(3).permutation(40)]
    names = ['c{:02d}'.format(k) for k in range(40)]
    asm = Assembly(names=names, name2id={c: k for k, c in enumerate(names)},
                   lengths=law, re_sites=np.ones(40, np.int64),
                   seqs=['A' * int(x) for x in law],
                   input_order={c: k for k, c in enumerate(names)})
    got = build_fragments(asm, nchrs=4, Nx=80, bin_size_kbp=300)
    off, flen = gen.bins(law, 300_000)
    assert np.array_equal(got.frag_offset, off)
    assert np.array_equal(got.frag_len, flen)
    assert np.array_equal(got.nx_mask, gen.nx_keep(flen, 80))


@pytest.mark.parametrize('x0,x1,y0,y1', [(0, 5e4, 5e4, 9e4),
                                         (0, 800, 800, 5e3),
                                         (1e4, 2e4, 3e5, 3.5e5)])
def test_pair_integral_is_the_law_over_two_regions(x0, x1, y0, y1):
    """The closed form against a midpoint sum of 1 / (y - x) over the
    two regions where y - x >= s."""
    s, k = 1000.0, 2000
    x = x0 + (np.arange(k) + 0.5) * (x1 - x0) / k
    y = y0 + (np.arange(k) + 0.5) * (y1 - y0) / k
    d = y[None, :] - x[:, None]
    want = np.where(d >= s, 1 / np.maximum(d, s), 0).sum() * \
        (x1 - x0) * (y1 - y0) / k ** 2
    got = gen.pair_integral(np.float64(x0), np.float64(x1),
                            np.float64(y0), np.float64(y1), s)
    assert got == pytest.approx(want, rel=2e-3)


def test_layout_links_lie_between_kept_flanks():
    cfg = config('tieguanyin_2x')
    cfg['published'] = dict(cfg['published'], contigs=240,
                            genome_bp=240 * 150_000, contig_n50_bp=300_000,
                            chromosomes=4, haplotypes=1, hic_depth_x=1.0)
    a, b = gen.make(cfg, 5), gen.make(cfg, 6)
    assert isinstance(a, gen.Layout)
    assert all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ('i', 'j', 'w', 'contig_len'))
    assert (a.i < a.j).all() and a.keep[a.i].all() and a.keep[a.j].all()
    assert a.w.min() >= 1 and a.sizes.split_contigs > 0

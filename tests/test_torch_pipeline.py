"""End-to-end parity of the port's pipeline (haphic_tpu_torch) with the
JAX package's, on the CPU, on the simulated genome of
tests/test_pipeline.py."""

import os
import random

import pytest
import torch

from haphic_tpu.cluster import mcl as jmcl
from haphic_tpu.pipeline import PipelineConfig, run_pipeline

from haphic_tpu_torch import convert
from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.cluster import mcl as tmcl
from haphic_tpu_torch.pipeline import run_pipeline as trun_pipeline

from . import util

# xdist runs several test files at once on the same cores; torch's
# default of one intra-op thread per core then oversubscribes them and
# the many small ops of the GA and MCL loops wait on each other.
torch.set_num_threads(1)

STAGES = ('01.cluster', '02.reassign', '03.sort', '04.build')


@pytest.fixture(scope='module')
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tpipe')
    ctgs, recs, chrom_of = util.clustered_genome_and_pairs(
        random.Random(13), nchrs=3, ctgs_per_chr=5, ctg_len=8000,
        n_pairs=30000)
    fa, pr = tmp / 'asm.fa', tmp / 'hic.pairs'
    util.write_genome(str(fa), ctgs)
    util.write_pairs(str(pr), recs)
    return tmp, str(fa), str(pr), chrom_of


def _config(**kw):
    cfg = PipelineConfig(Nx=100, RE_site_cutoff=0, density_lower='0',
                         density_upper='1', rank_sum_upper='1', ngen=200,
                         npop=16, flank=0, **kw)
    cfg.reassign.min_group_len = 0
    cfg.reassign.min_RE_sites = 0
    cfg.reassign.min_links = 1
    return cfg


def _run_both(sim, name, cfg=None, nchrs=3, **kw):
    tmp, fa, pairs = sim[:3]
    jout, tout = tmp / (name + '_jax'), tmp / (name + '_torch')
    cfg = cfg or _config(**kw)
    tcfg = convert.config_from_jax(cfg, device='cpu')
    jres = run_pipeline(fa, pairs, nchrs=nchrs, cfg=cfg, outdir=str(jout))
    tres = trun_pipeline(fa, pairs, nchrs=nchrs, cfg=tcfg, outdir=str(tout))
    return (jout, jres), (tout, tres)


def _tree(root, sub):
    base = root / sub
    files, links = {}, {}
    for dirpath, dirnames, filenames in os.walk(base):
        for n in dirnames + filenames:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                links[rel] = os.readlink(p)
            elif os.path.isfile(p):
                files[rel] = p
    return files, links


def _agp_partition(path):
    scaffolds = {}
    with open(path) as f:
        for line in f:
            cols = line.rstrip('\n').split('\t')
            if len(cols) >= 9 and cols[4] == 'W':
                scaffolds.setdefault(cols[0], set()).add(cols[5])
    return {frozenset(v) for v in scaffolds.values()}


def _ga_scores(sort_dir):
    out = {}
    for n in sorted(os.listdir(sort_dir)):
        if n.endswith('.tour'):
            with open(os.path.join(sort_dir, n)) as f:
                ga = [l for l in f if l.startswith('>GA')]
            if ga:
                out[n] = float(ga[-1].strip().rsplit('-', 1)[1])
    return out


def _assert_trees_equal(jout, tout, stages=STAGES):
    """Every regular file of ``stages`` byte-equal and every symlink
    with the same target; returns the number of files."""
    n = 0
    for sub in stages:
        jf, jl = _tree(jout, sub)
        tf, tl = _tree(tout, sub)
        assert sorted(tf) == sorted(jf), sub
        assert tl == jl, sub
        for rel, p in jf.items():
            with open(p, 'rb') as a, open(tf[rel], 'rb') as b:
                assert a.read() == b.read(), rel
        n += len(jf)
    return n


def test_pipeline_artifacts_byte_equal(sim):
    """Default routing at this size (host MCL below DEVICE_MIN_N, native
    GA below NATIVE_MAX_WORK): every regular file of 01.cluster ...
    04.build is byte-equal and every symlink has the same target."""
    (jout, jres), (tout, tres) = _run_both(sim, 'default')
    assert _assert_trees_equal(jout, tout) > 20
    assert tres.cluster.sweep.recommended_inflation == \
        jres.cluster.sweep.recommended_inflation
    assert set(tres.stage_secs) == {'cluster', 'reassign', 'sort', 'build'}


def test_pipeline_device_paths_match_quality(sim, monkeypatch):
    """The device paths forced on both sides (MCL from n=0, device GA):
    cluster files byte-equal, the same scaffold partition, and each
    group's GA score at least 0.99 of the JAX package's."""
    monkeypatch.setattr(jmcl, 'DEVICE_MIN_N', 0)
    monkeypatch.setattr(tmcl, 'DEVICE_MIN_N', 0)
    (jout, _), (tout, _) = _run_both(sim, 'device', ga_backend='device')
    jf, _ = _tree(jout, '01.cluster')
    tf, _ = _tree(tout, '01.cluster')
    assert sorted(tf) == sorted(jf)
    for rel, p in jf.items():
        with open(p, 'rb') as a, open(tf[rel], 'rb') as b:
            assert a.read() == b.read(), rel
    agp = os.path.join('04.build', 'scaffolds.agp')
    assert _agp_partition(tout / agp) == _agp_partition(jout / agp)
    jscore = _ga_scores(jout / '03.sort')
    tscore = _ga_scores(tout / '03.sort')
    assert sorted(tscore) == sorted(jscore) and len(jscore) == 3
    for g, s in jscore.items():
        assert tscore[g] >= 0.99 * s, (g, tscore[g], s)


def test_cli_entry_point_matches_run_pipeline(sim):
    """`python -m haphic_tpu_torch pipeline ... --device cpu` writes the
    same scaffolds as the JAX package's run_pipeline."""
    tmp, fa, pairs, chrom_of = sim
    jout = tmp / 'cli_jax'
    run_pipeline(fa, pairs, nchrs=3, cfg=_config(), outdir=str(jout))
    tout = tmp / 'cli_torch'
    rc = tmain(['pipeline', fa, pairs, '3', '--outdir', str(tout),
                '--device', 'cpu', '--Nx', '100', '--RE_site_cutoff', '0',
                '--density_lower', '0', '--density_upper', '1',
                '--rank_sum_upper', '1', '--flank', '0',
                '--min_group_len', '0', '--min_RE_sites', '0',
                '--min_links', '1', '--ngen', '200', '--npop', '16'])
    assert rc == 0
    for n in ('scaffolds.agp', 'scaffolds.raw.agp', 'scaffolds.fa'):
        assert (tout / '04.build' / n).read_bytes() == \
            (jout / '04.build' / n).read_bytes(), n
    expected = {}
    for name, c in chrom_of.items():
        expected.setdefault(c, set()).add(name)
    assert _agp_partition(tout / '04.build' / 'scaffolds.agp') == \
        {frozenset(v) for v in expected.values()}


@pytest.fixture(scope='module')
def sort_src(sim):
    tmp, fa, pairs, _ = sim
    src = tmp / 'sort_src'
    run_pipeline(fa, pairs, nchrs=3, cfg=_config(), outdir=str(src))
    return src


@pytest.mark.parametrize('flags', [[], ['--skipGA']], ids=['ga', 'skip-ga'])
def test_cli_sort_matches_jax_sort(sim, sort_src, flags):
    """The `sort` command alone, on the JAX package's 01.cluster and
    02.reassign artifacts: the port writes the same fast sort, GA and
    final tours as the JAX package's `sort`. The GA starts from the fast
    sort tour; with --skipGA its result is that hot start itself."""
    import glob

    from haphic_tpu.cli import main as jmain
    tmp, fa, _, _ = sim
    src = sort_src
    name = 'sort_{}'.format(len(flags))
    groups = sorted(glob.glob(str(src / '02.reassign' / 'final_groups' /
                                  'group*.txt')))
    assert groups
    args = [fa, str(src / '01.cluster' / 'HT_links.pkl'),
            str(src / '02.reassign' / 'split_clms'), *groups,
            '--ngen', '200', '--npop', '16', *flags]
    jout, tout = tmp / (name + '_jax'), tmp / (name + '_torch')
    assert jmain(['sort', *args, '--outdir', str(jout)]) == 0
    assert tmain(['sort', *args, '--outdir', str(tout),
                  '--device', 'cpu']) == 0
    jf, _ = _tree(tmp, name + '_jax')
    tf, _ = _tree(tmp, name + '_torch')
    jf = {os.path.relpath(p, jout): p for p in jf.values()}
    tf = {os.path.relpath(p, tout): p for p in tf.values()}
    assert sorted(tf) == sorted(jf)
    assert any(n.endswith('.tour.sav') for n in jf)
    for rel, p in jf.items():
        with open(p, 'rb') as a, open(tf[rel], 'rb') as b:
            assert a.read() == b.read(), rel


# ---- the flag-gated cluster steps: one case per flag, each byte-equal

@pytest.fixture(scope='module')
def flag_sim(tmp_path_factory):
    """A make_sim-style genome of two homologous pairs of chromosomes
    (chr1/chr2, chr3/chr4, 5 contigs x 30 kb each): contig I of a pair
    shares 40 Hi-C pairs at concordant positions with its allele, and
    600 pairs between chr1_ctg2 and chr1_ctg3 pile into 200 bp of
    chr1_ctg2. Beside it two GFAs (chr1 + chr3, chr2 + chr4) with read
    depths, one contig collapsed, and a UL BAM spanning the junctions
    chr1_ctg1-2, chr1_ctg2-3 and chr3_ctg4-5."""
    from . import bamutil
    tmp = tmp_path_factory.mktemp('tflags')
    rng = random.Random(21)
    ctgs, recs, chrom_of = util.clustered_genome_and_pairs(
        rng, nchrs=4, ctgs_per_chr=5, ctg_len=30000, n_pairs=40000)
    for a, b in (('chr1', 'chr2'), ('chr3', 'chr4')):
        for i in range(1, 6):
            for k in range(40):
                x = rng.randrange(1, 29900)
                recs.append(('al_{}{}_{}_{}'.format(a, b, i, k),
                             '{}_ctg{}'.format(a, i), x,
                             '{}_ctg{}'.format(b, i),
                             x + rng.randrange(0, 100)))
    for k in range(600):
        recs.append(('pile{}'.format(k), 'chr1_ctg2',
                     5000 + rng.randrange(0, 200), 'chr1_ctg3',
                     rng.randrange(1, 30001)))
    rng.shuffle(recs)
    fa, pr = tmp / 'asm.fa', tmp / 'hic.pairs'
    util.write_genome(str(fa), ctgs)
    util.write_pairs(str(pr), recs)
    for h, chroms in enumerate((('chr1', 'chr3'), ('chr2', 'chr4'))):
        with open(tmp / 'hap{}.gfa'.format(h), 'w') as f:
            for name in ctgs:
                if name.split('_')[0] in chroms:
                    depth = 90 if name == 'chr3_ctg2' else \
                        rng.randrange(20, 40)
                    f.write('S\t{}\t*\tLN:i:30000\trd:i:{}\n'.format(
                        name, depth))
    names = list(ctgs)
    ul = []
    for r, (a, b) in enumerate([('chr1_ctg1', 'chr1_ctg2'),
                                ('chr1_ctg2', 'chr1_ctg3'),
                                ('chr3_ctg4', 'chr3_ctg5')] * 3):
        name = 'ul{}'.format(r).encode()
        ul.append(bamutil.bam_record(
            names.index(a), 27000, -1, -1, 0, mapq=60, name=name,
            cigar=[('M', 3000), ('S', 3000)], tags=[(b'AS', 900)]))
        ul.append(bamutil.bam_record(
            names.index(b), 0, -1, -1, 0x800, mapq=60, name=name,
            cigar=[('S', 3000), ('M', 3000)], tags=[(b'AS', 800)]))
    bamutil.write_bam(str(tmp / 'ul.bam'), names, [30000] * len(names), ul)
    return tmp, str(fa), str(pr), chrom_of


@pytest.fixture(scope='module')
def chimera_sim(tmp_path_factory):
    """The 3-chromosome genome of ``sim`` with chr1_ctg3 and chr2_ctg3
    joined into one chimeric contig: pairs drawn on the two contigs,
    then their coordinates shifted into the chimera."""
    tmp = tmp_path_factory.mktemp('tchimera')
    ctgs, recs, chrom_of = util.clustered_genome_and_pairs(
        random.Random(13), nchrs=3, ctgs_per_chr=5, ctg_len=8000,
        n_pairs=30000)
    a, b = 'chr1_ctg3', 'chr2_ctg3'
    ctgs['chim'] = ctgs.pop(a) + ctgs.pop(b)
    shift = {a: 0, b: 8000}

    def moved(name, pos):
        return ('chim', pos + shift[name]) if name in shift else (name, pos)

    recs = [(r, *moved(x, p), *moved(y, q)) for r, x, p, y, q in recs]
    fa, pr = tmp / 'asm.fa', tmp / 'hic.pairs'
    util.write_genome(str(fa), ctgs)
    util.write_pairs(str(pr), recs)
    return tmp, str(fa), str(pr), chrom_of


FLAG_CASES = {
    'remove_allelic_links': ('flag_sim', dict(remove_allelic_links=2)),
    'remove_concentrated_links': ('flag_sim', dict(
        remove_concentrated_links=True, concentration_ratio=2.0)),
    'gfa': ('flag_sim', dict(gfa='hap0.gfa,hap1.gfa')),
    'ul': ('flag_sim', dict(ul='ul.bam', min_ul_alignment_length=2000)),
    'correct_nrounds': ('chimera_sim', dict(correct_nrounds=2,
                                            correct_resolution=200)),
}


def _in_dir(tmp, kw):
    """File arguments of ``kw`` (comma lists included) under ``tmp``."""
    out = dict(kw)
    for k in ('gfa', 'ul'):
        if k in out:
            out[k] = ','.join(str(tmp / p) for p in out[k].split(','))
    return out


@pytest.mark.parametrize('flag', sorted(FLAG_CASES))
def test_flag_artifacts_byte_equal(request, flag, caplog):
    """Each flag of the cluster stage alone: 01.cluster ... 04.build
    byte-equal to the JAX package's, and the step did something."""
    import logging
    import pickle
    fixture, kw = FLAG_CASES[flag]
    sim = request.getfixturevalue(fixture)
    nchrs = 4 if fixture == 'flag_sim' else 3
    with caplog.at_level(logging.INFO, logger='haphic_tpu_torch'):
        (jout, _), (tout, _) = _run_both(sim, flag, nchrs=nchrs,
                                         **_in_dir(sim[0], kw))
    assert _assert_trees_equal(jout, tout) > 20
    metrics = [r.metrics for r in caplog.records
               if hasattr(r, 'metrics')]
    cluster = tout / '01.cluster'
    if flag == 'remove_allelic_links':
        allelic = [m['allelic'] for m in metrics if 'allelic' in m]
        assert allelic[0]['n_allelic_pairs'] >= 10
    elif flag == 'remove_concentrated_links':
        with open(cluster / 'full_links.pkl', 'rb') as f:
            w = pickle.load(f).values()
        assert any(not float(v).is_integer() for v in w)
    elif flag == 'correct_nrounds':
        broken = (cluster / 'corrected_ctgs.txt').read_text().split()
        assert [c.split(':')[0] for c in broken] == ['chim', 'chim']
    elif flag == 'ul':
        assert 'chr1_ctg2' in (tout / '04.build' /
                               'scaffolds.agp').read_text()


@pytest.mark.parametrize('kw', [{}, {'remove_allelic_links': 2},
                                {'gfa': 'hap0.gfa,hap1.gfa'}],
                         ids=['plain', 'remove_allelic_links', 'per_hap'])
def test_quick_view_byte_equal(flag_sim, kw):
    """--quick_view, alone, with a pruning flag (which quick view
    ignores) and with two GFAs (one mock group per haplotype): every
    stage byte-equal to the JAX package's."""
    tmp = flag_sim[0]
    cfg = PipelineConfig(quick_view=True, **_in_dir(tmp, kw))
    name = 'qv_' + '_'.join(kw) if kw else 'qv'
    (jout, jres), (tout, tres) = _run_both(flag_sim, name, cfg=cfg,
                                           nchrs=4)
    _assert_trees_equal(jout, tout)
    assert tres.cluster.sweep is None
    groups = (tout / '02.reassign' / 'final_groups' /
              'final_clusters.txt').read_text().splitlines()[1:]
    assert len(groups) == (2 if 'gfa' in kw else 1)


@pytest.mark.parametrize('command', ['pipeline', 'cluster'])
def test_cli_carries_the_cluster_flags(flag_sim, command):
    """`python -m haphic_tpu_torch pipeline|cluster --device cpu` with
    four of the flags at once (--gfa, --remove_allelic_links,
    --remove_concentrated_links, --ul) writes what the JAX package's
    command writes."""
    from haphic_tpu.cli import main as jmain
    tmp, fa, pairs, _ = flag_sim
    flags = ['--gfa', '{0}/hap0.gfa,{0}/hap1.gfa'.format(tmp),
             '--remove_allelic_links', '2', '--remove_concentrated_links',
             '--ul', str(tmp / 'ul.bam'), '--min_ul_alignment_length',
             '2000', '--Nx', '100', '--RE_site_cutoff', '0',
             '--density_lower', '0', '--density_upper', '1',
             '--rank_sum_upper', '1', '--flank', '0']
    if command == 'pipeline':
        flags += ['--min_group_len', '0', '--min_RE_sites', '0',
                  '--min_links', '1', '--ngen', '200', '--npop', '16']
    name = 'cli_flags_' + command
    jout, tout = tmp / (name + '_jax'), tmp / (name + '_torch')
    stages = STAGES if command == 'pipeline' else STAGES[:1]
    sub = '' if command == 'pipeline' else STAGES[0]
    assert jmain([command, fa, pairs, '4', '--outdir', str(jout / sub)]
                 + flags) == 0
    assert tmain([command, fa, pairs, '4', '--outdir', str(tout / sub),
                  '--device', 'cpu'] + flags) == 0
    assert _assert_trees_equal(jout, tout, stages) > 10


def test_gfa_with_correction_fails_as_haphic_tpu(chimera_sim):
    """--gfa with --correct_nrounds: both packages build the read depths
    over the contigs before correction and index them by the corrected
    ones, so the depth filter runs past the array (a fault of both,
    ROADMAP.md section 3). The port keeps haphic_tpu's behaviour."""
    tmp = chimera_sim[0]
    with open(tmp / 'all.gfa', 'w') as f:
        for line in open(chimera_sim[1]):
            if line.startswith('>'):
                f.write('S\t{}\t*\tLN:i:{}\trd:i:30\n'.format(
                    line[1:].strip(),
                    16000 if line.startswith('>chim') else 8000))
    cfg = _config(correct_nrounds=2, correct_resolution=200,
                  gfa=str(tmp / 'all.gfa'))
    with pytest.raises(IndexError) as want:
        run_pipeline(*chimera_sim[1:3], nchrs=3, cfg=cfg,
                     outdir=str(tmp / 'gfa_corr_jax'))
    with pytest.raises(IndexError) as got:
        trun_pipeline(*chimera_sim[1:3], nchrs=3,
                      cfg=convert.config_from_jax(cfg, device='cpu'),
                      outdir=str(tmp / 'gfa_corr_torch'))
    assert str(got.value) == str(want.value)

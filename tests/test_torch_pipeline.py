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


def _run_both(sim, name, **kw):
    tmp, fa, pairs, _ = sim
    jout, tout = tmp / (name + '_jax'), tmp / (name + '_torch')
    cfg = _config(**kw)
    tcfg = convert.config_from_jax(cfg, device='cpu')
    jres = run_pipeline(fa, pairs, nchrs=3, cfg=cfg, outdir=str(jout))
    tres = trun_pipeline(fa, pairs, nchrs=3, cfg=tcfg, outdir=str(tout))
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


def test_pipeline_artifacts_byte_equal(sim):
    """Default routing at this size (host MCL below DEVICE_MIN_N, native
    GA below NATIVE_MAX_WORK): every regular file of 01.cluster ...
    04.build is byte-equal and every symlink has the same target."""
    (jout, jres), (tout, tres) = _run_both(sim, 'default')
    n = 0
    for sub in STAGES:
        jf, jl = _tree(jout, sub)
        tf, tl = _tree(tout, sub)
        assert sorted(tf) == sorted(jf), sub
        assert tl == jl, sub
        for rel, p in jf.items():
            with open(p, 'rb') as a, open(tf[rel], 'rb') as b:
                assert a.read() == b.read(), rel
        n += len(jf)
    assert n > 20
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

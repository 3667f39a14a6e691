"""The port's `allhic` command against the JAX package's, on the CPU:
tests/test_cli.py::test_allhic_command through both CLIs with
byte-equal tour files on the native GA route, `--resume --skipGA`
byte-equal, and the device GA forced on both sides on a group of the
tests/make_sim.py genome, where both reach the true chain (their random
streams differ, so the tours are compared by quality, not bytes)."""

import os
import random

import numpy as np
import pytest
import torch

from haphic_tpu.cli import main as jmain
from haphic_tpu.order import optimize as jopt

from haphic_tpu_torch.cli import main as tmain
from haphic_tpu_torch.io.artifacts import parse_clm_file, parse_group_file
from haphic_tpu_torch.order import optimize as topt

from . import util
from .test_cli import _write_toy_clm
from .test_optimize import _brute_score

torch.set_num_threads(1)

MAINS = ((jmain, 'jax', []), (tmain, 'torch', ['--device', 'cpu']))


def _toy_group(d):
    """test_allhic_command's group: 4 contigs listed out of order, with
    read pairs between neighbours of the chain A-B-C-D."""
    names = ['ctgA', 'ctgB', 'ctgC', 'ctgD']
    lengths = [30000, 40000, 25000, 35000]
    group = d / 'group1.txt'
    with open(group, 'w') as f:
        f.write('#Contig\tRECounts\tLength\n')
        for i in (2, 0, 3, 1):
            f.write('{}\t{}\t{}\n'.format(names[i], 10, lengths[i]))
    clm = d / 'group1.clm'
    _write_toy_clm(str(clm), names, lengths, random.Random(7))
    return str(group), str(clm), names


def _run(main, cwd, monkeypatch, argv):
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    assert main(argv) == 0
    return {f: (cwd / f).read_bytes() for f in sorted(os.listdir(cwd))}


def _final_tour(text):
    return [t for t in text.decode().splitlines() if t.strip()][-1].split()


@pytest.mark.skipif(topt.native_lib() is None or jopt.native_lib() is None,
                    reason='native GA kernel unavailable')
@pytest.mark.parametrize('args', [
    ['--ngen', '600', '--npop', '32', '--seed', '42'],
    ['--ngen', '300', '--npop', '16', '--seed', '7', '--mutapb', '0.4'],
], ids=['test_cli', 'other-flags'])
def test_allhic_native_byte_equal(tmp_path, monkeypatch, args):
    """The native route (work below NATIVE_MAX_WORK) in both packages:
    the same tour file, byte for byte; then --resume --skipGA on it:
    the same rescored tour and the same .tour.sav."""
    group, clm, names = _toy_group(tmp_path)
    trees = []
    for main, name, dev in MAINS:
        first = _run(main, tmp_path / name, monkeypatch,
                     ['allhic', group, clm] + args + dev)
        resumed = _run(main, tmp_path / name, monkeypatch,
                       ['allhic', group, clm, '--resume', '--skipGA',
                        '--seed', '1'] + dev)
        trees.append((first, resumed))
    assert trees[1] == trees[0]
    first, resumed = trees[1]
    assert list(first) == ['group1.tour']
    assert list(resumed) == ['group1.tour', 'group1.tour.sav']
    tour = [t[:-1] for t in _final_tour(first['group1.tour'])]
    assert tour == names or tour == names[::-1]
    assert resumed['group1.tour.sav'] == first['group1.tour']
    assert _final_tour(resumed['group1.tour']) == \
        _final_tour(first['group1.tour'])


def test_allhic_skip_ga_without_resume_byte_equal(tmp_path, monkeypatch):
    """--skipGA with no tour to resume: the best tour of the starting
    population, scored."""
    group, clm, _ = _toy_group(tmp_path)
    trees = [_run(main, tmp_path / name, monkeypatch,
                  ['allhic', group, clm, '--skipGA'] + dev)
             for main, name, dev in MAINS]
    assert trees[1] == trees[0]
    assert sorted(t[:-1] for t in _final_tour(trees[1]['group1.tour'])) \
        == ['ctgA', 'ctgB', 'ctgC', 'ctgD']


@pytest.fixture(scope='module')
def sim_group(tmp_path_factory):
    """A group of the tests/make_sim.py genome (3 chromosomes x 5
    contigs), its group file and split CLM as the port's pipeline writes
    them (cluster and reassign stages)."""
    tmp = tmp_path_factory.mktemp('allhic_sim')
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(12345), nchrs=3, ctgs_per_chr=5, ctg_len=8000,
        n_pairs=8000 * 3 * 5 // 5)
    util.write_genome(str(tmp / 'asm.fa'), ctgs)
    util.write_pairs(str(tmp / 'hic.pairs'), recs)
    out = tmp / 'out'
    assert tmain(['pipeline', str(tmp / 'asm.fa'), str(tmp / 'hic.pairs'),
                  '3', '--outdir', str(out), '--steps', '12', '--Nx', '100',
                  '--RE_site_cutoff', '0', '--density_lower', '0',
                  '--density_upper', '1', '--rank_sum_upper', '1',
                  '--flank', '0', '--min_group_len', '0',
                  '--min_RE_sites', '0', '--min_links', '1',
                  '--device', 'cpu']) == 0
    groups = sorted(os.listdir(out / '02.reassign' / 'final_groups'))
    group = [g for g in groups if g.startswith('group1_')][0]
    return (str(out / '02.reassign' / 'final_groups' / group),
            str(out / '02.reassign' / 'split_clms' /
                (os.path.splitext(group)[0] + '.clm')))


def _truth_problem(group, clm):
    """The group's problem as cmd_allhic builds it, and the true tour:
    the chromosome's contigs in order, all forward."""
    ctgs = parse_group_file(group)
    names = [c for c, _, __ in ctgs]
    name2id = {c: i for i, c in enumerate(names)}
    lengths = np.asarray([l for _, __, l in ctgs], np.int64)
    data = parse_clm_file(clm, name2id)
    problem = topt.build_problem(np.arange(len(names)), lengths,
                                 data.pair_i, data.pair_j, data.d)
    truth = sorted(names, key=lambda c: int(c.split('ctg')[1]))
    return problem, names, truth


def test_allhic_device_ga_matches_quality(sim_group, tmp_path, monkeypatch):
    """NATIVE_MAX_WORK set to 0 in both packages: each runs its device
    GA (JAX, and torch on the CPU). Both recover the chromosome's chain
    (its order: the simulated pairs lie uniformly inside each contig, so
    they carry no orientation), their >GA scores never fall, both reach
    0.95 of the true tour's score, as tests/test_torch_optimize.py::
    test_device_batched_groups_match_quality holds them, and their final
    scores lie within 5% of each other."""
    group, clm = sim_group
    monkeypatch.setattr(jopt, 'NATIVE_MAX_WORK', 0.0)
    monkeypatch.setattr(topt, 'NATIVE_MAX_WORK', 0.0)

    def no_native(*args, **kw):
        raise AssertionError('the native GA ran')
    monkeypatch.setattr(jopt, '_optimize_native', no_native)
    monkeypatch.setattr(topt, '_optimize_native', no_native)
    problem, names, truth = _truth_problem(group, clm)
    assert len(names) == 5 and problem.n_records > 0
    idx = {c: i for i, c in enumerate(names)}
    true_score = _brute_score(problem, np.asarray([idx[c] for c in truth]),
                              np.zeros(len(truth), np.int64))
    final_scores = []
    for main, name, dev in MAINS:
        tour = _run(main, tmp_path / name, monkeypatch,
                    ['allhic', group, clm, '--ngen', '600', '--npop', '32',
                     '--seed', '1'] + dev)
        text = list(tour.values())[0].decode().splitlines()
        ga = [l for l in text if l.startswith('>GA')]
        assert [l.split('-')[0] for l in ga] == ['>GA500', '>GA600']
        scores = [float(l.split('-', 1)[1]) for l in ga]
        assert all(b >= a - 1e-6 for a, b in zip(scores, scores[1:]))
        assert scores[-1] >= 0.95 * true_score, name
        order = [t[:-1] for t in text[-1].split()]
        assert order in (truth, truth[::-1]), (name, order)
        final_scores.append(scores[-1])
    assert abs(final_scores[1] - final_scores[0]) <= \
        0.05 * max(final_scores)

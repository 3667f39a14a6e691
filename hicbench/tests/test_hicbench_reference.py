"""The plain reference against the port's CPU path on tiny genomes."""

import json
import os

import pytest

from hicbench import genome as gen
from hicbench.reference import mcl_dense

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFL = [1.3, 2.0, 2.7]


def links(contigs, chromosomes, seed, genome_seed=None):
    with open(os.path.join(HERE, 'configs', 'xtropicalis.json')) as f:
        cfg = json.load(f)
    cfg['published'] = dict(cfg['published'], contigs=contigs,
                            genome_bp=contigs * 150_000,
                            chromosomes=chromosomes)
    if genome_seed is not None:
        cfg['assumed'] = dict(cfg['assumed'], genome_seed=genome_seed)
    gn = gen.make(cfg, seed)
    return gn, gen.fragment_links(gn, 80)


@pytest.mark.parametrize('seed,genome_seed', [(1, None), (2 ** 31 + 3, None),
                                              (5, 11)])
def test_dense_reference_matches_the_port(monkeypatch, seed, genome_seed):
    from haphic_tpu_torch.cluster import mcl
    monkeypatch.setattr(mcl, 'DEVICE_MIN_N', 0)
    _, (ci, cj, cw, n) = links(240, 4, seed, genome_seed)
    parts, iters, _ = mcl.run_mcl_partitions(
        None, INFL, expansion=2, max_iter=200, pruning=1e-4,
        coo=(ci, cj, cw, n), device='cpu')
    want, want_iters = mcl_dense.sweep(ci, cj, cw, n, INFL, 2, 200, 1e-4,
                                       'cpu')
    assert list(iters) == want_iters
    assert [mcl_dense.moved(g, w, n) for g, w in zip(parts, want)] == \
        [0] * len(INFL)
    assert all(p is not None for p in want)


def test_moved_counts_fragments_out_of_their_cluster():
    want = [(0, 1, 2), (3, 4)]
    assert mcl_dense.moved([(0, 1), (2, 3, 4)], want, 5) == 1
    assert mcl_dense.moved([(0, 1, 2, 3, 4)], want, 5) == 2
    assert mcl_dense.moved(None, want, 5) == 5
    assert mcl_dense.moved(None, None, 5) == 0

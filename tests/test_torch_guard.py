"""Guards of the PyTorch/CUDA port (haphic_tpu_torch): it imports
nothing of JAX, the JAX package or networkx, its entry points refuse to
fall back to the CPU, and its scipy group merge equals the JAX
package's scikit-learn one."""

import ast
import os

import numpy as np
import pytest
import torch

from haphic_tpu.assign import reassign as jreassign
from haphic_tpu.core.contacts import COO as JCOO

from haphic_tpu_torch.assign import reassign as treassign
from haphic_tpu_torch.core.contacts import COO as TCOO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    """The port's modules, chip_smoke.py and the tools beside them
    (tools/: the kernels' measurement kit, the trace and A/B tools)."""
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for top in ('haphic_tpu_torch', 'tools'):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            out += [os.path.join(root, f) for f in sorted(files)
                    if f.endswith('.py')]
    return sorted(out)


def _forbidden(name: str) -> bool:
    """JAX and the JAX package; networkx, which the card machine lacks
    (the port keeps its own clique search, core/prune.find_cliques)."""
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'haphic_tpu', 'networkx')


def test_port_imports_no_jax_and_no_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    assert os.path.join(REPO, 'tools', 'kernelkit.py') in sources
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module:
                    names = [node.module]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, 'attr', getattr(node.func, 'id', '')) in (
                    'import_module', '__import__') and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            bad += ['{}:{} {}'.format(os.path.relpath(path, REPO),
                                      node.lineno, n)
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_port_imports_no_matplotlib_at_module_level():
    """matplotlib (absent on the card machine) is imported only inside
    the functions that draw."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        todo = list(tree.body)
        while todo:
            node = todo.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                todo += list(ast.iter_child_nodes(node))
                continue
            bad += ['{}:{} {}'.format(os.path.relpath(path, REPO),
                                      node.lineno, n)
                    for n in names if n.split('.')[0] == 'matplotlib']
    assert not bad, bad


def _sim_files(tmp_path):
    import random
    from . import util
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(3), nchrs=2, ctgs_per_chr=3, ctg_len=4000,
        n_pairs=2000)
    fa, pairs = tmp_path / 'asm.fa', tmp_path / 'hic.pairs'
    util.write_genome(str(fa), ctgs)
    util.write_pairs(str(pairs), recs)
    return str(fa), str(pairs)


def _call_pipeline(tmp_path):
    from haphic_tpu_torch.pipeline import run_pipeline
    fa, pairs = _sim_files(tmp_path)
    run_pipeline(fa, pairs, 2, outdir=str(tmp_path / 'out'))


def _call_cli(tmp_path):
    from haphic_tpu_torch.cli import main
    fa, pairs = _sim_files(tmp_path)
    main(['pipeline', fa, pairs, '2', '--outdir', str(tmp_path / 'o')])


def _call_mcl(tmp_path):
    from haphic_tpu_torch.cluster.mcl import run_mcl_partitions
    run_mcl_partitions(np.eye(4, dtype=np.float32), [2.0])


def _call_ga(tmp_path):
    from haphic_tpu_torch.order.optimize import TourProblem, optimize_tours
    p = TourProblem(lengths=np.asarray([10, 20], np.int64),
                    pair_a=np.zeros(1, np.int32),
                    pair_b=np.ones(1, np.int32),
                    d=np.ones((4, 1), np.float32),
                    w=np.ones(1, np.float32))
    optimize_tours([p], npop=4, ngen=2, backend='native')


def _call_allhic_cli(tmp_path):
    from haphic_tpu_torch.cli import main
    group, clm = tmp_path / 'group1.txt', tmp_path / 'group1.clm'
    group.write_text('#Contig\tRECounts\tLength\na\t1\t100\nb\t1\t100\n')
    clm.write_text('a+ b+\t1\t50\na+ b-\t1\t60\na- b+\t1\t70\n'
                   'a- b-\t1\t80\n')
    main(['allhic', str(group), str(clm), '--skipGA'])


def _plot_inputs(tmp_path):
    agp, pairs = tmp_path / 's.agp', tmp_path / 'hic.pairs'
    agp.write_text('s1\t1\t100\t1\tW\ta\t1\t100\t+\n')
    pairs.write_text('## pairs format v1.0\nr1\ta\t5\ta\t60\t+\t+\n')
    return str(agp), str(pairs)


def _call_plot_cli(tmp_path):
    from haphic_tpu_torch.cli import main
    agp, pairs = _plot_inputs(tmp_path)
    main(['plot', agp, pairs, '--outdir', str(tmp_path / 'o'),
          '--bin_size', '1'])


def _call_contact_map(tmp_path):
    from haphic_tpu_torch.post.plot import contact_map
    agp, pairs = _plot_inputs(tmp_path)
    contact_map(agp, pairs, outdir=str(tmp_path / 'out'), bin_size_kbp=1)


@pytest.mark.parametrize('entry', [_call_pipeline, _call_cli, _call_mcl,
                                   _call_ga, _call_allhic_cli,
                                   _call_plot_cli, _call_contact_map],
                         ids=['run_pipeline', 'cli', 'run_mcl_partitions',
                              'optimize_tours', 'cli-allhic', 'cli-plot',
                              'contact_map'])
def test_entry_point_without_device_raises_on_cpu_host(entry, tmp_path):
    """Called without a device, an entry point asks for CUDA; on a host
    without a card it raises instead of running on the CPU, and writes
    nothing."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry(tmp_path)
    assert not (tmp_path / 'out').exists()
    assert not (tmp_path / 'o').exists()
    assert not any(f.endswith('.tour') for f in os.listdir(os.getcwd()))


@pytest.mark.parametrize('flag,value', [('use_mesh', 'on')])
def test_unported_options_raise(flag, value, tmp_path):
    """Every option is ported: use_mesh='on' in a single process runs
    unsharded (one process is one card, haphic_tpu's one-device case)
    and writes the tree that 'off' writes."""
    from haphic_tpu_torch.pipeline import PipelineConfig, run_pipeline
    fa, pairs = _sim_files(tmp_path)
    trees = []
    for v in (value, 'off'):
        cfg = PipelineConfig(device='cpu', Nx=100, RE_site_cutoff=0,
                             density_lower='0', density_upper='1',
                             rank_sum_upper='1', flank=0, ngen=20, npop=8,
                             **{flag: v})
        cfg.reassign.min_group_len = 0
        cfg.reassign.min_RE_sites = 0
        cfg.reassign.min_links = 1
        out = tmp_path / v
        run_pipeline(fa, pairs, 2, cfg=cfg, outdir=str(out))
        assert cfg.mesh is None
        trees.append({os.path.relpath(os.path.join(d, f), out):
                      open(os.path.join(d, f), 'rb').read()
                      for d, _, fs in os.walk(out) for f in fs
                      if not os.path.islink(os.path.join(d, f))})
    assert len(trees[0]) > 20 and trees[0] == trees[1]


def _merge_case(seed):
    """Random group-link state for agglomerative_merge: contigs in
    n_groups groups, random inter-contig links with float weights (no
    distance ties), a few low-confidence contigs."""
    rng = np.random.default_rng(seed)
    n_groups = int(rng.integers(4, 14))
    n_ctg = 6 * n_groups
    ctg_group = rng.integers(0, n_groups, n_ctg).astype(np.int64)
    ctg_group[:n_groups] = np.arange(n_groups)
    hiconf = rng.random(n_ctg) > 0.1
    hiconf[:n_groups] = True
    nl = 8 * n_ctg
    i = rng.integers(0, n_ctg, nl)
    j = rng.integers(0, n_ctg, nl)
    keep = i != j
    i, j = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    w = rng.random(len(i)) * 50 + 1
    re = {g: float(rng.integers(50, 500)) for g in range(n_groups)}
    nclusters = int(rng.integers(2, n_groups))
    return i, j, w, ctg_group, hiconf, re, n_groups, nclusters


@pytest.mark.parametrize('seed', range(20))
def test_agglomerative_merge_matches_sklearn(seed):
    i, j, w, ctg_group, hiconf, re, n_groups, ncl = _merge_case(seed)
    want = jreassign.agglomerative_merge(
        JCOO(i=i, j=j, w=w), ctg_group, hiconf, re, n_groups, ncl)
    got = treassign.agglomerative_merge(
        TCOO(i=i, j=j, w=w), ctg_group, hiconf, re, n_groups, ncl)
    assert len(got) == ncl
    assert {frozenset(c) for c in got} == {frozenset(c) for c in want}

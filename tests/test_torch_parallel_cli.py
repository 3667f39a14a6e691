"""The port's CLI under torchrun on the CPU: `python -m
torch.distributed.run --nproc_per_node 2 -m haphic_tpu_torch pipeline
... --device cpu --use_mesh on` shards the run over two gloo processes;
rank 0 writes --outdir and rank 1 <outdir>.rank1, both the single-
process tree byte for byte."""

import os
import random
import subprocess
import sys

import torch

from haphic_tpu_torch.cli import main as tmain

from . import util
from .test_torch_pipeline import STAGES, _assert_trees_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ['--device', 'cpu', '--Nx', '100', '--RE_site_cutoff', '0',
         '--density_lower', '0', '--density_upper', '1',
         '--rank_sum_upper', '1', '--flank', '0', '--min_group_len', '0',
         '--min_RE_sites', '0', '--min_links', '1', '--ngen', '50',
         '--npop', '16', '--remove_allelic_links', '2']


def test_torchrun_cli_ranks_write_the_single_process_tree(tmp_path):
    ctgs, recs, _ = util.clustered_genome_and_pairs(
        random.Random(12345), nchrs=3, ctgs_per_chr=5, ctg_len=8000,
        n_pairs=24000)
    fa, pairs = str(tmp_path / 'asm.fa'), str(tmp_path / 'hic.pairs')
    util.write_genome(fa, ctgs)
    util.write_pairs(pairs, recs)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT', 'LOCAL_WORLD_SIZE'):
        env.pop(var, None)
    out = tmp_path / 'out'
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', '-m', 'haphic_tpu_torch', 'pipeline',
         fa, pairs, '3', '--outdir', str(out), '--use_mesh', 'on']
        + FLAGS, env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'Sharding hot stages over a 2-rank gloo mesh' in proc.stderr
    assert 'Inflation-sharded MCL sweep over 2 ranks' in proc.stderr
    single = tmp_path / 'single'
    assert tmain(['pipeline', fa, pairs, '3', '--outdir', str(single)]
                 + FLAGS) == 0
    for rank_out in (out, tmp_path / 'out.rank1'):
        assert _assert_trees_equal(single, rank_out, STAGES) > 20

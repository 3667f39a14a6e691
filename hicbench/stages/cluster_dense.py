"""Stage ``cluster_dense``: the inflation sweep of one genome's fragment
links through the dense MCL engine's public entry."""

from __future__ import annotations

from decimal import Decimal
from typing import List

import numpy as np

from hicbench import genome as gen
from hicbench.reference import mcl_dense


def inflations(spec: dict) -> List[float]:
    """The inflations min..max by step, stepped in decimal as
    HapHiC does."""
    v, step = Decimal(str(spec['min'])), Decimal(str(spec['step']))
    end = Decimal(str(spec['max'])) + step
    out = []
    while v < end:
        out.append(float(v))
        v += step
    return out


class ClusterDense:
    """The inflation sweep of one genome through the dense MCL engine's
    ``run_mcl_partitions``: partitions, n_iters, converged. The dense
    engine is the route ``run_clustering`` takes under ``sparse_min_n``
    fragments."""

    def __init__(self, cfg: dict, mix: dict, gn: gen.Genome, device,
                 seed: int):
        self.ci, self.cj, self.cw, self.n = gen.fragment_links(
            gn, int(cfg['pipeline']['Nx']))
        if self.n >= int(mix['sparse_min_n']):
            raise ValueError('{} fragments take the sparse engine, not the '
                             'dense one'.format(self.n))
        self.mix, self.device = mix, device
        self.infl = inflations(mix['inflations'])
        self.sizes = {'links': int(len(self.ci)),
                      'inflations': len(self.infl)}

    def _run(self, max_iter: int):
        from haphic_tpu_torch.cluster import mcl
        m = self.mix
        parts, iters, conv = mcl.run_mcl_partitions(
            None, self.infl, expansion=int(m['expansion']),
            max_iter=max_iter, pruning=float(m['pruning']),
            coo=(self.ci, self.cj, self.cw, self.n), device=self.device)
        return parts, np.asarray(iters), np.asarray(conv)

    def warmup(self):
        # iterations 0-2 of every batch: the expansion, the column pass
        # with and without the convergence statistic, the result's copy
        self._run(3)

    def unit(self, i: int):
        return self._run(int(self.mix['max_iter']))

    def reference(self, precision: str = 'config'):
        m = self.mix
        return mcl_dense.sweep(
            self.ci, self.cj, self.cw, self.n, self.infl,
            int(m['expansion']), int(m['max_iter']), float(m['pruning']),
            self.device, tf32=precision == 'below')

    def compare(self, out, ref) -> dict:
        parts, iters = out[0], out[1]
        want, want_iters = ref
        return {'moved': sum(mcl_dense.moved(g, w, self.n)
                             for g, w in zip(parts, want)),
                'iters_gap': int(np.abs(np.asarray(iters)
                                        - np.asarray(want_iters)).sum())}

    def control(self, outputs):
        return self.reference('below')


Stage = ClusterDense

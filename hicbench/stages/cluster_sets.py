"""Stage ``cluster_sets``: the cluster stage's public entry,
``cluster.sweep.run_clustering``, on a genome past the sparse engine's
threshold, as the pipeline calls it (``pipeline.py``), with no cluster
files written.

Set-up draws the genome with contigs of unequal lengths
(``genome.make_lengths``: the configuration's length law) and hands the
program what its ingest would: the fragment table (contigs over the bin
split into bins, names and lengths), the fragments the Nx cut keeps as
``filtered_ids``, and the links between kept fragments' flanking
regions as a ``COO`` over the fragments. ``nchrs`` is the
configuration's chromosomes times haplotypes. ``--seed`` relabels the
contigs by a permutation: it orders the work and does not size it (the
kept set is the same on every seed: the Nx cut keeps by length).

One unit is one ``run_clustering`` call with the mix's parameters: on
the sparse engine (``mcl_backend`` 'auto' from the program's
``SPARSE_MIN_N`` fragments on) the links' COO and ELL on the host, the
pre-expansion and the batched sweep on the card, the final iterates'
copy, ``SparseMCLResult.interpret`` for each inflation, then
``_clusters_to_ctgs`` and ``recommend_inflation``. The stage keeps the
two records that the program logs with ``extra={'metrics': ...}`` on
its ``haphic_tpu_torch.cluster.sweep`` logger (the sparse sweep's and
the cluster sets'), through a handler on that logger.

The check runs the plain reference (``reference/mcl_sparse.py``) on the
same links, in the labels the program's rows have (ascending fragment
id), at the same K. The program outputs contigs, a split contig in the
cluster that holds most of its kept bins' length; the check maps the
reference's fragment clusters to contigs by that rule (ties to the
cluster listed first) and compares, summed over the inflations:

- ``moved``: kept contigs outside their best-matching reference
  cluster, the larger of the two directions (the program's clusters
  matched to the reference's, and the reference's to the program's),
  over the inflations that both sides output;
- ``iters_gap``: sum of |n_iters - the reference's|, the program's from
  its sparse record;
- ``dropped_gap``: inflations that one side outputs and the other drops
  as no partition.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hicbench import genome as gen
from hicbench.reference import mcl_dense, mcl_sparse
from hicbench.stages.cluster_dense import inflations

LOGGER = 'haphic_tpu_torch.cluster.sweep'
# the sparse engine's K where the mix's sparse_K is 0: HapHiC's
# pipeline default as the port documents it (cluster/sparse_mcl.py
# DEFAULT_K, commit 1df7d85)
DEFAULT_K = 128


class Records(logging.Handler):
    """The ``metrics`` of every record that the program's sweep logger
    emits, in order."""

    hicbench = True

    def __init__(self):
        super().__init__(logging.INFO)
        self.got: List[dict] = []

    def emit(self, record):
        m = getattr(record, 'metrics', None)
        if isinstance(m, dict):
            self.got.append(dict(m))


def _records() -> Records:
    """A fresh handler on the program's sweep logger, in place of any
    earlier stage's."""
    lg = logging.getLogger(LOGGER)
    for h in [h for h in lg.handlers if getattr(h, 'hicbench', False)]:
        lg.removeHandler(h)
    h = Records()
    lg.addHandler(h)
    if lg.getEffectiveLevel() > logging.INFO:
        lg.setLevel(logging.INFO)
    return h


@dataclass
class Unit:
    """One unit's output: the program's SweepResult and its two
    records."""
    result: object
    sparse: dict
    sets: dict


@dataclass
class View:
    """What the check compares: each inflation's partition in the
    program's row labels (None where it was not output) and n_iters."""
    partitions: List[Optional[list]]
    n_iters: List[int]


class Stage:
    def __init__(self, cfg: dict, mix: dict, gn: gen.Layout, device,
                 seed: int):
        from haphic_tpu_torch.core.contacts import COO
        from haphic_tpu_torch.core.fragments import Fragments
        from haphic_tpu_torch.io.fasta import Assembly
        self.mix, self.device = mix, device
        self.infl = inflations(mix['inflations'])
        self.K = int(mix['sparse_K']) or DEFAULT_K
        self.nchrs = (int(cfg['published']['chromosomes'])
                      * int(cfg['published']['haplotypes']))
        n, bin_bp = gn.sizes.contigs, gn.sizes.bin_bp
        # contig c of the genome is contig perm[c] of the program, its
        # bins in order
        perm = np.random.default_rng([gn.seed, 1]).permutation(n)
        lengths = np.empty(n, dtype=np.int64)
        lengths[perm] = gn.contig_len
        off, flen = gen.bins(lengths, bin_bp)
        nb = np.diff(off)
        gctg = np.repeat(np.arange(n), np.diff(gn.frag_offset))
        frag = off[perm[gctg]] + np.arange(gctg.size) - gn.frag_offset[gctg]
        m = int(flen.size)
        self.filtered = np.sort(frag[gn.keep])
        self.m = int(self.filtered.size)
        i, j = frag[gn.i], frag[gn.j]
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        o = np.argsort(lo * m + hi)
        self.flank = COO(i=lo[o], j=hi[o], w=gn.w[o])
        names = ['ctg{:05d}'.format(c) for c in range(n)]
        asm = Assembly(names=names,
                       name2id={c: k for k, c in enumerate(names)},
                       lengths=lengths, re_sites=np.ones(n, np.int64))
        ctg = np.repeat(np.arange(n, dtype=np.int32), nb)
        k = np.arange(m, dtype=np.int64) - off[ctg]
        nx = np.zeros(m, dtype=bool)
        nx[self.filtered] = True
        self.frags = Fragments(
            asm=asm, ctg_of_frag=ctg, bin_no=(k + 1).astype(np.int32),
            frag_start=k * bin_bp, frag_len=flen,
            frag_re=np.ones(m, np.int64), frag_offset=off,
            split_ctg=lengths > bin_bp, nx_mask=nx, bin_size=bin_bp)
        # the program's row of each fragment: its rank among the kept
        self.row = np.full(m, -1, dtype=np.int64)
        self.row[self.filtered] = np.arange(self.m)
        # the check's items: the kept contigs, numbered in contig order
        kept_ctg = np.unique(ctg[self.filtered])
        self.item = np.full(n, -1, dtype=np.int64)
        self.item[kept_ctg] = np.arange(kept_ctg.size)
        self.items = int(kept_ctg.size)
        self.row_item = self.item[ctg[self.filtered]]
        self.row_len = flen[self.filtered]
        self.row_split = self.frags.split_ctg[ctg[self.filtered]]
        self.sizes = {'links': int(lo.size), 'kept': self.m,
                      'kept_contigs': self.items, 'K': self.K,
                      'nchrs': self.nchrs, 'inflations': len(self.infl)}
        self.records = _records()

    def _links(self):
        """The kept fragments' links in the program's row labels."""
        li, lj = self.row[self.flank.i], self.row[self.flank.j]
        sel = (li >= 0) & (lj >= 0)
        return li[sel], lj[sel], self.flank.w[sel], self.m

    def warmup(self):
        # one whole unit: the sweep's every kernel and K-shrink shape,
        # and the host's first pass through scipy and its large arrays,
        # which made a window's first unit 1-2 s slower than the next
        # when the warm-up stopped at three iterations (PERF.md)
        self.unit(-1)

    def unit(self, i: int) -> Unit:
        from haphic_tpu_torch.cluster import sweep
        m = self.mix
        self.records.got.clear()
        res = sweep.run_clustering(
            self.flank, self.filtered, self.frags, self.nchrs,
            expansion=int(m['expansion']),
            min_inflation=float(m['inflations']['min']),
            max_inflation=float(m['inflations']['max']),
            inflation_step=float(m['inflations']['step']),
            max_iter=int(m['max_iter']), pruning=float(m['pruning']),
            write_files=False, mcl_backend=m['mcl_backend'],
            sparse_K=int(m['sparse_K']), device=self.device)
        sparse = [r for r in self.records.got
                  if r.get('mcl_engine') == 'sparse']
        sets = [r for r in self.records.got if 'cluster_map_s' in r]
        if len(sparse) != 1 or len(sets) != 1:
            raise RuntimeError('the unit logged {} sparse sweep and {} '
                               'cluster-set records, not one each: did it '
                               'take the sparse engine?'.format(
                                   len(sparse), len(sets)))
        s = sparse[0]
        print('[hicbench] sweep: sweep_s {:.3f}, interpret_s {:.3f}, '
              'cluster_map_s {:.3f}, n_iters {}, k_steps {}'.format(
                  s['sweep_s'], s['interpret_s'], sets[0]['cluster_map_s'],
                  s['n_iters'], s['k_steps']), file=sys.stderr, flush=True)
        return Unit(result=res, sparse=s, sets=sets[0])

    # ---- the check ----

    def view(self, out) -> View:
        """A unit's output (or the reference's View) as the check reads
        it: each inflation's contig clusters as sorted tuples of
        items."""
        if isinstance(out, View):
            return out
        at = {round(float(cs.inflation), 9): cs
              for cs in out.result.cluster_sets}
        parts = []
        for r in self.infl:
            cs = at.get(round(r, 9))
            parts.append(None if cs is None else sorted(
                t for t in (tuple(sorted(int(self.item[int(c[3:])])
                                         for c in names))
                            for names, _ in cs.clusters) if t))
        return View(partitions=parts,
                    n_iters=[int(x) for x in out.sparse['n_iters']])

    def contigs(self, part):
        """A partition of the program's rows as contig clusters: a split
        contig in the cluster that holds most of its kept bins' length,
        ties to the cluster listed first."""
        if part is None:
            return None
        lab = mcl_dense.labels(part, self.m)
        best = np.full(self.items, -1, dtype=np.int64)
        one = ~self.row_split
        best[self.row_item[one]] = lab[one]
        votes = {}
        for r in np.flatnonzero(self.row_split):
            v = votes.setdefault(int(self.row_item[r]), {})
            v[int(lab[r])] = v.get(int(lab[r]), 0) + int(self.row_len[r])
        for it, v in votes.items():
            top = max(v.values())
            best[it] = min(c for c, x in v.items() if x == top)
        out = {}
        for it, c in enumerate(best.tolist()):
            out.setdefault(c, []).append(it)
        return sorted(tuple(x) for x in out.values())

    def reference(self, precision: str = 'config'):
        m = self.mix
        ci, cj, cw, n = self._links()
        parts, iters = mcl_sparse.sweep(
            ci, cj, cw, n, self.infl, int(m['expansion']),
            int(m['max_iter']), float(m['pruning']), self.K, self.device,
            bf16=precision == 'below')
        return View(partitions=[self.contigs(p) for p in parts],
                    n_iters=iters)

    def compare(self, out, ref: View) -> dict:
        got = self.view(out)
        moved = dropped = 0
        for g, w in zip(got.partitions, ref.partitions):
            if (g is None) != (w is None):
                dropped += 1
            elif g is not None:
                moved += max(mcl_dense.moved(g, w, self.items),
                             mcl_dense.moved(w, g, self.items))
        return {'moved': moved,
                'iters_gap': int(np.abs(np.asarray(got.n_iters)
                                        - np.asarray(ref.n_iters)).sum()),
                'dropped_gap': dropped}

    def control(self, outputs) -> View:
        """The reference with every iterate rounded to bfloat16."""
        return self.reference('below')

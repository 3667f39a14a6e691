"""Stage ``sort_ga``: the sort stage's GA pass over a genome's groups, as
the port's pipeline runs it (``haphic_tpu_torch/pipeline.py``
``sort_stage``, pass 2, which ``ga_secs`` times).

Set-up draws the genome's whole CLM, every group's records and the
uniform pairs between groups (``hicbench/clm.py``), ordered by contig
pair as the port's ingest hands it to the sort stage, and makes each
unit group's order data with the program's
``fast_sort.make_group_data``, handing each group only its own HT links.
The GA starts from the group's contig order and random tours, as
HapHiC's ``--skip_fast_sort`` runs it: on these genomes the fast sort
finds the drawn order itself and leaves the GA nothing to do. One unit
is ``optimize.group_problem`` for every group of the unit, each on the
whole CLM as the pipeline passes it, then one
``optimize.optimize_tours`` call, with the pipeline's defaults.

The check scores tours with the plain reference
(``reference/tour_score.py``) on each group's raw records. Numbers,
each the worst over the unit's groups:

- ``score_gap``: |the program's score of its tour - the reference's| /
  the reference's;
- ``invalid``: groups whose tour is not a permutation of the group's
  contigs with orientations 0 or 1;
- ``not_improved``: groups whose returned tour scores no higher than
  the start tour;
- ``truth_ratio``: the score of the order the genome was drawn in (its
  contigs along the chromosome, all forward) over the returned tour's:
  how far the GA got.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import torch

from hicbench import clm
from hicbench import genome as gen
from hicbench.reference import tour_score

LOGGER = 'haphic_tpu_torch.order.optimize'


def _log_batches():
    """The GA's route and batch lines (G, k_pad, R_pad) on standard
    error, once a process."""
    lg = logging.getLogger(LOGGER)
    if any(getattr(h, 'hicbench', False) for h in lg.handlers):
        return
    h = logging.StreamHandler(sys.stderr)
    h.hicbench = True
    h.setFormatter(logging.Formatter('[hicbench] %(message)s'))
    lg.addHandler(h)
    lg.setLevel(logging.INFO)


class Stage:
    def __init__(self, cfg: dict, mix: dict, gn: gen.Genome, device,
                 seed: int):
        from haphic_tpu_torch.order import fast_sort as fs
        self.mix, self.device = mix, torch.device(device)
        self.ga_seed = gn.seed
        n = gn.sizes.contigs
        self.groups = list(range(int(cfg['groups'])))
        self.lengths = np.full(n, gn.sizes.contig_bp, dtype=np.int64)
        self.names = ['ctg{:05d}'.format(c) for c in range(n)]
        self.name2id = {c: i for i, c in enumerate(self.names)}
        self.new = clm.relabel(gn, seed)
        t = [time.perf_counter()]
        reads = clm.draw_reads(gn, cfg, range(gn.sizes.groups))
        t.append(time.perf_counter())
        self.clm = clm.records(reads, self.new, self.lengths)
        del reads
        t.append(time.perf_counter())
        gs = gn.group_start
        self.span = [(int(gs[g]), int(gs[g + 1])) for g in self.groups]
        self.rows = [clm.group_rows(self.clm, lo, hi)
                     for lo, hi in self.span]
        self.ctg_ids = [fs.make_group_data(
            np.arange(lo, hi), self.lengths,
            clm.ht_links(self.clm, self.lengths, lo, hi)).ctg_ids
            for lo, hi in self.span]
        t.append(time.perf_counter())
        self.sizes = {'sort_groups': len(self.groups),
                      'records': [int(r.size) for r in self.rows],
                      'clm_records': int(self.clm.pair_i.size),
                      'draw_s': t[1] - t[0], 'records_s': t[2] - t[1],
                      'order_data_s': t[3] - t[2]}
        _log_batches()

    def _ga(self, idx, ngen: int):
        from haphic_tpu_torch.order import optimize as opt
        m = self.mix
        t0 = time.perf_counter()
        problems, hots = zip(*[opt.group_problem(
            self.ctg_ids[t], self.lengths, self.clm, None, self.name2id)
            for t in idx])
        t1 = time.perf_counter()
        res = opt.optimize_tours(
            problems, npop=int(m['npop']), ngen=ngen,
            mutprob=float(m['mutprob']), seed=self.ga_seed,
            hot_starts=hots, log_every=int(m['log_every']),
            backend=m['backend'], device=self.device)
        # the pass's two parts on the host's clock, in every run
        print('[hicbench] GA pass: problems {:.3f} s, optimize_tours {:.3f} s'
              .format(t1 - t0, time.perf_counter() - t1), file=sys.stderr,
              flush=True)
        return [self._ids(opt.result_to_tour(r, self.ctg_ids[t], self.names))
                + (float(r.score),) for r, t in zip(res, idx)]

    def _ids(self, tour):
        """(order, ori) int64 in run labels of a tour [(name, '+'/'-')]."""
        return (np.asarray([self.name2id[c] for c, _ in tour], np.int64),
                np.asarray([o == '-' for _, o in tour], np.int64))

    def warmup(self):
        # one group through one delta cycle past the first: the kernels
        # build once a source, not a shape, and at the alfalfa's sizes
        # every batch is one group of one padded shape (the batch log)
        from haphic_tpu_torch.order import optimize as opt
        self._ga([0], 2 * opt.GA_SYNC_EVERY)

    def unit(self, i: int):
        return self._ga(range(len(self.groups)), int(self.mix['ngen']))

    # ---- the check ----

    def _records(self, t: int):
        """Group t's raw records in local ids (run label - first id), on
        the device."""
        lo, hi = self.span[t]
        m = self.rows[t]

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=self.device)
        return (put(self.lengths[lo:hi]), put(self.clm.pair_i[m] - lo),
                put(self.clm.pair_j[m] - lo), put(self.clm.d[:, m]))

    def _local(self, t: int, order, ori):
        lo, _ = self.span[t]
        return (torch.as_tensor(order - lo, device=self.device),
                torch.as_tensor(ori, device=self.device))

    def _start(self, t: int):
        """(order, ori) in run labels of the tour the GA starts from:
        the group's contig order, all forward."""
        lo, hi = self.span[t]
        return np.arange(lo, hi), np.zeros(hi - lo, np.int64)

    def reference(self, precision: str = 'config'):
        """Per group: the start tour's score and the drawn order's."""
        out = []
        for t, (lo, hi) in enumerate(self.span):
            rec = self._records(t)
            truth = self.new[lo:hi]
            out.append({
                'start': float(tour_score.score(
                    *self._local(t, *self._start(t)), *rec)),
                'truth': float(tour_score.score(
                    *self._local(t, truth, np.zeros(hi - lo, np.int64)),
                    *rec))})
            del rec
        return out

    def _valid(self, t: int, order, ori) -> bool:
        lo, hi = self.span[t]
        return (order.shape == (hi - lo,) and ori.shape == order.shape
                and np.array_equal(np.sort(order), np.arange(lo, hi))
                and bool(np.isin(ori, (0, 1)).all()))

    def compare(self, out, ref) -> dict:
        gap, invalid, not_improved, truth = 0.0, 0, 0, 0.0
        for t, ((order, ori, score), want) in enumerate(zip(out, ref)):
            if not self._valid(t, order, ori):
                invalid += 1
                continue
            got = float(tour_score.score(*self._local(t, order, ori),
                                         *self._records(t)))
            gap = max(gap, abs(score - got) / got)
            not_improved += int(got <= want['start'])
            truth = max(truth, want['truth'] / got)
        return {'score_gap': gap, 'invalid': invalid,
                'not_improved': not_improved, 'truth_ratio': truth}

    def control(self, outputs):
        """The program's own tours, scored by the reference in bfloat16
        (the distances, the weights and the sum)."""
        out = []
        for t, (order, ori, _) in enumerate(outputs[0]):
            s = tour_score.score(*self._local(t, order, ori),
                                 *self._records(t), dtype=torch.bfloat16)
            out.append((order, ori, float(s)))
        return out

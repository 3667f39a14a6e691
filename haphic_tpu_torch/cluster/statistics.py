"""Per-inflation threshold statistics for the reassignment step.

Byte-compatible re-implementation of output_statistics
(scripts/HapHiC_cluster.py:2245-2478): for every inflation's clusters it
writes cumulative filter-threshold curves — RE sites, best-group links,
best-group link density, and best/average density ratio — as
``inflation_*/{name}_statistics.txt`` plus a 4-panel ``statistics.pdf``.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from haphic_tpu_torch.core.contacts import COO
from haphic_tpu_torch.io.fasta import Assembly

logger = logging.getLogger(__name__)


def _generate_axes(sorted_list, lengths: Dict[str, int], total_n: int,
                   total_len: int):
    """(parity: :2281-2301) cumulative (#filtered, remaining length)
    per distinct threshold value, ascending."""
    n_at = OrderedDict({0: 0})
    len_at = OrderedDict({0: 0})
    last = 0
    for ctg, value in sorted_list:
        if value in n_at:
            n_at[value] += 1
            len_at[value] += lengths[ctg]
        else:
            n_at[value] = n_at[last] + 1
            len_at[value] = len_at[last] + lengths[ctg]
            last = value
    x, y1, y2 = [], [], []
    for k, v in n_at.items():
        x.append(k)
        y1.append(v / total_n * 100)
        y2.append((total_len - len_at[k]) / total_len * 100)
    return x, y1, y2


def _write_result(x, y1, y2, title: str, outdir: str) -> None:
    with open(os.path.join(outdir,
                           '{}_statistics.txt'.format(title)), 'w') as f:
        f.write('{}\tFiltered_ctg_n\tRest_ctg_len\n'.format(title))
        for n, value in enumerate(x):
            f.write('>{}\t{}\t{}\n'.format(value, y1[n], y2[n]))


def _link_density(max_group, current_group, links, group_re, ctg_re):
    if max_group == current_group:
        return links / group_re
    return links / (group_re + ctg_re - 1)


def output_statistics(asm: Assembly, full: COO, cluster_sets,
                      outdir: str = '.', draw: bool = True,
                      background: bool = False):
    """``cluster_sets``: list of sweep.ClusterSet; writes into
    ``outdir``/inflation_*/ (created by the sweep).

    With ``background=True`` the txt files are still written
    synchronously (the byte contract of the reassignment step) but the
    PDF render workers are only *started* before returning; the caller
    must invoke the returned ``wait()`` callable before relying on the
    statistics.pdf artifacts (run_pipeline does this after the build
    stage, taking the render off the cluster stage's critical path).
    Returns ``wait`` (a no-op callable when nothing renders).

    Vectorized: the reference (and the round-2 twin) walked every link
    through Python dicts once per inflation — O(#inflations × nnz)
    interpreter work that measured 12.5 s of a 33 s cluster stage.
    The accumulation is now one lexsort + reduceat per inflation, with
    the reference's exact selection semantics: stable sort by links
    descending, ties resolved by which group appears FIRST among the
    contig's links in ascending pair order (= dict insertion order in
    the reference, scripts/HapHiC_cluster.py:2350-2420)."""
    logger.info('Making some statistics for the next HapHiC '
                'reassignment step...')
    names_in_order = asm.names_by_input_order()
    lengths = {c: asm.length_of(c) for c in asm.names}
    re_sites = {c: asm.re_of(c) for c in asm.names}
    total_n = len(asm)
    total_len = asm.total_len

    re_list = sorted(((c, re_sites[c]) for c in names_in_order),
                     key=lambda x: x[1])
    x_re, y1_re, y2_re = _generate_axes(re_list, lengths, total_n,
                                        total_len)
    drawer = None
    if draw:
        if os.environ.get('HAPHIC_STATS_MPL', '') not in ('', '0'):
            # opt-in matplotlib renderer (forked workers; see
            # _ParallelDrawer); HAPHIC_STATS_MPL=0 means off
            try:
                import matplotlib  # noqa: F401 — availability probe
                drawer = _ParallelDrawer()
            except ImportError:
                logger.warning('matplotlib is not installed, '
                               'statistical plots are skipped')
        else:
            # default: built-in direct PDF writer (~3 ms/figure,
            # renders inline — no deferred workers; _pdfplot docstring)
            from haphic_tpu_torch.cluster._pdfplot import FastStatDrawer
            drawer = _InlineDrawer(FastStatDrawer())

    nc = len(asm)
    ids_in_order = np.asarray([asm.name2id[c] for c in names_in_order])
    re_arr = np.asarray(asm.re_sites, dtype=np.float64)
    li = np.asarray(full.i, dtype=np.int64)
    lj = np.asarray(full.j, dtype=np.int64)
    lw = np.asarray(full.w, dtype=np.float64)

    def as_scalar(v):
        return int(v) if float(v).is_integer() else float(v)

    for cs in cluster_sets:
        d = os.path.join(outdir, 'inflation_{}'.format(cs.inflation))
        os.makedirs(d, exist_ok=True)
        _write_result(x_re, y1_re, y2_re, 'RE_site_threshold', d)

        G = len(cs.clusters)
        group_of = np.full(nc, -1, dtype=np.int64)
        group_re = np.ones(max(G, 1), dtype=np.float64)
        for n, (ctgs, _) in enumerate(cs.clusters):
            ids = np.asarray([asm.name2id[c] for c in ctgs],
                             dtype=np.int64)
            group_of[ids] = n
            group_re[n] += (re_arr[ids] - 1).sum()

        # every (contig, target-group) contribution, both directions,
        # tagged with the link ordinal for the insertion-order tie-break
        t = np.arange(len(li), dtype=np.int64)
        ga, gb = group_of[li], group_of[lj]
        m1, m2 = gb >= 0, ga >= 0
        ct = np.concatenate([li[m1], lj[m2]])
        gr = np.concatenate([gb[m1], ga[m2]])
        wv = np.concatenate([lw[m1], lw[m2]])
        tv = np.concatenate([t[m1], t[m2]])

        key = ct * max(G, 1) + gr
        order = np.lexsort((tv, key))
        key_s, wv_s = key[order], wv[order]
        uk, start = np.unique(key_s, return_index=True)
        w_sum = np.add.reduceat(wv_s, start) if len(wv_s) else wv_s
        t_first = tv[order][start] if len(start) else tv[:0]
        u_ct = uk // max(G, 1)
        u_gr = uk % max(G, 1)

        # per-entry link density (reference _link_density semantics)
        own = u_gr == group_of[u_ct]
        dens = np.where(own, w_sum / group_re[u_gr],
                        w_sum / (group_re[u_gr] + re_arr[u_ct] - 1))

        # best entry per contig: max links, ties -> earliest first link
        sel = np.lexsort((t_first, -w_sum, u_ct))
        ct_sel = u_ct[sel]
        first = np.ones(len(sel), dtype=bool)
        first[1:] = ct_sel[1:] != ct_sel[:-1]
        best = sel[first]
        best_ctg = u_ct[best]

        links_best = np.zeros(nc, dtype=np.float64)
        dens_best = np.zeros(nc, dtype=np.float64)
        links_best[best_ctg] = w_sum[best]
        dens_best[best_ctg] = dens[best]
        has_links = np.zeros(nc, dtype=bool)
        has_links[best_ctg] = True

        # sum of the OTHER groups' densities in ranked order — reduceat
        # accumulates sequentially, reproducing the reference's
        # `sum(density for ranked[1:])` float order bit-for-bit
        tail = np.where(first, 0.0, dens[sel])
        seg_starts = np.nonzero(first)[0]
        other = np.zeros(nc, dtype=np.float64)
        if len(seg_starts):
            other[best_ctg] = np.add.reduceat(tail, seg_starts)

        ratio = np.zeros(nc, dtype=np.float64)
        if G > 1:
            avg_other = other / (G - 1)
            ratio = np.where(avg_other != 0, dens_best
                             / np.where(avg_other != 0, avg_other, 1.0),
                             1000000.0)
        else:
            ratio = np.where(has_links, 1000000.0, 0.0)
        ratio = np.where(has_links, ratio, 0.0)

        def value_list(arr):
            return [(c, as_scalar(arr[i]))
                    for c, i in zip(names_in_order, ids_in_order)]

        link_list = value_list(links_best)
        density_list = value_list(dens_best)
        ratio_list = value_list(ratio)
        link_list.sort(key=lambda x: x[1])
        density_list.sort(key=lambda x: x[1])
        ratio_list.sort(key=lambda x: x[1])
        axes_link = _generate_axes(link_list, lengths, total_n, total_len)
        axes_density = _generate_axes(density_list, lengths, total_n,
                                      total_len)
        axes_ratio = _generate_axes(ratio_list, lengths, total_n,
                                    total_len)
        _write_result(*axes_link, 'Link_threshold', d)
        _write_result(*axes_density, 'Link_density_threshold', d)
        _write_result(*axes_ratio, 'Link_density_ratio_threshold', d)

        if drawer is not None:
            drawer.save(d, [(x_re, y1_re, y2_re), axes_link,
                            axes_density, axes_ratio])

    if drawer is None:
        return lambda: None
    drawer.start()
    if not background:
        drawer.wait()
    return drawer.wait


class _InlineDrawer:
    """Synchronous adapter with the _ParallelDrawer start()/wait()
    surface: saves happen immediately (the fast writer is cheaper than
    queuing them), so wait() is a no-op."""

    def __init__(self, impl):
        self._impl = impl

    def save(self, outdir, panel_data) -> None:
        self._impl.save(outdir, panel_data)

    def start(self) -> None:
        pass

    def wait(self) -> None:
        pass

    def close(self) -> None:
        self._impl.close()


def _make_drawer():
    try:
        from haphic_tpu_torch.cluster._statdraw import StatDrawer
        return StatDrawer()
    except ImportError:
        logger.warning('matplotlib is not installed, statistical plots '
                       'are skipped')
        return None


class _ParallelDrawer:
    """Render statistics.pdf files in forked worker processes:
    matplotlib's PDF rendering is GIL-bound, so threads do not help,
    and this environment supports neither spawn (re-imports __main__,
    breaking ad-hoc scripts) nor forkserver. Jobs are collected and
    rendered at close(): each forked child renders its stride with its
    own figure and exits via os._exit — atexit handlers never run in
    the child, so an inherited device client cannot tear down the
    parent's session. Any failure falls back to serial rendering."""

    def __init__(self, n_workers: int = 2):
        self._n_workers = n_workers
        self._jobs = []
        self._pids = []
        self._started = False
        self._waited = False

    def save(self, outdir, panel_data) -> None:
        self._jobs.append((outdir, panel_data))

    def _serial(self, jobs) -> None:
        d = _make_drawer()
        if d is None:
            return
        for outdir, panel_data in jobs:
            d.save(outdir, panel_data)
        d.close()

    def start(self) -> None:
        """Fork the render workers (non-blocking). Serial-render paths
        (no fork, <2 jobs) run synchronously here."""
        if self._started:
            return
        self._started = True
        jobs = self._jobs
        if not jobs:
            self._waited = True
            return
        nw = min(self._n_workers, len(jobs))
        if nw < 2 or not hasattr(os, 'fork'):
            self._serial(jobs)
            self._waited = True
            return
        try:
            import warnings
            for w in range(nw):
                with warnings.catch_warnings():
                    # Python warns on fork() in multi-threaded
                    # processes (the runtime's background threads); the
                    # children only render matplotlib and exit via
                    # os._exit, never touching inherited threads/locks
                    warnings.simplefilter('ignore')
                    pid = os.fork()
                if pid == 0:
                    code = 1
                    try:
                        from haphic_tpu_torch.cluster._statdraw import StatDrawer
                        d = StatDrawer()
                        for outdir, panel_data in jobs[w::nw]:
                            d.save(outdir, panel_data)
                        code = 0
                    finally:
                        os._exit(code)
                self._pids.append(pid)
        except Exception:
            logger.warning('forking PDF render workers failed; '
                           'rendering serially')
            self._pids = []
            self._serial(jobs)
            self._waited = True

    def wait(self) -> None:
        """Join the render workers (idempotent); serial fallback when
        any worker failed."""
        if not self._started:
            self.start()
        if self._waited:
            return
        self._waited = True
        ok = True
        try:
            for p in self._pids:
                _, status = os.waitpid(p, 0)
                ok = ok and status == 0
        except Exception:
            ok = False
        if not ok:
            logger.warning('forked PDF rendering failed; rendering '
                           'serially')
            self._serial(self._jobs)

    # backwards-compatible synchronous render
    def close(self) -> None:
        self.wait()


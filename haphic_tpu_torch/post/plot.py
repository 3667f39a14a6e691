"""Contact-map plotting: AGP-indexed binning, KR balancing, heatmaps.

Port of haphic_tpu/post/plot.py. The AGP index, the bin layout, the
drawing functions and the pickle cache are host code, copied. The
numeric work runs in torch on ``device`` (default cuda):

  * mapping an alignment (ctg, pos) to its scaffold bin is one
    ``torch.searchsorted`` over the combined int64 (ctg, pos) key;
  * the (n_bins, n_bins) int64 matrix is an exact integer scatter-add
    (``index_add_`` over the flat cell index b1 * n + b2);
  * Knight-Ruiz balancing (``kr_balance``) runs in float64 on the
    device; its loop tests read scalars on the host, as numpy does;
  * ``normalize_matrix`` takes the median of the off-diagonal cells
    from order statistics (``kthvalue``) and averages the two middle
    ones of an even count, as ``np.median`` does.

The cache holds the numpy int64 matrix, the binning params and the AGP
md5, so `contact_matrix.pkl` is read and written the same by both
packages. ``contact_map`` is everything before drawing; ``run_plot``
calls it and then draws with matplotlib, imported only there.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)


# ---------------- AGP indexing --------------------------------------

@dataclass
class AgpIndex:
    """Columnar AGP W-line table for coordinate lifting."""
    ctg_names: List[str]
    ctg_id: Dict[str, int]
    # segments sorted by (ctg, raw_start); coordinates 1-based inclusive
    seg_key: np.ndarray          # ctg_id * KEY + raw_start
    seg_ctg: np.ndarray
    seg_raw_start: np.ndarray
    seg_raw_end: np.ndarray
    seg_group: np.ndarray        # group index
    seg_group_start: np.ndarray  # 1-based scaffold coordinate
    seg_fwd: np.ndarray          # bool
    group_names: List[str]
    group_sizes: np.ndarray      # scaffold length (max group_end)
    KEY: int

    def n_groups(self) -> int:
        return len(self.group_names)


def parse_agp(path: str) -> AgpIndex:
    ctg_id: Dict[str, int] = {}
    ctg_names: List[str] = []
    group_idx: Dict[str, int] = {}
    group_names: List[str] = []
    group_sizes: List[int] = []
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            cols = line.split()
            if cols[4] != 'W':
                continue
            group = cols[0]
            if group not in group_idx:
                group_idx[group] = len(group_names)
                group_names.append(group)
                group_sizes.append(0)
            g = group_idx[group]
            group_sizes[g] = max(group_sizes[g], int(cols[2]))
            ctg = cols[5]
            if ctg not in ctg_id:
                ctg_id[ctg] = len(ctg_names)
                ctg_names.append(ctg)
            rows.append((ctg_id[ctg], int(cols[6]), int(cols[7]), g,
                         int(cols[1]), cols[8] == '+'))
    rows.sort()
    seg_ctg = np.asarray([r[0] for r in rows], np.int64)
    seg_raw_start = np.asarray([r[1] for r in rows], np.int64)
    seg_raw_end = np.asarray([r[2] for r in rows], np.int64)
    seg_group = np.asarray([r[3] for r in rows], np.int64)
    seg_group_start = np.asarray([r[4] for r in rows], np.int64)
    seg_fwd = np.asarray([r[5] for r in rows], bool)
    KEY = int(max(seg_raw_end.max() if len(rows) else 1, 1)) + 2
    seg_key = seg_ctg * KEY + seg_raw_start
    return AgpIndex(ctg_names=ctg_names, ctg_id=ctg_id, seg_key=seg_key,
                    seg_ctg=seg_ctg, seg_raw_start=seg_raw_start,
                    seg_raw_end=seg_raw_end, seg_group=seg_group,
                    seg_group_start=seg_group_start, seg_fwd=seg_fwd,
                    group_names=group_names,
                    group_sizes=np.asarray(group_sizes, np.int64), KEY=KEY)


@dataclass
class BinIndex:
    agp: AgpIndex
    bin_size: int
    sel_groups: List[int]              # selected group indices, in order
    group_nbins: np.ndarray            # per selected group
    group_bin_offset: np.ndarray       # aligned with agp group index (-1 off)
    total_bins: int
    # the segment tables as tensors, per device (map_to_bins)
    _tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def group_names(self) -> List[str]:
        return [self.agp.group_names[g] for g in self.sel_groups]

    @property
    def group_sizes(self) -> np.ndarray:
        return self.agp.group_sizes[self.sel_groups]

    def tables(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(seg_key, seg_ctg, seg_raw_start, seg_raw_end, seg_fwd,
        seg_group_start, bin offset of each segment's group) on
        ``device``, uploaded once."""
        if device not in self._tables:
            agp = self.agp
            cols = (agp.seg_key, agp.seg_ctg, agp.seg_raw_start,
                    agp.seg_raw_end, agp.seg_fwd, agp.seg_group_start,
                    self.group_bin_offset[agp.seg_group])
            self._tables[device] = tuple(torch.as_tensor(c, device=device)
                                         for c in cols)
        return self._tables[device]


def build_bins(agp: AgpIndex, bin_size: int, min_len_mbp: float = 0,
               specified: Optional[Sequence[str]] = None) -> BinIndex:
    """Group-bin layout (parity: generate_contact_matrix, :106-150).
    ``bin_size`` in bp."""
    if specified:
        sel = []
        for g in specified:
            if g not in agp.group_names:
                raise RuntimeError(
                    'Cannot find {} in the input AGP file'.format(g))
            sel.append(agp.group_names.index(g))
    else:
        min_len = min_len_mbp * 1e6
        sel = [g for g in range(agp.n_groups())
               if agp.group_sizes[g] >= min_len]
    offsets = np.full(agp.n_groups(), -1, np.int64)
    nbins = []
    total = 0
    for g in sel:
        nb = int(agp.group_sizes[g]) // bin_size + 1
        offsets[g] = total
        nbins.append(nb)
        total += nb
    return BinIndex(agp=agp, bin_size=bin_size, sel_groups=sel,
                    group_nbins=np.asarray(nbins, np.int64),
                    group_bin_offset=offsets, total_bins=total)


def map_to_bins(bi: BinIndex, ctg: torch.Tensor, pos: torch.Tensor
                ) -> torch.Tensor:
    """(agp ctg id, 1-based pos), int64 tensors → total bin id (-1 =
    drop), on their device."""
    key_t, ctg_t, rs_t, re_t, fwd_t, gs_t, off_t = bi.tables(ctg.device)
    n_seg = key_t.shape[0]
    if n_seg == 0:
        return torch.full_like(ctg, -1)
    key = ctg * bi.agp.KEY + pos
    idx = torch.searchsorted(key_t, key, right=True) - 1
    idx = idx.clamp(0, n_seg - 1)
    rs, re = rs_t[idx], re_t[idx]
    ok = (ctg_t[idx] == ctg) & (pos >= rs) & (pos <= re)
    gpos = gs_t[idx] + torch.where(fwd_t[idx], pos - rs, re - pos)
    off = off_t[idx]
    ok &= off >= 0
    out = off + torch.div(gpos - 1, bi.bin_size, rounding_mode='floor')
    return torch.where(ok, out, torch.full_like(out, -1))


def accumulate_contacts(bi: BinIndex, chunks, device=None) -> torch.Tensor:
    """Scatter-add alignment chunks into the (total_bins, total_bins)
    int64 matrix on ``device``. Chunks carry 0-based positions
    (io.pairs/io.bam) and AGP contig ids (see contact_map); the AGP
    mapping is 1-based."""
    dev = resolve_device(device)
    n = bi.total_bins
    m = torch.zeros(n * n, dtype=torch.int64, device=dev)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    for chunk in chunks:
        b1 = map_to_bins(bi, col(chunk.ref), col(chunk.pos) + 1)
        b2 = map_to_bins(bi, col(chunk.mref), col(chunk.mpos) + 1)
        flat = (b1 * n + b2)[(b1 >= 0) & (b2 >= 0)]
        m.index_add_(0, flat, torch.ones_like(flat))
    return m.view(n, n)


def symmetrize(m: torch.Tensor) -> torch.Tensor:
    """total = m + m.T with the diagonal counted once
    (parity: scripts/HapHiC_plot.py:854-856)."""
    out = m + m.T
    out.diagonal().copy_(m.diagonal())
    return out


# ---------------- Knight-Ruiz balancing -----------------------------

def kr_balance(A: torch.Tensor, tol: float = 1e-6, delta: float = 0.1,
               Delta: float = 3.0, max_outer: int = 1000,
               max_inner: int = 10000,
               counts: Optional[List[Tuple[int, int]]] = None
               ) -> torch.Tensor:
    """KR scaling vector x (float64, on A's device) such that diag(x) A
    diag(x) is doubly stochastic: the inner-outer conjugate-gradient
    Newton iteration of Knight & Ruiz (2013), step for step as
    haphic_tpu's numpy version. The scalars of the loop tests are read
    on the host. ``counts``, when given, gets (outer, inner) iterations
    appended. Raises RuntimeError when the matrix is too sparse to
    converge."""
    A = A.to(torch.float64)
    n = A.shape[0]
    e = torch.ones(n, dtype=torch.float64, device=A.device)
    x = e.clone()
    g, etamax = 0.9, 0.1
    eta = etamax
    stop_tol = tol * 0.5
    rt = tol ** 2
    v = x * (A @ x)
    rk = 1 - v
    rho_km1 = float(rk @ rk)
    rout = rold = rho_km1
    err = ('KR balancing did not converge within the outer-iteration '
           'limit — the contact matrix is likely too sparse for KR; '
           'rerun with --normalization log10 or none.')
    nn = 0
    n_inner = 0
    while rout > rt:
        nn += 1
        if nn > max_outer:
            raise RuntimeError(err)
        k = 0
        mm = 0
        y = e.clone()
        innertol = max(eta ** 2 * rout, rt)
        rho_km2 = rho_km1
        while rho_km1 > innertol:
            mm += 1
            if mm > max_inner:
                raise RuntimeError(err)
            k += 1
            n_inner += 1
            if k == 1:
                Z = rk / v
                p = Z
                rho_km1 = float(rk @ Z)
            else:
                beta = rho_km1 / rho_km2
                p = Z + beta * p
            w = x * (A @ (x * p)) + v * p
            alpha = rho_km1 / float(p @ w)
            ap = alpha * p
            ynew = y + ap
            if float(ynew.min()) <= delta:
                if delta == 0:
                    break
                ind = ap < 0
                gamma = float(((delta - y[ind]) / ap[ind]).min())
                y = y + gamma * ap
                break
            if float(ynew.max()) >= Delta:
                ind = ynew > Delta
                gamma = float(((Delta - y[ind]) / ap[ind]).min())
                y = y + gamma * ap
                break
            y = ynew
            rk = rk - alpha * w
            rho_km2 = rho_km1
            Z = rk / v
            rho_km1 = float(rk @ Z)
        x = x * y
        v = x * (A @ x)
        rk = 1 - v
        rho_km1 = float(rk @ rk)
        rout = rho_km1
        rat = rout / rold
        rold = rout
        res_norm = float(np.sqrt(rout))
        eta_o = eta
        eta = g * rat
        if g * eta_o ** 2 > 0.1:
            eta = max(eta, g * eta_o ** 2)
        eta = max(min(eta, etamax), stop_tol / res_norm)
    if counts is not None:
        counts.append((nn, n_inner))
    return x


def _median(v: torch.Tensor) -> float:
    """np.median of a 1-D tensor: the middle order statistic, or the
    mean of the two middle ones of an even count (torch.median returns
    the lower one; torch.quantile refuses more than 2^24 values)."""
    n = v.numel()
    hi = float(v.kthvalue(n // 2 + 1).values)
    if n % 2:
        return hi
    lo = float(v.kthvalue(n // 2).values)
    return float(np.mean([lo, hi]))


def _nondiag(sub: torch.Tensor) -> torch.Tensor:
    """The off-diagonal cells of a square block, row-major."""
    n = sub.shape[0]
    mask = ~torch.eye(n, dtype=torch.bool, device=sub.device)
    return sub[mask]


def normalize_matrix(contact: torch.Tensor, bi: BinIndex,
                     normalization: str = 'KR', vmax_coef: float = 5.0,
                     manual_vmax: float = -1.0,
                     counts: Optional[List[Tuple[int, int]]] = None,
                     vectors: Optional[List[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, float]:
    """KR (intra per scaffold + global inter), log10, or none
    (parity: :407-504), on the device of ``contact``. ``counts`` and
    ``vectors`` get each KR call's (outer, inner) iterations and its
    vector: the whole matrix first, then each scaffold."""
    vectors = [] if vectors is None else vectors
    nbins = bi.group_nbins
    starts = np.concatenate([[0], np.cumsum(nbins)])

    if normalization == 'KR':
        zero = contact == 0
        m = contact.to(torch.float64) + 1e-5
        x = kr_balance(m, counts=counts)
        vectors.append(x)
        # x_i * x_j rounded first, as np.outer
        out = m * (x[:, None] * x[None, :])
        nondiag = []
        for t in range(len(nbins)):
            s, e = int(starts[t]), int(starts[t + 1])
            sub = m[s:e, s:e]
            xg = kr_balance(sub, counts=counts)
            vectors.append(xg)
            blk = sub * (xg[:, None] * xg[None, :])
            out[s:e, s:e] = blk
            nondiag.append(_nondiag(blk))
        out[zero] = 0
        vmax = (_median(torch.cat(nondiag)) * vmax_coef
                if manual_vmax < 0 else manual_vmax)
        return out, float(vmax)

    if normalization == 'log10':
        out = torch.log10(contact.to(torch.float64) + 1)
    else:
        out = contact.to(torch.float64)
    nondiag = []
    for t in range(len(nbins)):
        s, e = int(starts[t]), int(starts[t + 1])
        nondiag.append(_nondiag(out[s:e, s:e]))
    vmax = (_median(torch.cat(nondiag)) * vmax_coef
            if manual_vmax < 0 else manual_vmax)
    return out, float(vmax)


# ---------------- drawing -------------------------------------------

def _get_cmap(name: str):
    import matplotlib
    from matplotlib.colors import LinearSegmentedColormap
    if name == 'whitered':
        return LinearSegmentedColormap.from_list(
            'whitered', ['white', '#ff0000'])
    return matplotlib.colormaps.get_cmap(name)


def draw_heatmap(matrix: np.ndarray, bi: BinIndex, vmax: float,
                 out_path: str, cmap: str = 'whitered',
                 origin: str = 'bottom_left', border_style: str = 'grid',
                 figsize_cm: Tuple[float, float] = (15.0, 15.0),
                 title: str = 'Hi-C contact map',
                 normalization: str = 'KR') -> str:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(figsize_cm[0] / 2.54,
                                    figsize_cm[1] / 2.54), dpi=300)
    n = matrix.shape[0]
    edges = np.cumsum(bi.group_nbins) - 0.5
    centers = np.cumsum(bi.group_nbins) - bi.group_nbins / 2
    im = ax.imshow(matrix, cmap=_get_cmap(cmap), vmin=0,
                   vmax=max(vmax, 1e-12),
                   origin='lower' if origin == 'bottom_left' else 'upper',
                   interpolation='none')
    ax.set_yticks(centers)
    ax.set_yticklabels(bi.group_names, size=6)
    ax.set_xticks([])
    if border_style == 'grid':
        for edge in edges[:-1]:
            ax.axvline(edge, color='grey', lw=0.3, ls=(0, (5, 5)))
            ax.axhline(edge, color='grey', lw=0.3, ls=(0, (5, 5)))
    else:
        last = -0.5
        for edge in edges:
            for f in (ax.vlines, ax.hlines):
                f([last, edge], last, edge, color='grey', lw=0.4)
            last = edge
    ax.set_title('{} (bin size: {} Kb)'.format(title,
                                               bi.bin_size // 1000),
                 fontsize=8)
    cb = fig.colorbar(im, shrink=0.5)
    cb.set_label({'KR': 'KR normalized counts',
                  'log10': 'Log$_{10}$(counts+1)'}.get(normalization,
                                                       'Counts'),
                 fontsize=7)
    fig.savefig(out_path, bbox_inches='tight')
    plt.close(fig)
    return out_path


def draw_separate_heatmaps(matrix: np.ndarray, bi: BinIndex, vmax: float,
                           outdir: str, **kw) -> List[str]:
    """One heatmap per scaffold (parity: draw_separate_heatmaps,
    :676-715)."""
    os.makedirs(outdir, exist_ok=True)
    starts = np.concatenate([[0], np.cumsum(bi.group_nbins)])
    paths = []
    for t, name in enumerate(bi.group_names):
        s, e = int(starts[t]), int(starts[t + 1])
        sub_bi = BinIndex(agp=bi.agp, bin_size=bi.bin_size,
                          sel_groups=[bi.sel_groups[t]],
                          group_nbins=bi.group_nbins[t:t + 1],
                          group_bin_offset=bi.group_bin_offset,
                          total_bins=e - s)
        p = os.path.join(outdir, '{}.pdf'.format(name))
        draw_heatmap(matrix[s:e, s:e], sub_bi, vmax, p,
                     title='{} contact map'.format(name), **kw)
        paths.append(p)
    return paths


# ---------------- cache + orchestration -----------------------------

def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, 'rb') as f:
        for blk in iter(lambda: f.read(1 << 20), b''):
            h.update(blk)
    return h.hexdigest()


def save_cache(path: str, matrix: np.ndarray, agp: str,
               params: Tuple) -> None:
    with open(path, 'wb') as f:
        pickle.dump((matrix, params, _md5(agp)), f)


def load_cache(path: str, agp: str, params: Tuple) -> Optional[np.ndarray]:
    with open(path, 'rb') as f:
        matrix, old_params, agp_md5 = pickle.load(f)[:3]
    if agp_md5 != _md5(agp):
        raise RuntimeError(
            'The AGP file used to generate {} is different from the '
            'input AGP file {}'.format(path, agp))
    if tuple(old_params) != tuple(params):
        raise RuntimeError(
            'The input parameters are not consistent with those used '
            'to generate {}'.format(path))
    return matrix


@dataclass
class ContactMap:
    """What ``contact_map`` computes: the bin layout, the raw (None
    when read from a cache) and symmetrised int64 matrices and the
    normalised float64 matrix (tensors on the device), vmax, the KR
    vectors, and the seconds and KR iterations it took."""
    bi: BinIndex
    raw: Optional[torch.Tensor]
    matrix: torch.Tensor
    norm: torch.Tensor
    vmax: float
    accumulate_s: float          # reading, binning, scatter-add, cache
    normalize_s: float
    kr_iters: List[Tuple[int, int]]   # (outer, inner) per KR call
    kr_vectors: List[torch.Tensor]    # whole matrix, then each scaffold


def contact_map(agp: str, alignments: str, outdir: str = '.',
                bin_size_kbp: int = 500, min_len_mbp: float = 0,
                specified_scaffolds: Optional[str] = None,
                normalization: str = 'KR', vmax_coef: float = 5.0,
                manual_vmax: float = -1.0, threads: int = 4,
                device=None) -> ContactMap:
    """run_plot's work before drawing: the matrix from the alignments
    (written to ``outdir``/contact_matrix.pkl) or from a .pkl cache,
    then its normalisation, on ``device``."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    bin_size = bin_size_kbp * 1000
    agp_index = parse_agp(agp)
    bi = build_bins(agp_index, bin_size, min_len_mbp,
                    specified_scaffolds.split(',')
                    if specified_scaffolds else None)
    params = (bin_size, min_len_mbp, specified_scaffolds)
    cache = os.path.join(outdir, 'contact_matrix.pkl')

    raw = None
    if alignments.endswith('.pkl'):
        matrix = torch.as_tensor(load_cache(alignments, agp, params),
                                 device=dev)
    else:
        # readers resolve names against a sorted table; remap their ids
        # onto the AGP's contig ids afterwards
        names = sorted(agp_index.ctg_names)
        remap = np.asarray([agp_index.ctg_id[c] for c in names], np.int64)
        if alignments.endswith('.bam'):
            from haphic_tpu_torch.io.bam import BamReader
            reader = BamReader(alignments, names, threads=threads)
        else:
            from haphic_tpu_torch.io.pairs import PairsReader
            reader = PairsReader(alignments, names)

        def remapped():
            from haphic_tpu_torch.io.pairs import AlignChunk
            for c in reader:
                ok = (c.ref >= 0) & (c.mref >= 0)
                yield AlignChunk(ref=remap[c.ref[ok]], pos=c.pos[ok],
                                 mref=remap[c.mref[ok]], mpos=c.mpos[ok])

        raw = accumulate_contacts(bi, remapped(), dev)
        matrix = symmetrize(raw)
        save_cache(cache, matrix.cpu().numpy(), agp, params)
    t1 = time.perf_counter()
    kr_iters: List[Tuple[int, int]] = []
    kr_vectors: List[torch.Tensor] = []
    norm, vmax = normalize_matrix(matrix, bi, normalization, vmax_coef,
                                  manual_vmax, counts=kr_iters,
                                  vectors=kr_vectors)
    t2 = time.perf_counter()
    logger.info('contact map: %d bins on %s, %.3f s accumulate, %.3f s '
                'normalize (%s), KR iterations %s', bi.total_bins, dev,
                t1 - t0, t2 - t1, normalization, kr_iters)
    return ContactMap(bi=bi, raw=raw, matrix=matrix, norm=norm, vmax=vmax,
                      accumulate_s=t1 - t0, normalize_s=t2 - t1,
                      kr_iters=kr_iters, kr_vectors=kr_vectors)


def run_plot(agp: str, alignments: str, outdir: str = '.',
             bin_size_kbp: int = 500, min_len_mbp: float = 0,
             specified_scaffolds: Optional[str] = None,
             normalization: str = 'KR', vmax_coef: float = 5.0,
             manual_vmax: float = -1.0, cmap: str = 'whitered',
             origin: str = 'bottom_left', border_style: str = 'grid',
             separate_plots: bool = False, threads: int = 4,
             out_name: str = 'contact_map.pdf', device=None) -> str:
    cm = contact_map(agp, alignments, outdir=outdir,
                     bin_size_kbp=bin_size_kbp, min_len_mbp=min_len_mbp,
                     specified_scaffolds=specified_scaffolds,
                     normalization=normalization, vmax_coef=vmax_coef,
                     manual_vmax=manual_vmax, threads=threads,
                     device=device)
    norm, bi, vmax = cm.norm.cpu().numpy(), cm.bi, cm.vmax
    out_path = os.path.join(outdir, out_name)
    draw_heatmap(norm, bi, vmax, out_path, cmap=cmap, origin=origin,
                 border_style=border_style, normalization=normalization)
    if separate_plots:
        draw_separate_heatmaps(norm, bi, vmax,
                               os.path.join(outdir, 'separate_plots'),
                               cmap=cmap, origin=origin,
                               border_style=border_style,
                               normalization=normalization)
    return out_path

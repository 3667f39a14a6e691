"""Dependency-free statistics.pdf writer.

The inflation sweep emits one statistics.pdf per inflation directory
(reference: scripts/HapHiC_cluster.py draw_statistics_plots — a 4-panel
matplotlib figure). matplotlib re-renders the ENTIRE figure on every
savefig (~0.3 s each: axes, ticks, text relayout), so 20 inflations cost
~6 s of host CPU at the tail of the cluster stage even with figure reuse
and forked workers (`_statdraw.StatDrawer`, `_ParallelDrawer`).

The figure is, however, 95% static: only the 8 data polylines change
between inflations. This module writes the PDF directly — the static
layer (spines, ticks, labels, titles) is built ONCE as a content-stream
template string, and each save() appends the clipped polylines,
Flate-compresses, and writes the file. Measured ~3 ms per save, so the
render runs inline and the deferred-render machinery is bypassed
entirely.

Layout mirrors `_statdraw.StatDrawer` (8x7 in, 2x2 panels, twin y axes:
blue left = "contigs filtered out (%)" on [0, 50], red right = "length
of remaining contigs (%)" on [90, 100]). Set HAPHIC_STATS_MPL=1 to fall
back to the matplotlib renderer.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

# page: 8 x 7 inches at 72 pt/in (matches StatDrawer figsize)
PAGE_W, PAGE_H = 576.0, 504.0

# (title, xlabel, xmax) — identical to _statdraw.StatDrawer.PANELS
PANELS = [
    ('RE site threshold', 'Number of RE sites', 500),
    ('Hi-C link threshold', 'Number of links to the best group', 500),
    ('Link density threshold', 'Link density to the best group', 0.001),
    ('Link density ratio threshold',
     'Link density ratio (best/average)', 20),
]

Y1_LABEL = 'Number of contigs filtered out (%)'
Y2_LABEL = 'Length of remaining contigs (%)'
Y1_RANGE = (0.0, 50.0)
Y2_RANGE = (90.0, 100.0)

BLUE = '0 0 1'
RED = '1 0 0'
BLACK = '0 0 0'

# approximate Helvetica advance (em fraction) for centering; exact
# metrics are overkill for tick/title placement
_EM = 0.52


def _tw(text: str, size: float) -> float:
    return len(text) * size * _EM


def _fmt(v: float) -> str:
    return '{:g}'.format(round(v, 10))


class _Panel:
    """Static geometry of one subplot cell."""

    def __init__(self, col: int, row: int, title: str, xlabel: str,
                 xmax: float):
        cell_w, cell_h = PAGE_W / 2, PAGE_H / 2
        cx = col * cell_w
        # row 0 = top row (PDF origin is bottom-left)
        cy = (1 - row) * cell_h
        self.x0 = cx + 58.0
        self.x1 = cx + cell_w - 52.0
        self.y0 = cy + 46.0
        self.y1 = cy + cell_h - 26.0
        self.w = self.x1 - self.x0
        self.h = self.y1 - self.y0
        self.title = title
        self.xlabel = xlabel
        self.xmax = float(xmax)

    def sx(self, x):
        return self.x0 + (x / self.xmax) * self.w

    def sy1(self, y):
        lo, hi = Y1_RANGE
        return self.y0 + (y - lo) / (hi - lo) * self.h

    def sy2(self, y):
        lo, hi = Y2_RANGE
        return self.y0 + (y - lo) / (hi - lo) * self.h

    def static_content(self) -> str:
        c = []
        t = c.append
        # frame
        t('0.8 w {} RG'.format(BLACK))
        t('{:.2f} {:.2f} {:.2f} {:.2f} re S'.format(
            self.x0, self.y0, self.w, self.h))
        # x ticks: 6 evenly spaced values, black
        t('0.6 w')
        for n in range(6):
            xv = self.xmax * n / 5.0
            px = self.sx(xv)
            t('{:.2f} {:.2f} m {:.2f} {:.2f} l S'.format(
                px, self.y0, px, self.y0 - 3.5))
            lab = _fmt(xv)
            t(_text(px - _tw(lab, 8) / 2, self.y0 - 13, lab, 8, BLACK))
        # left y ticks (blue): 0..50 step 10
        for n in range(6):
            yv = Y1_RANGE[0] + n * 10.0
            py = self.sy1(yv)
            t('{:.2f} {:.2f} m {:.2f} {:.2f} l S'.format(
                self.x0, py, self.x0 - 3.5, py))
            lab = _fmt(yv)
            t(_text(self.x0 - 6 - _tw(lab, 8), py - 2.8, lab, 8, BLUE))
        # right y ticks (red): 90..100 step 2
        for n in range(6):
            yv = Y2_RANGE[0] + n * 2.0
            py = self.sy2(yv)
            t('{:.2f} {:.2f} m {:.2f} {:.2f} l S'.format(
                self.x1, py, self.x1 + 3.5, py))
            lab = _fmt(yv)
            t(_text(self.x1 + 6, py - 2.8, lab, 8, RED))
        # title / xlabel
        xc = (self.x0 + self.x1) / 2
        t(_text(xc - _tw(self.title, 11) / 2, self.y1 + 8,
                self.title, 11, BLACK))
        t(_text(xc - _tw(self.xlabel, 9) / 2, self.y0 - 28,
                self.xlabel, 9, BLACK))
        # rotated axis labels
        yc = (self.y0 + self.y1) / 2
        t(_vtext(self.x0 - 36, yc - _tw(Y1_LABEL, 8) / 2,
                 Y1_LABEL, 8, BLUE))
        t(_vtext(self.x1 + 38, yc - _tw(Y2_LABEL, 8) / 2,
                 Y2_LABEL, 8, RED))
        return '\n'.join(c)

    def polyline(self, xs, ys, to_y, color: str) -> str:
        """Clipped stroked path for one curve. Coordinates are emitted
        as integers in a 100x-scaled user space (`0.01 ... cm`): numpy
        rounds the whole array at once and int formatting is ~5x
        cheaper than float, which matters at 20 figures x 8 curves x
        thousands of points."""
        if len(xs) == 0:
            return ''
        # values can sit far outside the axes (the ratio panel emits
        # 1e6 sentinels); clamp to one page-size beyond the clip box so
        # coordinates stay small for PDF viewers. Clamping a far-out
        # point changes the slope of the segment crossing the clip
        # edge, shifting the visible crossing by at most
        # dy * box_width / clamp_distance — sub-point at these
        # magnitudes, not exact segment clipping
        px = np.clip(np.rint(self.sx(np.asarray(xs, dtype=np.float64))
                             * 100.0), -100 * PAGE_W,
                     200 * PAGE_W).astype(np.int64)
        py = np.clip(np.rint(to_y(np.asarray(ys, dtype=np.float64))
                             * 100.0), -100 * PAGE_H,
                     200 * PAGE_H).astype(np.int64)
        it = iter(zip(px.tolist(), py.tolist()))
        x0, y0 = next(it)
        pts = '{} {} m\n'.format(x0, y0) + '\n'.join(
            '{} {} l'.format(x, y) for x, y in it)
        return ('q {:.2f} {:.2f} {:.2f} {:.2f} re W n '
                '{} RG 1 w 1 j 1 J 0.01 0 0 0.01 0 0 cm 100 w\n'
                '{}\nS Q'.format(self.x0, self.y0, self.w, self.h,
                                 color, pts))


def _esc(s: str) -> str:
    return s.replace('\\', r'\\').replace('(', r'\(').replace(')', r'\)')


def _text(x: float, y: float, s: str, size: float, color: str) -> str:
    return 'BT /F1 {:g} Tf {} rg {:.2f} {:.2f} Td ({}) Tj ET'.format(
        size, color, x, y, _esc(s))


def _vtext(x: float, y: float, s: str, size: float, color: str) -> str:
    """Text rotated 90 deg CCW, baseline starting at (x, y)."""
    return ('BT /F1 {:g} Tf {} rg 0 1 -1 0 {:.2f} {:.2f} Tm '
            '({}) Tj ET'.format(size, color, x, y, _esc(s)))


class FastStatDrawer:
    """Drop-in for `_statdraw.StatDrawer`: save(outdir, panel_data)
    with panel_data = [(x, y1, y2)] * 4. Renders inline (~3 ms)."""

    def __init__(self):
        self._panels = [
            _Panel(n % 2, n // 2, title, xlabel, xmax)
            for n, (title, xlabel, xmax) in enumerate(PANELS)]
        self._static = '\n'.join(p.static_content()
                                 for p in self._panels)

    def save(self, outdir, panel_data) -> None:
        dyn = []
        for p, (x, y1, y2) in zip(self._panels, panel_data):
            dyn.append(p.polyline(x, y1, p.sy1, BLUE))
            dyn.append(p.polyline(x, y2, p.sy2, RED))
        content = (self._static + '\n' + '\n'.join(dyn)).encode('latin-1')
        path = os.path.join(outdir, 'statistics.pdf')
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            f.write(_document(content))
        os.replace(tmp, path)

    def close(self) -> None:
        pass


def _document(content: bytes) -> bytes:
    """Assemble a single-page PDF around a Flate-compressed content
    stream."""
    z = zlib.compress(content, 6)
    objs = [
        b'<</Type/Catalog/Pages 2 0 R>>',
        b'<</Type/Pages/Kids[3 0 R]/Count 1>>',
        ('<</Type/Page/Parent 2 0 R/MediaBox[0 0 {:g} {:g}]'
         '/Resources<</Font<</F1 4 0 R>>>>/Contents 5 0 R>>'
         .format(PAGE_W, PAGE_H)).encode(),
        b'<</Type/Font/Subtype/Type1/BaseFont/Helvetica>>',
        ('<</Length {}/Filter/FlateDecode>>'.format(len(z))).encode(),
    ]
    out = bytearray(b'%PDF-1.4\n')
    offsets = []
    for n, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += '{} 0 obj\n'.format(n).encode() + body
        if n == 5:
            out += b'\nstream\n' + z + b'\nendstream'
        out += b'\nendobj\n'
    xref = len(out)
    out += 'xref\n0 {}\n'.format(len(objs) + 1).encode()
    out += b'0000000000 65535 f \n'
    for off in offsets:
        out += '{:010d} 00000 n \n'.format(off).encode()
    out += ('trailer\n<</Size {}/Root 1 0 R>>\nstartxref\n{}\n%%EOF\n'
            .format(len(objs) + 1, xref)).encode()
    return bytes(out)

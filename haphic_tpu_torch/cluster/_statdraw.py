"""statistics.pdf rendering, import-light on purpose: the parallel
renderer spawns worker processes that import ONLY this module (and
matplotlib), not the haphic_tpu_torch package with its torch dependency —
worker startup is ~0.7 s instead of ~3 s."""

from __future__ import annotations

import os


class StatDrawer:
    """One reusable 4-panel figure: building matplotlib axes is ~10x
    the cost of setting line data + savefig, and the inflation sweep
    writes up to 20 statistics.pdf files with identical layout (only
    the curves change; axis limits are fixed)."""

    PANELS = [
        ('RE site threshold', 'Number of RE sites', 500),
        ('Hi-C link threshold', 'Number of links to the best group', 500),
        ('Link density threshold', 'Link density to the best group',
         0.001),
        ('Link density ratio threshold',
         'Link density ratio (best/average)', 20),
    ]

    def __init__(self):
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        self._plt = plt
        self.fig = plt.figure(figsize=(8, 7))
        self.lines = []
        for n, (title, xlabel, xmax) in enumerate(self.PANELS, 1):
            ax1 = self.fig.add_subplot(2, 2, n)
            l1, = ax1.plot([], [], 'b')
            ax1.tick_params(axis='y', colors='b')
            ax1.set_xlim([0, xmax])
            ax1.set_ylim([0, 50])
            ax1.set_ylabel('Number of contigs filtered out (%)',
                           color='b')
            ax1.set_title(title)
            ax1.set_xlabel(xlabel)
            ax2 = ax1.twinx()
            l2, = ax2.plot([], [], 'r')
            ax2.tick_params(axis='y', colors='r')
            ax2.set_ylim([90, 100])
            ax2.set_ylabel('Length of remaining contigs (%)', color='r')
            self.lines.append((l1, l2))
        self.fig.tight_layout(w_pad=1, h_pad=1)

    def save(self, outdir, panel_data) -> None:
        for (l1, l2), (x, y1, y2) in zip(self.lines, panel_data):
            l1.set_data(x, y1)
            l2.set_data(x, y2)
        self.fig.savefig(os.path.join(outdir, 'statistics.pdf'))

    def close(self) -> None:
        self._plt.close(self.fig)


_WORKER_DRAWER = None


def render_one(args) -> None:
    """Process-pool worker: render one statistics.pdf (reuses a
    per-process figure)."""
    global _WORKER_DRAWER
    outdir, panel_data = args
    if _WORKER_DRAWER is None:
        _WORKER_DRAWER = StatDrawer()
    _WORKER_DRAWER.save(outdir, panel_data)

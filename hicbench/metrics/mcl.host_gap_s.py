"""mcl.host_gap_s: device-clock seconds a sweep inside the program's
device span ``mcl.sweep`` that lie in none of its device spans
``mcl.densify``, ``mcl.pre_expand``, ``mcl.batch`` or ``mcl.pattern``:
the card's idle while the host works between batches (interpreting a
batch, or anything else), whatever that work is. On a card; None where
the program has no such spans."""

import torch

BUSY = ('mcl.densify', 'mcl.pre_expand', 'mcl.batch', 'mcl.pattern')


def _trace():
    try:
        from haphic_tpu_torch import trace
    except ImportError:
        return None
    return trace


def install(probe):
    t = _trace()
    if t is not None:
        t.reset()
        t.enable()


def gap_seconds(outer, inner):
    """Σ over the ``outer`` intervals of their length less the part
    that the union of the ``inner`` intervals covers."""
    total = 0.0
    for lo, hi in outer:
        cut = sorted((max(s, lo), min(e, hi)) for s, e in inner
                     if e > lo and s < hi)
        covered, cur = 0.0, lo
        for s, e in cut:
            if e > cur:
                covered += e - max(s, cur)
                cur = e
        total += (hi - lo) - covered
    return total


def read(probe, stage, outputs, profiled):
    t = _trace()
    if t is None or torch.device(stage.device).type != 'cuda' or \
            not probe.units:
        return None
    sweeps = t.device_intervals('mcl.sweep')
    if not sweeps:
        return None
    busy = [iv for name in BUSY for iv in t.device_intervals(name)]
    return gap_seconds(sweeps, busy) / probe.units

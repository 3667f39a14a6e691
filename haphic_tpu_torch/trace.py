"""In-memory spans of the port, off by default.

A span is a named interval of the program's work:

- ``span(name, **attrs)``, on the host's clock: ``time.perf_counter_ns``
  at entry and exit, inside a profiler range of that name, so that the
  span lies on a profiler's timeline beside the device's operations.
  The range has function scope (``_RecordFunctionFast``): the user scope
  of ``torch.profiler.record_function`` would also draw it on the
  device's timeline, over the device work launched inside it, where a
  reader of the device's busy time would count it as work.
  ``span(name, device=dev, ...)`` on a CUDA device also takes the
  device's clock, as ``device_span`` does.
- ``device_span(name, device, **attrs)``, on the device's clock: a pair
  of CUDA events (``enable_timing``) recorded on the device's current
  stream around the block, with no host sync. On any other device it
  records nothing.

Each record keeps ``parent``, the innermost span open when it began, and
``root``, the outermost: the spans under one root are one call of the
program's outermost traced function. ``attrs`` keep the call's shape.

Off (the default), ``span`` and ``device_span`` return one shared
context manager that does nothing: no clock, no CUDA event, no profiler
range. Records stay in memory until ``reset``; ``host_seconds``,
``device_seconds`` and ``device_intervals`` read them (the last two wait
for the spans' end events). Only a measurement turns tracing on.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch


class Record:
    """One finished span. ``start``/``end``: host ns (None for a
    device-only span); ``events``: the CUDA events (None off the card)."""

    __slots__ = ('id', 'name', 'parent', 'root', 'attrs', 'start', 'end',
                 'events')

    def __init__(self, id_: int, name: str, parent: Optional[int],
                 root: int, attrs: Dict):
        self.id, self.name, self.parent, self.root = id_, name, parent, root
        self.attrs, self.start, self.end, self.events = attrs, None, None, None


_on = False
_records: List[Record] = []
_open: List[Record] = []
_anchor: List[torch.cuda.Event] = []      # the device clock's zero, once
_ids = itertools.count()


_OFF = contextlib.nullcontext()            # reusable, does nothing


class _Span:
    __slots__ = ('name', 'attrs', 'host', 'stream', 'rec', 'range')

    def __init__(self, name, attrs, host, stream):
        self.name, self.attrs, self.host, self.stream = \
            name, attrs, host, stream

    def __enter__(self):
        up = _open[-1] if _open else None
        i = next(_ids)
        rec = self.rec = Record(i, self.name, None if up is None else up.id,
                                i if up is None else up.root, self.attrs)
        if self.stream is not None:
            if not _anchor:
                _anchor.append(_event(self.stream))
            rec.events = (_event(self.stream), None)
        if self.host:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
            rec.start = time.perf_counter_ns()
        _open.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.host:
            rec.end = time.perf_counter_ns()
            self.range.__exit__(*exc)
        if self.stream is not None:
            rec.events = (rec.events[0], _event(self.stream))
        # a generator left open can close after spans opened later
        for k in range(len(_open) - 1, -1, -1):
            if _open[k] is rec:
                del _open[k]
                break
        _records.append(rec)
        return False


def _event(stream) -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


def _stream(device):
    if device is None:
        return None
    dev = torch.device(device)
    return torch.cuda.current_stream(dev) if dev.type == 'cuda' else None


def enable(on: bool = True):
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset():
    """Drop every record (and the device clock's zero); open spans stay
    open and are recorded when they close."""
    _records.clear()
    _anchor.clear()


def records() -> List[Record]:
    return list(_records)


def span(name: str, device=None, **attrs):
    """A host span; with a CUDA ``device``, also a device span."""
    if not _on:
        return _OFF
    return _Span(name, attrs, True, _stream(device))


def device_span(name: str, device, **attrs):
    """A device span: CUDA events around the block, no host sync."""
    if not _on:
        return _OFF
    stream = _stream(device)
    return _OFF if stream is None else _Span(name, attrs, False, stream)


def host_seconds(name: str) -> float:
    return sum(r.end - r.start for r in _records
               if r.name == name and r.start is not None) / 1e9


def _timed(name: str):
    got = [r.events for r in _records if r.name == name and r.events]
    for _, e1 in got:
        e1.synchronize()
    return got


def device_seconds(name: str) -> float:
    return sum(e0.elapsed_time(e1) for e0, e1 in _timed(name)) / 1e3


def device_intervals(name: str) -> List[Tuple[float, float]]:
    """(start, end) of each device span, in seconds after the zero of
    the device clock (recorded at the first device span after
    ``reset``), so that every device span lies on one clock."""
    got = _timed(name)
    if not got:
        return []
    zero = _anchor[0]
    return [(zero.elapsed_time(e0) / 1e3, zero.elapsed_time(e1) / 1e3)
            for e0, e1 in got]

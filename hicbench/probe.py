"""What a ``--trace 1`` run records around the program, from the
benchmark's own files: host spans and CUDA-event times of wrapped
program functions, and one unit under torch.profiler.

Per-layer metric readers (``metrics/<name>.py``) ask for what they read
in ``install(probe)``; the wrappers live only for the window, and the
program is called exactly as in an untraced run.

The profiler's filter of device events is a copy of
``haphic_tpu_torch/kernels/profiling.py`` ``kernel_events`` (commit
2773cb2), widened to memory copies and sets, which are device time too.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

import torch

from hicbench import peaks

NAME = 160          # characters kept of a kernel's (templated) name


class Probe:
    def __init__(self):
        self.units = 0
        self.unit = 0
        self.spans: Dict[str, List[float]] = {}
        self.calls: Dict[str, list] = {}
        self._patches = []
        self._installed = set()

    # ---- wrapping ----

    def _patch(self, module, attr: str, wrapper):
        orig = getattr(module, attr)
        self._patches.append((module, attr, orig))
        setattr(module, attr, wrapper(orig))

    def span(self, module, attr: str, key: str):
        """Host seconds of every call of ``module.attr`` under ``key``."""
        if ('span', key) in self._installed:
            return
        self._installed.add(('span', key))
        out = self.spans.setdefault(key, [])

        def wrapper(fn):
            @functools.wraps(fn)
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                with torch.profiler.record_function('hicbench.' + key):
                    r = fn(*args, **kwargs)
                out.append(time.perf_counter() - t0)
                return r
            return timed
        self._patch(module, attr, wrapper)

    def time_calls(self, module, attr: str, key: str, cost: Callable):
        """CUDA events around every call of ``module.attr`` (on the
        current stream, no host sync), with ``cost(*args, **kwargs)`` ->
        (bytes, operations, peak) of the call."""
        if ('time', key) in self._installed or \
                not torch.cuda.is_available():
            return
        self._installed.add(('time', key))
        out = self.calls.setdefault(key, [])

        def wrapper(fn):
            @functools.wraps(fn)
            def timed(*args, **kwargs):
                c = cost(*args, **kwargs)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                r = fn(*args, **kwargs)
                e1.record()
                out.append((e0, e1, c))
                return r
            return timed
        self._patch(module, attr, wrapper)

    def count_calls(self, module, attr: str, key: str, cost: Callable):
        """``cost(*args, **kwargs)`` -> (bytes, operations, peak) of
        every call of ``module.attr``, with the unit it fell in (the
        harness sets ``unit``); no event, no sync: the time is read
        from the traced unit's device operations (``kernel_roofline``)."""
        if ('count', key) in self._installed:
            return
        self._installed.add(('count', key))
        out = self.calls.setdefault(key, [])

        def wrapper(fn):
            @functools.wraps(fn)
            def counted(*args, **kwargs):
                out.append((self.unit, cost(*args, **kwargs)))
                return fn(*args, **kwargs)
            return counted
        self._patch(module, attr, wrapper)

    def restore(self):
        for module, attr, orig in reversed(self._patches):
            setattr(module, attr, orig)
        self._patches = []

    # ---- reading ----

    def span_total(self, key: str) -> Optional[float]:
        got = self.spans.get(key)
        return sum(got) if got else None

    def roofline(self, key: str) -> Optional[float]:
        """100 x (the least time of the recorded calls) / (their
        CUDA-event time): a share of the kernel's roofline, in %."""
        got = self.calls.get(key)
        if not got:
            return None
        torch.cuda.synchronize()
        t = sum(e0.elapsed_time(e1) for e0, e1, _ in got) / 1e3
        least = sum(peaks.bound_s(float(b), float(o), p)
                    for _, _, (b, o, p) in got)
        return 100.0 * least / t if t > 0 else None


    def kernel_roofline(self, key: str, profiled: Optional[dict],
                        kernel: str) -> Optional[float]:
        """100 x (the least time of the traced unit's ``count_calls``
        under ``key``) / (the device time of the operations named
        ``kernel(...)`` or ``kernel<...>(...)`` in that unit's trace), in
        %: the kernel's own time, without the host's launch or its
        wrapper's checks."""
        got = [c for u, c in self.calls.get(key, []) if u == 0]
        if not got or profiled is None:
            return None
        t = sum(s for name, s in profiled['kernels'].items()
                if name.split('(')[0].split('<')[0].split(' ')[-1] == kernel)
        least = sum(peaks.bound_s(float(b), float(o), p)
                    for b, o, p in got)
        return 100.0 * least / t if t > 0 else None


def profile_unit(fn):
    """Run ``fn()`` once under torch.profiler. Returns (its result, a
    function that reads the trace): read after the window, it gives a
    dict with busy_s, window_s, kernels, device_ops, idle_gaps: the
    union of the device's operations, the unit's length, each device
    operation's seconds by name, the ten device operations with most
    time and the ten longest idle gaps, each named by the
    innermost host event (a benchmark span or a torch op) running at its
    middle, 'python' where none is. The reader takes the profiler's raw
    events, not its parsed tree, which takes minutes to build for a
    unit of a million events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('hicbench.unit'):
            r = fn()
            torch.cuda.synchronize()
    return r, lambda: _read_trace(prof.profiler.kineto_results.events())


def _read_trace(events) -> dict:
    """The dict of ``profile_unit`` from raw profiler events (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``)."""
    dev, host, unit = [], [], None
    for e in events:
        name = e.name()
        s = e.start_ns()
        span = (s, s + e.duration_ns(), name)
        if getattr(e.device_type(), 'name', '') == 'CUDA':
            # the benchmark's own spans show on the device's timeline too
            if not name.startswith('hicbench.'):
                dev.append(span)
        elif name == 'hicbench.unit':
            unit = span
        else:
            host.append(span)
    lo, hi = unit[0], unit[1]
    dev.sort()
    by_name: Dict[str, float] = {}
    busy, gaps, cur = 0, [], lo
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
        s, e = max(s, lo), min(e, hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((s - cur, cur, s))
        busy += e - max(s, cur)
        cur = e
    if hi > cur:
        gaps.append((hi - cur, cur, hi))
    gaps.sort(reverse=True)
    named = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = max(inner)[2] if inner else 'python'
        named.append([name[:NAME], length / 1e9])
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return {'busy_s': busy / 1e9, 'window_s': (hi - lo) / 1e9,
            'kernels': {n: t / 1e9 for n, t in by_name.items()},
            'device_ops': [[n[:NAME], t / 1e9] for n, t in ops],
            'idle_gaps': named}

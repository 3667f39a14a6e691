"""The device kernels that torch.profiler records for a few calls of a
function: one helper for the smoke, the card tests and the A/B tools.

On an H100 the profiler's CUDA trace recorded every launch of every
window in a fresh process (tools/profiler_capture.py), but 9 of 10 in
every window late in the smoke's long process, and once none of 3; the
cause is not known. So a launch count is proven by the wrappers'
counters, and ``one_kernel_a_call`` takes a window that recorded too
few kernels again.
"""

from __future__ import annotations

import torch


def kernel_events(fn, calls: int):
    """[(name, start us, end us)] of the device kernels that the profiler
    records over ``calls`` calls of ``fn`` (after one call to warm up),
    in start order; memory copies and sets are left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if getattr(e.device_type, 'name', '') == 'CUDA'
              and 'memcpy' not in e.name.lower()
              and 'memset' not in e.name.lower()]
    return sorted(events, key=lambda e: e[1])


def check_kernels(events, calls: int, name: str):
    """Raises RuntimeError where ``events`` (kernel_events of ``calls``
    calls) hold more than one kernel a call or a kernel not named
    ``name``."""
    names = sorted({e[0] for e in events})
    if len(events) > calls or not all(name in n for n in names):
        raise RuntimeError('{} calls ran {} device kernels, want one {} a '
                           'call: {}'.format(calls, len(events), name, names))


def device_ms(events) -> float:
    """The mean device ms of the kernels of ``events``."""
    return sum(e[2] - e[1] for e in events) / 1e3 / len(events)


def one_kernel_a_call(fn, calls: int, name: str, windows: int = 3) -> float:
    """The mean device ms of ``fn``'s kernel, after checking that the
    profiler recorded one kernel a call, each one named ``name``, over
    ``calls`` calls. A window that recorded fewer is taken again, up to
    ``windows`` windows; one that recorded more, or another kernel,
    fails at once. Raises RuntimeError if no window recorded one kernel
    a call."""
    counts = []
    for _ in range(windows):
        events = kernel_events(fn, calls)
        check_kernels(events, calls, name)
        if len(events) == calls:
            return device_ms(events)
        counts.append(len(events))
    raise RuntimeError('the profiler recorded {} {} kernels in {} windows '
                       'of {} calls each'.format(counts, name, windows,
                                                 calls))

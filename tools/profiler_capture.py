#!/usr/bin/env python3
"""How many of a few kernel launches torch.profiler records, in a fresh
process and after a profile that also traced the host.

    python3 tools/profiler_capture.py [--windows 10] [--calls 10]

rescore_population in scores mode at the dense pipeline's largest GA
batch (about 0.3 ms a launch) is launched ``--calls`` times in each of
``--windows`` profiler windows, under three conditions taken in this
order in one process:

  fresh            CUDA activity only, nothing profiled before;
  after_host       CUDA activity only, after one profile of CPU and CUDA
                   activity (as the smoke's dense step takes before the
                   rescoring);
  host_and_device  the window tracing CPU and CUDA.

Prints one JSON line per condition: the rescoring kernels each window
recorded and the names of any other kernel. Then runs kernelkit.py's
one_kernel_a_call as the card test does and prints what it returns or
raises.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from haphic_tpu_torch.kernels import rescore as krs  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ab_rescore  # noqa: E402
import kernelkit as kit  # noqa: E402

NAME = 'rescore_kernel'


def window(fn, calls, host=False):
    """The names of the device kernels of one window."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if getattr(e.device_type, 'name', '') == 'CUDA'
            and 'memcpy' not in e.name.lower()
            and 'memset' not in e.name.lower()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--windows', type=int, default=10)
    ap.add_argument('--calls', type=int, default=10)
    args = ap.parse_args(argv)
    rs = ab_rescore.inputs(torch, **ab_rescore.SHAPE)

    def fn():
        return krs.rescore(*rs, caches=False)
    fn()
    torch.cuda.synchronize()
    for cond in ('fresh', 'after_host', 'host_and_device'):
        if cond == 'after_host':
            a = torch.randn(1000, 1000, device='cuda')
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                (a @ a).sum().item()
        wins = [window(fn, args.calls, host=cond == 'host_and_device')
                for _ in range(args.windows)]
        print(json.dumps({
            'condition': cond, 'calls': args.calls,
            'recorded': [sum(NAME in n for n in w) for w in wins],
            'other_kernels': sorted({n[:60] for w in wins for n in w
                                     if NAME not in n}),
            'device': torch.cuda.get_device_name(0)}), flush=True)
    try:
        ms = kit.one_kernel_a_call(fn, args.calls, NAME)
        print(json.dumps({'one_kernel_a_call_ms': ms}), flush=True)
    except RuntimeError as e:
        print(json.dumps({'one_kernel_a_call_error': str(e)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""mcl.pattern_s: host seconds a sweep in the program's span
``mcl.pattern``: each batch's nonzero pattern, its copy to the host and
the copies of n_iters and converged, the wait for the batch's last
iterations included. On a card; None where the program has no such
span."""

import torch


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


def read(probe, stage, outputs, profiled):
    t = _trace()
    if t is None or torch.device(stage.device).type != 'cuda' or \
            not probe.units or not any(r.name == 'mcl.pattern'
                                       for r in t.records()):
        return None
    return t.host_seconds('mcl.pattern') / probe.units

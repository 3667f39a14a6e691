"""mcl.expand_s: device seconds a sweep in the dense engine's expansion,
the program's device span ``mcl.expand`` (every ``_matpower`` call: the
pre-expansion and each iteration's), on a card. None where the program
has no such span."""

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
            not probe.units or not t.device_intervals('mcl.expand'):
        return None
    return t.device_seconds('mcl.expand') / probe.units

"""mcl.syncs: the dense engine's host waits for the card a sweep, the
program's counter ``run_mcl_partitions.syncs`` (each copy between host
and card, each boolean-mask index of a tensor) over the window. On a
card; None where the program has no such counter."""

import torch

_at_install = []


def _counter():
    from haphic_tpu_torch.cluster import mcl
    return getattr(mcl.run_mcl_partitions, 'syncs', None)


def install(probe):
    _at_install[:] = [_counter()]


def read(probe, stage, outputs, profiled):
    now = _counter()
    if now is None or not _at_install or _at_install[0] is None or \
            torch.device(stage.device).type != 'cuda' or not probe.units:
        return None
    return (now - _at_install[0]) / probe.units

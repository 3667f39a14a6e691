"""mcl.interpret_s: host seconds a sweep in the program's span
``mcl.interpret``: each batch's partitions made on the host, from the
card's labels (``partition_from_labels``) on a card, from the final
matrices (``interpret_result``) on the CPU. None where the program has
no such span."""


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
    if t is None or not probe.units or not any(
            r.name == 'mcl.interpret' for r in t.records()):
        return None
    return t.host_seconds('mcl.interpret') / probe.units

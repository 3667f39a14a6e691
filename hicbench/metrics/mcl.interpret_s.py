"""mcl.interpret_s: host seconds a sweep in the dense engine's
interpret_result (the partitions made from each final matrix's nonzero
pattern), a benchmark span around every call."""


def install(probe):
    from haphic_tpu_torch.cluster import mcl
    probe.span(mcl, 'interpret_result', 'interpret_result')


def read(probe, stage, outputs, profiled):
    total = probe.span_total('interpret_result')
    return None if total is None else total / probe.units

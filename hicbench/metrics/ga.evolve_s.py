"""ga.evolve_s: host seconds a unit in the batched GA,
``optimize.optimize_tours`` (every batch's records to the card, the
evolution and the results back to the host), a benchmark span around
every call."""


def install(probe):
    from haphic_tpu_torch.order import optimize
    probe.span(optimize, 'optimize_tours', 'ga.evolve')


def read(probe, stage, outputs, profiled):
    total = probe.span_total('ga.evolve')
    return None if total is None else total / probe.units

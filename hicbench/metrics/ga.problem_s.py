"""ga.problem_s: host seconds a unit in the GA's problem build,
``optimize.group_problem`` (each group's records selected from the
whole CLM, relabelled and collapsed by ``build_problem``), a benchmark
span around every call."""


def install(probe):
    from haphic_tpu_torch.order import optimize
    probe.span(optimize, 'group_problem', 'ga.problem')


def read(probe, stage, outputs, profiled):
    total = probe.span_total('ga.problem')
    return None if total is None else total / probe.units

"""sparse.sweep_s: the program's own seconds a unit in
``run_mcl_sparse``, ``sweep_s`` of its sparse sweep record: the links'
ELL on the host, the pre-expansion, the batched sweep on the card and
the final iterates fetched."""


def read(probe, stage, outputs, profiled):
    return sum(o.sparse['sweep_s'] for o in outputs) / len(outputs)

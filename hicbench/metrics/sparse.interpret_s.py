"""sparse.interpret_s: the program's own seconds a unit in
``SparseMCLResult.interpret`` over every inflation (the host's scipy
rows of each attractor), ``interpret_s`` of its sparse sweep record."""


def read(probe, stage, outputs, profiled):
    return sum(o.sparse['interpret_s'] for o in outputs) / len(outputs)

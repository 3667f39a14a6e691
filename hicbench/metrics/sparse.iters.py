"""sparse.iters: the sparse engine's iterations a unit, the sum over the
inflations of the n_iters in the program's sparse sweep record (a count
the program makes and logs)."""


def read(probe, stage, outputs, profiled):
    return sum(sum(o.sparse['n_iters']) for o in outputs) / len(outputs)

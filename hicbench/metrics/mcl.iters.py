"""mcl.iters: the dense engine's iterations a sweep, the sum over the
inflations of the n_iters that run_mcl_partitions returns (a count the
program makes)."""


def read(probe, stage, outputs, profiled):
    return sum(int(o[1].sum()) for o in outputs) / len(outputs)

"""idle.cluster_sets: the share of the first run_clustering unit of the
window, traced by torch.profiler, in which no operation ran on the
device, in %."""


def read(probe, stage, outputs, profiled):
    if profiled is None or profiled['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - profiled['busy_s'] / profiled['window_s'])

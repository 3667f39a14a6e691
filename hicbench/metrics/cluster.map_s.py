"""cluster.map_s: the program's own seconds a unit in
``_clusters_to_ctgs`` over the output inflations (fragments to contigs
on the host), ``cluster_map_s`` of its cluster-set record."""


def read(probe, stage, outputs, profiled):
    return sum(o.sets['cluster_map_s'] for o in outputs) / len(outputs)

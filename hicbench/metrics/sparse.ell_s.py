"""sparse.ell_s: host seconds a unit in ``sparse_mcl.coo_to_ell`` (the
links' COO to the column-normalised top-K ELL, numpy on the host,
inside ``sweep_s``), a benchmark span around every call."""


def install(probe):
    from haphic_tpu_torch.cluster import sparse_mcl
    probe.span(sparse_mcl, 'coo_to_ell', 'sparse.ell')


def read(probe, stage, outputs, profiled):
    total = probe.span_total('sparse.ell')
    return None if total is None else total / probe.units

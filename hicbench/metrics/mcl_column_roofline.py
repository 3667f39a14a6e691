"""mcl_column_roofline: the dense column kernel (kernels/mcl_column.py)
against its bytes at 3.35 TB/s, by CUDA events around every call."""

from hicbench import peaks


def install(probe):
    from haphic_tpu_torch.cluster import mcl
    probe.time_calls(mcl, 'mcl_column', 'mcl_column', peaks.mcl_column_cost)


def read(probe, stage, outputs, profiled):
    return probe.roofline('mcl_column')

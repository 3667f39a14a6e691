"""gemm_roofline: the dense expansion's FP32 matrix products (cuBLAS
through torch.matmul in the engine's _matpower, the pre-expansion and
every active inflation-iteration) against 67 TFLOP/s, by CUDA events
around every call."""

from hicbench import peaks


def install(probe):
    from haphic_tpu_torch.cluster import mcl
    probe.time_calls(mcl, '_matpower', 'gemm', peaks.gemm_cost)


def read(probe, stage, outputs, profiled):
    return probe.roofline('gemm')

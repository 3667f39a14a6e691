"""rescore_roofline: the GA cycle's rescoring kernel
(kernels/rescore.py, every ``rescore`` call the GA makes: the parents'
and the offspring's scores, the selected population's caches) against
its bound, the larger of its bytes at 3.35 TB/s and its FP32 operations
at 67 TFLOP/s, by CUDA events around every call."""

from hicbench import peaks


def install(probe):
    from haphic_tpu_torch.order import optimize
    probe.time_calls(optimize, 'rescore', 'rescore', peaks.rescore_cost)


def read(probe, stage, outputs, profiled):
    return probe.roofline('rescore')

"""col_allclose_roofline: the sparse convergence statistic's kernel
(kernels/col_allclose.py, one launch a sweep step) against its bound,
the larger of the column pairs' bytes read once at 3.35 TB/s and the
union merge's FP32 operations at 67 TFLOP/s (``peaks.col_allclose_cost``
of every launch, ``kernels.col_allclose._launch``, in the traced unit),
over the device time of ``col_allclose_kernel`` in that unit's trace:
the kernel alone, not the host's launch."""

from hicbench import peaks


def install(probe):
    from haphic_tpu_torch.kernels import col_allclose
    probe.count_calls(col_allclose, '_launch', 'col_allclose',
                      peaks.col_allclose_cost)


def read(probe, stage, outputs, profiled):
    return probe.kernel_roofline('col_allclose', profiled,
                                 'col_allclose_kernel')

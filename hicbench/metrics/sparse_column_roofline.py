"""sparse_column_roofline: the sparse column kernel
(kernels/sparse_column.py) against its bound, the larger of its
columns' bytes read once and written once at 3.35 TB/s and its FP32
products at 67 TFLOP/s (``peaks.sparse_column_cost`` of every launch,
``kernels.sparse_column._launch``, in the traced unit), over the device
time of ``sparse_column_kernel`` in that unit's trace: the kernel alone,
not its wrapper's ELL-order check or the host's launch."""

from hicbench import peaks


def install(probe):
    from haphic_tpu_torch.kernels import sparse_column
    probe.count_calls(sparse_column, '_launch', 'sparse_column',
                      lambda fns, *a, **k: peaks.sparse_column_cost(*a, **k))


def read(probe, stage, outputs, profiled):
    return probe.kernel_roofline('sparse_column', profiled,
                                 'sparse_column_kernel')

"""haphic_tpu_torch — the PyTorch/CUDA port of haphic_tpu.

A HapHiC-compatible Hi-C scaffolder for NVIDIA Hopper cards. It keeps
the layout and the on-disk contract of haphic_tpu (the JAX reference
package beside it) and runs the same four stages:

io        FASTA/pairs/BAM parsing and on-disk format writers
core      fragment statistics, link aggregation, filtering
cluster   Markov clustering sweeps on the card (torch): dense, and
          sparse top-K past SPARSE_MIN_N fragments
assign    reassignment/rescue + average-linkage group merge (scipy)
order     fast sort + tour optimizer (torch GA, CUDA tour-score kernel)
build     final scaffold FASTA/AGP emission
kernels   hand-written CUDA kernels, built with nvcc at first use
parallel  one process per card on torch.distributed: rank-sharded
          ingest, MCL sweeps and GA

Entry points take ``device`` and default to "cuda"; asking for CUDA on
a host without a card raises (see runtime.resolve_device).
"""

from haphic_tpu_torch._version import __version__, __update_time__
from haphic_tpu_torch.runtime import resolve_device

__all__ = ['__version__', '__update_time__', 'resolve_device']

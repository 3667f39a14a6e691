"""Cluster labels of the dense MCL sweep's final matrices: the CUDA
kernel's wrapper and its plain torch version.

Counterpart of the JAX package's ``_pack_nz`` (haphic_tpu/cluster/mcl.py
:283), which packs the final matrices' nonzero pattern for the host,
together with the host's ``interpret_result`` (:376) that reads it.
Shapes:

    m      f32 (B, n, n)   final matrices, contiguous
    -> labels int32 (B, n)

For one matrix, with nz = (m != 0) (-0.0 is zero, NaN nonzero, as numpy
has it) and the attractors the rows a with nz[a, a], the label of column
j is L(j), the least attractor a with nz[a, j]. The matrix is a partition
(``interpret_result`` returns a list) if and only if every column has a
label and nz[a, j] == (L(j) == L(a)) for every attractor a and column j;
the clusters are then the level sets of L. A matrix that is no partition
gets a row of -1. ``cluster.mcl.partition_from_labels`` turns a row into
``interpret_result``'s list.

``mcl_labels`` launches the CUDA kernel (csrc/mcl_interpret.cu) on CUDA
tensors and runs ``mcl_labels_plain``, the same criterion in torch ops
over (B, n, n) temporaries, on CPU tensors; nothing else picks the plain
version. The dense sweep (cluster/mcl.py ``run_mcl_partitions``) reads
every batch's partitions through it on either device.

What bounds it: bytes. The check must read each attractor's row once:
A · n · 4 bytes a matrix for its A attractors, plus the diagonal read
and the labels written, at 3.35 TB/s (tools/kernelkit.py).

chip_smoke.py times the kernel and its plain version on the final
matrices of the dense pipeline's first batch and holds one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from haphic_tpu_torch.kernels import build as kbuild


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def mcl_labels_plain(m: torch.Tensor) -> torch.Tensor:
    """The criterion in torch ops: (B, n) int32 labels, a row of -1 for a
    matrix that is no partition."""
    n = m.shape[-1]
    nz = m != 0
    att = torch.diagonal(nz, dim1=-2, dim2=-1)                  # (B, n)
    rows = torch.arange(n, device=m.device).view(1, n, 1)
    # L(j): the least attractor row with a nonzero in column j, n if none
    L = torch.where(nz & att[:, :, None], rows, n).amin(dim=1)
    same = L[:, None, :] == L[:, :, None]                       # L(j) == L(a)
    ok = (L < n).all(dim=1) & ~((nz != same) & att[:, :, None]).any(
        dim=(1, 2))
    return torch.where(ok[:, None], L, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn():
    fn = kbuild.load('mcl_interpret').mcl_interpret_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp]
    fn.restype = ci
    return fn


def _check(m: torch.Tensor):
    if m.dim() != 3 or m.shape[1] != m.shape[2] or min(m.shape) < 1:
        raise ValueError('m: want (B, n, n) with B, n >= 1, got {}'.format(
            tuple(m.shape)))
    if m.dtype != torch.float32 or not m.is_contiguous():
        raise ValueError('m: want contiguous float32, got {} strides {}'
                         .format(m.dtype, m.stride()))
    if m.shape[0] > 65535:
        raise ValueError('m: B = {} past the grid\'s 65,535'.format(
            m.shape[0]))


def mcl_labels(m: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 cluster labels of the final matrices ``m``: the CUDA
    kernel on a CUDA tensor (no host sync, only (B, n) buffers), the
    plain version on a CPU tensor."""
    _check(m)
    dev = m.device
    if dev.type == 'cpu':
        return mcl_labels_plain(m)
    if dev.type != 'cuda':
        raise ValueError('unsupported device {}'.format(dev))
    B, n = m.shape[0], m.shape[2]
    att = torch.empty((B, n), dtype=torch.int32, device=dev)
    cnt_flag = torch.empty((2, B), dtype=torch.int32, device=dev)
    labels = torch.empty((B, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fn()(m.data_ptr(), B, n, att.data_ptr(),
                    cnt_flag[0].data_ptr(), cnt_flag[1].data_ptr(),
                    labels.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError('mcl_interpret kernel launch failed: CUDA error '
                           '{}'.format(err))
    mcl_labels.launches += 1
    return labels


mcl_labels.launches = 0

"""Torch runtime setup for haphic_tpu_torch: numerics and device choice.

Counterpart of haphic_tpu/runtime.py:75 ``setup_jax``. That module
configures an XLA compilation cache; PyTorch runs eagerly, so there is
no cache to manage here. What remains is:

* full-f32 numerics. ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` are both set to False: the MCL
  expansion matmul must run in exact f32 (TF32 keeps ~3 decimal
  digits, which moves the column pruning and the convergence test);
  the JAX reference runs exact f32 on the CPU.
* device resolution. Entry points take ``device`` ("cuda" by default)
  and resolve it here. Asking for CUDA on a host without a usable card
  raises: the port never carries on on the CPU by itself. In a process
  that torchrun started (LOCAL_RANK set), "cuda" is the rank's card,
  cuda:{LOCAL_RANK % device_count}: one process per card, and ranks
  share cards round-robin when there are more ranks than cards
  (parallel/mesh.py).
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None) -> torch.device:
    """torch.device for ``device`` (None means DEFAULT_DEVICE); "cuda"
    without an index is the rank's card under torchrun. Raises
    RuntimeError when CUDA is requested and unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device {!r} requested but CUDA is not available; pass '
            'device="cpu" (CLI: --device cpu) to run on the CPU'.format(
                str(dev)))
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device {!r}'.format(str(dev)))
    if dev.type == 'cuda' and dev.index is None \
            and 'LOCAL_RANK' in os.environ:
        dev = torch.device('cuda', int(os.environ['LOCAL_RANK'])
                           % torch.cuda.device_count())
    return dev

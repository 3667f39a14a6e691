"""Carry state from the JAX package (haphic_tpu) into the port.

HapHiC has no weights: its state is link tensors, tour problems and GA
populations. These functions take the JAX package's objects through
their numpy fields (duck-typed, so this module imports nothing of
haphic_tpu) and return the port's objects, so that both packages can
compute from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from haphic_tpu_torch.assign.reassign import ReassignParams
from haphic_tpu_torch.order.optimize import TourProblem
from haphic_tpu_torch.pipeline import PipelineConfig


def problem_from_jax(p) -> TourProblem:
    """A haphic_tpu.order.optimize.TourProblem as the port's."""
    return TourProblem(lengths=np.asarray(p.lengths, np.int64).copy(),
                       pair_a=np.asarray(p.pair_a, np.int32).copy(),
                       pair_b=np.asarray(p.pair_b, np.int32).copy(),
                       d=np.asarray(p.d, np.float32).copy(),
                       w=np.asarray(p.w, np.float32).copy())


def population_from_jax(order, ori, device='cpu'):
    """A population (order, ori), JAX or numpy arrays of any leading
    shape, as int32 torch tensors on ``device``."""
    return (torch.as_tensor(np.asarray(order, np.int32), device=device),
            torch.as_tensor(np.asarray(ori, np.int32), device=device))


def config_from_jax(cfg, device: str = 'cuda') -> PipelineConfig:
    """A haphic_tpu.pipeline.PipelineConfig as the port's, field by
    field from dataclasses.asdict; ``device`` picks the port's device.
    A JAX mesh object does not carry over (mesh stays None)."""
    src = dataclasses.asdict(cfg)
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    kw = {k: v for k, v in src.items()
          if k in fields and k not in ('reassign', 'mesh', 'device')}
    rp = ReassignParams(**src['reassign'])
    return PipelineConfig(reassign=rp, device=device, **kw)

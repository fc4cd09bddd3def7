"""Learning-rate schedules as step -> lr callables.

Port of ``repro/optim/schedules.py``.  The step is a 0-dim int32 tensor and
the lr an f32 0-dim tensor on the step's device.  Scalars enter the ops as
Python floats (rounded to f32 by the op, as the reference's weak-typed
scalars), and a divisor is filled on the step's device: CUDA turns division
by a host scalar into a reciprocal multiply, which rounds differently.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_decay"]


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def constant(lr: float):
    return lambda step: _full(lr, step)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp_max(step.float() / _full(max(warmup_steps, 1), step), 1.0)
        return _full(lr, step) * frac
    return fn


def cosine_decay(lr: float, total_steps: int, warmup_steps: int = 0, floor: float = 0.0):
    def fn(step):
        s = step.float()
        warm = (torch.clamp_max(s / _full(max(warmup_steps, 1), step), 1.0)
                if warmup_steps else 1.0)
        prog = torch.clamp((s - warmup_steps) / _full(max(total_steps - warmup_steps, 1), step),
                           0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return _full(lr, step) * warm * cos
    return fn

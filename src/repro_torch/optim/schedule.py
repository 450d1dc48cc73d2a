"""Learning-rate schedules: fp32 functions of the step counter (an int or
a tensor), as the JAX package computes them."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, total_steps: int, *, floor: float = 0.1):
    frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    return floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))


def linear_warmup_cosine(step, warmup: int, total_steps: int, *,
                         floor: float = 0.1):
    s = _f32(step)
    warm = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
    return warm * cosine_schedule(torch.clamp(s - warmup, min=0.0),
                                  max(total_steps - warmup, 1), floor=floor)

"""Learning-rate schedules (step -> lr, a float32 tensor): the port of
``repro.optim.schedules``, with JAX's arithmetic in its order.  A step
given as a tensor keeps its device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def linear_warmup_cosine(peak: float, warmup: int, total: int,
                         floor: float = 0.0):
    warmup = max(warmup, 1)

    def sched(step):
        step = _f32(step)
        warm = peak * step / warmup
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return sched


def linear_warmup_linear_decay(peak: float, warmup: int, total: int,
                               floor: float = 0.0):
    warmup = max(warmup, 1)

    def sched(step):
        step = _f32(step)
        warm = peak * step / warmup
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        lin = peak + (floor - peak) * frac
        return torch.where(step < warmup, warm, lin)

    return sched

"""Learning-rate schedules (step -> lr), a port of ``repro.optim.schedules``.

``step`` is the optimizers' int32 step tensor (or a Python int); each
schedule returns a 0-d fp32 tensor.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))

    return fn


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    cos = cosine_decay(peak, max(total_steps - warmup_steps, 1), floor)

    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn

"""LR schedules as functions of the step counter (reference
``optim/schedule.py``): the step is an int or a 0-d tensor, the scale an f32
0-d tensor on the step's device, computed without a host read."""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(warmup: int, total: int, *, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of the peak LR."""

    def fn(step):
        step = _step_f32(step)
        warm = step / max(1.0, float(warmup))
        prog = ((step - warmup) / max(1.0, float(total - warmup))).clamp(0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn


def constant():
    def fn(step):
        return torch.ones_like(_step_f32(step))

    return fn

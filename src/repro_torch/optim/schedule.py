"""Learning-rate schedules (return the multiplier for
``AdamWConfig.schedule``): the reference's formulas, in f32 torch."""
from __future__ import annotations

import math

import torch


def cosine_schedule(warmup: int, total: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def linear_schedule(warmup: int, total: int):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        dec = torch.clamp(1.0 - (step - warmup) / max(total - warmup, 1),
                          0.0, 1.0)
        return torch.where(step < warmup, warm, dec)
    return fn

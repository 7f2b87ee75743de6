"""LR schedules (port of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``: a 0-d float32 tensor on
    ``step``'s device (``step`` an int tensor or an int)."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)

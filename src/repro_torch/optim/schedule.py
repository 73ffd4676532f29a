"""Learning-rate schedules (port of `repro/optim/schedule.py`): pure
functions of the step counter, in f32 as the reference computes them."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 200, total: int = 10000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1, then a cosine down to ``min_ratio``: a 0-d f32
    tensor."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp_max(s / max(warmup, 1), 1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step):
    return 1.0

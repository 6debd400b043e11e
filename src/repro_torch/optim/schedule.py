"""LR schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine down
    to ``min_ratio * peak_lr`` at ``total_steps``. The returned function
    maps a step (an int or a tensor) to a float32 0-d tensor on the CPU."""
    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (s + 1.0) / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr

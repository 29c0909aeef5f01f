"""LR schedules (``repro.optim.schedules``): f32 scalars of the step."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``final_frac * peak_lr``: a 0-d
    f32 tensor on the CPU, computed as the reference computes it in f32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)

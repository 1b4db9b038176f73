"""Learning-rate schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_with_warmup", "step_decay"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn


def step_decay(lr: float, decay: float, every: int):
    def fn(step):
        step = _f32(step)
        return torch.tensor(lr, dtype=torch.float32) * decay ** torch.floor(
            step / every)
    return fn

"""LR schedules (pure functions of the step counter), computed in float32
tensor arithmetic on the step's device like the reference."""
from __future__ import annotations

import math

import torch

from repro_torch.config import OptimizerConfig


def make_schedule(cfg: OptimizerConfig):
    warmup = max(1, cfg.warmup_steps)
    total = max(cfg.total_steps, warmup + 1)

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = cfg.lr * torch.clamp(step / warmup, max=1.0)
        if cfg.schedule == "constant":
            return warm
        prog = torch.clamp((step - warmup) / (total - warmup), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cfg.lr * (0.1 + 0.9 * cos))

    return sched

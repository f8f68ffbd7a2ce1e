"""LR schedules: cosine (llama-style) and WSD (minicpm's warmup-stable-decay).

Each schedule maps a step (an int or a 0-dim tensor) to a 0-dim f32 tensor,
with the reference's arithmetic in the reference's order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak: float, total_steps: int,
                    warmup_frac: float = 0.01,
                    final_frac: float = 0.1) -> Callable:
    warmup = max(1, int(total_steps * warmup_frac))

    def sched(step):
        step = _f32(step)
        warm = peak * step / warmup
        prog = torch.clamp((step - warmup) / max(1, total_steps - warmup),
                           0, 1)
        cos = final_frac * peak + (1 - final_frac) * peak * \
            0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return sched


def wsd_schedule(peak: float, total_steps: int, warmup_frac: float = 0.01,
                 decay_frac: float = 0.1, final_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, long flat plateau,
    short exponential-ish (here linear-in-log) decay tail."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1 - decay_frac))

    def sched(step):
        step = _f32(step)
        warm = peak * step / warmup
        tail_prog = torch.clamp((step - decay_start) /
                                max(1, total_steps - decay_start), 0, 1)
        tail = peak * torch.exp(math.log(final_frac) * tail_prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start,
                                       torch.full_like(step, peak), tail))

    return sched

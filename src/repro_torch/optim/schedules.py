"""LR schedules: linear warmup + {cosine, WSD}, and constant.

WSD (Warmup-Stable-Decay) is MiniCPM's schedule (arXiv:2404.06395):
constant LR after warmup for the 'stable' phase, then a short decay tail.
Each takes the step as an int or a tensor and returns a 0-d fp32 tensor
(on the step's device), computed in fp32 as in the reference package's
``repro/optim/schedules.py``."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, min_ratio: float = 0.1):
    """Warmup -> Stable (constant) -> Decay (exponential tail)."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    d = ((step - warmup_steps - stable_steps) / max(decay_steps, 1)).clamp(0.0, 1.0)
    decay = peak_lr * torch.pow(torch.tensor(min_ratio, dtype=torch.float32,
                                             device=step.device), d)
    stable = torch.full_like(step, peak_lr)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < warmup_steps + stable_steps, stable,
                                   decay))


def constant(step, *, peak_lr: float, **_):
    return torch.full_like(_f32(step), peak_lr)


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd, "constant": constant}

"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM §4).

Counterpart of ``repro.optim.schedules``: each schedule maps a step (an
int or a tensor, on any device) to a 0-d fp32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac=0.1):
    def lr(step):
        step = _as_step(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int, min_frac=0.01):
    """Warmup -> stable plateau -> sharp exponential-ish decay (MiniCPM)."""
    def lr(step):
        step = _as_step(step)
        warm = base_lr * step / max(warmup, 1)
        d_prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = base_lr * (min_frac ** d_prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, torch.full_like(step, base_lr),
                                       dec))

    return lr

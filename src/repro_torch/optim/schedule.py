"""LR schedules: functions of the optimizer's step counter.

The counterpart of the reference package's ``optim/schedule.py``. The
counter is a 0-dim int32 tensor on the parameters' device, and the rate is
computed from it in float32 on that device, so a train step never waits on
the host for its learning rate.
"""

from __future__ import annotations

import math

import torch


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` rounded once, on any device: the card divides by a Python
    scalar as a product with its reciprocal, which can differ by an ulp."""
    return t / torch.full_like(t, d)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac · peak_lr`` at ``total_steps``. Returns
    ``lr(count) -> float32 tensor``, the reference's arithmetic in its
    order (each Python constant meets a float32 tensor, as JAX's weakly
    typed scalars do).

    Example::

        lr = warmup_cosine(3e-4, 2000, 100_000)
        lr(torch.tensor(10, dtype=torch.int32))   # tensor(1.5000e-06)
    """
    def lr(count):
        c = torch.as_tensor(count).float()
        warm = _div(peak_lr * c, max(warmup_steps, 1))
        progress = torch.clamp(
            _div(c - warmup_steps, max(total_steps - warmup_steps, 1)), 0.0, 1.0
        )
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(c < warmup_steps, warm, cos)

    return lr

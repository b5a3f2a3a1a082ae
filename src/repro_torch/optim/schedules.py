"""Learning-rate schedules as pure step -> lr functions; port of
``repro.optim.schedules`` on plain Python floats (the reference computes
them in float32 jnp inside its jitted step)."""
from __future__ import annotations

import math


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``."""
    step = float(step)
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = min(max(t, 0.0), 1.0)
    return peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                      (1 + math.cos(math.pi * t)))


def constant(step, *, lr: float) -> float:
    return float(lr)

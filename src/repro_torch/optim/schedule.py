"""Learning-rate schedules (step → lr), evaluated in float32 as ``repro``'s
jnp schedules are."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]


def cosine_with_warmup(peak_lr: float, warmup: int, total: int,
                       floor: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor · peak_lr`` at ``total``."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                              * (f32(1) + np.cos(f32(math.pi) * frac)))
        return float(cos)
    return lr


def constant(lr_value: float) -> Schedule:
    def lr(step: int) -> float:
        return float(np.float32(lr_value))
    return lr

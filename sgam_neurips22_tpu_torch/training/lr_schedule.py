"""LR schedules — port of `sgam_neurips22_tpu/training/lr_schedule.py`
(the reference's `LambdaWarmUpCosineScheduler`)."""
from __future__ import annotations

import numpy as np


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float, max_decay_steps: int):
    """Linear warmup lr_start -> lr_max, then cosine decay to lr_min: a
    multiplier f(step) of the base learning rate, a float32 value computed
    in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step) -> np.float32:
        step = f32(step)
        warm = f32(lr_start) + f32((lr_max - lr_start) / max(warm_up_steps, 1)) * step
        t = np.clip((step - f32(warm_up_steps)) / f32(max(max_decay_steps - warm_up_steps, 1)), f32(0), f32(1))
        cos = f32(lr_min) + f32(0.5 * (lr_max - lr_min)) * (f32(1) + np.cos(t * f32(np.pi)))
        return warm if step < warm_up_steps else cos

    return schedule

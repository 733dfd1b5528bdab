"""Learning-rate schedules: functions step -> learning rate.

Counterpart of tal_asrd_tpu/train/schedules.py, evaluated in float32 as the
reference evaluates them, so both give the same numbers:
  * linear_decay_schedule: scaled_lr * max(1 - step/total_steps,
    scaled_lr / 1000) — the floor is a factor equal to scaled_lr / 1000, a
    quirk of the reference's trainer that is kept;
  * constant_schedule;
  * triangle_schedule: linear warmup to max_lr, then linear decay to 0;
  * inv_sqrt_schedule: linear warmup, then max_lr * sqrt(warmup / step).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

f32 = np.float32


def triangle_schedule(max_lr: float, warmup_steps: int,
                      total_steps: int) -> Callable[[int], float]:
    def schedule(step):
        step = f32(step)
        if step < warmup_steps:
            return float(f32(max_lr) * step / f32(max(warmup_steps, 1)))
        frac = (f32(total_steps) - step) / f32(max(total_steps - warmup_steps, 1))
        return float(f32(max_lr) * max(frac, f32(0.0)))

    return schedule


def inv_sqrt_schedule(max_lr: float, warmup_steps: int) -> Callable[[int], float]:
    def schedule(step):
        step = f32(step)
        if step < warmup_steps:
            return float(f32(max_lr) * step / f32(max(warmup_steps, 1)))
        return float(f32(max_lr) * np.sqrt(f32(warmup_steps) / max(step, f32(1.0))))

    return schedule


def linear_decay_schedule(scaled_lr: float, total_steps: int) -> Callable[[int], float]:
    def schedule(step):
        factor = max(f32(1.0) - f32(step) / f32(total_steps), f32(scaled_lr / 1000.0))
        return float(f32(scaled_lr) * factor)

    return schedule


def constant_schedule(lr: float) -> Callable[[int], float]:
    def schedule(step):
        return float(f32(lr))

    return schedule

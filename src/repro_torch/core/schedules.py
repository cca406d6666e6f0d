"""Learning-rate schedules (port of ``repro/core/schedules.py``).

A schedule here is a function of the HOST-side integer step that returns
a ``numpy.float32``: the JAX package computes ``lr_fn(step)`` in f32, so
every operation below is carried out in f32 in the same order. Keeping
the step on the host means the optimizer never waits on the device to
learn its learning rate.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], np.float32]
f32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: f32(lr)


def inverse_time_decay(lr0: float, decay: float = 1e-4) -> Schedule:
    """Paper Table 1: lr_t = lr0 / (1 + decay * t)."""
    return lambda step: f32(lr0) / (f32(1.0) + f32(decay) * f32(step))


def step_decay(lr0: float, drop: float = 0.1, every: int = 1000) -> Schedule:
    return lambda step: f32(lr0) * np.power(f32(drop), f32(step // every))


def polynomial_decay(lr0: float, total_steps: int, power: float = 2.0,
                     lr_end: float = 0.0) -> Schedule:
    """LARS-paper style poly decay: lr = (lr0-end)*(1 - t/T)^p + end."""
    def fn(step):
        frac = np.clip(f32(step) / f32(total_steps), f32(0.0), f32(1.0))
        return f32(lr0 - lr_end) * np.power(f32(1.0) - frac, f32(power)) \
            + f32(lr_end)
    return fn


def cosine_decay(lr0: float, total_steps: int, lr_end: float = 0.0
                 ) -> Schedule:
    def fn(step):
        frac = np.clip(f32(step) / f32(total_steps), f32(0.0), f32(1.0))
        return f32(lr_end) + f32(0.5) * f32(lr0 - lr_end) * (
            f32(1.0) + np.cos(f32(math.pi) * frac))
    return fn


def poly_decay_with_warmup(lr0: float, total_steps: int, warmup_steps: int,
                           *, power: float = 2.0, lr_end: float = 0.0
                           ) -> Schedule:
    """You et al. (1708.03888 §6): linear warmup to ``lr0`` over
    ``warmup_steps``, then polynomial decay over the remaining steps."""
    decay = polynomial_decay(lr0, max(total_steps - warmup_steps, 1),
                             power, lr_end)
    return with_warmup(decay, warmup_steps)


def large_batch_lr(base_lr: float, base_batch: int, batch: int,
                   total_steps: int, *, warmup_steps: int = 0,
                   power: float = 2.0, policy: str = "linear") -> Schedule:
    """Batch-size scaling of a tuned ``(base_lr, base_batch)`` pair
    combined with warmup + polynomial decay."""
    from repro_torch.core.scaling import scaled_lr
    lr0 = scaled_lr(base_lr, base_batch, batch, policy)
    if warmup_steps <= 0:
        return polynomial_decay(lr0, total_steps, power)
    return poly_decay_with_warmup(lr0, total_steps, warmup_steps,
                                  power=power)


def with_warmup(schedule: Schedule, warmup_steps: int) -> Schedule:
    """Linear warmup from 0 into ``schedule`` (offset so schedule sees t=0
    at the end of warmup)."""
    if warmup_steps <= 0:
        return schedule

    def fn(step):
        if step < warmup_steps:
            return schedule(0) * (f32(step) + f32(1.0)) / f32(warmup_steps)
        return schedule(step - warmup_steps)
    return fn

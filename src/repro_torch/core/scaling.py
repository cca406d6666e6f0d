"""Large-batch LR scaling policies (port of ``repro/core/scaling.py``).

* linear  (Goyal et al.): lr = base_lr * batch / base_batch   — SGD regime
* sqrt    (You et al.):   lr = base_lr * sqrt(batch / base_batch) — LARS/LAMB
"""

from __future__ import annotations

import math

POLICIES = ("none", "linear", "sqrt")


def scaled_lr(base_lr: float, base_batch: int, batch: int,
              policy: str = "linear") -> float:
    if policy == "none":
        return base_lr
    if policy == "linear":
        return base_lr * batch / base_batch
    if policy == "sqrt":
        return base_lr * math.sqrt(batch / base_batch)
    raise ValueError(f"unknown scaling policy {policy!r}; have {POLICIES}")

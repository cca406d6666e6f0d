"""AdamW — the non-layer-wise baseline of the LM experiments (port of
``repro/core/adamw.py``). On the shared substrate AdamW is LAMB with the
trust ratio removed (``trust=None``); like LAMB it has no kernel.
"""

from __future__ import annotations

from repro_torch.core.optim_base import (LayerwiseRule, Optimizer, Schedule,
                                         adam_moments, make_optimizer)


def adamw(learning_rate: float | Schedule = 1e-3, *, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          slot_dtype: str = "f32") -> Optimizer:
    prepare, direction = adam_moments(b1, b2, eps, weight_decay)

    def apply(ctx, w, g, u, local_lr, slots):
        return w - local_lr * u, slots

    rule = LayerwiseRule(name="adamw", slots=("mu", "nu"),
                         direction=direction, apply=apply, trust=None,
                         prepare=prepare, needs_grad_sq=True)
    return make_optimizer(rule, learning_rate, slot_dtype=slot_dtype,
                          hyperparams=dict(learning_rate=learning_rate,
                                           b1=b1, b2=b2,
                                           weight_decay=weight_decay,
                                           slot_dtype=slot_dtype))

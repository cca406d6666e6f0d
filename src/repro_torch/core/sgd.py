"""Stochastic Gradient Descent with momentum + weight decay (port of
``repro/core/sgd.py``) — the paper's baseline, heavy-ball form:

    m <- mu * m + (g + wd * w)
    w <- w - lr_t * m

The degenerate member of the trust-ratio family (``trust=None``); it has
no kernel passes, so an SGD step launches no hand kernel.
"""

from __future__ import annotations

from repro_torch.core.optim_base import (LayerwiseRule, Optimizer, Schedule,
                                         make_optimizer)


def sgd(learning_rate: float | Schedule = 0.01, *, momentum: float = 0.9,
        weight_decay: float = 1e-4, nesterov: bool = False,
        slot_dtype: str = "f32") -> Optimizer:

    def direction(g, w, slots):
        return g + weight_decay * w, slots

    def apply(w, g, u, lr, slots):
        m_new = momentum * slots["momentum"] + u
        step_dir = u + momentum * m_new if nesterov else m_new
        return w - lr * step_dir, {"momentum": m_new}

    rule = LayerwiseRule(name="sgd", slots=("momentum",),
                         direction=direction, apply=apply)
    return make_optimizer(rule, learning_rate, slot_dtype=slot_dtype,
                          hyperparams=dict(learning_rate=learning_rate,
                                           momentum=momentum,
                                           weight_decay=weight_decay,
                                           nesterov=nesterov,
                                           slot_dtype=slot_dtype))

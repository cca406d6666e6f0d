"""LAMB — Layer-wise Adaptive Moments for Batch training (You et al. 2019;
port of ``repro/core/lamb.py``), the paper's stated future work (§6):

    m <- b1 m + (1-b1) g          (bias-corrected)
    v <- b2 v + (1-b2) g^2        (bias-corrected)
    u  = m_hat / (sqrt(v_hat) + eps) + wd * w
    w <- w - lr * [phi(||w||)/||u||] * u

The same trust-ratio family as LARS, differing in the direction and the
ratio. It has no kernel: the engine takes its per-slice norms and runs
its ``apply`` in PyTorch, as the reference's does.
"""

from __future__ import annotations

from repro_torch.core import trust_ratio as tr
from repro_torch.core.optim_base import (LayerwiseRule, Optimizer, Schedule,
                                         adam_moments, make_optimizer)


def lamb(learning_rate: float | Schedule = 1e-3, *, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 1e-4,
         trust_clip_max: float = 10.0,
         skip_adaptation_1d: bool = True,
         slot_dtype: str = "f32") -> Optimizer:
    prepare, direction = adam_moments(b1, b2, eps, weight_decay)

    def trust(ctx, w_norm, u_norm):
        return tr.lamb_trust_ratio(w_norm, u_norm, clip_max=trust_clip_max)

    def apply(ctx, w, g, u, local_lr, slots):
        return w - local_lr * u, slots

    rule = LayerwiseRule(name="lamb", slots=("mu", "nu"),
                         direction=direction, apply=apply, trust=trust,
                         prepare=prepare, needs_grad_sq=True,
                         skip_adaptation_1d=skip_adaptation_1d)
    return make_optimizer(rule, learning_rate, slot_dtype=slot_dtype,
                          hyperparams=dict(learning_rate=learning_rate,
                                           b1=b1, b2=b2,
                                           weight_decay=weight_decay,
                                           trust_clip_max=trust_clip_max,
                                           skip_adaptation_1d=skip_adaptation_1d,
                                           slot_dtype=slot_dtype))

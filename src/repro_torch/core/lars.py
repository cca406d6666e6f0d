"""LARS — Layer-wise Adaptive Rate Scaling (the paper's technique; port of
``repro/core/lars.py``). Paper Eqs. (1)-(3), Table-1 defaults:

    lambda_l = eta * ||w_l|| / (||grad_l|| + beta * ||w_l||)        (Eq. 3)
    m_l   <- mu * m_l + gamma_t * lambda_l * (grad_l + beta * w_l)
    w_l   <- w_l - m_l

The two memory-bound phases go through :mod:`repro_torch.kernels.ops` —
ONE joint ||w||,||g|| pass (``norms_flat``) and ONE fused
momentum+decay+apply pass (``apply_flat``, or ``apply_flat_q8`` when the
momentum is stored as int8) over the whole superbuffer: two kernel
launches per step on the card, whatever the leaf count, and the kernels'
plain versions on the CPU. A tree-layout state (``init(params)``) runs
the rule's ``apply`` per leaf in torch ops and launches no kernel, as
the reference's tree engine runs jnp.
"""

from __future__ import annotations

from repro_torch.core import trust_ratio as tr
from repro_torch.core.optim_base import (LayerwiseRule, Optimizer, Schedule,
                                         make_optimizer)


def lars(learning_rate: float | Schedule = 0.01, *, momentum: float = 0.9,
         weight_decay: float = 1e-4, trust_coefficient: float = 0.001,
         skip_adaptation_1d: bool = True, eps: float = 1e-9,
         use_kernels: bool | str = "auto",
         slot_dtype: str = "f32") -> Optimizer:
    """Build the LARS optimizer (paper defaults from Table 1).

    ``use_kernels`` names where the buffers must lie: ``"auto"``
    (default) takes either, ``True`` CUDA buffers (the kernels) and
    ``False`` CPU buffers (the plain versions). Any other placement
    raises; the kernel wrappers choose by the buffers' device. Tree
    states have no kernel path: ``True`` refuses them.
    ``slot_dtype="int8"`` stores the momentum as int8 codes + f32
    per-block scales (~4x smaller optimizer state).
    """

    def direction(ctx, g, w, slots):
        return g, slots          # Eq. 3 norms the raw gradient

    def apply(ctx, w, g, u, local_lr, slots):
        # the tree engine's update; the packed engine takes the kernels
        m_new = momentum * slots["momentum"] + local_lr * (
            g + weight_decay * w)
        return w - m_new, {"momentum": m_new}

    def trust(ctx, w_norm, g_norm):
        return tr.lars_trust_ratio(w_norm, g_norm, eta=trust_coefficient,
                                   weight_decay=weight_decay, eps=eps)

    def packed_norms(layout, wbuf, ubuf):
        from repro_torch.kernels import ops as kops
        kops.check_use_kernels(use_kernels, wbuf.device)
        return kops.lars_norms_packed(layout, wbuf, ubuf)

    def packed_apply(layout, wbuf, gbuf, ubuf, lr_slices, slots):
        from repro_torch.kernels import ops as kops
        wbuf2, mbuf2 = kops.lars_apply_packed(
            layout, wbuf, gbuf, slots["momentum"], lr_slices,
            momentum=momentum, weight_decay=weight_decay)
        return wbuf2, {"momentum": mbuf2}

    def packed_apply_q8(layout, wbuf, gbuf, ubuf, lr_slices, slots):
        # int8 momentum: dequantize, update and requantize in ONE launch;
        # the f32 momentum never reaches memory
        from repro_torch.kernels import ops as kops
        wbuf2, q2, s2 = kops.lars_apply_packed_q8(
            layout, wbuf, gbuf, slots["momentum"],
            slots["momentum_scale"], lr_slices,
            momentum=momentum, weight_decay=weight_decay)
        return wbuf2, {"momentum": q2, "momentum_scale": s2}

    rule = LayerwiseRule(name="lars", slots=("momentum",),
                         direction=direction, apply=apply, trust=trust,
                         packed_norms=packed_norms,
                         packed_apply=packed_apply,
                         packed_apply_q8=packed_apply_q8,
                         skip_adaptation_1d=skip_adaptation_1d)
    return make_optimizer(rule, learning_rate, slot_dtype=slot_dtype,
                          use_kernels=use_kernels,
                          hyperparams=dict(learning_rate=learning_rate,
                                           momentum=momentum,
                                           weight_decay=weight_decay,
                                           trust_coefficient=trust_coefficient,
                                           skip_adaptation_1d=skip_adaptation_1d,
                                           use_kernels=use_kernels,
                                           slot_dtype=slot_dtype))

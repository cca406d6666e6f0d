"""Layer-wise trust-ratio math (LARS). Port of
``repro/core/trust_ratio.py``; the LAMB ratio comes with LAMB.

Paper Eq. (2)/(3):

    lambda_l = eta * ||w_l|| / (||grad_l|| + beta * ||w_l||)

Parameters whose effective rank is <= 1 (biases) are not adapted, and
degenerate norms (zero weights or zero grads) fall back to a trust ratio
of 1, so the step degenerates to plain (decayed) SGD instead of 0/0.
"""

from __future__ import annotations

from typing import Optional

import torch


def reduction_axes(x: torch.Tensor, stacked: bool
                   ) -> Optional[tuple[int, ...]]:
    """Axes of a per-layer norm: all axes, or all but 0 when stacked."""
    if stacked:
        return tuple(range(1, x.ndim))
    return tuple(range(x.ndim))


def effective_rank(x: torch.Tensor, stacked: bool) -> int:
    return x.ndim - (1 if stacked else 0)


def layer_norms(w: torch.Tensor, g: torch.Tensor, stacked: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(||w||, ||g||) per layer, computed in f32; shape () or (L,)."""
    axes = reduction_axes(w, stacked)
    return (torch.sqrt(torch.sum(torch.square(w.float()), dim=axes)),
            torch.sqrt(torch.sum(torch.square(g.float()), dim=axes)))


def lars_trust_ratio(w_norm: torch.Tensor, g_norm: torch.Tensor, *,
                     eta: float, weight_decay: float,
                     eps: float = 1e-9) -> torch.Tensor:
    """Paper Eq. (3): eta * ||w|| / (||g|| + beta*||w||), guarded."""
    denom = g_norm + weight_decay * w_norm
    ratio = eta * w_norm / (denom + eps)
    ok = (w_norm > 0.0) & (g_norm > 0.0)
    return torch.where(ok, ratio, torch.ones_like(ratio))


def broadcast_ratio(ratio: torch.Tensor, like: torch.Tensor,
                    stacked: bool) -> torch.Tensor:
    """Reshape a () or (L,) ratio so it broadcasts against ``like``."""
    if not stacked:
        return ratio
    return ratio.reshape((like.shape[0],) + (1,) * (like.ndim - 1))

"""Loss functions (f32 accumulation regardless of model compute dtype).
Port of ``repro/train/losses.py``: the classification loss and the
next-token LM loss. The chunked LM loss (``chunked_lm_loss``) is not yet
ported.
"""

from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean masked NLL. logits (..., V) any float dtype; labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """The paper's loss: softmax cross-entropy on the class head."""
    return softmax_cross_entropy(logits, labels)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
            prefix_len: int = 0) -> torch.Tensor:
    """Next-token loss. logits (B, S, V) aligned with tokens (B, S):
    predict tokens[:, t+1] from logits[:, t]. ``prefix_len`` masks the
    first positions (a bidirectional prefix)."""
    lg = logits[:, :-1]
    tg = tokens[:, 1:]
    mask = None
    if prefix_len:
        pos = torch.arange(lg.shape[1], device=lg.device)
        mask = (pos >= prefix_len).expand(tg.shape)
    return softmax_cross_entropy(lg, tg, mask)

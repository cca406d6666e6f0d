"""Loss functions (f32 accumulation regardless of model compute dtype).
Port of ``repro/train/losses.py``, classification losses only."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean NLL. logits (..., V) any float dtype; labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - ll)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """The paper's loss: softmax cross-entropy on the class head."""
    return softmax_cross_entropy(logits, labels)

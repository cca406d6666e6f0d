"""Evaluation metrics — the paper's three (§4.2): test accuracy, train
accuracy, and generalization error (train acc − test acc)."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy; logits (..., V), labels (...)."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels.long())
                      .float())


def generalization_error(train_acc: float, test_acc: float) -> float:
    """Paper §4.2: difference between training and test accuracy."""
    return float(train_acc) - float(test_acc)

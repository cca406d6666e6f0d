"""TrainState: what is carried across steps (port of
``repro/train/state.py``). The optimizer state is born on the
flat-packed substrate: the model's stacked marker goes into
``optimizer.init``, so weights and slots live in packed superbuffers.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.optim_base import OptState

Pytree = Any


class TrainState(NamedTuple):
    params: Pytree
    opt_state: OptState


def create_train_state(model, optimizer, generator: torch.Generator, *,
                       device: torch.device | str, packed: bool = True,
                       precision: str = "f32") -> TrainState:
    """Fresh TrainState on ``device`` from ``model.init(generator)``."""
    if precision != "f32":
        raise NotImplementedError(
            f"precision {precision!r} is not yet ported to repro_torch")
    if not packed:
        raise NotImplementedError(
            "per-leaf (packed=False) optimizer states are not yet ported "
            "to repro_torch")
    params = model.init(generator, device)
    return TrainState(params=params, opt_state=optimizer.init(
        params, stacked=model.stacked_marker(params)))

"""Train/eval step factories (port of ``repro/train/step.py``, cnn
family). A step is an eager function (TrainState, batch) -> (TrainState,
metrics): autograd for the gradients, then the optimizer update. The
metrics stay on the device; reading them is the caller's choice.

  cnn      {"x": images (B,28,28,1), "y": labels (B,)}
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.losses import classification_loss
from repro_torch.train.metrics import accuracy
from repro_torch.train.state import TrainState
from repro_torch.treepath import tree_flatten_with_path, tree_unflatten

Pytree = Any


def _forward_and_loss(model, cfg, params, batch):
    """(loss, (logits, aux)) for the cnn family."""
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch")
    logits, aux = model.forward(params, batch["x"])
    return classification_loss(logits, batch["y"]), (logits, aux)


def value_and_grad(model, cfg, params: Pytree, batch
                   ) -> tuple[torch.Tensor, Pytree, tuple]:
    """(loss, grads, (logits, aux)): the loss and its gradient with
    respect to every leaf of ``params``."""
    leaves, treedef = tree_flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in leaves]
    loss, out = _forward_and_loss(model, cfg,
                                  tree_unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(treedef, grads), out


def make_train_step(model, optimizer, cfg=None) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics dict)."""
    cfg = cfg if cfg is not None else model.cfg

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads, (_, aux) = value_and_grad(model, cfg, state.params,
                                               batch)
        new_params, new_opt = optimizer.update(
            grads, state.opt_state, state.params,
            stacked=model.stacked_marker(state.params))
        metrics = {"loss": loss, "aux_loss": aux["aux_loss"],
                   "step": new_opt.step}
        return TrainState(new_params, new_opt), metrics

    return step


def make_eval_step(model, cfg=None) -> Callable:
    """(params, batch) -> metrics {loss, accuracy}; the cnn family scores
    the class head directly against the labels."""
    cfg = cfg if cfg is not None else model.cfg

    @torch.no_grad()
    def step(params, batch) -> dict:
        loss, (logits, _) = _forward_and_loss(model, cfg, params, batch)
        return {"loss": loss, "accuracy": accuracy(logits, batch["y"])}

    return step
